"""The port's static verifiers (pinot_tpu_torch/analysis: concur, detlint,
plan_verify; the runner pinot_tpu_torch/tools/check_static.py) against
the JAX package's on the CPU.

- Parity: every synthetic source of the JAX package's CC201–CC205 and
  DT301–DT305 cases (tests/test_static_analysis.py) is captured as that
  case feeds it to the JAX analyser, then run through the port's; both
  must report the same rule ids, lines and scopes (the package prefix of
  paths mapped, a JAX device sync mapped to torch's on the same line).
- The torch rules: CC202 on ``.cpu()`` and ``torch.cuda.synchronize()``
  under a lock, DT302 on torch's global generator (clean with
  ``generator=``), and a module function's ``# holds-lock:``.
- The port's own tree: clean against its ratchet baselines (one
  module-scoped analysis), every registry root resolves, the baselines
  grandfather no CC201/CC203/CC205 and only what the JAX baseline
  grandfathers at the same site; the CLI exits 0, and an injected
  finding makes it fail.
- The plan verifier: each targeted bad plan of the JAX suite's PV101-PV112
  cases, rebuilt from the port's IR classes, gets the same rule ids,
  paths and severities from the port's verifier; where the port differs
  on purpose (no carrier half of PV104, the port's PV106 capacity ladder)
  the port's behaviour is asserted on its own.
"""
import dataclasses
import importlib.util
import json
import os

import pytest

from pinot_tpu_torch.analysis import concur as pconcur
from pinot_tpu_torch.analysis import detlint as pdetlint
from pinot_tpu_torch.analysis.astutil import Finding, load_baseline
from pinot_tpu_torch.tools import check_static

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "pinot_tpu/", "pinot_tpu_torch/"


def _reference_cases():
    spec = importlib.util.spec_from_file_location(
        "_static_analysis_reference",
        os.path.join(REPO, "tests", "test_static_analysis.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the synthetic cases of the JAX package's suite (the corpus, registry
# and CLI tests there read the JAX tree and are not ported)
PARITY = [
    "test_cc201_unlocked_mutation_site",
    "test_cc201_read_under_different_lock",
    "test_cc201_unguarded_ordereddict_lru",
    "test_cc201_module_global_mixed_guard",
    "test_cc202_blocking_under_lock_direct_and_transitive",
    "test_cc202_future_result_and_device_sync",
    "test_cc203_lock_order_cycle",
    "test_cc203_self_deadlock_through_call",
    "test_cc204_thread_local_escape_and_handoff",
    "test_cc205_check_then_act",
    "test_concur_caller_holds_lock_inference",
    "test_concur_holds_lock_annotation",
    "test_concur_guarded_by_annotation",
    "test_concur_suppression_roundtrip",
    "test_concur_parse_error_never_baselined",
    "test_cc205_ignores_mutation_inside_deferred_closure",
    "test_concur_namesake_classes_stay_distinct",
    "test_cc204_unrelated_bare_helper_is_no_handoff",
    "test_cc203_multi_item_with_orders_like_nested",
    "test_concur_inference_converges_on_deep_chains",
    "test_dt301_wall_clock_in_plane",
    "test_dt301_escape_hatch_idioms_are_clean",
    "test_dt301_gmtime_arg_is_pure_conversion",
    "test_dt302_ambient_randomness",
    "test_dt303_unordered_serialization",
    "test_dt304_query_time_environ",
    "test_dt305_completion_order_float_accumulation",
    "test_detlint_cross_module_taint",
    "test_detlint_suppression_roundtrip",
    "test_detlint_parse_error_never_baselined",
]

# JAX device syncs the port's CC202 does not know, each mapped to the
# torch sync the port's code makes at the same line
TORCH_SYNCS = {"arr.block_until_ready()": "torch.cuda.synchronize()"}


def _to_port(src: str) -> str:
    for jax_call, torch_call in TORCH_SYNCS.items():
        src = src.replace(jax_call, torch_call)
    return src.replace("pinot_tpu.", "pinot_tpu_torch.")


def _record(monkeypatch, ref):
    """Wrap the JAX analysers the reference case calls so each analysed
    corpus is captured: (pass, [(source, path)], extra_roots, findings,
    suppressed)."""
    seen = []
    for name in ("concur", "detlint"):
        mod = getattr(ref, name)
        real_src, real_prog = mod.analyze_source, mod.Program

        def analyze_source(src, path, *a, _n=name, _r=real_src, **k):
            out = _r(src, path, *a, **k)
            roots = k.get("extra_roots", a[0] if a else ())
            seen.append((_n, [(src, path)], tuple(roots), *out))
            return out

        class Recording(real_prog):
            def __init__(self, *a, _n=name, **k):
                super().__init__(*a, **k)
                self._sources, self._pass = [], _n
                self._roots = tuple(k.get("extra_roots", ()))

            def add_source(self, src, path):
                self._sources.append((src, path))
                super().add_source(src, path)

            def analyze(self):
                out = super().analyze()
                if self._sources:   # a tree analysis is not synthetic
                    seen.append((self._pass, list(self._sources),
                                 self._roots, *out))
                return out

        monkeypatch.setattr(mod, "analyze_source", analyze_source)
        monkeypatch.setattr(mod, "Program", Recording)
    return seen


def _shape(findings, prefix):
    return [(f.rule, f.path[len(prefix):] if f.path.startswith(prefix)
             else f.path, f.line, f.scope) for f in findings]


@pytest.fixture(scope="module")
def reference():
    return _reference_cases()


@pytest.mark.parametrize("case", PARITY)
def test_synthetic_cases_match_the_jax_analysers(case, reference,
                                                 monkeypatch, tmp_path):
    seen = _record(monkeypatch, reference)
    fn = getattr(reference, case)
    fn(*([tmp_path] if "tmp_path" in fn.__code__.co_varnames[
        :fn.__code__.co_argcount] else []))
    monkeypatch.undo()
    assert seen, f"{case} analysed no synthetic source"
    for kind, sources, roots, j_find, j_sup in seen:
        prog = (pconcur.Program() if kind == "concur" else
                pdetlint.Program(extra_roots=tuple(
                    (PORT_PKG + p[len(JAX_PKG):], q) for p, q in roots)))
        for src, path in sources:
            assert path.startswith(JAX_PKG)
            prog.add_source(_to_port(src), PORT_PKG + path[len(JAX_PKG):])
        p_find, p_sup = prog.analyze()
        assert _shape(p_find, PORT_PKG) == _shape(j_find, JAX_PKG), sources
        assert _shape(p_sup, PORT_PKG) == _shape(j_sup, JAX_PKG), sources


# ---------------------------------------------------------------------------
# the torch rules
# ---------------------------------------------------------------------------

CMOD = "pinot_tpu_torch/cluster/somemod.py"
HOT = "pinot_tpu_torch/engine/somehot.py"
DMOD = "pinot_tpu_torch/cluster/detmod.py"


def _concur(src, path=CMOD):
    return pconcur.analyze_source(src, path)[0]


def _detlint(src, path=DMOD):
    return pdetlint.analyze_source(src, path)[0]


def test_cc202_fires_on_torch_device_syncs_under_a_lock():
    src = ("import threading\n"
           "import torch\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def bad(self, t, ev):\n"
           "        with self._lock:\n"
           "            h = t.cpu()\n"
           "            torch.cuda.synchronize()\n"
           "            ev.synchronize()\n"
           "            return h\n"
           "    def fenced(self):\n"
           "        torch.cuda.current_stream().synchronize()\n"
           "    def indirect(self):\n"
           "        with self._lock:\n"
           "            self.fenced()\n")
    got = [(f.rule, f.line) for f in _concur(src)]
    assert got == [("CC202", 8), ("CC202", 9), ("CC202", 10),
                   ("CC202", 16)], got
    # outside the lock the same syncs are clean
    assert _concur(src.replace("        with self._lock:\n"
                               "            h = t.cpu()",
                               "        if True:\n"
                               "            h = t.cpu()").replace(
        "        with self._lock:\n            self.fenced()",
        "        if True:\n            self.fenced()")) == []


def test_cc202_host_copies_fire_only_in_the_hot_packages():
    src = ("import threading\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def read(self, t):\n"
           "        with self._lock:\n"
           "            return t.item(), t.tolist(), t.numpy()\n")
    # numpy shares these names: a registry lock over host data is routine
    assert _concur(src) == []
    assert [(f.rule, f.line) for f in _concur(src, HOT)] == \
        [("CC202", 7)] * 3


def test_dt302_fires_on_the_global_torch_generator():
    src = ("import torch\n"
           "def decide(n, seed):  # detlint: entrypoint\n"
           "    a = torch.rand(n)\n"
           "    b = torch.randint(0, 10, (n,))\n"
           "    torch.manual_seed(seed)\n"
           "    d = torch.randn(n, generator=None)\n"
           "    return a, b, d\n")
    got = [(f.rule, f.line) for f in _detlint(src)]
    assert got == [("DT302", 3), ("DT302", 4), ("DT302", 5),
                   ("DT302", 6)], got
    assert "global torch generator" in _detlint(src)[0].message
    # a draw from an explicitly seeded generator is deterministic
    clean = ("import torch\n"
             "def decide(n, seed):  # detlint: entrypoint\n"
             "    g = torch.Generator().manual_seed(seed)\n"
             "    a = torch.rand(n, generator=g)\n"
             "    b = torch.randperm(n, generator=g)\n"
             "    return a, b\n")
    assert _detlint(clean) == []


def test_module_function_holds_lock_annotation():
    src = ("import threading\n"
           "_lock = threading.Lock()\n"
           "_log = []\n"
           "def _build(x):{ann}\n"
           "    _log.append(x)\n"
           "def load(x):\n"
           "    with _lock:\n"
           "        _build(x)\n"
           "        _log.append(x)\n")
    assert _concur(src.format(ann="  # holds-lock: _lock")) == []
    assert [(f.rule, f.line) for f in _concur(src.format(ann=""))] == \
        [("CC201", 5)]


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    c_find, c_sup = pconcur.analyze_tree(REPO)
    prog = pdetlint.Program()
    prog.add_tree(REPO)
    d_find, d_sup = prog.analyze()
    return {"concur": (c_find, c_sup), "detlint": (d_find, d_sup),
            "roots": (prog.roots_matched, prog.roots_missing)}


def test_the_ports_tree_is_clean_against_its_baselines(tree):
    for name, path in (("concur", check_static.CONCUR_BASELINE),
                       ("detlint", check_static.DETLINT_BASELINE)):
        findings, _sup = tree[name]
        assert all(f.rule != "parse-error" for f in findings)
        assert all(f.path.startswith(PORT_PKG) for f in findings)
        new, stale = pconcur.compare_baseline(findings, load_baseline(path))
        assert new == [], "\n".join(str(f) for f in new)
        assert stale == [], stale
    # every lost annotation is back and every true race repaired: the
    # only concurrency findings left are grandfathered blocking calls
    assert {f.rule for f in tree["concur"][0]} == {"CC202"}


def test_baselines_grandfather_only_the_jax_packages_sites():
    for port, ref in (("concur_baseline.json", "concur_baseline.json"),
                      ("detlint_baseline.json", "detlint_baseline.json")):
        mine = load_baseline(os.path.join(REPO, "pinot_tpu_torch",
                                          "analysis", port))
        theirs = load_baseline(os.path.join(REPO, "tools", ref))
        for key, n in mine.items():
            assert key.rsplit("::", 1)[1] not in ("CC201", "CC203",
                                                  "CC205"), key
            jax_key = JAX_PKG + key[len(PORT_PKG):]
            assert theirs.get(jax_key, 0) >= n, key


def test_every_registry_root_resolves(tree):
    matched, missing = tree["roots"]
    assert missing == []
    assert len(matched) == len(pdetlint.ROOTS)
    assert all(p.startswith(PORT_PKG) for p, _q in pdetlint.ROOTS)
    assert pdetlint.EXTRA_FILES == ()


def test_check_static_cli_passes_and_fails_on_an_injected_finding(
        tree, monkeypatch, capsys):
    monkeypatch.setattr(pconcur, "analyze_tree", lambda root: tree["concur"])
    monkeypatch.setattr(pdetlint, "analyze_tree",
                        lambda root: tree["detlint"])
    assert check_static.main(["--fuzz", "20"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] is True
    assert summary["concur"]["new"] == summary["detlint"]["new"] == 0
    assert summary["verify"]["diagnostics"] == 0
    assert summary["verify"]["coverage_failures"] == 0
    assert summary["verify"]["device_plans"] >= 17   # all SSB and taxi
    # --json: one document with the per-finding detail
    assert check_static.main(["--concur-only", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["concur"]["baselined"] == doc["concur"]["findings"]
    for f in doc["concur"]["detail"]["findings"]:
        assert {"rule", "file", "line", "scope", "message",
                "baselined"} <= set(f)
    # an injected finding fails the gate
    c_find, c_sup = tree["concur"]
    bad = Finding("CC201", "pinot_tpu_torch/engine/tier.py", 1,
                  "TierManager.injected", "injected")
    monkeypatch.setattr(pconcur, "analyze_tree",
                        lambda root: (c_find + [bad], c_sup))
    assert check_static.main(["--concur-only"]) == 1
    out = capsys.readouterr().out
    assert "NEW [concur]" in out and "injected" in out
    assert json.loads(out.strip().splitlines()[-1])["ok"] is False


# ---------------------------------------------------------------------------
# the plan verifier: the JAX suite's targeted bad plans, both packages
# ---------------------------------------------------------------------------

PV_PARITY = [
    "test_pv101_col_index_out_of_range",
    "test_pv102_param_index_out_of_range",
    "test_pv103_unhashable_plan_node",
    "test_pv105_sum_accumulator_overflow",
    "test_pv106_misaligned_slots_cap",
    "test_pv107_sketch_never_reaches_compact",
    "test_pv107_dense_space_cap",
    "test_pv108_bad_agg_spec",
    "test_pv109_inset_not_pow2",
    "test_pv110_zero_cardinality_key",
    "test_pv111_inset_param_unsorted",
    "test_pv112_select_plan",
]


def _port_ir(obj):
    """The same plan tree built from the port's ops/ir classes (a list
    stays a list: PV103 must see it)."""
    from pinot_tpu_torch.ops import ir as pir

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type) \
            and type(obj).__module__ == "pinot_tpu.ops.ir":
        return getattr(pir, type(obj).__name__)(**{
            f.name: _port_ir(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_port_ir(x) for x in obj)
    return obj


def _record_plans(monkeypatch, ref, names):
    """Wrap the JAX verifier entry points the reference case calls:
    [(entry, plan, kwargs, diagnostics)]."""
    seen = []
    for name in names:
        def wrapped(plan, _r=getattr(ref, name), _n=name, **kw):
            out = _r(plan, **kw)
            seen.append((_n, plan, kw, out))
            return out
        monkeypatch.setattr(ref, name, wrapped)
    return seen


def _diag_shape(diags):
    return [(d.rule, d.path, d.severity) for d in diags]


@pytest.mark.parametrize("case", PV_PARITY)
def test_bad_plans_match_the_jax_verifier(case, reference, monkeypatch):
    from pinot_tpu_torch.analysis import plan_verify as ppv

    seen = _record_plans(monkeypatch, reference,
                         ("verify_kernel_plan", "verify_select_plan"))
    getattr(reference, case)()
    monkeypatch.undo()
    assert seen, f"{case} verified no plan"
    for entry, plan, kw, j_diags in seen:
        p_diags = getattr(ppv, entry)(_port_ir(plan), **kw)
        assert _diag_shape(p_diags) == _diag_shape(j_diags), (case, plan)


def test_pv104_lossy_bits_claim_matches_the_jax_verifier(
        reference, monkeypatch, tmp_path):
    """The JAX case plans an SSB SUM over its segment, then corrupts the
    claimed magnitude below what column metadata proves; the port's
    planner and verifier over the port's SSB segment must agree."""
    from pinot_tpu_torch.analysis.plan_verify import verify_compiled_plan
    from pinot_tpu_torch.query.context import build_query_context
    from pinot_tpu_torch.query.planner import SegmentPlanner
    from pinot_tpu_torch.query.sql import parse_sql
    from pinot_tpu_torch.segment.immutable import ImmutableSegment
    from pinot_tpu_torch.tools import ssb

    seen = _record_plans(monkeypatch, reference, ("verify_compiled_plan",))
    reference.test_pv104_lossy_bits_claim(reference.bench.build_segment(
        1 << 12, str(tmp_path / "jax")))
    monkeypatch.undo()
    (_e, _cp, _kw, j_clean), (_e, j_cp, _kw, j_bad) = seen
    seg = ImmutableSegment.load(
        ssb.build_segment_dir(1 << 12, str(tmp_path / "port")), "cpu")
    sql = ("SELECT SUM(lo_extendedprice) FROM lineorder "
           "WHERE lo_discount BETWEEN 1 AND 3")
    cp = SegmentPlanner(build_query_context(parse_sql(sql)), seg).plan()
    assert cp.kind == "kernel"
    assert verify_compiled_plan(cp) == j_clean == []
    spec = cp.kernel_plan.aggs[0]
    assert (spec.kind, spec.integral) == ("sum", True)
    cp.kernel_plan = dataclasses.replace(
        cp.kernel_plan, aggs=(dataclasses.replace(spec, bits=2),))
    assert _diag_shape(verify_compiled_plan(cp)) == _diag_shape(j_bad)
    assert "PV104" in {d.rule for d in j_bad}


def test_pv104_has_no_carrier_half_in_the_port():
    """The JAX verifier also fires PV104 on a compact SUM with no exact
    integer carrier (jax_enable_x64 off); the port's carriers are always
    exact, so the same plans are clean, the bits=63 sentinel too."""
    from pinot_tpu_torch.analysis.plan_verify import verify_kernel_plan
    from pinot_tpu_torch.ops.ir import AggSpec, Col, KernelPlan, TrueP

    for bits in (40, 63):
        for strategy in ("dense", "compact"):
            plan = KernelPlan(pred=TrueP(),
                              aggs=(AggSpec("sum", Col(1), True, bits=bits),),
                              group_keys=((0, 8),), strategy=strategy)
            assert verify_kernel_plan(plan, n_cols=2, n_params=0) == []


def test_pv106_follows_the_ports_capacity_ladder():
    """The port's ladder is a power of two or full_slots_cap (no Pallas
    staging rung), and its cost model is compact_slots_cap(n, sel)."""
    from pinot_tpu.analysis.plan_verify import \
        verify_kernel_plan as jax_verify
    from pinot_tpu.ops import ir as jir
    from pinot_tpu.ops.compact import STAGE
    from pinot_tpu_torch.analysis.plan_verify import verify_kernel_plan
    from pinot_tpu_torch.multistage.costs import compact_slots_cap
    from pinot_tpu_torch.ops.compact import full_slots_cap
    from pinot_tpu_torch.ops.ir import AggSpec, Col, KernelPlan, TrueP

    def rules(plan, **kw):
        return {d.rule for d in verify_kernel_plan(
            plan, n_cols=2, n_params=0, bucket=1 << 16, **kw)}

    plan = KernelPlan(pred=TrueP(),
                      aggs=(AggSpec("sum", Col(1), True, bits=20),),
                      group_keys=((0, 64),), strategy="compact")
    good = compact_slots_cap(1 << 16, 0.05)
    assert rules(plan, n_docs=1 << 16, slots_cap=good,
                 est_selectivity=0.05) == set()
    assert rules(plan, n_docs=1 << 16, slots_cap=good * 4,
                 est_selectivity=0.05) == {"PV106"}
    # off the ladder: neither a power of two nor full
    full = full_slots_cap(3000)
    assert full & (full - 1) and rules(plan, n_docs=3000,
                                       slots_cap=full) == set()
    assert rules(plan, n_docs=3000, slots_cap=full - 1) == {"PV106"}
    # the JAX package's staging rung is on its ladder, not the port's
    rung = 3 * STAGE
    assert rung & (rung - 1)
    assert rules(plan, n_docs=1 << 16, slots_cap=rung) == {"PV106"}
    assert jax_verify(_jax_twin(plan, jir), n_cols=2, n_params=0,
                      bucket=1 << 16, n_docs=1 << 16, slots_cap=rung) == []


def _jax_twin(plan, jir):
    return jir.KernelPlan(
        pred=jir.TrueP(),
        aggs=tuple(jir.AggSpec(a.kind, jir.Col(a.value.col), a.integral,
                               bits=a.bits) for a in plan.aggs),
        group_keys=plan.group_keys, strategy=plan.strategy)
