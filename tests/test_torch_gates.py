"""The port's ratchet and report tools against the JAX package's, on the
CPU.

``pinot_tpu_torch/tools/{span_diff,freshness_gate,slo_report,
check_ledger}.py`` and ``pinot_tpu_torch/utils/shapehash.py`` are the
root ``tools/*.py`` and ``pinot_tpu/utils/shapehash.py`` over the port.
On the same seeded synthetic ledgers (never the repo's
``PERF_LEDGER.jsonl``) their pure functions give the JAX tools' outputs
(floats to a relative 1e-9), the report tools print the JAX tools' last
line, and the ratchets exit 0 on a clean candidate, 1 on an injected
regression and 3 when a CPU run is checked against a card baseline.
Without a card a tool that runs the engine refuses (exit 2) unless
``--device cpu`` is given.
"""
import json
import math
import os
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the tools)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import check_ledger as JCL  # noqa: E402
import freshness_gate as JFG  # noqa: E402
import slo_report as JSR  # noqa: E402
import span_diff as JSD  # noqa: E402
from pinot_tpu.utils.shapehash import shape_key as j_shape_key  # noqa: E402
from pinot_tpu_torch.tools import check_ledger as TCL  # noqa: E402
from pinot_tpu_torch.tools import freshness_gate as TFG  # noqa: E402
from pinot_tpu_torch.tools import slo_report as TSR  # noqa: E402
from pinot_tpu_torch.tools import span_diff as TSD  # noqa: E402
from pinot_tpu_torch.utils.shapehash import shape_key  # noqa: E402

PHASES = ("parse", "plan", "device_execute", "reduce", "broker_overhead")


def _close(a, b, path="") -> None:
    """Equal structures; floats to a relative 1e-9."""
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0), (path, a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _write(path, records) -> str:
    with open(path, "w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    return str(path)


def _traces(seed: int, iters: int = 5, slow: str = "", backend="cpu"):
    """Seeded query_trace records over the span corpus; ``slow`` names
    a corpus query whose device_execute phase is 6x slower."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(iters):
        for qid, sql in TSD.CORPUS_SQL:
            kids = []
            for p in PHASES:
                ms = float(rng.uniform(0.3, 30.0))
                if qid == slow and p == "device_execute":
                    ms *= 6.0
                kids.append({"name": p, "ms": ms})
            out.append({"kind": "query_trace", "backend": backend,
                        "sql": sql, "root": {
                            "name": "query", "children": kids,
                            "ms": sum(k["ms"] for k in kids)
                            + float(rng.uniform(0.0, 2.0))}})
    return out


def _bench(seed: int, n: int = 5, fresh_x: float = 1.0):
    rng = np.random.default_rng(seed)
    return [{"kind": "ingest_bench", "ok": True, "backend": "cpu",
             "scenario": s, "duration_s": float(rng.uniform(1.0, 3.0)),
             "freshness_p50_ms": float(rng.uniform(0.2, 2.0)) * fresh_x,
             "freshness_p99_ms": float(rng.uniform(1.0, 9.0)) * fresh_x,
             "commit_p50_ms": float(rng.uniform(5.0, 40.0)),
             "commit_p99_ms": float(rng.uniform(20.0, 90.0))}
            for s in ("gate_corpus", "other") for _ in range(n)]


def _stats(seed: int, n: int = 200, bad_frac: float = 0.02):
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    for i in range(n):
        t += float(rng.uniform(5.0, 40.0))
        bad = rng.random() < bad_frac
        out.append({"kind": "query_stats", "qid": f"q{i}",
                    "table": ("orders", "events")[i % 2],
                    "tenant": ("ten_a", "ten_b")[i % 2],
                    "arrival_ms": round(t, 3),
                    "wall_ms": float(rng.uniform(1.0, 400.0)),
                    "shed": bool(bad and i % 3 == 0),
                    "error": "boom" if bad and i % 3 == 1 else None,
                    "partial": bool(bad and i % 3 == 2)})
    out += [{"kind": "incident", "incident_id": "p-1", "alert": "slo_burn",
             "severity": "page"},
            {"kind": "incident", "incident_id": "p-2", "alert": "x",
             "severity": "info"},
            {"kind": "incident", "incident_id": "p-3", "alert": "y",
             "severity": "info"},
            {"kind": "rca_verdict", "incident_ref": "p-1",
             "top_cause": "straggler", "inconclusive": False,
             "causes": [{"cause": "straggler", "score": 0.75,
                         "detail": "server_0 +60 ms"}]},
            {"kind": "rca_verdict", "incident_ref": "p-2",
             "top_cause": "", "inconclusive": True, "causes": []},
            {"kind": "slo_status"}, {"kind": "alert"}]
    return out


# -- shapehash ---------------------------------------------------------------

def test_shape_key_matches_reference_on_the_span_corpus():
    assert TSD.CORPUS_SQL == JSD.CORPUS_SQL
    for _qid, sql in TSD.CORPUS_SQL:
        assert shape_key(sql) == j_shape_key(sql) == JSD.shape_key(sql)
        assert shape_key("  " + sql.upper().replace(" ", "\n\t ")) \
            == shape_key(sql)


@settings(max_examples=100, deadline=None)
@given(st.text())
def test_shape_key_matches_reference_on_any_string(sql):
    assert shape_key(sql) == j_shape_key(sql)


# -- span_diff ---------------------------------------------------------------

@pytest.mark.parametrize("seed,last", [(0, 5), (1, None), (7, 3)])
def test_span_diff_pure_functions_match_reference(seed, last):
    base = _traces(seed)
    cand = _traces(seed + 100, slow="groupby_topn")
    for a, b in ((base, base), (base, cand), (cand, base)):
        ta, tb = TSD.aggregate(a, last=last), TSD.aggregate(b, last=last)
        ja, jb = JSD.aggregate(a, last=last), JSD.aggregate(b, last=last)
        _close(ta, ja)
        _close(tb, jb)
        _close(TSD.speed_calibration(ta, tb), JSD.speed_calibration(ja, jb))
        for bar, min_ms in ((1.7, 1.0), (1.2, 0.1), (3.0, 5.0)):
            _close(TSD.diff_shapes(ta, tb, bar, min_ms),
                   JSD.diff_shapes(ja, jb, bar, min_ms))
    for rec in base[:7]:
        _close(TSD.phase_times(rec["root"]), JSD.phase_times(rec["root"]))


def test_span_diff_cli_exit_codes(tmp_path, capsys):
    """0 on a clean candidate, 1 on an injected regression (the JAX
    tool's verdicts on the same ledgers), 3 when a CPU candidate is
    checked against a card baseline, 2 without a card unless cpu."""
    base = _write(tmp_path / "base.jsonl", _traces(3))
    clean = _write(tmp_path / "clean.jsonl", _traces(3))
    bad = _write(tmp_path / "bad.jsonl", _traces(3, slow="scalar_agg"))
    tb, jb = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert TSD.main(["update", base, "--baseline", tb,
                     "--device", "cpu"]) == 0
    env = json.load(open(tb))["env"]
    assert env["backend"] == "cpu" and env["card"] is None
    # the JAX tool's baseline of the same records, its env header left
    # out (a legacy header is checkable anywhere)
    JSD.write_baseline(jb, JSD.aggregate(JSD.load_trace_records([base])),
                       env={})
    assert json.load(open(tb))["shapes"] == json.load(open(jb))["shapes"]
    capsys.readouterr()
    for ledger, rc in ((clean, 0), (bad, 1)):
        assert TSD.main(["check", ledger, "--baseline", tb,
                         "--device", "cpu"]) == rc
        t_out = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert JSD.main(["check", ledger, "--baseline", jb]) == rc
        j_out = json.loads(capsys.readouterr().out.splitlines()[-1])
        _close(t_out, j_out)
    assert TSD.main(["check", "--fleet", bad, "--baseline", tb,
                     "--device", "cpu"]) == 1
    card = dict(env, backend="cuda", card="NVIDIA H100 80GB HBM3",
                power_limit="700.00 W")
    TSD.write_baseline(tb, TSD.load_baseline(tb), card)
    capsys.readouterr()
    for argv in (["check", bad], ["check", "--fleet", bad]):
        assert TSD.main(argv + ["--baseline", tb, "--device", "cpu"]) == 3
        out = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert out["env_mismatch"] == {"backend": ["cuda", "cpu"]}
    assert TSD.main(["check", bad, "--baseline", tb]) == 2


def test_span_diff_capture_on_cpu_is_a_valid_trace_ledger(tmp_path):
    out = str(tmp_path / "trace.jsonl")
    assert TSD.main(["capture", "--out", out, "--iters", "1", "--rows",
                     "1024", "--device", "cpu"]) == 0
    assert TCL.main([out]) == 0
    recs = TSD.load_trace_records([out])
    assert len(recs) == len(TSD.CORPUS_SQL)
    assert {r["backend"] for r in recs} == {"cpu"}
    assert set(TSD.aggregate(recs)) == {shape_key(s)
                                        for _q, s in TSD.CORPUS_SQL}


# -- freshness_gate ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11])
def test_freshness_pure_functions_match_reference(seed):
    assert TFG.MIN_MS == JFG.MIN_MS
    assert (TFG.GATE_SCENARIO, TFG.GATE_SEED, TFG.GATE_ROWS) == \
        (JFG.GATE_SCENARIO, JFG.GATE_SEED, JFG.GATE_ROWS)
    base = _bench(seed)
    for cand in (_bench(seed + 1), _bench(seed + 1, fresh_x=4.0),
                 _bench(seed)[:3]):
        for last in (5, 2, None):
            ta, tc = TFG.aggregate(base, last), TFG.aggregate(cand, last)
            ja, jc = JFG.aggregate(base, last), JFG.aggregate(cand, last)
            _close(ta, ja)
            _close(tc, jc)
            _close(TFG.speed_calibration(ta, tc),
                   JFG.speed_calibration(ja, jc))
            for bar in (1.8, 1.1):
                _close(TFG.diff_scenarios(ta, tc, bar),
                       JFG.diff_scenarios(ja, jc, bar))


def test_freshness_corpus_config_matches_reference(tmp_path):
    t = TFG.corpus_config(str(tmp_path / "l.jsonl"))
    j = JFG.corpus_config(str(tmp_path / "l.jsonl"))
    assert [vars(s) for s in t.tables] == [vars(s) for s in j.tables]
    assert {k: v for k, v in vars(t).items() if k != "tables"} == \
        {k: v for k, v in vars(j).items() if k != "tables"}


def test_freshness_gate_cli_exit_codes(tmp_path, capsys):
    base = _write(tmp_path / "base.jsonl", _bench(5))
    clean = _write(tmp_path / "clean.jsonl", _bench(5))
    bad = _write(tmp_path / "bad.jsonl", _bench(5, fresh_x=6.0))
    tb, jb = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert TFG.main(["update", base, "--baseline", tb,
                     "--device", "cpu"]) == 0
    JFG.write_baseline(jb, JFG.aggregate(JFG.load_bench_records([base])),
                       env={})
    capsys.readouterr()
    for ledger, rc in ((clean, 0), (bad, 1)):
        assert TFG.main(["check", ledger, "--baseline", tb,
                         "--device", "cpu"]) == rc
        t_out = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert JFG.main(["check", ledger, "--baseline", jb]) == rc
        j_out = json.loads(capsys.readouterr().out.splitlines()[-1])
        _close(t_out, j_out)
    data = json.load(open(tb))
    TFG.write_baseline(tb, data["scenarios"],
                       dict(data["env"], backend="cuda",
                            card="NVIDIA H100 80GB HBM3"))
    assert TFG.main(["check", bad, "--baseline", tb,
                     "--device", "cpu"]) == 3
    assert TFG.main(["check", bad, "--baseline", tb]) == 2


# -- slo_report --------------------------------------------------------------

@pytest.mark.parametrize("seed,bad_frac", [(0, 0.0), (3, 0.05), (9, 0.4)])
def test_slo_report_pure_functions_match_reference(seed, bad_frac):
    recs = _stats(seed, bad_frac=bad_frac)
    for bar, avail in ((None, None), (100.0, None), (None, 0.99),
                       (250.0, 0.999)):
        args = (bar, avail, 0.99, 1.0, 6.0, 1.0)
        t_obj = TSR.build_objectives(recs, *args)
        assert t_obj == JSR.build_objectives(recs, *args)
        _close(TSR.summarize(recs, t_obj), JSR.summarize(recs, t_obj))
    assert TSR.autopsy_join(recs) == JSR.autopsy_join(recs)
    assert [r["verdict"] for r in TSR.autopsy_join(recs)] == \
        ["straggler", "inconclusive", "pending"]


@pytest.mark.parametrize("argv,rc", [
    (["report", "--latency-bar-ms", "200", "--autopsy"], 0),
    (["gate", "--availability-objective", "0.999"], 1),
    (["gate", "--latency-bar-ms", "1000"], 0),
    (["gate", "--min-events", "10000"], 1),
])
def test_slo_report_cli_prints_the_references_verdict(tmp_path, capsys,
                                                      argv, rc):
    ledger = _write(tmp_path / "slo.jsonl", _stats(4, bad_frac=0.2))
    assert TSR.main([argv[0], ledger, *argv[1:]]) == rc
    t_out = capsys.readouterr().out.splitlines()
    assert JSR.main([argv[0], ledger, *argv[1:]]) == rc
    j_out = capsys.readouterr().out.splitlines()
    assert t_out == j_out


# -- check_ledger ------------------------------------------------------------

def test_check_ledger_cli_matches_reference(tmp_path, capsys):
    from pinot_tpu_torch.utils import ledger as uledger

    good = uledger.make_record("query_stats", qid="a", table="t",
                               wall_ms=1.0, partial=False,
                               servers_queried=1, servers_responded=1,
                               exception_codes=[])
    paths = {"ok": _write(tmp_path / "ok.jsonl", [good, {"legacy": 1}]),
             "bad": _write(tmp_path / "bad.jsonl",
                           [dict(good, typo_field=1)])}
    for name, argv, rc in (("ok", [], 0), ("ok", ["--strict"], 1),
                           ("bad", [], 1)):
        assert TCL.main([paths[name], *argv]) == rc
        t_out = capsys.readouterr().out
        assert JCL.main([paths[name], *argv]) == rc
        assert t_out == capsys.readouterr().out
    assert TCL.main([str(tmp_path / "missing.jsonl")]) == 1
