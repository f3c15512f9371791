"""The port's chaos smoke against the JAX package's, on the CPU.

``pinot_tpu_torch/tools/chaos_smoke.py`` is the root
``tools/chaos_smoke.py`` over the port. Its SSB cluster and tables hold
the reference tool's rows (the port's own copy of the generator), so at
the same seed and rows the base mode's fault-free and under-fault
digests are byte-equal to the reference tool's, and its fault plans fire
the same (point, site, hit) streams (the servers' ports named by server);
its ratchets are checked against a CPU baseline, and against the card's
committed one a CPU run's ratchet fails the mode.
``--tier``'s mid-query ``tier.evict`` streams and digests equal the
reference tool's too. A mode restores the process's global state when
it ends: no plan armed, no rung pinned.
"""
import json
import os
import re
import sys

import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the tools)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench  # noqa: E402
import chaos_smoke as JCS  # noqa: E402
import pinot_tpu.utils.faults as jfaults  # noqa: E402
import pinot_tpu_torch.utils.faults as tfaults  # noqa: E402
from pinot_tpu_torch.tools import chaos_smoke as TCS  # noqa: E402
from pinot_tpu_torch.tools import ssb  # noqa: E402
from test_torch_chip_smoke import cpu_baselines  # noqa: E402

QUERIES = "q1.1,q4.1"
ROWS = 512
SEED = 20260804


@pytest.fixture(autouse=True)
def _clean():
    from test_torch_tier import reset_port_memory

    yield
    for f in (jfaults, tfaults):
        f.clear()
    reset_port_memory()


def _recording(monkeypatch, faults_mod, owner, digest_attr):
    """Every plan ``faults_mod.install`` returns and every digest
    ``owner.<digest_attr>`` computes, in order."""
    plans, digests = [], []
    real_install = faults_mod.install
    real_digest = getattr(owner, digest_attr)

    def install(*a, **k):
        plans.append(real_install(*a, **k))
        return plans[-1]

    def digest(*a, **k):
        digests.append(real_digest(*a, **k))
        return digests[-1]

    monkeypatch.setattr(faults_mod, "install", install)
    monkeypatch.setattr(owner, digest_attr, digest)
    return plans, digests


def _stream(plan, ports) -> str:
    """A plan's fired (point, site, hit) stream with each server's port
    replaced by its server's index."""
    out = []
    for point, key, hit in plan.fired_summary():
        for i, p in enumerate(ports):
            key = re.sub(rf":{p}\b", f":server_{i}", key)
        out.append([point, key, hit])
    return json.dumps(out)


def test_data_and_queries_match_reference():
    assert TCS.smoke_queries() == JCS.smoke_queries()
    assert TCS.SMOKE_QUERY_IDS == JCS.SMOKE_QUERY_IDS
    for name in ("INGEST_SEEDS", "INGEST_ROWS", "RATE_ROWS",
                 "OVERLOAD_ROWS", "TIER_ROWS", "REBALANCE_ROWS",
                 "AUTOPSY_ROWS", "VECTOR_ROWS", "VECTOR_DIM",
                 "VECTOR_LISTS", "VECTOR_K", "FUSED_ROWS", "FUSED_MIX",
                 "OPTION"):
        assert getattr(TCS, name) == getattr(JCS, name), name
    t, j = ssb.gen_columns(ROWS), bench.gen_columns(ROWS)
    assert [(f.name, f.data_type.name, f.field_type.name)
            for f in ssb._ssb_fields(t)] == \
        [(f.name, f.data_type.name, f.field_type.name)
         for f in bench._ssb_fields(j)]


def _jax_base_passes(tmp) -> tuple:
    """The reference tool's fault-free, rpc.drop and wire.corrupt
    passes (its base mode's plans 1-2) over its own cluster."""
    from pinot_tpu.cluster.http_util import http_json

    ctrl, servers, broker, stop = JCS.build_ssb_cluster(tmp, ROWS)
    try:
        queries = JCS.smoke_queries(tuple(QUERIES.split(",")))

        def run_all():
            return [JCS.digest(http_json(
                "POST", f"{broker.url}/query/sql",
                {"sql": sql + JCS.OPTION}, timeout=120.0))
                for _qid, sql in queries]

        passes, streams = [run_all()], []
        p0 = servers[0].port
        for text in (f"seed={SEED}; rpc.drop: match=:{p0}/query/bin, "
                     "times=1",
                     f"seed={SEED}; wire.corrupt: match=server_0, "
                     "times=1"):
            for s in servers:
                broker._failures.record_success(s.instance_id)
            plan = jfaults.install(text)
            try:
                passes.append(run_all())
            finally:
                jfaults.clear()
            streams.append(_stream(plan, [s.port for s in servers]))
        return passes, streams
    finally:
        stop()


def test_base_mode_digests_and_fault_streams_match_reference(
        tmp_path, monkeypatch, capsys):
    """The port's base mode at 512 rows: its fault-free, rpc.drop and
    wire.corrupt passes' digests are byte-equal to the reference tool's
    passes at the same seed and rows, and the two plans fire the same
    streams."""
    from pinot_tpu_torch.cluster import ServerNode

    ports = []
    real_init = ServerNode.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        ports.append(self.port)

    monkeypatch.setattr(ServerNode, "__init__", init)
    cpu_baselines(monkeypatch, tmp_path)
    plans, digests = _recording(monkeypatch, tfaults, TCS, "digest")
    rc = TCS.main(["--rows", str(ROWS), "--queries", QUERIES, "--device",
                   "cpu"])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and summary["ok"], summary["failures"]
    assert summary["plans"] == 4 and summary["rollup_faults_fired"] >= 1
    j_passes, j_streams = _jax_base_passes(str(tmp_path / "jax"))
    n = len(QUERIES.split(","))
    t_passes = [digests[i * n:(i + 1) * n] for i in range(3)]
    assert json.dumps(t_passes) == json.dumps(j_passes)
    assert all(d for d in t_passes[0])
    assert [_stream(p, ports[:2]) for p in plans[:2]] == j_streams
    assert not tfaults.active()


def test_tier_mode_streams_and_digests_match_reference(monkeypatch,
                                                       capsys):
    """--tier at 512 rows: the (point, site, hit) streams of both
    same-seed tier.evict runs and every digest of every pass equal the
    reference tool's."""
    from pinot_tpu.engine.tier import global_tier as j_tier
    from pinot_tpu_torch.engine.tier import global_tier as t_tier

    argv = ["--tier", "--rows", str(ROWS), "--queries", QUERIES]
    t_plans, t_digests = _recording(monkeypatch, tfaults, ssb, "_digest")
    assert TCS.main(argv + ["--device", "cpu"]) == 0
    t_sum = json.loads(capsys.readouterr().out.splitlines()[-1])
    j_plans, j_digests = _recording(monkeypatch, jfaults, bench, "_digest")
    assert JCS.main(argv) == 0
    j_sum = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert t_sum["ok"] and j_sum["ok"]
    assert len(t_plans) == len(j_plans) == 2
    t_streams = [json.dumps(p.fired_summary()) for p in t_plans]
    assert t_streams == [json.dumps(p.fired_summary()) for p in j_plans]
    assert t_streams[0] == t_streams[1] and t_plans[0].fired
    # base, twin, two evict runs, three budget passes: 2 queries each
    assert len(t_digests) == 14 and all(t_digests)
    assert json.dumps(t_digests) == json.dumps(j_digests)
    assert t_sum["faults_fired"] == j_sum["faults_fired"]
    for pool, r in t_sum["reconcile"].items():
        assert r["tracked"] == r["actual"], (pool, r)
    assert t_tier.budget_bytes is None and j_tier.budget_bytes is None


def test_a_mode_restores_the_process_state(monkeypatch, capsys):
    """A mode that raises still leaves no plan armed, no rung pinned and
    no device budget behind."""
    from pinot_tpu_torch.broker.workload import global_governor
    from pinot_tpu_torch.engine.tier import global_tier

    def arm_and_fail(args):
        tfaults.install("seed=1; rpc.drop: match=nowhere")
        global_governor.pin_rungs({"q": 3})
        global_tier.configure(budget_bytes=1 << 20)
        raise RuntimeError("mid-mode")

    monkeypatch.setattr(TCS, "main_ingest", arm_and_fail)
    with pytest.raises(RuntimeError, match="mid-mode"):
        TCS.main(["--ingest", "--device", "cpu"])
    assert not tfaults.active()
    assert not global_governor.snapshot()["pinned"]
    assert global_tier.budget_bytes is None
    assert TCS.main(["--ingest"]) == 2       # no card, no --device cpu


def test_a_cpu_run_fails_its_ratchet_against_the_card_baseline(capsys):
    """As in the reference tool, a ratchet that does not exit 0 fails the
    mode: ``--rate`` on the CPU checks its fresh capture against the
    committed baseline, which is the card's, so the freshness check exits
    3 (environment mismatch) and the mode exits 1."""
    from pinot_tpu_torch.tools import freshness_gate

    with open(freshness_gate.DEFAULT_BASELINE) as fh:
        assert json.load(fh)["env"]["backend"] == "cuda"
    rc = TCS.main(["--rate", "--rows", "200", "--gate-iters", "1",
                   "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1 and not summary["ok"]
    assert summary["freshness_gate_exit"] == 3
    assert summary["failures"] == ["rate.freshness_gate: exit 3"]
