"""The port's traffic replay against the JAX package's, on the CPU.

``pinot_tpu_torch/tools/traffic_replay.py`` is the root
``tools/traffic_replay.py`` over the port. The seeded mixes and table
columns are the reference's, its pure replay plan (rung pins, the
precomputed shed stream with its retries) and SLO alert plan are
``json.dumps``-equal to the reference's on the same records, and a
local-mode gate run on the CPU sheds exactly the stream the reference's
planner predicts from that run's recorded ledger. The gate's two
wall-clock bars (the protected tenant's p99 and the recovery noise
floor) are judged on the card by ``chip_smoke.py``, not here.
"""
import json
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the tools)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import traffic_replay as JTR  # noqa: E402
from pinot_tpu_torch.tools import traffic_replay as TTR  # noqa: E402

TIER_OF = {t[1]: t[2] for t in JTR.TENANT_TABLES}
# the gate's checks that read a wall clock (judged on the card)
WALL_CLOCK = ("spike.protected_p99_bar", "recovery")


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


def _records(seed: int, n: int = 40, qps: float = 24.0):
    """Seeded query_stats records shaped like a 1x recording of
    ``build_mix(seed, n)``: jittered arrivals at ``qps``, seeded walls."""
    rng = np.random.default_rng(seed)
    out = []
    for i, q in enumerate(JTR.build_mix(seed, n)):
        out.append({"kind": "query_stats", "qid": q["qid"],
                    "table": q["table"], "tenant": q["tenant"],
                    "sql": q["sql"], "partial": False,
                    "wall_ms": float(rng.uniform(2.0, 60.0)),
                    "arrival_ms": round(i * 1e3 / qps
                                        + float(rng.uniform(0, 10)), 3)})
    return out


def test_tables_mixes_and_constants_match_reference():
    assert TTR.TENANT_TABLES == JTR.TENANT_TABLES
    assert TTR.QUERY_SHAPES == JTR.QUERY_SHAPES
    for name in ("OPTION_TIMEOUT_MS", "CAPACITY_HEADROOM",
                 "PRESSURE_WINDOW_S", "RECOVER_FACTOR", "RECOVER_FLOOR_MS",
                 "PROTECTED_BAR_FACTOR", "PROTECTED_BAR_FLOOR_MS",
                 "SLO_FAST_S", "SLO_SLOW_S", "SLO_BURN_THRESHOLD",
                 "REBALANCE_TABLES", "REBALANCE_DELAY_MS", "AUTOPSY_TABLE",
                 "AUTOPSY_DELAY_MS", "AUTOPSY_TIER_BUDGET_BYTES"):
        assert getattr(TTR, name) == getattr(JTR, name), name
    for seed in (1, 20260805, 20260807):
        for n in (1, 24, 48):
            assert TTR.build_mix(seed, n) == JTR.build_mix(seed, n)
            assert TTR.build_rebalance_mix(seed, n) == \
                JTR.build_rebalance_mix(seed, n)
            assert TTR.build_autopsy_mix(seed, n) == \
                JTR.build_autopsy_mix(seed, n)
    for rows in (512, 4096):
        t, j = TTR._gen_columns(rows), JTR._gen_columns(rows)
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])


@pytest.mark.parametrize("seed,multiple,capacity", [
    (20260805, 4.0, None), (3, 1.0, None), (11, 8.0, None),
    (20260805, 4.0, 30.0)])
def test_replay_and_slo_plans_match_reference(seed, multiple, capacity):
    recs = _records(seed)
    t = TTR.plan_replay(recs, multiple, seed, capacity_qps=capacity,
                        tier_of=TIER_OF)
    j = JTR.plan_replay(recs, multiple, seed, capacity_qps=capacity,
                        tier_of=TIER_OF)
    assert _dumps(t) == _dumps(j)
    assert _dumps(TTR.plan_replay(recs, multiple, seed)) == \
        _dumps(JTR.plan_replay(recs, multiple, seed))
    assert _dumps(TTR.plan_slo(recs, t, multiple)) == \
        _dumps(JTR.plan_slo(recs, j, multiple))
    if multiple >= 4.0:
        assert any(s[1] == "ten_besteffort" for s in t["shed_stream"])
    assert all(s[1] != "ten_protected" for s in t["shed_stream"])


def test_plan_cli_prints_the_references_stream(tmp_path, capsys):
    stats = tmp_path / "stats.jsonl"
    with open(stats, "w") as fh:
        for r in _records(7):
            fh.write(json.dumps(r) + "\n")
    assert TTR.main(["plan", str(stats), "--multiple", "6"]) == 0
    t_out = capsys.readouterr().out
    assert JTR.main(["plan", str(stats), "--multiple", "6"]) == 0
    assert t_out == capsys.readouterr().out
    assert json.loads(t_out)["shed_stream"]
    assert TTR.main(["gate"]) == 2          # no card, no --device cpu


def test_local_gate_sheds_the_references_planned_stream(tmp_path):
    """The local-mode gate on the CPU (24 queries at 512 rows, chaos
    armed): the plan computed twice matches itself, the broker's observed
    shed stream equals it, and the JAX planner computes the same stream
    from the run's own recorded ledger. Only a wall-clock bar may fail
    here."""
    from pinot_tpu_torch.broker.workload import global_governor
    from pinot_tpu_torch.utils import faults
    from test_torch_tier import reset_port_memory

    seed = 20260805
    try:
        s = TTR.run_gate(seed=seed, n_queries=24, rows=512, mode="local",
                         keep_dir=str(tmp_path), device="cpu")
    finally:
        reset_port_memory()
    assert [f for f in s["failures"]
            if not f.startswith(WALL_CLOCK)] == [], s["failures"]
    assert s["deterministic"] is True and s["backend"] == "cpu"
    assert not faults.active() and not global_governor.snapshot()["pinned"]
    recs = [r for r in JTR.load_records(
        str(tmp_path / "replay_stats.jsonl"))
        if str(r.get("qid", "")).startswith(f"rp{seed}_")]
    assert [r["qid"] for r in recs] == \
        [r["qid"] for r in TTR.load_records(
            str(tmp_path / "replay_stats.jsonl"))
         if str(r.get("qid", "")).startswith(f"rp{seed}_")]
    plan = JTR.plan_replay(recs, 4.0, seed, tier_of=TIER_OF)
    assert s["shed"] == len(plan["shed_stream"]) >= 1
    by_tenant = {}
    for _q, tenant, _rung, _reason, _after in plan["shed_stream"]:
        by_tenant[tenant] = by_tenant.get(tenant, 0) + 1
    assert s["shed_by_tenant"] == by_tenant
    assert s["protected_sheds"] == 0 and s["faults_fired"] == 1


class _Node:
    """A stand-in for a ServerNode or the controller: its stops are
    counted; ``fail`` makes ``stop`` raise."""

    def __init__(self, fail: bool = False):
        self._tables, self.stops, self.fail = {}, 0, fail

    def stop(self):
        self.stops += 1
        if self.fail:
            raise OSError("socket already gone")


def test_stop_cluster_raises_a_server_that_failed_to_stop():
    """A server whose stop raises does not keep the others or the
    controller running, and its failure reaches the caller."""
    servers = [_Node(), _Node(fail=True), _Node()]
    ctrl, broker = _Node(), _Node()
    with pytest.raises(RuntimeError, match="1 server node") as e:
        TTR.stop_cluster(ctrl, servers, broker)
    assert isinstance(e.value.__cause__, OSError)
    assert [s.stops for s in servers] == [1, 1, 1]
    assert ctrl.stops == broker.stops == 1
