"""Fault injection in the port against the JAX package, on the CPU.

``pinot_tpu_torch.utils.faults`` is the reference's module: the same plan
grammar, the same seeded decisions (one seed fires at the same ingest
sites in both packages, hit for hit), the same inline effects and no
effect without a plan. A chaotic ingest (``stream.error``,
``stream.rebalance``, ``commit.crash``, ``upsert.compact_crash`` armed
from a seed; every injected crash answered by a restart from the
checkpoint), driven by the port's ``tools/ingest_fuzz``, ends in the rows
of the fault-free oracle and of the JAX package's ``ingest_fuzz`` run of
the same plan, having fired the same faults.
"""
import os
import sys

import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the broker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pinot_tpu.utils.faults as jfaults  # noqa: E402
from pinot_tpu.tools import ingest_fuzz as JIF  # noqa: E402
import pinot_tpu_torch.utils.faults as tfaults  # noqa: E402
from pinot_tpu_torch.realtime.stream import consume_faults  # noqa: E402
from pinot_tpu_torch.tools import ingest_fuzz as IF  # noqa: E402

INGEST_POINTS = ("stream.error", "stream.rebalance", "commit.crash",
                 "upsert.compact_crash")
PLAN = ("seed=3; rpc.drop: match=/query, p=0.5, times=1; "
        "stream.error: p=0.2, after=1; commit.crash: times=1, "
        "match=__0__0; handoff.stall: delay_ms=2")


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    for f in (jfaults, tfaults):
        f.clear()
    yield
    for f in (jfaults, tfaults):
        f.clear()


def _specs(plan):
    return plan.seed, [(s.point, s.prob, s.match, s.times, s.after,
                        s.delay_ms, s.http_status) for s in plan.specs]


def test_registry_and_grammar_match_reference():
    assert tfaults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert _specs(tfaults.FaultPlan.parse(PLAN)) == \
        _specs(jfaults.FaultPlan.parse(PLAN))
    for bad in ("bogus.point: p=1", "stream.error: q=1"):
        errors = []
        for f in (jfaults, tfaults):
            with pytest.raises(ValueError) as ei:
                f.FaultPlan.parse(bad)
            errors.append(str(ei.value))
        assert errors[1] == errors[0]


@pytest.mark.parametrize("seed", [5, 6, 41])
def test_same_seed_same_ingest_sites_in_both_packages(seed):
    """Decisions are pure in (seed, point, site key, hit): the two
    packages fire at the same hits of the same keys."""
    text = (f"seed={seed}; stream.error: p=0.3; stream.rebalance: p=0.2; "
            "commit.crash: p=0.4, times=2; upsert.compact_crash: p=0.5, "
            "after=3")
    streams = []
    for f in (jfaults, tfaults):
        plan = f.FaultPlan.parse(text)
        streams.append([[plan.decide(pt, key) is not None
                         for _ in range(50)]
                        for pt in INGEST_POINTS
                        for key in ("rt/0", "rt/1", "rt__0__3")])
        assert f._unit(seed, "stream.error", "mem/0", 7) == \
            jfaults._unit(seed, "stream.error", "mem/0", 7)
    assert streams[1] == streams[0]
    assert any(any(s) for s in streams[0])


def test_inline_effects_and_no_plan():
    consume_faults("mem/0")                  # no plan: nothing happens
    assert not tfaults.active()
    assert tfaults.fault_fires("commit.crash", "seg") is False
    tfaults.install("stream.error: match=reads; commit.crash: times=1")
    with pytest.raises(ConnectionError):
        consume_faults("reads/0")
    consume_faults("other/0")
    assert tfaults.fault_fires("commit.crash", "seg") is True
    assert tfaults.fault_fires("commit.crash", "seg") is False   # spent
    assert tfaults.install_from_env({"PINOT_FAULTS": "seed=9"}).seed == 9
    assert tfaults.install_from_env({}) is None


@pytest.mark.parametrize("seed,upsert", [(40, False), (50, True),
                                         (57, True)])
def test_chaotic_ingest_matches_oracle_and_reference(tmp_path, seed,
                                                     upsert):
    m, plan, _restarts = IF.run_one(str(tmp_path / "torch"), seed, 300,
                                    upsert=upsert, device="cpu")
    got = IF.digest(IF.queryable_rows(m))
    rows = IF.gen_rows(seed, 300)
    assert got == IF.digest(IF.oracle_rows(rows, upsert))
    jm, jplan, _jrestarts = JIF.run_one(str(tmp_path / "jax"), seed, 300,
                                        upsert=upsert)
    assert got == JIF.digest(JIF.queryable_rows(jm))
    assert plan.fired_summary() == jplan.fired_summary()
    assert {f["point"] for f in plan.fired} & {"commit.crash",
                                               "stream.error"}
