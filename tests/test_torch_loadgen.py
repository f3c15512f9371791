"""The ingest-under-load harness and the ingest fuzzer against the JAX
package's, on the CPU.

``pinot_tpu_torch/engine/loadgen.py`` and ``tools/ingest_fuzz.py`` are
the reference's modules on the port's realtime plane: the same seed
gives the same producer rows, the same fault plan, the same oracle and,
after a chaos-armed run that crashes and restarts its managers, the same
final rows per partition as the reference's run of the same seed. The
port's run writes an ``ingest_bench`` record with the torch device type
as its ``backend``, and a crashed or closed manager leaves no device
bytes behind (tracked == held).
"""
import os
import sys

import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the broker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pinot_tpu.engine.loadgen as JL  # noqa: E402
import pinot_tpu.tools.ingest_fuzz as JF  # noqa: E402
import pinot_tpu.utils.faults as jfaults  # noqa: E402
import pinot_tpu_torch.engine.loadgen as TL  # noqa: E402
import pinot_tpu_torch.tools.ingest_fuzz as TF  # noqa: E402
import pinot_tpu_torch.utils.faults as tfaults  # noqa: E402


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    from test_torch_tier import reset_port_memory

    for f in (jfaults, tfaults):
        f.clear()
    yield
    for f in (jfaults, tfaults):
        f.clear()
    reset_port_memory()


@pytest.mark.parametrize("seed", [0, 7, 1992])
def test_seeded_rows_plans_and_oracles_match_reference(seed):
    for t, p, n in ((0, 0, 50), (1, 3, 200), (2, 1, 1)):
        assert TL.gen_partition_rows(seed, t, p, n) == \
            JL.gen_partition_rows(seed, t, p, n)
    rows = TF.gen_rows(seed, 300)
    assert rows == JF.gen_rows(seed, 300)
    for protocol in (False, True):
        assert TF.ingest_plan(seed, protocol) == JF.ingest_plan(seed,
                                                                protocol)
    for upsert in (False, True):
        assert TF.digest(TF.oracle_rows(rows, upsert)) == \
            JF.digest(JF.oracle_rows(rows, upsert))
    assert TL.QUERY_MIX == JL.QUERY_MIX and TL.BACKENDS == JL.BACKENDS
    assert TL._kinesis_shard_keys(4) == JL._kinesis_shard_keys(4)
    assert [(f.name, f.data_type.name, f.field_type.name)
            for f in TL.loadgen_schema("t").fields] == \
        [(f.name, f.data_type.name, f.field_type.name)
         for f in JL.loadgen_schema("t").fields]


@pytest.mark.parametrize("upsert,protocol", [(False, False), (True, False),
                                             (True, True)])
def test_run_one_gives_the_references_rows_and_faults(tmp_path, upsert,
                                                      protocol):
    seed = 40 if not upsert else 50
    m, plan, restarts = TF.run_one(str(tmp_path / "torch"), seed, 300,
                                   upsert, protocol, device="cpu")
    got = TF.digest(TF.queryable_rows(m))
    jm, jplan, jrestarts = JF.run_one(str(tmp_path / "jax"), seed, 300,
                                      upsert, protocol)
    assert got == JF.digest(JF.queryable_rows(jm))
    assert got == TF.digest(TF.oracle_rows(TF.gen_rows(seed, 300), upsert))
    assert plan.fired_summary() == jplan.fired_summary()
    assert restarts == jrestarts


def _final_rows(lg) -> dict:
    return {t.spec.name: sorted(lg._queryable_rows(t.spec.name))
            for t in lg.tables}


def _run(mod, data_dir, cfg, **kw):
    lg = mod.IngestLoadGen(data_dir, cfg, **kw)
    try:
        summary = lg.run()
        rows = _final_rows(lg)
        tables = lg.tables
    finally:
        lg.close()
    return summary, rows, tables


@pytest.mark.parametrize("chaos", [False, True])
def test_drained_run_matches_reference(tmp_path, chaos):
    """2 tables x 2 partitions x 200 rows over the in-memory stream
    (the upsert table committing through the completion protocol), with
    and without the seeded chaos plan: the final rows of every table
    equal the reference's run and the oracle's, the run validates as an
    ingest_bench record with backend "cpu", and no device byte of a
    crashed or closed manager's segments stays tracked."""
    from pinot_tpu_torch.engine.tier import reconcile_devmem
    from pinot_tpu_torch.utils import ledger

    seed = 11

    def cfg(mod, ledger_path=None):
        return mod.LoadgenConfig(
            seed=seed, rows_per_partition=200, query_concurrency=2,
            fault_plan=(mod_plan(mod) if chaos else None),
            ledger_path=ledger_path)

    def mod_plan(mod):
        return (TF if mod is TL else JF).ingest_plan(seed, protocol=True)

    summary, rows, tables = _run(TL, str(tmp_path / "torch"), cfg(TL),
                                 device="cpu")
    jsummary, jrows, _jt = _run(JL, str(tmp_path / "jax"), cfg(JL))
    assert summary["ok"] and jsummary["ok"], (summary, jsummary)
    assert rows == jrows
    for t in tables:
        assert sorted(rows[t.spec.name]) == t.oracle_digest(seed, 200)
    assert summary["backend"] == "cpu" and summary["chaos"] == chaos
    assert summary["rows"] == jsummary["rows"] == 800
    if chaos:
        assert summary["restarts"] > 0 and summary["faults_fired"] > 0
    path = str(tmp_path / "ledger.jsonl")
    rec = TL.write_ingest_bench(summary, path)
    assert rec["backend"] == "cpu"
    checked = ledger.validate_file(path)
    assert checked["errors"] == [] and checked["kinds"] == {
        "ingest_bench": 1}
    segs = [s for t in tables for s in t.current()[1].acquire_segments()
            if not getattr(s, "is_mutable", False)]
    assert segs and all(not s._device for s in segs)
    assert all(r["tracked"] == r["actual"]
               for r in reconcile_devmem([]).values())


@pytest.mark.parametrize("backend", ["kafka", "wire", "kinesis", "pulsar"])
def test_run_load_over_the_wire_fakes(tmp_path, backend):
    """run_load over each protocol fake (Kafka, the wire stream, Kinesis
    with SigV4, Pulsar), with the ledger records it writes: one
    ingest_bench, one ingest_stats a table."""
    from pinot_tpu_torch.utils import ledger

    path = str(tmp_path / "ledger.jsonl")
    cfg = TL.LoadgenConfig(
        tables=[TL.TableLoadSpec("lg_a", partitions=2, backend=backend,
                                 threshold=48),
                TL.TableLoadSpec("lg_u", partitions=2, upsert=True,
                                 protocol=True, backend=backend,
                                 threshold=48)],
        seed=4, rows_per_partition=120, query_concurrency=2,
        ledger_path=path)
    summary = TL.run_load(str(tmp_path / "run"), cfg, device="cpu")
    assert summary["ok"] and summary["oracle_ok"], summary
    assert summary["table_stats_written"] == 2
    assert summary["commits"] > 0 and summary["queries"] > 0
    checked = ledger.validate_file(path)
    assert checked["errors"] == []
    assert checked["kinds"] == {"ingest_bench": 1, "ingest_stats": 2}
