"""The query fuzzer through the port.

The port's ``tools/fuzzer.py`` (the JAX package's ``pinot_tpu/tools/
fuzzer.py`` ported) draws seeded specs — aggregations, selections and
(``kind="window"``) window functions — over a two-segment ``fz`` table
built by the port's builder from the fuzzer's own data. Each spec runs
through ``Broker(device="cpu")`` on the kernel path and under
``OPTION(forceHostExecution=true)``, and both digests
(``fuzzer.digest``: a row multiset, floats to a relative 1e-9) must
equal the fuzzer's independent numpy oracle. The window specs go
through the multi-stage engine; with the window threshold at 0 its
device functions run (on the CPU, their plain versions). Seeds drawn
``with_exists`` add correlated [NOT] EXISTS predicates over the fuzzer's
``fzd`` side table, which the broker decorrelates into semi-joins; their
rows must equal the JAX broker's and the oracle's. For 20 seeds the
port's fuzzer makes the reference's data, specs and SQL, and its fuzz
segment's files are byte-equal to the reference's. A few seeds run in
tier-1; the soak of more seeds is slow-marked; the card-only suite
(tests/test_torch_cuda.py) runs a seed on CUDA.
"""
import filecmp
import json
import os

import numpy as np
import pytest

from pinot_tpu_torch.broker import Broker
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.server import TableDataManager
from pinot_tpu_torch.spi import (DataType, FieldSpec, FieldType, Schema,
                                 TableConfig)
from pinot_tpu_torch.tools import fuzzer

N_ROWS = 4000
SCHEMA = fuzzer.fuzz_schema()


DIM_SCHEMA = Schema("fzd", [FieldSpec("dk", DataType.LONG),
                            FieldSpec("dv", DataType.LONG, FieldType.METRIC)])


def fuzz_broker(out: str, device: str = "cpu"):
    """(broker, data): the fuzzer's rows as two segments of table fz, and
    its EXISTS side table fzd."""
    data = fuzzer.make_data(N_ROWS)
    b = SegmentBuilder(SCHEMA, TableConfig("fz"))
    dm = TableDataManager("fz", device=device)
    for i, sl in enumerate((slice(0, N_ROWS // 2),
                            slice(N_ROWS // 2, N_ROWS))):
        dm.add_segment_dir(b.build({k: v[sl] for k, v in data.items()},
                                   out, f"s{i}"))
    broker = Broker(device=device)
    broker.register_table(dm)
    dmd = TableDataManager("fzd", device=device)
    dmd.add_segment_dir(SegmentBuilder(DIM_SCHEMA, TableConfig("fzd")).build(
        fuzzer.make_dim_data(), out, "d0"))
    broker.register_table(dmd)
    return broker, data


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return fuzz_broker(str(tmp_path_factory.mktemp("fuzz")))


def test_schema_matches_the_fuzzers():
    from pinot_tpu.tools.fuzzer import fuzz_schema

    assert [(f.name, f.data_type.name, f.field_type.name, f.single_value)
            for f in fuzz_schema().fields] == \
        [(f.name, f.data_type.name, f.field_type.name, f.single_value)
         for f in SCHEMA.fields]


def _same_segment_files(a: str, b: str) -> None:
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        if f == "metadata.json":
            ma, mb = (json.load(open(os.path.join(d, f))) for d in (a, b))
            ma.pop("creationTimeMs"), mb.pop("creationTimeMs")
            assert ma == mb
        else:
            assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                               shallow=False), f


def test_fuzzer_data_sql_and_segments_match_the_references(tmp_path):
    """20 seeds: the same data and dim data, the same specs and SQL
    (with and without EXISTS), the same oracle rows, and byte-equal
    segment files from build_fuzz_segment."""
    import jax.numpy as jnp  # noqa: F401  (JAX on the CPU first)
    from pinot_tpu.tools import fuzzer as jfuzzer

    for seed in range(20):
        n = 150 + 7 * seed
        data, jdata = fuzzer.make_data(n, seed), jfuzzer.make_data(n, seed)
        assert data.keys() == jdata.keys()
        for k in data:
            assert np.array_equal(np.asarray(data[k], dtype=object),
                                  np.asarray(jdata[k], dtype=object)), k
        dim = fuzzer.make_dim_data(60, seed)
        jdim = jfuzzer.make_dim_data(60, seed)
        assert all(np.array_equal(dim[k], jdim[k]) for k in dim)
        for exists in (False, True):
            gen = fuzzer.QueryGenerator(seed, with_exists=exists)
            jgen = jfuzzer.QueryGenerator(seed, with_exists=exists)
            for _ in range(4):
                spec, jspec = gen.generate(), jgen.generate()
                sql = fuzzer.render_sql(spec)
                assert sql == jfuzzer.render_sql(jspec)
                assert fuzzer.digest(fuzzer.oracle_rows(
                    spec, data, n, dim)) == jfuzzer.digest(
                    jfuzzer.oracle_rows(jspec, jdata, n, jdim)), sql
        seg = fuzzer.build_fuzz_segment(n, str(tmp_path / "t"), f"fz{seed}",
                                        seed, device="cpu")
        jseg = jfuzzer.build_fuzz_segment(n, str(tmp_path / "j"),
                                          f"fz{seed}", seed)
        assert seg.n_docs == n and seg.device.type == "cpu"
        _same_segment_files(seg.dir, jseg.dir)


def run_specs(broker, data, seed: int, n: int, reference=None,
              with_exists: bool = False):
    """Failures of n specs of ``seed`` on both paths: (sql, why). With a
    ``reference`` broker (the JAX package's), rows equal to its rows pass
    too: the port's contract is the reference, and the reference's own
    disagreements with the oracle are its faults (ROADMAP Queue 3)."""
    gen = fuzzer.QueryGenerator(seed, with_exists=with_exists)
    dim = fuzzer.make_dim_data()
    failures = []
    kinds = set()
    for _ in range(n):
        spec = gen.generate()
        kinds.add(spec.kind)
        sql = fuzzer.render_sql(spec)
        try:
            want = fuzzer.digest(fuzzer.oracle_rows(spec, data, N_ROWS,
                                                    dim))
            for path_sql in (sql, sql.replace(
                    "OPTION(", "OPTION(forceHostExecution=true,")):
                got = fuzzer.digest(broker.query(path_sql).rows)
                if got != want and (reference is None or got != fuzzer.digest(
                        reference.query(path_sql).rows)):
                    failures.append((path_sql, f"{len(got)} rows vs "
                                     f"{len(want)} from the oracle"))
        except Exception as e:  # noqa: BLE001 — collected for the report
            failures.append((sql, f"{type(e).__name__}: {e}"))
    return failures, kinds


@pytest.mark.parametrize("seed,window_rows", [(5, "0"), (9, "200000"),
                                              (31, "0")])
def test_fuzz_port_against_oracle(setup, seed, window_rows, monkeypatch):
    monkeypatch.setenv("PINOT_DEVICE_WINDOW_MIN_ROWS", window_rows)
    broker, data = setup
    failures, kinds = run_specs(broker, data, seed, 30)
    assert not failures, failures[:5]
    assert kinds == {"agg", "select", "window"}


def jax_broker(broker):
    """The JAX broker over the same segment directories."""
    from pinot_tpu.broker import Broker as JaxBroker
    from pinot_tpu.server import TableDataManager as JaxTable

    jb = JaxBroker()
    for name in ("fz", "fzd"):
        jdm = JaxTable(name)
        for seg in broker.table(name).acquire_segments():
            jdm.add_segment_dir(seg.dir)
        jb.register_table(jdm)
    return jb


@pytest.mark.parametrize("seed", [11, 23])
def test_fuzz_exists_against_jax(setup, seed, monkeypatch):
    """with_exists seeds: every spec's rows equal the JAX broker's on
    both paths, and the oracle's unless the JAX broker's differ too."""
    monkeypatch.setenv("PINOT_DEVICE_WINDOW_MIN_ROWS", "0")
    broker, data = setup
    jb = jax_broker(broker)
    gen = fuzzer.QueryGenerator(seed, with_exists=True)
    dim = fuzzer.make_dim_data()
    n_exists = 0
    for _ in range(20):
        spec = gen.generate()
        n_exists += any(p.op in ("exists", "not_exists")
                        for p in spec.preds)
        sql = fuzzer.render_sql(spec)
        oracle = fuzzer.digest(fuzzer.oracle_rows(spec, data, N_ROWS, dim))
        for path_sql in (sql, sql.replace(
                "OPTION(", "OPTION(forceHostExecution=true,")):
            got = fuzzer.digest(broker.query(path_sql).rows)
            want = fuzzer.digest(jb.query(path_sql).rows)
            assert got == want, path_sql
            assert got == oracle or want != oracle, path_sql
    assert n_exists >= 3


@pytest.mark.slow
def test_fuzz_port_soak(setup, monkeypatch):
    monkeypatch.setenv("PINOT_DEVICE_WINDOW_MIN_ROWS", "0")
    broker, data = setup
    jb = jax_broker(broker)
    n = int(os.environ.get("PINOT_FUZZ_N", 300))
    for seed in (20260730, 1, 2, 3):
        failures, _ = run_specs(broker, data, seed, n, reference=jb)
        assert not failures, (seed, failures[:5])
