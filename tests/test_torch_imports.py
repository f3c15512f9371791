"""The port stands alone: no JAX, nothing of pinot_tpu, CUDA by default.

``pinot_tpu_torch`` and ``chip_smoke.py`` must import neither ``jax`` nor
``pinot_tpu`` (checked by importing every module in a fresh interpreter
and by scanning their sources), its entry points must refuse to run when
CUDA is asked for and absent rather than fall back to the CPU, and
``chip_smoke.py`` must fail, printing no result, without a GPU or away
from the repository.
"""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pinot_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "pinot_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_import_no_jax_and_no_reference_package():
    bad = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import pinot_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(pinot_tpu_torch.__path__, "
        "'pinot_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pinot_tpu') or m.startswith(('jax.', 'jaxlib.', 'pinot_tpu.'))]\n"
        "print(sorted(bad))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd="/")
    assert r.returncode == 0, r.stdout + r.stderr


MEMORY_PLANE = tuple(f"pinot_tpu_torch.{m}" for m in (
    "utils.metrics", "utils.devmem", "utils.heat", "engine.tier",
    "engine.pipeline", "ops.plan_cache"))


def test_walk_covers_the_memory_plane():
    """The import checks above reach the device-memory modules."""
    import pkgutil

    import pinot_tpu_torch

    walked = {m.name for m in pkgutil.walk_packages(
        pinot_tpu_torch.__path__, "pinot_tpu_torch.")}
    assert set(MEMORY_PLANE) <= walked
    srcs = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in MEMORY_PLANE} <= srcs


SERVING_PLANE = tuple(f"pinot_tpu_torch.{m}" for m in (
    "engine.accounting", "engine.scheduler", "engine.ragged"))


def test_walk_covers_the_serving_plane():
    """The import checks above reach the accountant, the admission
    window and the cross-query micro-batcher, and the broker imports
    them (the batcher runs by default)."""
    import pkgutil

    import pinot_tpu_torch
    from pinot_tpu_torch.broker import broker

    walked = {m.name for m in pkgutil.walk_packages(
        pinot_tpu_torch.__path__, "pinot_tpu_torch.")}
    assert set(SERVING_PLANE) <= walked
    srcs = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in SERVING_PLANE} <= srcs
    assert broker.global_accountant is not None
    assert broker.global_batcher is not None


MULTISTAGE_PLANE = tuple(f"pinot_tpu_torch.{m}" for m in (
    "multistage.relation", "multistage.join", "multistage.exchange",
    "multistage.costs", "multistage.device_join", "multistage.window",
    "multistage.fused", "multistage.executor", "ops.join", "ops.segscan",
    "analysis.plan_verify", "utils.stats"))


def test_walk_covers_the_multistage_plane():
    """The import checks above reach the multi-stage engine and its
    kernels' modules, and the broker routes to it."""
    import pkgutil

    import pinot_tpu_torch
    from pinot_tpu_torch.broker import broker

    walked = {m.name for m in pkgutil.walk_packages(
        pinot_tpu_torch.__path__, "pinot_tpu_torch.")}
    assert set(MULTISTAGE_PLANE) <= walked
    srcs = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in MULTISTAGE_PLANE} <= srcs
    assert broker.execute_multistage is not None


VECTOR_PLANE = tuple(f"pinot_tpu_torch.{m}" for m in (
    "index.registry", "index.predicates", "index.csr", "index.inverted",
    "index.range_index", "index.bloom", "index.text", "index.json_index",
    "index.vector", "engine.vector_exec", "ops.vecsearch",
    "segment.loader", "tools.vec"))


def test_walk_covers_the_vector_plane():
    """The import checks above reach the index package, the vector plane
    and its kernels' module, and the kernel source is a library of the
    builder."""
    import pkgutil

    import pinot_tpu_torch
    from pinot_tpu_torch.ops import cuda_build

    walked = {m.name for m in pkgutil.walk_packages(
        pinot_tpu_torch.__path__, "pinot_tpu_torch.")}
    assert set(VECTOR_PLANE) <= walked
    srcs = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in VECTOR_PLANE} <= srcs
    assert cuda_build.SOURCES["vecsearch"] == ["vecsearch.cu"]


FORMAT_AND_TRACING = tuple(f"pinot_tpu_torch.{m}" for m in (
    "native", "startree", "startree.builder", "startree.query",
    "utils.spans", "utils.phases", "utils.trace", "utils.metrics",
    "ops.phase_profile"))


def test_walk_covers_the_segment_format_and_the_tracing_plane():
    """The import checks above reach the native codec runtime, the
    star-tree rollups and the tracing modules; the native library's
    C++ source is the port's own copy and builds outside the package."""
    import pkgutil

    import pinot_tpu_torch
    from pinot_tpu_torch import native

    walked = {m.name for m in pkgutil.walk_packages(
        pinot_tpu_torch.__path__, "pinot_tpu_torch.")}
    assert set(FORMAT_AND_TRACING) <= walked
    srcs = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in FORMAT_AND_TRACING
            if m.split(".")[-1] not in ("native", "startree")} <= srcs
    assert {"pinot_tpu_torch/native/__init__.py",
            "pinot_tpu_torch/startree/__init__.py"} <= srcs
    assert os.path.exists(os.path.join(PKG, "native", "src",
                                       "pinot_native.cpp"))
    assert not os.path.commonpath([native.BUILD_DIR, PKG]) == PKG


INGEST_AND_REMOTE = tuple(f"pinot_tpu_torch.{m}" for m in (
    "engine.loadgen", "tools.ingest_fuzz", "tools.fuzzer",
    "utils.metrics_sinks", "fs.common", "fs.s3", "fs.gcs", "fs.hdfs",
    "fs.adls", "fs.stub", "fs.stub_cloud", "inputformat.avro",
    "inputformat.extended"))


def test_walk_covers_the_ingest_harness_and_remote_stores():
    """The import checks above reach the load harness, the fuzzers, the
    metrics sinks, every PinotFS client and stub store, and the input
    formats."""
    import pkgutil

    import pinot_tpu_torch

    walked = {m.name for m in pkgutil.walk_packages(
        pinot_tpu_torch.__path__, "pinot_tpu_torch.")}
    assert set(INGEST_AND_REMOTE) <= walked
    srcs = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {m.replace(".", "/") + ".py" for m in INGEST_AND_REMOTE} <= srcs


def test_entry_points_default_to_cuda_and_refuse_without_it(monkeypatch,
                                                          tmp_path):
    from pinot_tpu_torch.broker import Broker
    from pinot_tpu_torch.device import resolve_device
    from pinot_tpu_torch.segment import ImmutableSegment, SegmentBuilder
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.spi import DataType, FieldSpec, Schema

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg_dir = SegmentBuilder(Schema("t", [FieldSpec("v", DataType.INT)])
                             ).build({"v": [1, 2]}, str(tmp_path), "s")
    from pinot_tpu_torch.engine.loadgen import (IngestLoadGen,
                                                LoadgenConfig, run_load)
    from pinot_tpu_torch.tools import fuzzer, ingest_fuzz

    for make in (Broker, lambda: TableDataManager("t"),
                 lambda: ImmutableSegment.load(seg_dir),
                 lambda: resolve_device("cuda"),
                 lambda: IngestLoadGen(str(tmp_path / "lg"),
                                       LoadgenConfig()),
                 lambda: run_load(str(tmp_path / "rl"), LoadgenConfig()),
                 lambda: ingest_fuzz.run_one(str(tmp_path / "if"), 1, 10,
                                             upsert=False),
                 lambda: fuzzer.build_fuzz_segment(10, str(tmp_path / "fz"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # refused before any work: no stream, table or segment was made
    assert not any(os.path.exists(tmp_path / d)
                   for d in ("lg", "rl", "if", "fz"))
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert Broker(device="cpu").device.type == "cpu"


def test_unported_plan_kinds_raise(tmp_path):
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.spi import DataType, FieldSpec, Schema

    seg_dir = SegmentBuilder(Schema("t", [
        FieldSpec("k", DataType.STRING), FieldSpec("v", DataType.INT)])
    ).build({"k": ["a", "b", "a"], "v": [1, 2, 3]}, str(tmp_path), "s")
    dm = TableDataManager("t", device="cpu")
    dm.add_segment_dir(seg_dir)
    b = Broker(device="cpu")
    b.register_table(dm)
    q = connect(b)
    assert q("SELECT k, SUM(v) FROM t WHERE v > 1 GROUP BY k "
             "ORDER BY k").rows == [("a", 3), ("b", 2)]
    assert q("SELECT COUNT(*) FROM t WHERE k = 'zzz'").rows == [(0,)]
    # every single-stage plan kind runs now (kselect, fast, host)
    assert q("SELECT k, v FROM t LIMIT 2").rows == [("a", 1), ("b", 2)]
    assert q("SELECT COUNT(*) FROM t").rows == [(3,)]
    assert q("SELECT UPPER(k), SUM(v) FROM t GROUP BY UPPER(k) "
             "ORDER BY UPPER(k)").rows == [("A", 4), ("B", 2)]
    # joins and window functions run (the multi-stage engine), and so do
    # set operations, CTEs, subqueries and EXPLAIN (these raised once)
    assert q("SELECT COUNT(*) FROM t a JOIN t b ON a.k = b.k").rows \
        == [(5,)]
    assert q("SELECT v, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v) "
             "FROM t ORDER BY v").rows == [(1, 1), (2, 1), (3, 2)]
    for sql, rows in (
            ("SELECT k FROM t UNION SELECT k FROM t", [("a",), ("b",)]),
            ("WITH w AS (SELECT k FROM t) SELECT k FROM w",
             [("a",), ("b",), ("a",)]),
            ("SELECT k FROM t WHERE v IN (SELECT v FROM t WHERE v > 1)",
             [("b",), ("a",)]),
            ("EXPLAIN PLAN FOR SELECT k FROM t",
             [("BROKER_REDUCE(LIMIT:10)", 0, -1),
              ("COMBINE(vmap_batched)", 1, 0)])):
        assert q(sql).rows == rows, sql


def test_explain_analyze_and_trace_raise(tmp_path):
    """The span plane is ported: EXPLAIN ANALYZE and OPTION(trace=true)
    run, and a trace persists to the ledger at the caller's path as a
    record the JAX package's validator accepts. What still raises is
    OPTION(ledgerTrace=true) with no path at all: the port never writes
    a ledger the caller did not name."""
    from pinot_tpu.utils.ledger import validate_file
    from pinot_tpu_torch.query.sql import SqlError
    from pinot_tpu_torch.broker import Broker, connect
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.server import TableDataManager
    from pinot_tpu_torch.spi import DataType, FieldSpec, Schema

    seg_dir = SegmentBuilder(Schema("t", [FieldSpec("v", DataType.INT)])
                             ).build({"v": [1, 2, 3]}, str(tmp_path), "s")
    dm = TableDataManager("t", device="cpu")
    dm.add_segment_dir(seg_dir)
    b = Broker(device="cpu")
    b.register_table(dm)
    q = connect(b)
    assert q("EXPLAIN ANALYZE SELECT SUM(v) FROM t").rows[0][0] == "query"
    assert "phases" in q("SELECT SUM(v) FROM t OPTION(trace=true)").trace
    with pytest.raises(SqlError, match="ledger path"):
        q("EXPLAIN ANALYZE SELECT SUM(v) FROM t OPTION(ledgerTrace=true)")
    path = tmp_path / "l.jsonl"
    q(f"EXPLAIN ANALYZE SELECT SUM(v) FROM t OPTION(ledgerTrace=true, "
      f"ledgerPath='{path}')")
    b2 = Broker(device="cpu", trace_ledger_path=str(path))
    b2.register_table(dm)
    connect(b2)("SELECT SUM(v) FROM t OPTION(traceRatio=1)")
    report = validate_file(str(path))
    assert report["errors"] == [] and report["kinds"] == {"query_trace": 2}


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    r = _run_smoke(ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0 and '"ok"' not in r.stdout
