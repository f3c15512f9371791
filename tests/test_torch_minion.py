"""The minion role, the connectors and the config recommender of the port
against the JAX package, on the CPU.

Each built-in task (MergeRollup with and without a rollup and a time
bucket, Purge, UpsertCompaction, RealtimeToOfflineSegments,
SegmentGenerationAndPush) runs through ``MinionWorker`` over the same
seeded input segments in both packages: the task results are equal, the
output segment files are byte-equal (``metadata.json`` less its creation
time), the output segments load on the data manager's device and answer
queries as the reference's do; the generators emit the same tasks, and a
failed task records the same error. ``connectors.read_sql``,
``read_table`` and ``to_torch`` give the reference's frames and tensors,
``to_torch(device=...)`` places them there. ``tools/recommender`` gives
the reference's config and reasons.
"""
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the engine)

import pinot_tpu.broker as jbroker
import pinot_tpu.connectors as jconn
import pinot_tpu.minion as jmin
import pinot_tpu.minion.framework as jfw
import pinot_tpu.segment as jseg
import pinot_tpu.server as jserver
import pinot_tpu.spi as jspi
import pinot_tpu.tools.recommender as jrec
import pinot_tpu_torch.broker as tbroker
import pinot_tpu_torch.connectors as tconn
import pinot_tpu_torch.minion as tmin
import pinot_tpu_torch.minion.framework as tfw
import pinot_tpu_torch.server as tserver
import pinot_tpu_torch.spi as tspi
import pinot_tpu_torch.tools.recommender as trec

DAY = 86_400_000


def _schema(spi):
    return spi.Schema("m", [
        spi.FieldSpec("city", spi.DataType.STRING, spi.FieldType.DIMENSION),
        spi.FieldSpec("day", spi.DataType.LONG, spi.FieldType.DIMENSION),
        spi.FieldSpec("clicks", spi.DataType.INT, spi.FieldType.METRIC),
        spi.FieldSpec("cost", spi.DataType.DOUBLE, spi.FieldType.METRIC)])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Four seeded input segments built by the reference's builder."""
    root = tmp_path_factory.mktemp("minion_inputs")
    rng = np.random.default_rng(5)
    b = jseg.SegmentBuilder(_schema(jspi), jspi.TableConfig("m"))
    dirs = []
    for i in range(4):
        rows = 300 + 50 * i
        dirs.append(b.build({
            "city": rng.choice(["nyc", "sf", "la"], rows),
            "day": rng.integers(0, 3, rows).astype(np.int64) * DAY,
            "clicks": rng.integers(0, 50, rows).astype(np.int32),
            "cost": rng.uniform(0, 9, rows)}, str(root), f"seg_{i}"))
    return dirs


def _dm(name, dirs, valid=None):
    if name == "jax":
        dm = jserver.TableDataManager("m")
    else:
        dm = tserver.TableDataManager("m", device="cpu")
    for d in dirs:
        seg = dm.add_segment_dir(d)
        if valid is not None and seg.name in valid:
            seg.set_valid_docs(valid[seg.name].copy())
    return dm


def _files(dm):
    out = {}
    for seg in sorted(dm.acquire_segments(), key=lambda s: s.name):
        for f in sorted(os.listdir(seg.dir)):
            with open(os.path.join(seg.dir, f), "rb") as fh:
                raw = fh.read()
            if f == "metadata.json":
                meta = json.loads(raw)
                assert meta.pop("creationTimeMs") > 0
                raw = json.dumps(meta, sort_keys=True).encode()
            out[f"{seg.name}/{f}"] = raw
    return out


def _answers(name, dms):
    b = jbroker.Broker() if name == "jax" else tbroker.Broker(device="cpu")
    for dm in dms:
        b.register_table(dm)
    return [[tuple(r) for r in b.query(sql).rows] for sql in (
        "SELECT COUNT(*), SUM(clicks) FROM m",
        "SELECT city, day, SUM(clicks), MAX(cost) FROM m GROUP BY city, "
        "day ORDER BY city, day LIMIT 100")]


TASKS = {
    "merge": ("MergeRollupTask", {"targetRows": 10_000}),
    "merge_rollup": ("MergeRollupTask", {"rollup": {"clicks": "sum",
                                                    "cost": "max"}}),
    "merge_bucketed": ("MergeRollupTask", {"timeColumn": "day",
                                           "bucketMs": DAY,
                                           "targetRows": 200}),
    "purge": ("PurgeTask", {"where": "city = 'nyc' AND clicks > 20"}),
    "upsert_compaction": ("UpsertCompactionTask",
                          {"segments": ["seg_1", "seg_2"]}),
    "realtime_to_offline": ("RealtimeToOfflineSegmentsTask",
                            {"timeColumn": "day", "bucketMs": DAY}),
}


def _valid(dirs):
    rng = np.random.default_rng(9)
    out = {}
    for d in dirs[1:3]:
        with open(os.path.join(d, "metadata.json")) as fh:
            n = json.load(fh)["totalDocs"]
        out[os.path.basename(d)] = rng.random(n) > 0.3
    return out


def _run_task(name, case, dirs, tmp_path):
    mod = jmin if name == "jax" else tmin
    task_type, cfg = TASKS[case]
    dm = _dm(name, dirs, _valid(dirs))
    offline = {}
    if task_type == "RealtimeToOfflineSegmentsTask":
        offline = {"m": _dm(name, [])}
    ctx = mod.MinionContext({"m": dm}, str(tmp_path / name / "out"),
                            offline_tables=offline)
    w = mod.MinionWorker(ctx)
    spec = w.submit(mod.TaskSpec(task_type, "m", dict(cfg),
                                 task_id="fixedid"))
    assert w.run_once() is spec
    assert spec.state.value == "COMPLETED", spec.error
    out = [dm] + list(offline.values())
    return spec.result, [_files(x) for x in out], _answers(name, out), out


@pytest.mark.parametrize("case", sorted(TASKS))
def test_task_outputs_byte_equal(case, inputs, tmp_path):
    got = _run_task("torch", case, inputs, tmp_path)
    want = _run_task("jax", case, inputs, tmp_path)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    # the outputs load on the data manager's device
    for dm in got[3]:
        assert all(s.device.type == dm.device.type == "cpu"
                   for s in dm.acquire_segments())


def test_segment_generation_and_push_matches(tmp_path):
    csv_path = tmp_path / "in.csv"
    csv_path.write_text("city,day,clicks,cost\nnyc,0,3,1.5\n"
                        f"sf,{DAY},7,2.25\nla,{2 * DAY},11,0.5\n")
    json_path = tmp_path / "in.json"
    json_path.write_text(json.dumps(
        [{"city": "nyc", "day": 0, "clicks": 10, "cost": 4.0}]))
    out = {}
    for name, mod, spi in (("jax", jmin, jspi), ("torch", tmin, tspi)):
        dm = _dm(name, [])
        dm.schema = _schema(spi)
        w = mod.MinionWorker(mod.MinionContext(
            {"m": dm}, str(tmp_path / name)))
        specs = [w.submit(mod.TaskSpec(
            "SegmentGenerationAndPushTask", "m",
            {"inputPath": str(p), "format": fmt}, task_id=f"id{i}"))
            for i, (p, fmt) in enumerate(((csv_path, "csv"),
                                          (json_path, "json")))]
        w.drain()
        out[name] = ([(s.state.value, s.result) for s in specs],
                     _files(dm), _answers(name, [dm]))
    assert out["torch"] == out["jax"]


def test_generators_and_failures_match(inputs, tmp_path):
    out = {}
    for name, mod, fw in (("jax", jmin, jfw), ("torch", tmin, tfw)):
        dm = _dm(name, inputs, _valid(inputs))
        w = mod.MinionWorker(mod.MinionContext({"m": dm},
                                               str(tmp_path / name)))
        mgr = mod.TaskManager(w)
        mgr.register_generator(fw.merge_rollup_generator(
            min_small_segments=3, small_segment_rows=400))
        mgr.register_generator(fw.upsert_compaction_generator(
            invalid_fraction=0.2))
        specs = mgr.generate_and_submit()
        bad = w.submit(mod.TaskSpec("PurgeTask", "m", {}))
        w.drain()
        out[name] = ([(s.task_type, s.config) for s in specs],
                     [s.state.value for s in specs], bad.state.value,
                     bad.error, _answers(name, [dm]))
    assert out["torch"] == out["jax"]
    assert tmin.task_executor_types() == jmin.task_executor_types()


def test_connectors_match(inputs):
    dms = {"jax": _dm("jax", inputs), "torch": _dm("torch", inputs)}
    jb = jbroker.Broker()
    jb.register_table(dms["jax"])
    tb = tbroker.Broker(device="cpu")
    tb.register_table(dms["torch"])
    sql = "SELECT city, SUM(clicks) AS c FROM m GROUP BY city ORDER BY city"
    got, want = tconn.read_sql(tb, sql), jconn.read_sql(jb, sql)
    assert got.equals(want)
    got = tconn.read_table(dms["torch"], ["city", "clicks"])
    want = jconn.read_table(dms["jax"], ["city", "clicks"])
    assert got.equals(want) and len(got) == sum(
        s.n_docs for s in dms["jax"].acquire_segments())
    tt, jt = tconn.to_torch(got), jconn.to_torch(want)
    assert sorted(tt) == sorted(jt) == ["clicks"]
    assert all(tt[k].equal(jt[k]) for k in tt)
    placed = tconn.to_torch(tb.query(sql), device="cpu")
    assert placed["c"].device.type == "cpu"
    assert placed["c"].tolist() == [r[1] for r in tb.query(sql).rows]


def test_recommender_matches():
    workload = [
        ("SELECT SUM(clicks) FROM m WHERE city = 'nyc'", 5.0),
        ("SELECT day, COUNT(*) FROM m WHERE day BETWEEN 0 AND 86400000 "
         "GROUP BY day", 3.0),
        ("SELECT city FROM m WHERE city IN ('sf', 'la') AND clicks > 3",
         2.0),
        ("SELECT COUNT(*) FROM m WHERE city LIKE 'n%'", 1.0),
        ("SELECT MAX(cost) FROM m WHERE NOT (clicks != 4)", 1.0)]
    for cards in (None, {"city": 3, "day": 900_000, "clicks": 50}):
        for n_rows in (10_000, 50_000_000):
            got = trec.recommend(_schema(tspi), workload,
                                 cardinalities=cards, n_rows=n_rows)
            want = jrec.recommend(_schema(jspi), workload,
                                  cardinalities=cards, n_rows=n_rows)
            assert got.to_dict() == want.to_dict()
