"""Upsert and dedup in the port against the JAX package, on the CPU.

Each scenario streams the same rows through ``pinot_tpu`` and
``pinot_tpu_torch`` (``device="cpu"``) and queries both brokers: full
upsert in the consuming segment and across seals (the kernel path honours
the sealed segments' masks), rehydration after a restart, stream order
without a comparison column, dedup across a restart, the partial
strategies in the consuming segment and across a seal, the default
OVERWRITE, metadata TTL, a bad config refused with the reference's
errors, and a star-tree rollup refused once its segment has invalidated
documents. Rows must be equal, integers exactly and floats to a relative
1e-9.
"""
import os
import sys
import threading

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the broker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pinot_tpu.realtime.manager as jmanager  # noqa: E402
import pinot_tpu.upsert as jups  # noqa: E402
import pinot_tpu.upsert.metadata as jmeta  # noqa: E402
import pinot_tpu_torch.upsert as tups  # noqa: E402
import pinot_tpu_torch.upsert.metadata as tmeta  # noqa: E402
from pinot_tpu_torch.realtime import manager as tmanager  # noqa: E402
from test_torch_realtime import OPT, PKGS, _pkg  # noqa: E402

REL = 1e-9


def _ns(name):
    ns = _pkg(name)
    ns.ups = jups if name == "jax" else tups
    return ns


def _schema(ns):
    s = ns.spi
    return s.Schema("users", [
        s.FieldSpec("uid", s.DataType.INT),
        s.FieldSpec("score", s.DataType.INT, s.FieldType.METRIC),
        s.FieldSpec("ts", s.DataType.LONG, s.FieldType.METRIC)])


def _pschema(ns):
    s = ns.spi
    return s.Schema("users", [
        s.FieldSpec("uid", s.DataType.INT),
        s.FieldSpec("score", s.DataType.INT, s.FieldType.METRIC),
        s.FieldSpec("city", s.DataType.STRING),
        s.FieldSpec("tags", s.DataType.STRING, single_value=False),
        s.FieldSpec("ts", s.DataType.LONG, s.FieldType.METRIC)])


def _mgr(ns, tmp, stream, schema, threshold=100, upsert=None, dedup=None):
    cfg = ns.Config("users", num_partitions=stream.num_partitions(),
                    flush_threshold_rows=threshold, consumer_factory=stream)
    return ns.manager("users", schema, cfg, str(tmp), upsert_config=upsert,
                      dedup_config=dedup)


def _q(ns, dm, *sqls):
    b = ns.broker()
    b.register_table(dm)
    out = []
    for sql in sqls:
        rows = b.query(sql if "OPTION" in sql else sql + OPT).rows
        out.append(sorted(tuple(tuple(v) if isinstance(v, list) else v
                                for v in r) for r in rows))
    return out


FULL_SQLS = ("SELECT uid, score FROM users ORDER BY uid LIMIT 100",
             "SELECT COUNT(*), SUM(score) FROM users",
             "SELECT uid, COUNT(*), SUM(score) FROM users GROUP BY uid "
             "ORDER BY uid LIMIT 100 "
             "OPTION(groupByStrategy=compact,timeoutMs=600000)",
             "SELECT COUNT(*) FROM users "
             "OPTION(skipUpsert=true,timeoutMs=600000)")


def _scn_consuming(ns, tmp):
    stream = ns.Stream(1)
    for uid, score, ts in [(1, 10, 100), (2, 20, 100), (1, 11, 200),
                           (1, 12, 300), (2, 21, 50)]:
        stream.produce({"uid": uid, "score": score, "ts": ts})
    dm = _mgr(ns, tmp, stream, _schema(ns), threshold=1000,
              upsert=ns.ups.UpsertConfig(["uid"], "ts"))
    dm.consume_once(0)
    return _q(ns, dm, *FULL_SQLS)


def _scn_across_seals(ns, tmp):
    stream = ns.Stream(1)
    rng = np.random.default_rng(3)
    for i in range(60):
        stream.produce({"uid": int(rng.integers(0, 11)),
                        "score": int(rng.integers(0, 1000)),
                        "ts": int(rng.integers(0, 20))})
    dm = _mgr(ns, tmp, stream, _schema(ns), threshold=16,
              upsert=ns.ups.UpsertConfig(["uid"], "ts"))
    dm.consume_once(0)
    return [dm.num_segments] + _q(ns, dm, *FULL_SQLS)


def _scn_restart(ns, tmp):
    stream = ns.Stream(1)
    for i in range(6):
        stream.produce({"uid": i % 3, "score": 100 + i, "ts": i})
    cfg = ns.ups.UpsertConfig(["uid"], "ts")
    _mgr(ns, tmp, stream, _schema(ns), threshold=3,
         upsert=cfg).consume_once(0)
    dm2 = _mgr(ns, tmp, stream, _schema(ns), threshold=3, upsert=cfg)
    first = _q(ns, dm2, *FULL_SQLS)
    stream.produce({"uid": 1, "score": 999, "ts": 100})
    dm2.consume_once(0)
    return first + _q(ns, dm2, *FULL_SQLS)


def _scn_stream_order(ns, tmp):
    stream = ns.Stream(1)
    for k in range(40):
        stream.produce({"uid": k % 6, "score": k, "ts": 0})
    dm = _mgr(ns, tmp, stream, _schema(ns), threshold=15,
              upsert=ns.ups.UpsertConfig(["uid"]))
    dm.consume_once(0)
    return _q(ns, dm, *FULL_SQLS)


def _scn_dedup(ns, tmp):
    stream = ns.Stream(1)
    for uid in [1, 2, 1, 3, 2, 1]:
        stream.produce({"uid": uid, "score": uid * 10, "ts": 0})
    cfg = ns.ups.DedupConfig(["uid"])
    dm = _mgr(ns, tmp, stream, _schema(ns), threshold=4, dedup=cfg)
    dm.consume_once(0)
    first = _q(ns, dm, *FULL_SQLS[1:2])
    dm2 = _mgr(ns, tmp, stream, _schema(ns), threshold=4, dedup=cfg)
    stream.produce({"uid": 3, "score": 30, "ts": 0})
    stream.produce({"uid": 4, "score": 40, "ts": 0})
    dm2.consume_once(0)
    return first + _q(ns, dm2, *FULL_SQLS[1:2])


def _partial_cfg(ns, **kw):
    return ns.ups.UpsertConfig(
        ["uid"], "ts", mode="partial",
        partial_strategies={"score": "INCREMENT", "city": "IGNORE",
                            "tags": "UNION"}, **kw)


PARTIAL_SQLS = ("SELECT uid, score, city, tags, ts FROM users LIMIT 100",
                "SELECT COUNT(*) FROM users "
                "OPTION(skipUpsert=true,timeoutMs=600000)")


def _scn_partial_consuming(ns, tmp):
    stream = ns.Stream(1)
    stream.produce({"uid": 1, "score": 10, "city": "nyc", "tags": ["a"],
                    "ts": 100})
    stream.produce({"uid": 1, "score": 5, "city": "sf", "tags": ["b", "a"],
                    "ts": 200})
    stream.produce({"uid": 1, "score": None, "city": None, "tags": None,
                    "ts": 300})
    dm = _mgr(ns, tmp, stream, _pschema(ns), threshold=1000,
              upsert=_partial_cfg(ns))
    dm.consume_once(0)
    return _q(ns, dm, *PARTIAL_SQLS)


def _scn_partial_across_seal(ns, tmp):
    stream = ns.Stream(1)
    stream.produce({"uid": 1, "score": 10, "city": "nyc", "tags": ["a"],
                    "ts": 100})
    stream.produce({"uid": 2, "score": 7, "city": "la", "tags": ["z"],
                    "ts": 100})
    dm = _mgr(ns, tmp, stream, _pschema(ns), threshold=2,
              upsert=_partial_cfg(ns))
    dm.consume_once(0)
    stream.produce({"uid": 1, "score": 4, "city": "sf", "tags": ["b"],
                    "ts": 200})
    stream.produce({"uid": 2, "score": None, "city": "sd",
                    "tags": ["z", "y"], "ts": 300})
    dm.consume_once(0)
    return _q(ns, dm, *PARTIAL_SQLS)


def _scn_partial_default(ns, tmp):
    stream = ns.Stream(1)
    stream.produce({"uid": 3, "score": 1, "city": "x", "tags": ["t"],
                    "ts": 10})
    stream.produce({"uid": 3, "score": 2, "city": "y", "tags": ["u"],
                    "ts": 20})
    dm = _mgr(ns, tmp, stream, _pschema(ns), threshold=1000,
              upsert=ns.ups.UpsertConfig(["uid"], "ts", mode="partial"))
    dm.consume_once(0)
    return _q(ns, dm, *PARTIAL_SQLS)


def _scn_ttl(ns, tmp):
    stream = ns.Stream(1)
    stream.produce({"uid": 1, "score": 10, "ts": 100})
    stream.produce({"uid": 2, "score": 20, "ts": 1000})
    dm = _mgr(ns, tmp, stream, _schema(ns), threshold=1000,
              upsert=ns.ups.UpsertConfig(["uid"], "ts", metadata_ttl=500))
    dm.consume_once(0)
    keys = dm._upsert[0].num_keys
    stream.produce({"uid": 1, "score": 11, "ts": 1100})
    dm.consume_once(0)
    return [keys] + _q(ns, dm, *FULL_SQLS[1:2])


SCENARIOS = [_scn_consuming, _scn_across_seals, _scn_restart,
             _scn_stream_order, _scn_dedup, _scn_partial_consuming,
             _scn_partial_across_seal, _scn_partial_default, _scn_ttl]


def _close(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[5:] for s in SCENARIOS])
def test_upsert_matches_reference(tmp_path, scenario):
    jax_rows, torch_rows = (scenario(_ns(name), tmp_path / name)
                            for name in PKGS)
    assert _close(torch_rows, jax_rows), (torch_rows, jax_rows)


def test_upsert_known_answers(tmp_path):
    """Spot values of the reference's own upsert tests, on the port."""
    ns = _ns("torch")
    assert _scn_consuming(ns, tmp_path / "a")[:2] == [
        [(1, 12), (2, 20)], [(2, 32)]]
    assert _scn_consuming(ns, tmp_path / "b")[3] == [(5,)]
    assert _scn_dedup(ns, tmp_path / "c") == [[(3, 60)], [(4, 100)]]
    rows = _scn_partial_consuming(ns, tmp_path / "d")[0]
    assert rows == [(1, 15, "nyc", ("a", "b"), 300)]


@pytest.mark.parametrize("meta,ups", [(jmeta, jups), (tmeta, tups)],
                         ids=PKGS)
def test_bad_config_refused(meta, ups):
    with pytest.raises(ValueError, match="strategy"):
        meta.PartitionUpsertMetadataManager(ups.UpsertConfig(
            ["uid"], "ts", mode="partial",
            partial_strategies={"score": "bogus"}))
    with pytest.raises(ValueError, match="mode"):
        ups.UpsertConfig(["uid"], "ts", mode="nope")
    with pytest.raises(ValueError, match="ttl"):
        ups.UpsertConfig(["uid"], "ts", metadata_ttl=-1)


def test_upsert_and_dedup_together_refused(tmp_path):
    ns = _ns("torch")
    with pytest.raises(ValueError, match="not both"):
        _mgr(ns, tmp_path, ns.Stream(1), _schema(ns),
             upsert=ns.ups.UpsertConfig(["uid"]),
             dedup=ns.ups.DedupConfig(["uid"]))


def test_rollup_refused_on_invalidated_segment(tmp_path):
    """A rollup answers a segment until it has upsert-invalidated docs
    (its pre-aggregates hold the superseded rows); then the per-doc path
    answers, as in the JAX package."""
    import pinot_tpu.startree as jst
    import pinot_tpu_torch.startree as tst
    from pinot_tpu.query.context import build_query_context as jctx
    from pinot_tpu.query.sql import parse_sql as jparse
    from pinot_tpu_torch.query.context import build_query_context as tctx
    from pinot_tpu_torch.query.sql import parse_sql as tparse

    got = []
    for name, st, ctx_of, parse in (("jax", jst, jctx, jparse),
                                    ("torch", tst, tctx, tparse)):
        ns = _ns(name)
        d = ns.seg.SegmentBuilder(_schema(ns), ns.spi.TableConfig(
            "users")).build({"uid": np.array([1, 2, 1], np.int32),
                             "score": np.array([10, 20, 30], np.int32),
                             "ts": np.array([1, 1, 2], np.int64)},
                            str(tmp_path / name), "s0")
        st.build_rollup(ns.load(d), st.RollupConfig(
            dims=["uid"], metrics=[("sum", "score")]))
        seg = ns.load(d)
        ctx = ctx_of(parse("SELECT COUNT(*) FROM users"))
        answered = st.try_rollup_execute(ctx, seg) is not None
        seg.set_valid_docs(np.array([False, True, True]))
        refused = st.try_rollup_execute(ctx, seg) is None
        dm = ns.table("users")
        dm.add_segment(seg)
        got.append([answered, refused] + _q(
            ns, dm, "SELECT COUNT(*), SUM(score) FROM users"))
    assert got[1] == got[0] == [True, True, [(2, 50)]]


class _SeenLock:
    """A consuming segment's lock that records, at each release, what a
    reader taking the lock sees: the published docs, the valid ones among
    them and the distinct keys of those (consecutive repeats kept once)."""

    def __init__(self, seg, states):
        self._lock = threading.Lock()
        self._seg = seg
        self._states = states

    def __enter__(self):
        return self._lock.__enter__()

    def __exit__(self, *exc):
        seg = self._seg
        n = seg._count
        valid = np.asarray(seg._valid[:n])
        uids = np.asarray(seg._cols["uid"].values[:n])[valid]
        state = (n, int(valid.sum()), len(set(uids.tolist())))
        if n and (not self._states or self._states[-1] != state):
            self._states.append(state)
        return self._lock.__exit__(*exc)


@pytest.mark.parametrize("kind", ["upsert", "dedup"])
def test_readers_see_no_more_duplicates_than_the_reference(
        tmp_path, monkeypatch, kind):
    """Every state of the consuming segment a reader can see while one
    fetched batch is indexed. A full-upsert table shows the reference's
    states, so at most one superseded row beside its successor; a dedup
    table never shows a duplicate key, where the reference shows each for
    one row. Both end with one valid row per key."""
    rng = np.random.default_rng(29)
    n = 300
    rows = [{"uid": int(u), "score": int(v), "ts": 0}
            for u, v in zip(rng.integers(0, 40, n),
                            rng.integers(0, 1000, n))]
    seen = {}
    for name, mod in (("jax", jmanager), ("torch", tmanager)):
        ns = _ns(name)
        states = seen[name] = []

        class Recorded(mod.MutableSegment):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self._lock = _SeenLock(self, states)

        monkeypatch.setattr(mod, "MutableSegment", Recorded)
        stream = ns.Stream(1)
        for r in rows:
            stream.produce(r)
        cfg = (ns.ups.UpsertConfig(["uid"]) if kind == "upsert"
               else ns.ups.DedupConfig(["uid"]))
        _mgr(ns, tmp_path / name, stream, _schema(ns), threshold=1000,
             **{kind: cfg}).consume_once(0)
    keys = len({r["uid"] for r in rows})
    ref, port = seen["jax"], seen["torch"]
    assert port[-1] == ref[-1] == (n, keys, keys)
    assert max(v - k for _n, v, k in ref) == 1
    if kind == "upsert":
        assert port == ref
    else:
        assert all(v == k for _n, v, k in port)
