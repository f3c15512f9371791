"""Vector search through the port against the JAX package, on the CPU.

The same seeded rows (tools/vec.gen_clustered, 3000 x 12, 16 lists) go
through both packages:

- layout parity: both builders write byte-equal vector files, and the
  in-memory IVF build gives the same centroids, pages and pageptr
  bitwise; the readers' upload sets (``_host_arrays``) are equal;
- reader parity: ``search_batch`` (flat and IVF, cosine and l2, B in {1,
  3, 8}, k in {1, 5, 64, n}, nprobe in {1, default, n_lists}) gives the
  same scores within 1e-5 of the summed terms' magnitude (float32 sums in
  another order; for cosine the terms are at most 1, for l2 the expanded
  form 2 m.q - |m|^2 - |q|^2 cancels terms up to 4 max |v|^2), the same
  doc ids at every rank whose score is apart from its neighbours' by
  twice that, and -1/-inf at the same places; on duplicate rows and a
  zero query (the tie rule alone decides) the ids are exactly equal;
- broker parity over a two-segment table: plan kinds, rows for filter,
  ORDER BY and select-list scores, the exact probe against a float64
  numpy oracle, and the 8 structured errors as SqlError with the same
  message, never PlanError;
- the plane: one search per (query, segment) through the memo, the
  admission window fusing concurrent broker queries (rows equal to solo),
  a build race uploading once, a collected reader dropping its pool
  bytes, demotion / reconciliation / re-promotion, and a tier budget
  counting the ``vector`` pool.
"""
import gc
import threading

import numpy as np
import pytest

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.index.vector import VectorIndexReader as JaxReader
from pinot_tpu.query.context import build_query_context as j_ctx
from pinot_tpu.query.planner import SegmentPlanner as JPlanner
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu.segment import SegmentBuilder as JaxBuilder
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu.spi import Schema as JaxSchema, TableConfig as JaxConfig
from pinot_tpu_torch.broker import connect
from pinot_tpu_torch.engine import vector_exec as vx
from pinot_tpu_torch.engine.tier import global_tier, reconcile_devmem
from pinot_tpu_torch.index import vector as vix
from pinot_tpu_torch.index.vector import VectorIndexReader
from pinot_tpu_torch.query.context import build_query_context as t_ctx
from pinot_tpu_torch.query.planner import PlanError, SegmentPlanner
from pinot_tpu_torch.query.sql import SqlError, parse_sql as t_parse
from pinot_tpu_torch.tools import vec
from pinot_tpu_torch.utils.devmem import global_device_memory
from pinot_tpu_torch.utils.metrics import global_metrics

from test_torch_tier import reset_port_memory

N, DIM, LISTS, K = 3000, 12, 16, 5
COLS = {"emb": (DIM, "cosine", 3), "emb_l2": (DIM, "l2", 4)}


def _gen(seed, rows=N, dim=DIM):
    return vec.gen_clustered(rows, dim, 8, seed, n_queries=8)


def _term_scale(m, qs, metric):
    """1 for cosine; 4 max(|m|^2, |q|^2) for l2 (module doc)."""
    if metric == "cosine":
        return 1.0
    sq = max(float((m.astype(np.float64) ** 2).sum(1).max()),
             float((np.asarray(qs, np.float64) ** 2).sum(1).max()))
    return 4.0 * max(sq, 1.0)


def _assert_search_equal(got, want, scale, tol=1e-5):
    (gs, gd), (ws, wd) = got, want
    assert gs.shape == ws.shape and gd.shape == wd.shape
    fin = np.isfinite(ws)
    assert np.array_equal(fin, np.isfinite(gs))
    assert np.array_equal(gd < 0, wd < 0)
    assert np.allclose(gs[fin], ws[fin], rtol=0, atol=tol * scale)
    with np.errstate(invalid="ignore"):     # -inf - -inf: not apart
        gap = np.abs(np.diff(ws.astype(np.float64), axis=1)) \
            > 2 * tol * scale
    lo = np.concatenate([np.ones_like(gap[:, :1]), gap], axis=1)
    # the last rank's successor is not shown: never compared
    hi = np.concatenate([gap, np.zeros_like(gap[:, :1])], axis=1)
    assert np.array_equal(gd[lo & hi], wd[lo & hi])


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The two-segment table built by each package's builder, served by
    each package's broker (the port's on the CPU)."""
    cols, queries = vec.vec_table(N, COLS, n_queries=8)
    out = tmp_path_factory.mktemp("vt")
    tdirs = vec.build_table(str(out / "torch"), cols, columns=COLS,
                            n_lists=LISTS)
    schema, cfg = vec.schema_and_config(COLS, N // 2, LISTS)
    jb = JaxBuilder(JaxSchema.from_dict(schema.to_dict()),
                    JaxConfig.from_dict(cfg.to_dict()))
    jdirs = [jb.build({k: v[i * N // 2:(i + 1) * N // 2]
                       for k, v in cols.items()}, str(out / "jax"),
                      f"vt_{i}") for i in range(2)]
    tbroker = vec.load_broker(tdirs, "cpu")
    jbroker = JaxBroker()
    jdm = JaxTable("vt")
    for d in jdirs:
        jdm.add_segment_dir(d)
    jbroker.register_table(jdm)
    segs = tbroker.table("vt").acquire_segments()
    yield {"cols": cols, "queries": queries, "tdirs": tdirs, "jdirs": jdirs,
           "tb": tbroker, "jb": jbroker, "segs": segs}
    reset_port_memory(segs)


@pytest.fixture(autouse=True)
def _port_memory(request):
    """Start and end from devmem-synced residency: the suite's conftest
    resets the JAX package's registries only."""
    segs = request.getfixturevalue("tables")["segs"] \
        if "tables" in request.fixturenames else []
    reset_port_memory(segs)
    vx.clear_memo()
    yield
    vx.global_vector_batcher.configure(enabled=True, window_ms=2.0)
    reset_port_memory(segs)


# ---------------------------------------------------------------------------
# layout parity
# ---------------------------------------------------------------------------

def test_vector_files_byte_equal(tables):
    import json
    import os
    for td, jd in zip(tables["tdirs"], tables["jdirs"]):
        names = sorted(os.listdir(jd))
        assert names == sorted(os.listdir(td))
        vec_files = [f for f in names if ".vec." in f]
        assert len(vec_files) == 2 * 4      # matrix, cent, pages, pageptr
        for f in names:
            if f == "metadata.json":
                tm, jm = (json.load(open(os.path.join(d, f)))
                          for d in (td, jd))
                assert tm["columns"] == jm["columns"]
                continue
            with open(os.path.join(td, f), "rb") as a, \
                    open(os.path.join(jd, f), "rb") as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_ivf_build_and_upload_set_bitwise(metric):
    m, _ = _gen(21)
    t = VectorIndexReader.from_matrix(m, metric, device="cpu").build_ivf(
        n_lists=LISTS, seed=7)
    j = JaxReader.from_matrix(m, metric).build_ivf(n_lists=LISTS, seed=7)
    for key in ("centroids", "pages", "pageptr"):
        assert t.ivf[key].dtype == j.ivf[key].dtype
        assert t.ivf[key].tobytes() == j.ivf[key].tobytes()
    assert t.nprobe_default == j.nprobe_default
    th, jh = t._host_arrays(), j._host_arrays()
    assert sorted(th) == sorted(jh)
    for key in jh:
        assert th[key].dtype == jh[key].dtype and th[key].shape == \
            jh[key].shape, key
        assert th[key].tobytes() == jh[key].tobytes(), key
    for nprobe in (1, 2, 5):
        assert t.max_pages_for(nprobe) == j.max_pages_for(nprobe)


# ---------------------------------------------------------------------------
# reader parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("nprobe", [1, "default", LISTS])
def test_search_batch_matches_jax(metric, nprobe):
    m, qs = _gen(31)
    t = VectorIndexReader.from_matrix(m, metric, device="cpu").build_ivf(
        n_lists=LISTS, seed=7)
    j = JaxReader.from_matrix(m, metric).build_ivf(n_lists=LISTS, seed=7)
    npb = t.nprobe_default if nprobe == "default" else nprobe
    scale = _term_scale(m, qs, metric)
    for b in (1, 3, 8):
        for k in (1, K, 64, N):
            got = t.search_batch(qs[:b], k, npb)
            _assert_search_equal(got, j.search_batch(qs[:b], k, npb), scale)
            if b == 8 and k == 64:
                # batched == solo, bitwise
                for i in (0, 5):
                    s, d = t.search_batch(qs[i:i + 1], k, npb)
                    assert s.tobytes() == got[0][i:i + 1].tobytes()
                    assert np.array_equal(d, got[1][i:i + 1])


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("case", ["duplicates", "zero-query"])
def test_tie_rule_matches_jax_exactly(metric, case):
    m, qs = _gen(41)
    if case == "duplicates":
        m[1::2] = m[0::2][: N // 2]
    else:
        qs[:3] = 0.0
    t = VectorIndexReader.from_matrix(m, metric, device="cpu").build_ivf(
        n_lists=LISTS, seed=7)
    j = JaxReader.from_matrix(m, metric).build_ivf(n_lists=LISTS, seed=7)
    for nprobe in (None, LISTS):
        (ts, td), (js, jd) = (r.search_batch(qs[:3], 64, nprobe)
                              for r in (t, j))
        assert np.array_equal(td, jd)
        assert np.allclose(ts, js, rtol=0,
                           atol=1e-5 * _term_scale(m, qs, metric))


def test_tiny_layout_pads_misses_like_jax():
    """k_pad past max_pages x 64: one list's probe has 8 pages (512
    slots) for k = 1000, so both pad with (-inf, -1) at the same
    places."""
    m, qs = _gen(51)
    t = VectorIndexReader.from_matrix(m, device="cpu").build_ivf(
        n_lists=16, seed=7)
    j = JaxReader.from_matrix(m).build_ivf(n_lists=16, seed=7)
    assert t.max_pages_for(1) * 64 < 1000
    got, want = t.search_batch(qs[:2], 1000, 1), j.search_batch(qs[:2],
                                                                 1000, 1)
    assert got[0].shape == (2, 1000) and (got[1] < 0).any()
    _assert_search_equal(got, want, 1.0)


# ---------------------------------------------------------------------------
# broker parity
# ---------------------------------------------------------------------------

def _rows(res):
    return [tuple(r) for r in res.rows]


@pytest.mark.parametrize("col", list(COLS))
def test_plan_kinds_golden(tables, col):
    q = tables["queries"][col][0]
    vs = vec.vs(col, q, K)
    jseg = tables["jb"].table("vt").acquire_segments()[0]
    tseg = tables["segs"][0]
    for sql, kind in ((f"SELECT SUM(views) FROM vt WHERE {vs}", "kernel"),
                      (f"SELECT id FROM vt WHERE {vs} LIMIT {K}", "kselect"),
                      (f"SELECT id FROM vt WHERE {vs} ORDER BY {vs} DESC "
                       f"LIMIT {K}", "host")):
        assert JPlanner(j_ctx(j_parse(sql)), jseg).plan().kind == kind
        assert SegmentPlanner(t_ctx(t_parse(sql)), tseg).plan().kind == kind


@pytest.mark.parametrize("col", list(COLS))
@pytest.mark.parametrize("nprobe", [None, 4, LISTS])
def test_rows_match_jax(tables, col, nprobe):
    for q in tables["queries"][col][:2]:
        vs = vec.vs(col, q, K, nprobe)
        for sql in (f"SELECT id, {vs} AS score FROM vt WHERE {vs} "
                    f"ORDER BY {vs} DESC LIMIT {K}",
                    f"SELECT SUM(views), COUNT(*) FROM vt WHERE {vs}",
                    f"SELECT id FROM vt WHERE {vs} ORDER BY id LIMIT 20"):
            assert _rows(connect(tables["tb"])(sql)) == \
                _rows(tables["jb"].query(sql)), sql


@pytest.mark.parametrize("col", list(COLS))
def test_exact_probe_matches_numpy_oracle(tables, col):
    """nprobe >= n_lists is the exact scan: the two-segment merge equals
    a float64 oracle's top-k where its scores are apart."""
    dim, metric, _ = COLS[col]
    m = tables["cols"][col].astype(np.float64)
    for q in tables["queries"][col][:3]:
        vs = vec.vs(col, q, 10, LISTS)
        got = [r[0] for r in connect(tables["tb"])(
            f"SELECT id FROM vt WHERE {vs} ORDER BY {vs} DESC LIMIT 10").rows]
        q64 = np.float32(q).astype(np.float64)
        if metric == "cosine":
            s = (m / np.linalg.norm(m, axis=1, keepdims=True)) @ \
                (q64 / np.linalg.norm(q64))
        else:
            s = -((m - q64) ** 2).sum(1)
        order = np.argsort(-s, kind="stable")[:11]
        gaps = np.abs(np.diff(s[order])) > 1e-4
        for r in range(10):
            if (r == 0 or gaps[r - 1]) and gaps[r]:
                assert got[r] == order[r]


BAD = [
    ("VECTOR_SIMILARITY(emb, ARRAY[1.0, 2.0], 3)", "dim mismatch"),
    ("VECTOR_SIMILARITY(emb, ARRAY[%s], 0)", "topK must be a positive"),
    ("VECTOR_SIMILARITY(emb, ARRAY[%s], -2)", "topK must be a positive"),
    ("VECTOR_SIMILARITY(views, ARRAY[%s], 3)", "requires a vector index"),
    ("VECTOR_SIMILARITY(emb, ARRAY['a', 'b'], 3)", "numeric ARRAY"),
    ("VECTOR_SIMILARITY(emb, ARRAY[], 3)", "numeric ARRAY"),
    ("VECTOR_SIMILARITY(emb, ARRAY[%s], 3, 0)", "nprobe must be a positive"),
    ("VECTOR_SIMILARITY(emb, 42, 3)", "ARRAY"),
]


@pytest.mark.parametrize("expr,msg", BAD)
def test_structured_errors_match_jax(tables, expr, msg):
    arr = ", ".join(str(float(x)) for x in tables["queries"]["emb"][0])
    expr = expr % arr if "%s" in expr else expr
    for sql in (f"SELECT id FROM vt WHERE {expr} LIMIT 3",
                f"SELECT id FROM vt ORDER BY {expr} DESC LIMIT 3",
                f"SELECT {expr} FROM vt LIMIT 3"):
        with pytest.raises(SqlError, match=msg) as got:
            connect(tables["tb"])(sql)
        assert not isinstance(got.value, PlanError)
        with pytest.raises(Exception) as want:
            tables["jb"].query(sql)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

def _counter(name):
    return global_metrics.snapshot()["counters"].get(name, 0)


def test_memo_one_search_per_query_segment(tables):
    q = tables["queries"]["emb"][3]
    vs = vec.vs("emb", q, K)
    c0 = _counter("vector_searches")
    connect(tables["tb"])(f"SELECT id, {vs} AS score FROM vt WHERE {vs} "
                          f"ORDER BY {vs} DESC LIMIT {K}")
    assert _counter("vector_searches") - c0 == len(tables["segs"])


def test_admission_window_fuses_concurrent_broker_queries(tables):
    sqls = [f"SELECT id, {vec.vs('emb', q, K)} AS score FROM vt WHERE "
            f"{vec.vs('emb', q, K)} ORDER BY {vec.vs('emb', q, K)} DESC "
            f"LIMIT {K}" for q in tables["queries"]["emb"][:4]]
    tb = tables["tb"]
    solo = [_rows(connect(tb)(s)) for s in sqls]
    vx.global_vector_batcher.configure(enabled=True, window_ms=250.0)
    c0 = _counter("vector_batched_dispatches")
    results, errors = [None] * 4, []
    barrier = threading.Barrier(4)

    def run(i):
        try:
            barrier.wait(timeout=10)
            results[i] = _rows(connect(tb)(sqls[i]))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert _counter("vector_batched_dispatches") > c0
    assert results == solo


def test_build_race_uploads_once(tables):
    reader = tables["segs"][0].index_reader("emb", "vector")
    reader.evict_device()
    base = global_device_memory.pool_bytes("vector")
    barrier = threading.Barrier(6)

    def up():
        barrier.wait(timeout=10)
        reader.ensure_device()

    threads = [threading.Thread(target=up) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    added = global_device_memory.pool_bytes("vector") - base
    assert added == reader.device_bytes() > 0


def test_gc_without_evict_drops_pool_bytes():
    m, _ = _gen(13, rows=256, dim=8)
    reader = VectorIndexReader.from_matrix(m, device="cpu")
    reader.ensure_device()
    nbytes = reader.device_bytes()
    base = global_device_memory.pool_bytes("vector")
    assert nbytes > 0 and base >= nbytes
    del reader
    gc.collect()
    vix.live_readers()      # drains the dead-entry queue
    assert global_device_memory.pool_bytes("vector") == base - nbytes


def _reconciled(segs):
    rec = reconcile_devmem(segs)
    return all(r["tracked"] == r["actual"] for r in rec.values()), rec


def test_demote_reconciles_and_repromotes(tables):
    tb, seg = tables["tb"], tables["segs"][0]
    reader = seg.index_reader("emb", "vector")
    vs = vec.vs("emb", tables["queries"]["emb"][5], K)
    sql = f"SELECT id FROM vt WHERE {vs} ORDER BY {vs} DESC LIMIT {K}"
    before = _rows(connect(tb)(sql))
    assert reader.device_bytes() > 0
    ok, rec = _reconciled(tables["segs"])
    assert ok and rec["vector"]["actual"] > 0, rec
    seg.demote_device()
    assert reader.device_bytes() == 0
    ok, rec = _reconciled(tables["segs"])
    assert ok, rec
    vx.clear_memo()
    assert _rows(connect(tb)(sql)) == before
    assert reader.device_bytes() > 0
    assert _reconciled(tables["segs"])[0]


def test_tier_budget_counts_vector_pool(tables):
    tb = tables["tb"]
    vs = vec.vs("emb_l2", tables["queries"]["emb_l2"][6], K)
    sql = f"SELECT id FROM vt WHERE {vs} ORDER BY {vs} DESC LIMIT {K}"
    before = _rows(connect(tb)(sql))
    vec_bytes = global_device_memory.pool_bytes("vector")
    assert vec_bytes > global_device_memory.pool_bytes("segment_cols")
    d0 = global_tier.demotions
    try:
        # a budget the segment columns alone fit, the vector pool not
        global_tier.configure(budget_bytes=vec_bytes // 4)
        vx.clear_memo()
        after = _rows(connect(tb)(sql))
    finally:
        global_tier.configure(budget_bytes=None)
    assert after == before
    assert global_tier.demotions > d0
