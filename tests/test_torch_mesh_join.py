"""The mesh plane's exchanges and joins: the JAX package against the port.

The JAX side runs on the suite's 8 virtual CPU devices (``segment_mesh(n)``
for n in 1, 2, 4, 8), the port on a mesh of n logical shards on the CPU
(``logical_mesh(n, "cpu")``), where ``hash_partition`` runs its plain
version. The same numpy inputs go to both.

- ``hash_partition`` (the hand-written kernel's function) against the
  per-device buckets and overflow flag of ``_shuffle_exchange_jit``,
  bitwise: after the reference's ``all_to_all`` shard d holds ``[src 0's
  bucket d; src 1's bucket d; ...]``, so each source's buckets are read
  back out of it. Cases: random codes with -1 (no partition), one hot
  partition that overflows, the cap at the run length exactly (no
  overflow) and one below it, int64 row ids.
- ``mesh_shuffle_join`` / ``mesh_equi_join`` pairs and their order
  bitwise, and None on the same overflowing inputs.
- The star schema of ``test_torch_multistage.py`` at 8 shards against the
  JAX executor: the mailbox plane's backends by name (``mesh_broadcast``,
  ``mesh_shuffle``), the fused plane's ``hash`` kind (``PINOT_FUSED_
  HASH_MIN=0`` and no broadcast threshold, as the reference's
  ``test_hash_exchange_parity`` sets them), rows equal to a relative 1e-9;
  a port-built ``hash`` plan through the PV201/PV202 checks.
- Without a mesh asked for, the port keeps one shard: no mesh backend and
  no ``hash`` stage.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pinot_tpu.broker import Broker as JaxBroker
from pinot_tpu.multistage import executor as jexec
from pinot_tpu.multistage.executor import MultiStageExecutor as JaxExec
from pinot_tpu.ops import join as jjoin
from pinot_tpu.parallel.mesh import segment_mesh as jax_mesh
from pinot_tpu.query.sql import parse_sql as j_parse
from pinot_tpu.server import TableDataManager as JaxTable
from pinot_tpu_torch.analysis.plan_verify import verify_fused_plan
from pinot_tpu_torch.broker import Broker, connect
from pinot_tpu_torch.multistage import device_join, fused
from pinot_tpu_torch.multistage import executor as texec
from pinot_tpu_torch.multistage.executor import MultiStageExecutor
from pinot_tpu_torch.multistage.relation import Relation
from pinot_tpu_torch.ops import hashpart
from pinot_tpu_torch.ops import join as tjoin
from pinot_tpu_torch.parallel import collectives, logical_mesh, using_mesh
from pinot_tpu_torch.query.sql import parse_sql
from pinot_tpu_torch.server import TableDataManager
from test_torch_multistage import JOIN_SQL, PLANES, THRESHOLDS, \
    same_rows, star_schema

SHARDS = (1, 2, 4, 8)


def _jax_exchange(codes: np.ndarray, ids: np.ndarray, n: int, cap: int):
    """The reference's exchange on n devices -> (per-source buckets
    (n_src, n_dev, cap) of codes and ids, overflow per device)."""
    mesh = jax_mesh(n)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P("seg")))  # noqa
    rc, ri, ovf = jjoin._shuffle_exchange_jit(put(codes), put(ids), n, cap,
                                              mesh)
    # received on device d: [src 0's bucket d; src 1's bucket d; ...]
    rc = np.asarray(rc).reshape(n, n, cap).transpose(1, 0, 2)
    ri = np.asarray(ri).reshape(n, n, cap).transpose(1, 0, 2)
    return rc, ri, np.asarray(ovf)


def _port_partitions(codes: np.ndarray, ids: np.ndarray, n: int, cap: int):
    m = len(codes) // n
    out = [hashpart.hash_partition(
        torch.from_numpy(codes[s * m:(s + 1) * m]),
        (torch.from_numpy(ids[s * m:(s + 1) * m]),), n, cap)
        for s in range(n)]
    return (np.stack([b[0].numpy() for b, _o in out]),
            np.stack([b[1].numpy() for b, _o in out]),
            np.array([bool(o) for _b, o in out]))


def _same_exchange(codes, ids, n, cap):
    jc, ji, jo = _jax_exchange(codes, ids, n, cap)
    tc, ti, to = _port_partitions(codes, ids, n, cap)
    assert tc.dtype == np.int32 and ti.dtype == np.int64
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(to, jo)
    return to


@pytest.mark.parametrize("n", SHARDS)
def test_hash_partition_matches_shuffle_exchange(n):
    rng = np.random.default_rng(200 + n)
    m = 64 * n            # the shapes and cap of the next test (one compile)
    codes = rng.integers(-1, 300, m).astype(np.int32)
    codes[::7] = -1                       # no partition, never written
    ids = rng.permutation(m).astype(np.int64)
    assert not _same_exchange(codes, ids, n, 64).any()


@pytest.mark.parametrize("n", SHARDS)
def test_hash_partition_hot_partition_and_cap_edges(n):
    """Every row of every shard on one code: one partition holds the
    whole shard. At cap == the run length nothing overflows; at half of
    it every shard overflows, and the buckets still agree."""
    m = 64
    codes = np.full(m * n, 12345, dtype=np.int32)
    ids = np.arange(m * n, dtype=np.int64) + (1 << 40)   # past int32
    assert not _same_exchange(codes, ids, n, m).any()
    assert _same_exchange(codes, ids, n, m // 2).all()


def test_hash_partition_edges_and_checks():
    """n = 0 and 1 rows, all rows without a partition, 64 partitions, and
    the wrapper's refusals."""
    for codes in ([], [7], [-1, -1, -1, -1]):
        c = torch.tensor(codes, dtype=torch.int32)
        (b, i), ovf = hashpart.hash_partition(
            c, (torch.arange(len(codes), dtype=torch.int64),), 64, 4)
        assert b.shape == (64, 4) and i.dtype == torch.int64
        assert int((b >= 0).sum()) == int((c >= 0).sum()) and not ovf
    with pytest.raises(ValueError):
        hashpart.hash_partition(torch.zeros(4, dtype=torch.int64), (), 2, 4)
    with pytest.raises(ValueError):
        hashpart.hash_partition(torch.zeros(4, dtype=torch.int32), (), 65, 4)
    with pytest.raises(ValueError):
        hashpart.hash_partition(torch.zeros(4, dtype=torch.int32), (), 2, 6)


def test_splitmix32_matches_the_reference():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(0, 2**31 - 1, 5000),
                        [0, 1, 2**16, 2**31 - 1]]).astype(np.int32)
    want = np.asarray(jjoin._splitmix32(jax.numpy.asarray(x)))
    got = hashpart.splitmix32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_collectives_layout():
    """all_to_all is source-major on the receiver; all_reduce combines in
    shard order with the dtype kept."""
    shards = [torch.arange(8, dtype=torch.int32).reshape(4, 2) + 100 * s
              for s in range(4)]
    got = collectives.all_to_all(shards)
    for d in range(4):
        want = torch.stack([shards[s][d] for s in range(4)])
        assert torch.equal(got[d], want)
    vals = [torch.tensor([1, -5], dtype=torch.int32),
            torch.tensor([7, 2], dtype=torch.int32)]
    assert collectives.all_reduce("sum", vals)[1].tolist() == [8, -3]
    assert collectives.all_reduce("min", vals)[0].tolist() == [1, -5]
    assert collectives.all_reduce("max", vals)[0].dtype == torch.int32
    flags = [torch.tensor([True, False]), torch.tensor([False, False])]
    assert collectives.all_reduce("or", flags)[1].tolist() == [True, False]


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_joins_match_jax(n):
    rng = np.random.default_rng(300 + n)
    # both sides of one length: one exchange program a side in each package
    lk = rng.integers(0, 300, 2001).astype(np.int32)
    rk = rng.integers(0, 600, 2001).astype(np.int32)
    lk[::11] = -1
    mesh = logical_mesh(n, "cpu")
    want = jjoin.mesh_shuffle_join(jax_mesh(n), lk, rk, 16)
    got = tjoin.mesh_shuffle_join(mesh, lk, rk, 16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    jm, jr = jjoin.mesh_equi_join(jax_mesh(n), lk, rk, 16)
    tm, tr = tjoin.mesh_equi_join(mesh, lk, rk, 16)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("n", (2, 4, 8))
def test_mesh_shuffle_join_overflow_is_none(n):
    lk = np.full(2000, 5, dtype=np.int32)        # one hot partition
    rk = np.arange(40, dtype=np.int32)
    assert jjoin.mesh_shuffle_join(jax_mesh(n), lk, rk, 1, slack=0.5) \
        is None
    assert tjoin.mesh_shuffle_join(logical_mesh(n, "cpu"), lk, rk, 1,
                                   slack=0.5) is None


# ---------------------------------------------------------------------------
# the multi-stage engine at 8 shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def brokers(tmp_path_factory):
    dirs = star_schema(str(tmp_path_factory.mktemp("mesh_star")))
    jb, tb = JaxBroker(), Broker(device="cpu")
    for name, ds in dirs.items():
        jdm, dm = JaxTable(name), TableDataManager(name, device="cpu")
        for d in ds:
            jdm.add_segment_dir(d)
            dm.add_segment_dir(d)
        jb.register_table(jdm)
        tb.register_table(dm)
    return jb, tb


@pytest.fixture(autouse=True)
def _device_paths(monkeypatch):
    for k in THRESHOLDS:
        monkeypatch.setenv(k, "0")
    monkeypatch.setenv("PINOT_CPU_FAST_GROUPBY", "1")


def _backends(brokers, sql):
    """(port backends, JAX backends, port rows, JAX rows) of one query,
    the port on 8 logical shards."""
    jb, tb = brokers
    jex = JaxExec(jb, j_parse(sql))
    jrows = jex.execute().rows
    with using_mesh(logical_mesh(8, "cpu")):
        ex = MultiStageExecutor(tb, parse_sql(sql))
        rows = ex.execute().rows
    return ex.join_backends, jex.join_backends, rows, jrows


@pytest.mark.parametrize("name", ["dup_build", "three_way", "left_rows"])
def test_mesh_broadcast_backend_matches_jax(brokers, name):
    d0 = device_join.STATS["mesh_joins"]
    got, want, rows, jrows = _backends(brokers, JOIN_SQL[name] + PLANES[1])
    assert got == want and set(got) == {"mesh_broadcast"}
    assert device_join.STATS["mesh_joins"] == d0 + len(got)
    same_rows(rows, jrows)


@pytest.mark.parametrize("name", ["inner_gb", "inner_rows"])
def test_mesh_shuffle_backend_matches_jax(brokers, monkeypatch, name):
    monkeypatch.setattr(jexec, "BROADCAST_THRESHOLD", 100)
    monkeypatch.setattr(texec, "BROADCAST_THRESHOLD", 100)
    got, want, rows, jrows = _backends(brokers, JOIN_SQL[name] + PLANES[1])
    assert got == want == ["mesh_shuffle"]
    same_rows(rows, jrows)


def _kinds(monkeypatch):
    """Spy on the port's plan_fused: every fused plan's stage kinds and
    IR."""
    seen = []
    real = fused.plan_fused

    def spy(*a, **kw):
        plan, stages, reason = real(*a, **kw)
        if plan is not None:
            seen.append(([s.kind for s in stages], plan))
        return plan, stages, reason

    monkeypatch.setattr(fused, "plan_fused", spy)
    return seen


@pytest.mark.parametrize("name", ["inner_rows", "three_way"])
def test_fused_hash_kind_matches_jax(brokers, monkeypatch, name):
    jb, tb = brokers
    sql = JOIN_SQL[name] + PLANES[0]
    monkeypatch.setenv("PINOT_FUSED_HASH_MIN", "0")
    monkeypatch.setattr(jexec, "BROADCAST_THRESHOLD", 0)
    monkeypatch.setattr(texec, "BROADCAST_THRESHOLD", 0)
    seen = _kinds(monkeypatch)
    f0 = dict(fused.STATS)
    want = jb.query(sql).rows
    with using_mesh(logical_mesh(8, "cpu")):
        got = connect(tb)(sql).rows
    same_rows(got, want)
    assert seen and "hash" in seen[-1][0]
    assert fused.STATS["fused_plans"] == f0["fused_plans"] + 1
    assert seen[-1][1].partitions == 8


def test_fused_hash_overflow_retries_then_falls_back(brokers, monkeypatch):
    """A tight slack overflows a bucket: one retry at doubled slack, then
    the mailbox plane; rows unchanged either way."""
    jb, tb = brokers
    sql = JOIN_SQL["inner_gb"] + PLANES[0]
    monkeypatch.setenv("PINOT_FUSED_HASH_MIN", "0")
    monkeypatch.setattr(texec, "BROADCAST_THRESHOLD", 0)
    want = jb.query(sql).rows
    # 512 live probe rows a shard into 8 buckets: a cap of 64 (the least
    # that covers the shard, PV202) overflows, 128 does not; slack 0.5
    # gives 64 and its retry at 1.0 128, slack 0.3 and its retry at 0.6
    # both give 64
    for slack, served in (("0.5", "fused_plans"),
                          ("0.3", "fused_fallbacks")):
        monkeypatch.setenv("PINOT_FUSED_SLACK", slack)
        f0 = dict(fused.STATS)
        with using_mesh(logical_mesh(8, "cpu")):
            same_rows(connect(tb)(sql).rows, want)
        assert fused.STATS["fused_overflow"] >= f0["fused_overflow"] + 1
        assert fused.STATS[served] == f0[served] + 1


def test_port_hash_plan_through_plan_verify(brokers, monkeypatch):
    """A port-built hash plan verifies clean; a bucket cap that cannot
    cover its shard is PV202, a cap that is not a power of two PV201."""
    _jb, tb = brokers
    monkeypatch.setenv("PINOT_FUSED_HASH_MIN", "0")
    monkeypatch.setattr(texec, "BROADCAST_THRESHOLD", 0)
    seen = _kinds(monkeypatch)
    with using_mesh(logical_mesh(4, "cpu")):
        connect(tb)(JOIN_SQL["inner_gb"] + PLANES[0])
    kinds, plan = seen[-1]
    assert kinds == ["hash"] and plan.partitions == 4
    assert not [d for d in verify_fused_plan(plan)
                if d.severity == "error"]
    st = plan.stages[0]
    for cap, rule in ((4, "PV202"), (st.exchange.cap + 1, "PV201")):
        bad = dataclasses.replace(plan, stages=(dataclasses.replace(
            st, exchange=dataclasses.replace(st.exchange, cap=cap)),))
        assert rule in {d.rule for d in verify_fused_plan(bad)}


def test_one_shard_keeps_the_one_device_planes(brokers, monkeypatch):
    """With no mesh asked for the port has one shard: the shuffle join
    returns None, the fused plane takes no hash stage, broadcast joins
    stay on the one-device K16."""
    _jb, tb = brokers
    rng = np.random.default_rng(5)
    left = Relation({"l.k": rng.integers(0, 50, 500).astype(np.int64)})
    right = Relation({"r.k": rng.integers(0, 50, 90).astype(np.int64)})
    assert device_join.try_mesh_shuffle_join(
        left, right, ["l.k"], ["r.k"], torch.device("cpu")) is None
    ex = MultiStageExecutor(tb, parse_sql(JOIN_SQL["dup_build"]
                                          + PLANES[1]))
    ex.execute()
    assert ex.join_backends == ["device"]
    monkeypatch.setenv("PINOT_FUSED_HASH_MIN", "0")
    monkeypatch.setattr(texec, "BROADCAST_THRESHOLD", 0)
    seen = _kinds(monkeypatch)
    connect(tb)(JOIN_SQL["inner_gb"] + PLANES[0])
    assert seen and "hash" not in seen[-1][0]
    assert seen[-1][1].partitions == 1
