"""Multi-stage stage dispatch of the port against the JAX package, on the CPU.

The stage plans and mailbox frames of ``multistage/dispatch`` (proto3
messages of the reference's ``protos/plan.proto``, through the port's
copy of its gencode) are byte-equal to the reference's and each package
reads the other's; ``distributed_join`` over two port server nodes
(``ServerNode(device="cpu")``: leaf scans through the server's executor,
join stages through the port's ``hash_join``) returns the reference's
rows for inner and left joins, over tables on one server each and over a
table split across both.
"""
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the engine)

import pinot_tpu.cluster as jcluster
import pinot_tpu.multistage.dispatch as jdisp
import pinot_tpu.multistage.exchange as jex
import pinot_tpu.multistage.relation as jrel
import pinot_tpu.segment as jseg
import pinot_tpu.spi as jspi
import pinot_tpu_torch.cluster as tcluster
import pinot_tpu_torch.multistage.dispatch as tdisp
import pinot_tpu_torch.multistage.exchange as tex
import pinot_tpu_torch.multistage.relation as trel
from pinot_tpu_torch.utils import leak

SPECS = [
    {"kind": "leaf", "queryId": "q1", "sql": "SELECT a, b FROM t",
     "alias": "t", "exchange": {
         "type": "hash", "keys": ["t.a", "t.b"], "stage": 1,
         "targets": [{"url": "http://127.0.0.1:1", "worker": 0},
                     {"url": "http://127.0.0.1:2", "worker": 1}]}},
    {"kind": "leaf", "queryId": "q1", "sql": "SELECT a FROM t",
     "alias": None, "exchange": {
         "type": "broadcast", "keys": [], "stage": 2,
         "targets": [{"url": "u", "worker": 0}]}},
    {"kind": "leaf", "queryId": "", "sql": "SELECT 'é' FROM t",
     "alias": "x", "exchange": {
         "type": "hash", "keys": ["x.k"], "stage": 0,
         "targets": [{"url": "v", "worker": 300}]}},
    {"kind": "join", "queryId": "q2", "worker": 0, "leftStage": 1,
     "rightStage": 2, "leftKeys": ["a"], "rightKeys": ["b"], "how": "left",
     "nLeftSenders": 2, "nRightSenders": 3, "timeoutSec": 60.0},
    {"kind": "join", "queryId": "q2", "worker": 3, "leftStage": 1,
     "rightStage": 2, "leftKeys": ["a", "c"], "rightKeys": ["b", "d"],
     "how": "full", "nLeftSenders": 0, "nRightSenders": 200,
     "timeoutSec": 2.5},
    {"kind": "join", "queryId": "q3", "worker": -1, "leftStage": 1,
     "rightStage": 2, "leftKeys": ["a"], "rightKeys": ["b"],
     "how": "inner", "nLeftSenders": 1, "nRightSenders": 1,
     "timeoutSec": 0.125},
]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_stage_plans_are_the_reference_bytes(i):
    spec = SPECS[i]
    jb, tb = jdisp.encode_stage_plan(spec), tdisp.encode_stage_plan(spec)
    assert tb == jb
    assert tdisp.decode_stage_plan(jb) == jdisp.decode_stage_plan(jb)
    assert jdisp.decode_stage_plan(tb) == tdisp.decode_stage_plan(tb)
    with pytest.raises(ValueError):
        tdisp.decode_stage_plan(b"\x0a\x01q")     # a plan without a node


def _rel(mod):
    names = np.empty(4, dtype=object)
    names[:] = ["a", "bb", None, "dé"]
    return mod.Relation({"t.k": np.array([3, 1, 4, 1], dtype=np.int64),
                         "t.name": names},
                        {"t.name": np.array([0, 0, 1, 0], dtype=bool)},
                        "t")


@pytest.mark.parametrize("eos", [False, True])
def test_mailbox_frames_cross_packages(eos):
    """A frame (a relation block or EOS) is the reference's bytes, and
    each package's MailboxService takes the other's frames."""
    jf = jdisp.encode_mailbox_frame("qq", 2, 5,
                                    None if eos else _rel(jrel))
    tf = tdisp.encode_mailbox_frame("qq", 2, 5,
                                    None if eos else _rel(trel))
    assert tf == jf
    for frame, svc, disp in ((jf, tex.MailboxService(), tdisp),
                             (tf, jex.MailboxService(), jdisp)):
        disp.deliver_mailbox_frame(svc, frame)
        if not eos:
            disp.deliver_mailbox_frame(
                svc, disp.encode_mailbox_frame("qq", 2, 5, None))
        blocks = svc.mailbox("qq", 2, 5).drain(5.0, n_eos=1)
        svc.release_one("qq", 2, 5)
        if eos:
            assert blocks == []
        else:
            (got,) = blocks
            assert list(got.data) == ["t.k", "t.name"]
            assert list(got.data["t.k"]) == [3, 1, 4, 1]
            assert list(got.data["t.name"]) == ["a", "bb", None, "dé"]
            assert list(got.nulls["t.name"]) == [False, False, True, False]


def _pkg(name):
    if name == "jax":
        return SimpleNamespace(cluster=jcluster, disp=jdisp, server=lambda
                               i, url: jcluster.ServerNode(
                                   i, url, poll_interval=0.1))
    return SimpleNamespace(cluster=tcluster, disp=tdisp, server=lambda
                           i, url: tcluster.ServerNode(
                               i, url, poll_interval=0.1, device="cpu"))


def _hosted(server, table):
    dm = server._tables.get(table)
    return len(dm.acquire_segments()) if dm is not None else 0


def _wait_assigned(servers, table, n):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if sum(_hosted(s, table) for s in servers) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"segments of {table} never assigned")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """{table: (schema dict, [segment dirs])}: the reference test's
    orders (in two segments) and customers, and its l / r pair."""
    out = str(tmp_path_factory.mktemp("dispatch"))
    rng = np.random.default_rng(53)
    S, F = jspi.Schema, jspi.FieldSpec
    D, T = jspi.DataType, jspi.FieldType
    orders_schema = S("orders", [F("cust_id", D.INT, T.DIMENSION),
                                 F("amount", D.INT, T.METRIC)])
    cust_schema = S("customers", [F("id", D.INT, T.DIMENSION),
                                  F("tier", D.STRING, T.DIMENSION)])
    l_schema = S("l", [F("k", D.INT, T.DIMENSION), F("v", D.INT, T.METRIC)])
    r_schema = S("r", [F("k", D.INT, T.DIMENSION), F("w", D.INT, T.METRIC)])
    orders = {"cust_id": rng.integers(0, 70, 500).astype(np.int32),
              "amount": rng.integers(1, 1000, 500).astype(np.int32)}
    custs = {"id": np.arange(60, dtype=np.int32),
             "tier": rng.choice(["gold", "silver"], 60)}

    def build(schema, cols, name):
        return jseg.SegmentBuilder(schema, jspi.TableConfig(
            schema.name)).build(cols, out, name)

    return {
        "orders": (orders_schema.to_dict(), [
            build(orders_schema, {k: v[:250] for k, v in orders.items()},
                  "orders_0"),
            build(orders_schema, {k: v[250:] for k, v in orders.items()},
                  "orders_1")]),
        "customers": (cust_schema.to_dict(),
                      [build(cust_schema, custs, "customers_0")]),
        "l": (l_schema.to_dict(), [build(l_schema, {
            "k": np.arange(6, dtype=np.int32),
            "v": (np.arange(6) * 10).astype(np.int32)}, "l_0")]),
        "r": (r_schema.to_dict(), [build(r_schema, {
            "k": np.asarray([0, 2, 4], dtype=np.int32),
            "w": np.asarray([7, 8, 9], dtype=np.int32)}, "r_0")]),
    }


def _run(name, tables, root):
    """Both joins of the reference's tests on one package's two-server
    fleet; the relations' columns, nulls and sorted rows."""
    pk = _pkg(name)
    ctrl = pk.cluster.Controller(str(root / "ctrl"), heartbeat_timeout=30.0,
                                 reconcile_interval=0.2)
    servers = [pk.server(f"server_{i}", ctrl.url) for i in range(2)]
    try:
        for table, (schema, dirs) in tables.items():
            ctrl.add_table(table, schema, replication=1)
            for d in dirs:
                ctrl.add_segment(table, os.path.basename(d), d)
        for table, (_s, dirs) in tables.items():
            _wait_assigned(servers, table, len(dirs))

        def leaves(table, sql, alias):
            return [{"url": s.url, "sql": sql, "alias": alias}
                    for s in servers if _hosted(s, table)]

        out = {}
        for label, args in {
            "inner": (leaves("orders", "SELECT cust_id, amount FROM "
                             "orders LIMIT 100000", "o"),
                      leaves("customers", "SELECT id, tier FROM customers "
                             "LIMIT 100000", "c"),
                      ["o.cust_id"], ["c.id"], "inner"),
            "left": (leaves("l", "SELECT k, v FROM l LIMIT 100", "l"),
                     leaves("r", "SELECT k, w FROM r LIMIT 100", "r"),
                     ["l.k"], ["r.k"], "left"),
        }.items():
            left, right, lk, rk, how = args
            rel = pk.disp.distributed_join(left, right,
                                           [s.url for s in servers],
                                           lk, rk, how=how)
            cols = list(rel.data)
            nulls = {c: rel.nulls[c].tolist() for c in rel.nulls}
            rows = sorted(zip(*[[None if nulls.get(c, [False] * rel.n_rows)
                                 [i] else v.item() if hasattr(v, "item")
                                 else v for i, v in enumerate(rel.data[c])]
                                for c in cols]),
                          key=repr)
            out[label] = (cols, rows)
        out["split"] = sorted(s.instance_id for s in servers
                              if _hosted(s, "orders"))
        return out
    finally:
        for s in servers:
            s.stop()
        ctrl.stop()


def test_distributed_join_matches_the_reference(tables, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _run("jax", tables, tmp_path / "jax")
    got = _run("torch", tables, tmp_path / "torch")
    assert got["inner"] == want["inner"]
    assert got["left"] == want["left"]
    assert got["split"] == ["server_0", "server_1"]   # a leaf on each
    assert 0 < len(got["inner"][1]) < 500
    assert [r[-1] is None for r in got["left"][1]] == \
        [False, True, False, True, False, True]
    assert not leak.live("mailbox")
