"""Networked multi-stage dispatch: stages spanning server processes.

Reference parity: the broker->server stage submission of worker.proto:26
(QueryDispatcher.submitAndReduce -> QueryRunner.processQuery) and the
gRPC mailbox data plane of mailbox.proto:25 (GrpcSendingMailbox ->
ReceivingMailbox), collapsed to the cluster's HTTP planes:

- POST /stage     submits one worker's stage of a query plan; leaf
  stages scan locally and hash/broadcast-exchange blocks to the next
  stage's workers, join stages block on their receiving mailboxes and
  return the joined relation as the (binary) response;
- POST /mailbox   delivers one binary Relation block (or EOS) into the
  receiving MailboxService of the worker process — the
  GrpcSendingMailbox.offer analog.

`distributed_join` is the broker-side coordinator: it assigns the join
stage's workers, submits every stage, and concatenates the join
partitions — HashExchange partitioning guarantees rows with equal keys
meet at the same worker, so the concatenation IS the join result.

Port of ``pinot_tpu/multistage/dispatch.py``. Leaf stages run through the
server node's ``execute``, so they scan on the node's device; join stages
run the port's ``multistage.join.hash_join``. The stage plans and mailbox
headers go through the port's copy of the reference's gencode
(``protos/plan_pb2.py``), so their bytes are the reference's.
"""
from __future__ import annotations

import json
import struct
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..engine.datablock import decode_relation, encode_relation
from ..utils import phases as ph
from ..utils.spans import Span, span, span_tracer
from .exchange import EOS, MailboxService, hash_partition_codes
from .join import hash_join
from .relation import Relation


# ---------------------------------------------------------------------------
# typed wire contract: stage plans and mailbox headers are proto
# messages (protos/plan.proto, the StageNode / MailboxContent analog),
# not JSON blobs. A non-Python client speaking plan.proto can drive
# these planes.
# ---------------------------------------------------------------------------

def encode_stage_plan(spec: Dict[str, Any]) -> bytes:
    from ..protos import plan_pb2

    p = plan_pb2.StagePlan(query_id=spec["queryId"])
    if spec["kind"] == "leaf":
        leaf = p.leaf
        leaf.sql = spec["sql"]
        if spec.get("alias"):
            leaf.alias = spec["alias"]
        exs = spec["exchange"]
        ex = leaf.exchange
        ex.type = (plan_pb2.ExchangeSpec.HASH if exs["type"] == "hash"
                   else plan_pb2.ExchangeSpec.BROADCAST)
        ex.keys.extend(exs.get("keys") or [])
        ex.stage = exs["stage"]
        for t in exs["targets"]:
            mt = ex.targets.add()
            mt.url = t["url"]
            mt.worker = t["worker"]
    else:
        j = p.join
        j.worker = spec["worker"]
        j.left_stage = spec["leftStage"]
        j.right_stage = spec["rightStage"]
        j.left_keys.extend(spec["leftKeys"])
        j.right_keys.extend(spec["rightKeys"])
        j.how = spec.get("how", "inner")
        j.n_left_senders = spec["nLeftSenders"]
        j.n_right_senders = spec["nRightSenders"]
        j.timeout_sec = spec.get("timeoutSec", 60.0)
    return p.SerializeToString()


def decode_stage_plan(data: bytes) -> Dict[str, Any]:
    from ..protos import plan_pb2

    p = plan_pb2.StagePlan.FromString(data)
    node = p.WhichOneof("node")
    if node == "leaf":
        leaf = p.leaf
        return {
            "kind": "leaf", "queryId": p.query_id, "sql": leaf.sql,
            "alias": leaf.alias or None,
            "exchange": {
                "type": ("hash" if leaf.exchange.type
                         == plan_pb2.ExchangeSpec.HASH else "broadcast"),
                "keys": list(leaf.exchange.keys),
                "stage": leaf.exchange.stage,
                "targets": [{"url": t.url, "worker": t.worker}
                            for t in leaf.exchange.targets],
            },
        }
    if node != "join":
        raise ValueError(f"StagePlan without a node: {data[:40]!r}")
    j = p.join
    return {
        "kind": "join", "queryId": p.query_id, "worker": j.worker,
        "leftStage": j.left_stage, "rightStage": j.right_stage,
        "leftKeys": list(j.left_keys), "rightKeys": list(j.right_keys),
        "how": j.how or "inner",
        "nLeftSenders": j.n_left_senders,
        "nRightSenders": j.n_right_senders,
        "timeoutSec": j.timeout_sec or 60.0,
    }


# ---------------------------------------------------------------------------
# mailbox wire frames: u32 header length | MailboxHeader proto | PREL
# ---------------------------------------------------------------------------

def encode_mailbox_frame(query_id: str, stage: int, worker: int,
                         rel: Optional[Relation]) -> bytes:
    from ..protos import plan_pb2

    hb = plan_pb2.MailboxHeader(query_id=query_id, stage=stage,
                                worker=worker,
                                eos=rel is None).SerializeToString()
    buf = bytearray(struct.pack(">I", len(hb)) + hb)
    if rel is not None:
        buf += encode_relation(rel)
    return bytes(buf)


def deliver_mailbox_frame(service: MailboxService, data: bytes) -> None:
    from ..protos import plan_pb2

    mv = memoryview(data)
    (hlen,) = struct.unpack(">I", mv[:4])
    header = plan_pb2.MailboxHeader.FromString(bytes(mv[4:4 + hlen]))
    box = service.mailbox(header.query_id, header.stage, header.worker)
    if header.eos:
        box.offer(EOS)
    else:
        box.offer(decode_relation(bytes(mv[4 + hlen:])))


def _send_block(url: str, query_id: str, stage: int, worker: int,
                rel: Optional[Relation], timeout: float = 30.0) -> None:
    from ..cluster.http_util import http_raw
    with span(ph.EXCHANGE, target=url, stage=stage, worker=worker,
              rows=None if rel is None else rel.n_rows,
              eos=rel is None):
        http_raw("POST", f"{url}/mailbox",
                 encode_mailbox_frame(query_id, stage, worker, rel),
                 timeout=timeout)


# ---------------------------------------------------------------------------
# trace plumbing: the /stage request body is opaque StagePlan proto
# bytes, so the traceContext rides the X-Pinot-Trace-Context header
# (cluster/http_util) and a sampled worker roots a ``stage`` span tree
# the coordinator stitches back under its per-submission ``stage_call``
# span.
# Leaf responses are JSON (the tree is a "trace" key); join responses
# are raw relation bytes, so a sampled join response is wrapped in a
# magic-guarded trace envelope the coordinator strips.
# ---------------------------------------------------------------------------

_TRACE_MAGIC = b"PTRC"


def wrap_trace(payload: bytes, trace: Dict[str, Any]) -> bytes:
    h = json.dumps(trace).encode()
    return _TRACE_MAGIC + struct.pack("<I", len(h)) + h + payload


def unwrap_trace(data: bytes) -> Tuple[bytes, Optional[Dict[str, Any]]]:
    """-> (payload, trace-or-None); non-enveloped payloads pass through
    untouched (magic-guarded, so the wire stays backward compatible)."""
    if bytes(data[:4]) != _TRACE_MAGIC:
        return data, None
    (hn,) = struct.unpack("<I", bytes(data[4:8]))
    try:
        trace = json.loads(bytes(data[8:8 + hn]))
    except ValueError:
        return data, None
    return bytes(data[8 + hn:]), trace


# ---------------------------------------------------------------------------
# stage execution (worker side; ServerNode routes POST /stage here)
# ---------------------------------------------------------------------------

def _concat(blocks: List[Relation]) -> Relation:
    assert blocks, "exchange must deliver schema blocks even when empty"
    return Relation.concat(blocks)


def _leaf_relation(node, spec: Dict[str, Any]) -> Relation:
    """Run the stage's local scan and qualify columns with the alias
    (LeafStageTransferableBlockOperator analog: the v1 engine's selection
    rows become a transferable columnar block)."""
    resp = node.execute(spec["sql"])
    partials = resp.get("partials_raw", [])
    labels: List[str] = []
    rows: List[tuple] = []
    for p in partials:
        if getattr(p, "labels", None):
            labels = p.labels
        rows.extend(getattr(p, "rows", []))
    alias = spec.get("alias") or spec.get("table", "t")
    data: Dict[str, np.ndarray] = {}
    for ci, label in enumerate(labels):
        cells = [r[ci] for r in rows]
        arr = np.asarray(cells)
        if arr.dtype.kind in "USO":
            a2 = np.empty(len(cells), dtype=object)
            a2[:] = cells
            arr = a2
        data[f"{alias}.{label}"] = arr
    if not data:
        # empty scan (no partials / untabled server): the schema still
        # ships, derived from the select list, so the join worker's
        # concat and key lookup never see a schema-less block
        from ..query.sql import Identifier, parse_sql
        stmt = parse_sql(spec["sql"])
        for ci, item in enumerate(stmt.select):
            e = getattr(item, "expr", item)
            label = getattr(item, "alias", None) or (
                e.name if isinstance(e, Identifier) else f"col{ci}")
            data[f"{alias}.{label}"] = np.asarray([])
    return Relation(data, {}, alias)


def execute_stage(node, spec, trace_ctx: Optional[Dict[str, Any]] = None):
    """-> JSON dict (leaf summary) or bytes (root join's relation).
    spec: StagePlan proto bytes (the wire contract) or the decoded
    dict (in-process callers). A sampled ``trace_ctx`` roots a
    ``stage`` span tree around the stage's work (exchange sends
    included) and ships it back — "trace" key on the leaf's JSON
    summary, trace envelope (wrap_trace) on the join's binary
    relation — for the coordinator to stitch under its stage_call span."""
    if isinstance(spec, (bytes, bytearray)):
        spec = decode_stage_plan(bytes(spec))
    if trace_ctx and trace_ctx.get("sampled"):
        root = span_tracer.start(
            ph.STAGE, kind=spec["kind"], query_id=spec["queryId"],
            parent_span_id=trace_ctx.get("parentSpanId"))
        try:
            out = _execute_stage(node, spec)
        finally:
            root = span_tracer.stop() or root
        if isinstance(out, (bytes, bytearray)):
            return wrap_trace(bytes(out), root.to_dict())
        out["trace"] = root.to_dict()
        return out
    return _execute_stage(node, spec)


def _execute_stage(node, spec):
    kind = spec["kind"]
    query_id = spec["queryId"]
    if kind == "leaf":
        with span(ph.LEAF_SCAN, sql=spec["sql"][:120]) as sp:
            rel = _leaf_relation(node, spec)
            if sp is not None:
                sp.annotate(rows=rel.n_rows)
        ex = spec["exchange"]
        targets = ex["targets"]  # [{url, worker}], stage = ex["stage"]
        stage = ex["stage"]
        if ex["type"] == "hash":
            parts = hash_partition_codes(rel, ex["keys"], len(targets))
            for w, t in enumerate(targets):
                # empty partitions still ship (schema travels with blocks)
                _send_block(t["url"], query_id, stage, t["worker"],
                            rel.take(np.nonzero(parts == w)[0]))
        else:  # broadcast
            for t in targets:
                _send_block(t["url"], query_id, stage, t["worker"], rel)
        for t in targets:
            _send_block(t["url"], query_id, stage, t["worker"], None)
        return {"rows": rel.n_rows}
    assert kind == "join", kind
    worker = spec["worker"]
    lbox = node.mailboxes.mailbox(query_id, spec["leftStage"], worker)
    rbox = node.mailboxes.mailbox(query_id, spec["rightStage"], worker)
    timeout = spec.get("timeoutSec", 60.0)
    try:
        with span("mailbox_drain", worker=worker) as sp:
            left = _concat(lbox.drain(timeout,
                                      n_eos=spec["nLeftSenders"]))
            right = _concat(rbox.drain(timeout,
                                       n_eos=spec["nRightSenders"]))
            if sp is not None:
                sp.annotate(left_rows=left.n_rows,
                            right_rows=right.n_rows)
    finally:
        # per-worker cleanup, even on drain timeout (a dead leaf must not
        # leak queued blocks); co-located workers keep their own boxes
        node.mailboxes.release_one(query_id, spec["leftStage"], worker)
        node.mailboxes.release_one(query_id, spec["rightStage"], worker)
    with span(ph.JOIN_STAGE, worker=worker, how=spec.get("how", "inner")):
        out = hash_join(left, right, spec["leftKeys"], spec["rightKeys"],
                        spec.get("how", "inner"))
    return encode_relation(out)


# ---------------------------------------------------------------------------
# broker-side coordinator
# ---------------------------------------------------------------------------

def distributed_join(left_leaves: List[Dict[str, str]],
                     right_leaves: List[Dict[str, str]],
                     join_workers: List[str],
                     left_keys: List[str], right_keys: List[str],
                     how: str = "inner",
                     timeout: float = 60.0) -> Relation:
    """Run a hash join whose stages span server processes.

    left_leaves/right_leaves: [{"url", "sql", "alias"}] — each runs as a
    leaf stage on its server (where the table's segments live) and hash-
    exchanges on the join keys; join_workers: server URLs, one join
    partition each. Returns the concatenated join relation.

    When the calling thread has an active span trace (EXPLAIN ANALYZE /
    a sampled query), every /stage submission carries a sampled
    traceContext header, gets a ``stage_call`` span, and the worker's
    remote-rooted ``stage`` tree is stitched under it — the multistage
    dispatch analog of the scatter_call stitching.
    """
    from ..cluster.http_util import http_raw, trace_context_header

    query_id = uuid.uuid4().hex[:12]
    l_stage, r_stage = 1, 2
    sampled = span_tracer.active()
    collect: Optional[List[Span]] = [] if sampled else None

    def post_stage(url: str, data: bytes, timeout: float, kind: str,
                   worker: Optional[int] = None
                   ) -> Tuple[bytes, Optional[Span]]:
        """One traced /stage submission (runs on pool threads: spans are
        built explicitly and collected GIL-atomically)."""
        sp = None
        headers = None
        if collect is not None:
            sp = Span(ph.STAGE_CALL, url=url, kind=kind, worker=worker,
                      span_id=uuid.uuid4().hex[:8], status=None,
                      error=None, net_ms=None)
            collect.append(sp)
            headers = trace_context_header(
                {"queryId": query_id, "sampled": True,
                 "parentSpanId": sp.attrs["span_id"]})
        try:
            raw = http_raw("POST", f"{url}/stage", data, timeout,
                           headers=headers)
        except Exception as e:
            if sp is not None:
                sp.finish()
                sp.annotate(status="failed",
                            error=f"{type(e).__name__}: {e}"[:200])
            raise
        if sp is not None:
            sp.finish()
            sp.annotate(status="ok")
        return raw, sp

    def stitch(sp: Optional[Span], tree: Optional[Dict[str, Any]]) -> None:
        if sp is None or not tree:
            return
        rt = Span.from_dict(tree)
        sp.children.append(rt)
        sp.annotate(net_ms=round(
            max(sp.duration_ms - rt.duration_ms, 0.0), 3))

    def targets(keys):
        return {"type": "hash", "keys": keys, "stage": None,
                "targets": [{"url": u, "worker": w}
                            for w, u in enumerate(join_workers)]}

    join_specs = [{
        "kind": "join", "queryId": query_id, "worker": w,
        "leftStage": l_stage, "rightStage": r_stage,
        "leftKeys": left_keys, "rightKeys": right_keys, "how": how,
        "nLeftSenders": len(left_leaves),
        "nRightSenders": len(right_leaves),
        "timeoutSec": timeout,
    } for w in range(len(join_workers))]

    def leaf_spec(leaf, stage, keys):
        ex = targets(keys)
        ex["stage"] = stage
        return {"kind": "leaf", "queryId": query_id, "sql": leaf["sql"],
                "alias": leaf.get("alias"), "exchange": ex}

    with span(ph.STAGE_DISPATCH, workers=len(join_workers),
              leaves=len(left_leaves) + len(right_leaves)) as dsp:
        try:
            with ThreadPoolExecutor(
                    max_workers=len(join_specs) + len(left_leaves)
                    + len(right_leaves)) as pool:
                # join stages first: they block on their mailboxes.
                # Every /stage submission ships as a typed StagePlan
                # proto (plan.proto), not a JSON blob.
                join_futs = [pool.submit(post_stage, join_workers[w],
                                         encode_stage_plan(spec),
                                         timeout, "join", w)
                             for w, spec in enumerate(join_specs)]
                leaf_futs = [pool.submit(
                    post_stage, leaf["url"],
                    encode_stage_plan(leaf_spec(leaf, l_stage,
                                                left_keys)),
                    timeout, "leaf") for leaf in left_leaves]
                leaf_futs += [pool.submit(
                    post_stage, leaf["url"],
                    encode_stage_plan(leaf_spec(leaf, r_stage,
                                                right_keys)),
                    timeout, "leaf") for leaf in right_leaves]
                for f in leaf_futs:
                    raw, sp = f.result()  # leaf summaries are JSON
                    stitch(sp, json.loads(raw).get("trace"))
                parts = []
                for f in join_futs:
                    raw, sp = f.result()
                    payload, tree = unwrap_trace(raw)
                    stitch(sp, tree)
                    parts.append(decode_relation(payload))
        finally:
            # attach even when a stage raises (a failed analyze still
            # shows WHICH submissions failed); snapshot first — a pool
            # thread may still be appending
            if dsp is not None and collect:
                done = list(collect)
                done.sort(key=lambda s: s._t0)
                dsp.children.extend(done)
    return _concat(parts)
