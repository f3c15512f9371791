"""Mailboxes + block exchanges: the data plane between stages.

Port of ``pinot_tpu/multistage/exchange.py``: the in-process mailboxes
only (the networked transport, ``multistage/dispatch.py``, stays with the
cluster package); a mailbox registers with the leak tracker
(``utils/leak``, kind "mailbox") as the reference's does.

Reference parity: pinot-query-runtime/.../mailbox/MailboxService.java:38
(GrpcSendingMailbox / InMemorySendingMailbox / ReceivingMailbox; gRPC bidi
stream mailbox.proto:25) and runtime/operator/exchange/{HashExchange,
BroadcastExchange, SingletonExchange, RandomExchange}.java. In-process
deployments short-circuit through these same in-memory mailboxes (exactly
Pinot's InMemorySendingMailbox fast path); a multi-host transport plugs in
behind the same MailboxService interface.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import leak
from .relation import Relation

EOS = object()  # end-of-stream marker (MetadataBlock EOS analog)


class ReceivingMailbox:
    def __init__(self, mailbox_id: str):
        leak.track(self, "mailbox", mailbox_id)
        self.mailbox_id = mailbox_id
        self._q: "queue.Queue[Any]" = queue.Queue()

    def offer(self, block: Any) -> None:
        self._q.put(block)

    def poll(self, timeout: Optional[float] = None) -> Any:
        return self._q.get(timeout=timeout)

    def drain(self, timeout: Optional[float] = 30.0,
              n_eos: int = 1) -> List[Relation]:
        """Collect blocks until n_eos end-of-stream markers arrive (one
        per sender — networked exchanges fan many senders into one box).
        timeout is a DEADLINE over the whole drain, not per block."""
        import time
        out: List[Relation] = []
        remaining = n_eos
        deadline = None if timeout is None else time.monotonic() + timeout
        while remaining > 0:
            left = None if deadline is None \
                else max(deadline - time.monotonic(), 0.001)
            b = self.poll(left)
            if b is EOS:
                remaining -= 1
            else:
                out.append(b)
        return out


class MailboxService:
    """Registry of receiving mailboxes keyed by
    (query_id, stage, worker) — mailbox.proto addressing at small scale."""

    def __init__(self):
        self._boxes: Dict[str, ReceivingMailbox] = {}
        self._lock = threading.Lock()

    @staticmethod
    def mailbox_id(query_id: str, stage: int, worker: int) -> str:
        return f"{query_id}|{stage}|{worker}"

    def mailbox(self, query_id: str, stage: int, worker: int
                ) -> ReceivingMailbox:
        mid = self.mailbox_id(query_id, stage, worker)
        with self._lock:
            if mid not in self._boxes:
                self._boxes[mid] = ReceivingMailbox(mid)
            return self._boxes[mid]

    def release(self, query_id: str) -> None:
        with self._lock:
            for mid in [m for m in self._boxes
                        if m.startswith(query_id + "|")]:
                del self._boxes[mid]

    def release_one(self, query_id: str, stage: int, worker: int) -> None:
        """Drop a single mailbox (per-worker cleanup: co-located workers
        of one query must not reap each other's boxes)."""
        with self._lock:
            self._boxes.pop(self.mailbox_id(query_id, stage, worker), None)


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

def hash_partition_codes(rel: Relation, key_cols: List[str],
                         n_partitions: int) -> np.ndarray:
    """Deterministic per-row partition assignment from the join/distribution
    keys (HashExchange's murmur-on-key analog, numpy-vectorized)."""
    h = np.zeros(rel.n_rows, dtype=np.uint64)
    for c in key_cols:
        v = rel.raw_values(c)
        if v.dtype == object or v.dtype.kind in "US":
            # content-based vectorized hash (consistent across the two join
            # sides — per-relation factorization would not be): polynomial
            # fold over UCS4 codepoints of the fixed-width unicode view
            sv = np.asarray(v, dtype=object).astype(str)
            if sv.itemsize == 0:
                codes = np.zeros(len(sv), dtype=np.int64)
            else:
                u = sv.view(np.uint32).reshape(len(sv), -1)
                acc = np.zeros(len(sv), dtype=np.uint64)
                for col in range(u.shape[1]):
                    c = u[:, col].astype(np.uint64)
                    # skip NUL padding: the hash must not depend on the
                    # array's max string width, or the two sides of a
                    # networked join (separately built relations) route
                    # equal keys to different workers
                    acc = np.where(c != 0, acc * np.uint64(31) + c, acc)
                codes = acc.view(np.int64)
        else:
            codes = v.astype(np.int64, copy=False)
        h = h * np.uint64(1099511628211) + codes.astype(np.uint64)
    return (h % np.uint64(n_partitions)).astype(np.int64)


class BlockExchange:
    """Sender side: routes a relation's rows to stage-N workers' mailboxes."""

    def __init__(self, service: MailboxService, query_id: str, stage: int,
                 n_workers: int):
        self.service = service
        self.query_id = query_id
        self.stage = stage
        self.n_workers = n_workers

    def _boxes(self) -> List[ReceivingMailbox]:
        return [self.service.mailbox(self.query_id, self.stage, w)
                for w in range(self.n_workers)]

    def close(self) -> None:
        for b in self._boxes():
            b.offer(EOS)


class HashExchange(BlockExchange):
    def __init__(self, service, query_id, stage, n_workers,
                 key_cols: List[str]):
        super().__init__(service, query_id, stage, n_workers)
        self.key_cols = key_cols

    def send(self, rel: Relation) -> None:
        parts = hash_partition_codes(rel, self.key_cols, self.n_workers)
        boxes = self._boxes()
        for w in range(self.n_workers):
            idx = np.nonzero(parts == w)[0]
            if len(idx):
                boxes[w].offer(rel.take(idx))


class BroadcastExchange(BlockExchange):
    def send(self, rel: Relation) -> None:
        for b in self._boxes():
            b.offer(rel)


class SingletonExchange(BlockExchange):
    def send(self, rel: Relation) -> None:
        self.service.mailbox(self.query_id, self.stage, 0).offer(rel)


class RandomExchange(BlockExchange):
    """Round-robin load spreading (RandomExchange.java)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._next = 0

    def send(self, rel: Relation) -> None:
        self.service.mailbox(self.query_id, self.stage,
                             self._next % self.n_workers).offer(rel)
        self._next += 1
