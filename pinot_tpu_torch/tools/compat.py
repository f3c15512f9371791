"""Compatibility / rolling-upgrade verifier over the port's cluster.

yaml-driven op suites executed against a live cluster while its roles
are rolled one at a time, proving that on-disk state (the controller's
property store, segment artifacts) and the wire planes written by one
incarnation are served correctly by the next. A single checkout rolls
between two INCARNATIONS over the same persistent state — and, since
the JAX package and the port read the same store and segment formats,
from the JAX package's incarnation to the port's over the same
directories.

Suite yaml shape (tests/resources/compat_suite.yaml):

    phases:
      - name: seed
        ops:
          - {op: createTable, table: t, replication: 1,
             schema: {k: STRING, v: INT}}
          - {op: ingestRows, table: t, segment: s0,
             rows: [{k: a, v: 1}, {k: b, v: 2}]}
          - {op: query, sql: "SELECT SUM(v) FROM t", expect: [[3]]}
      - name: roll-servers
        roll: [server]          # restart roles, keep all state dirs
        ops:
          - {op: query, sql: "SELECT SUM(v) FROM t", expect: [[3]]}

ops: createTable, ingestRows, query (expect rows, optional `tolerance`
for floats, optional `unordered: true`), pause {seconds}. roll entries:
controller | server | broker.

Servers serve on the card unless ``device="cpu"`` is given. A query
retries through a roll window only the errors of a restarting role: an
HTTP or URL error from the broker, or the broker's error for segments
no live replica answered while routing catches up. An error that names
a device or kernel failure inside a server fails the op at once, and so
does an answer that differs from the expected rows (every roll waits
until each node has the controller's routing): a roll must never hide a
wrong kernel behind a retry.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

# what a server's 500 says when its device or a kernel failed: the
# port's launch wrappers ("... kernel launch failed: CUDA error ..."),
# torch's CUDA errors, a kernel that did not build
_DEVICE_ERROR = re.compile(
    r"CUDA error|CUDA out of memory|OutOfMemoryError|AcceleratorError|"
    r"cudaError|device-side assert|kernel launch failed|nvcc")


class CompatError(AssertionError):
    pass


class CompatVerifier:
    """An in-process cluster whose roles restart over persistent state."""

    def __init__(self, work_dir: str, n_servers: int = 2, device=None):
        from ..cluster import BrokerNode, Controller, ServerNode

        self.work_dir = work_dir
        self.n_servers = n_servers
        self.device = device
        os.makedirs(work_dir, exist_ok=True)
        self._Controller = Controller
        self._ServerNode = ServerNode
        self._BrokerNode = BrokerNode
        self._schema_cache: Dict[str, Any] = {}
        self.controller = self._new_controller()
        self.servers = [self._new_server(i) for i in range(n_servers)]
        self.broker = self._new_broker()
        self.log: List[str] = []

    def _new_controller(self):
        return self._Controller(os.path.join(self.work_dir, "ctrl"),
                                heartbeat_timeout=5.0,
                                reconcile_interval=0.1)

    def _new_server(self, i: int):
        return self._ServerNode(f"server_{i}", self.controller.url,
                                poll_interval=0.1, device=self.device)

    def _new_broker(self):
        return self._BrokerNode(self.controller.url, routing_refresh=0.1)

    # -- rolling restarts -------------------------------------------------
    def roll(self, role: str,
             during: Optional[Callable[[int], None]] = None) -> None:
        """Restart one role over its persisted state (the rolling-
        upgrade step: the new incarnation must serve the old state).
        Servers roll one at a time; ``during(i)`` runs while server i is
        down, before its new incarnation starts."""
        if role == "controller":
            self.controller.stop()
            self.controller = self._new_controller()
            for s in self.servers:
                s.controller_url = self.controller.url
            self.broker.controller_url = self.controller.url
        elif role == "server":
            # one at a time — the rolling discipline; with replication,
            # queries keep answering mid-roll
            for i, s in enumerate(self.servers):
                s.stop()
                _release(s)
                if during is not None:
                    during(i)
                self.servers[i] = self._new_server(i)
                self._await_live()
        elif role == "broker":
            self.broker.stop()
            self.broker = self._new_broker()
        else:
            raise CompatError(f"unknown role {role!r}")
        self._await_live()
        self._sync()
        self.log.append(f"rolled {role}")

    def _await_live(self, timeout: float = 20.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.controller.live_servers()) == self.n_servers:
                return
            time.sleep(0.05)
        raise CompatError(
            f"servers did not re-register: "
            f"{self.controller.live_servers()}")

    def _sync(self, timeout: float = 20.0) -> None:
        v = self.controller.routing_snapshot()["version"]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(s.wait_for_version(v, timeout=0.5)
                   for s in self.servers) and \
                    self.broker.wait_for_version(v, timeout=0.5):
                return
            time.sleep(0.05)
        raise CompatError(f"cluster did not sync to version {v}")

    # -- ops --------------------------------------------------------------
    def op_create_table(self, spec: Dict[str, Any]) -> None:
        from ..spi import DataType, FieldSpec, FieldType, Schema

        fields = []
        for name, dt in spec["schema"].items():
            ft = (FieldType.METRIC if name in spec.get("metrics", [])
                  else FieldType.DIMENSION)
            fields.append(FieldSpec(name, DataType[dt], ft))
        self.create_table(Schema(spec["table"], fields),
                          spec.get("config"), spec.get("replication", 1))

    def create_table(self, schema, config: Optional[Dict[str, Any]] = None,
                     replication: int = 1) -> None:
        """Register ``schema``'s table with the controller and wait until
        every node has its routing."""
        self.controller.add_table(schema.name, schema.to_dict(), config,
                                  replication)
        self._schema_cache[schema.name] = schema
        self._sync()

    def op_ingest_rows(self, spec: Dict[str, Any]) -> None:
        from ..segment import SegmentBuilder
        from ..spi import TableConfig

        schema = self._schema(spec["table"])
        rows = spec["rows"]
        cols = {f.name: np.asarray([r[f.name] for r in rows])
                for f in schema.fields}
        out = os.path.join(self.work_dir, "segments", spec["table"])
        d = SegmentBuilder(schema, TableConfig(spec["table"])).build(
            cols, out, spec["segment"])
        self.add_segment(spec["table"], spec["segment"], d)

    def _schema(self, table: str):
        """The table's schema: this incarnation's own, else the one the
        controller persisted (a table an earlier incarnation created)."""
        from ..spi import Schema

        schema = self._schema_cache.get(table)
        if schema is None:
            meta = self.controller.admin_table(table)
            if meta is None:
                raise CompatError(f"table {table!r} is not registered")
            schema = self._schema_cache[table] = \
                Schema.from_dict(meta["schema"])
        return schema

    def add_segment(self, table: str, segment: str, seg_dir: str) -> None:
        """Register a built segment directory with the controller and
        wait until every node serves it."""
        self.controller.add_segment(table, segment, seg_dir)
        self._sync()

    def query_rows(self, sql: str, retry_window: float = 10.0) -> list:
        """The broker's rows for ``sql``, retried through the roll
        window on a restarting role's errors only (module docstring)."""
        import urllib.error

        from ..cluster.http_util import http_json

        deadline = time.monotonic() + retry_window
        while True:
            why: Any = None
            try:
                resp = http_json("POST", f"{self.broker.url}/query/sql",
                                 {"sql": sql}, timeout=600.0)
                if "error" in resp:
                    why = resp["error"]
                    _fail_on_device_error(sql, str(why))
                else:
                    return [tuple(r) for r in resp["resultTable"]["rows"]]
            except urllib.error.HTTPError as e:
                try:
                    why = f"HTTP {e.code}: {e.read().decode()[:2000]}"
                except OSError:
                    why = f"HTTP {e.code}"
                _fail_on_device_error(sql, why)
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                why = e
            if time.monotonic() >= deadline:
                raise CompatError(f"{sql!r}: {why} (after {self.log})")
            time.sleep(0.2)

    def op_query(self, spec: Dict[str, Any],
                 retry_window: float = 10.0) -> None:
        """The broker's rows must equal ``expect`` at once: a roll ends
        only when every node has the controller's routing version
        (``roll``, ``add_segment``), so a wrong answer is a fault, never
        a routing transient."""
        exp = [tuple(r) for r in spec["expect"]]
        tol = spec.get("tolerance")
        got = self.query_rows(spec["sql"], retry_window)
        g2, e2 = (sorted(got), sorted(exp)) \
            if spec.get("unordered") else (got, exp)
        ok = len(g2) == len(e2) and all(
            len(g) == len(e) and all(
                (abs(a - b) <= tol if tol is not None
                 and isinstance(a, (int, float)) else a == b)
                for a, b in zip(g, e))
            for g, e in zip(g2, e2))
        if not ok:
            raise CompatError(f"{spec['sql']!r}: got {g2!r}, want "
                              f"{e2!r} (after {self.log})")
        self.log.append(f"query ok: {spec['sql']}")

    def run_phase(self, phase: Dict[str, Any]) -> None:
        for role in phase.get("roll", []):
            self.roll(role)
        for op in phase.get("ops", []):
            kind = op["op"]
            if kind == "createTable":
                self.op_create_table(op)
            elif kind == "ingestRows":
                self.op_ingest_rows(op)
            elif kind == "query":
                self.op_query(op)
            elif kind == "pause":
                time.sleep(float(op.get("seconds", 0.1)))
            else:
                raise CompatError(f"unknown op {kind!r}")
        self.log.append(f"phase ok: {phase.get('name', '?')}")

    def run_suite(self, suite: Dict[str, Any]) -> List[str]:
        for phase in suite["phases"]:
            self.run_phase(phase)
        return self.log

    def stop(self) -> None:
        """Stop every role (the broker and the servers side by side, each
        stop waits out its HTTP server's shutdown poll); the servers'
        segments leave the device."""
        import threading

        def stop_server(s) -> None:
            try:
                s.stop()
            finally:
                _release(s)

        threads = [threading.Thread(target=self.broker.stop)] + [
            threading.Thread(target=stop_server, args=(s,))
            for s in self.servers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.controller.stop()


def _fail_on_device_error(sql: str, why: str) -> None:
    if _DEVICE_ERROR.search(why):
        raise CompatError(f"{sql!r}: a server's device or kernel failed "
                          f"(not a roll transient): {why}")


def _release(server) -> None:
    """A stopped server is a process that ended: its segments release
    their device residency (a query still on one finishes on its own
    uploads, ImmutableSegment.retire)."""
    for dm in list(server._tables.values()):
        for seg in dm.acquire_segments():
            if not getattr(seg, "is_mutable", False):
                seg.retire()


def load_suite(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as fh:
        return yaml.safe_load(fh)


def run_suite_file(path: str, work_dir: str,
                   n_servers: Optional[int] = None,
                   device=None) -> List[str]:
    """Load + run a yaml suite; returns the verifier's op log."""
    suite = load_suite(path)
    v = CompatVerifier(work_dir,
                       n_servers=n_servers or suite.get("servers", 2),
                       device=device)
    try:
        return v.run_suite(suite)
    finally:
        v.stop()


# -- golden artifacts from a previous incarnation -----------------------------

def check_golden_segment(golden_dir: str, device=None) -> Dict[str, Any]:
    """Load ``<golden_dir>/sales_seg`` on ``device`` and answer every
    query of ``expected.json`` through the port's broker; raises
    CompatError on a row that differs. -> {"n_docs", "queries", "ms"}."""
    from ..broker import Broker
    from ..device import resolve_device
    from ..segment import ImmutableSegment
    from ..server import TableDataManager

    dev = resolve_device(device)
    with open(os.path.join(golden_dir, "expected.json")) as fh:
        fixture = json.load(fh)
    seg = ImmutableSegment.load(os.path.join(golden_dir, "sales_seg"), dev)
    try:
        if seg.n_docs != fixture["n_docs"]:
            raise CompatError(f"golden segment: {seg.n_docs} docs, want "
                              f"{fixture['n_docs']}")
        dm = TableDataManager("sales", device=dev)
        dm.add_segment(seg)
        b = Broker(device=dev)
        b.register_table(dm)
        ms = []
        for case in fixture["queries"]:
            t0 = time.perf_counter()
            rows = [list(r) for r in b.query(case["sql"]).rows]
            ms.append((time.perf_counter() - t0) * 1e3)
            if rows != case["rows"]:
                raise CompatError(f"golden segment {case['sql']!r}: got "
                                  f"{rows}, want {case['rows']}")
    finally:
        seg.retire()
    return {"n_docs": fixture["n_docs"], "queries": len(ms), "ms": ms}


def check_golden_wire(golden_dir: str) -> Dict[str, Any]:
    """Decode the golden wire blobs through the port: the PREL relation
    codec, the StagePlan proto and a full mailbox frame; raises
    CompatError on a field that differs from ``wire_expected.json``."""
    from ..engine.datablock import decode_relation
    from ..multistage.dispatch import (decode_stage_plan,
                                       deliver_mailbox_frame,
                                       encode_mailbox_frame)
    from ..multistage.exchange import MailboxService

    def blob(name: str) -> bytes:
        with open(os.path.join(golden_dir, name), "rb") as fh:
            return fh.read()

    with open(os.path.join(golden_dir, "wire_expected.json")) as fh:
        exp = json.load(fh)
    rel = decode_relation(blob("relation.prel.bin"))
    got_rel = {"columns": sorted(rel.data), "n_rows": rel.n_rows,
               "v_sum": int(np.asarray(rel.data["t.v"]).sum())}
    if got_rel != exp["relation"] or \
            np.asarray(rel.nulls["t.k"]).tolist() != [False, False, False,
                                                      True]:
        raise CompatError(f"golden relation: {got_rel}")
    plan = decode_stage_plan(blob("stageplan.pb.bin"))
    if plan["queryId"] != exp["stageplan"]["queryId"] or \
            plan["sql"] != exp["stageplan"]["sql"] or \
            plan["exchange"]["targets"] != [{"url": "http://h:1",
                                             "worker": 0}]:
        raise CompatError(f"golden stage plan: {plan}")
    svc = MailboxService()
    deliver_mailbox_frame(svc, blob("mailbox.frame.bin"))
    deliver_mailbox_frame(svc, encode_mailbox_frame("golden-q", 1, 0,
                                                    None))  # EOS
    blocks = svc.mailbox("golden-q", 1, 0).drain(5.0, n_eos=1)
    if len(blocks) != 1 or blocks[0].n_rows != 4:
        raise CompatError(f"golden mailbox frame: {len(blocks)} blocks")
    return {"relation_rows": rel.n_rows, "stage_plan": plan["queryId"],
            "mailbox_rows": blocks[0].n_rows}
