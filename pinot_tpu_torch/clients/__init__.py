"""Client library: connections to in-process brokers and broker HTTP
endpoints.

Reference parity: pinot-clients/pinot-java-client (Connection /
ResultSetGroup over broker REST) and pinot-jdbc-client's
cursor-flavoured access. `connect()` (re-exported from broker.broker)
wraps an in-process Broker; HttpConnection speaks /query/sql to a
BrokerNode.

Port of ``pinot_tpu/clients/__init__.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..broker.broker import Broker, Connection, connect  # noqa: F401
from ..engine.reduce import ResultTable
from ..query.sql import SqlError


class HttpConnection:
    """SQL over a broker's REST endpoint (java-client Connection
    analog). execute() returns the same ResultTable the in-process path
    yields; errors surface as SqlError."""

    def __init__(self, broker_url: str, timeout: float = 60.0):
        self.broker_url = broker_url.rstrip("/")
        self.timeout = timeout

    def execute(self, sql: str) -> ResultTable:
        import urllib.error

        from ..cluster.http_util import http_json
        try:
            resp = http_json("POST", f"{self.broker_url}/query/sql",
                             {"sql": sql}, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            try:
                detail = e.read().decode()
            except Exception:
                detail = str(e)
            raise SqlError(f"broker rejected query: {detail[:300]}") \
                from None
        return result_table_from_response(resp)

    __call__ = execute

    # cursor-style access (jdbc-client analog)
    def cursor(self) -> "Cursor":
        return Cursor(self)


class Cursor:
    """Minimal DB-API-shaped cursor over HttpConnection/Connection."""

    def __init__(self, conn):
        self._conn = conn
        self._result: Optional[ResultTable] = None
        self._pos = 0

    @property
    def description(self):
        if self._result is None:
            return None
        return [(c, None, None, None, None, None, None)
                for c in self._result.columns]

    def execute(self, sql: str) -> "Cursor":
        self._result = self._conn.execute(sql)
        self._pos = 0
        return self

    def fetchone(self):
        if self._result is None or self._pos >= len(self._result.rows):
            return None
        row = self._result.rows[self._pos]
        self._pos += 1
        return row

    def fetchall(self) -> List[tuple]:
        if self._result is None:
            return []
        rows = self._result.rows[self._pos:]
        self._pos = len(self._result.rows)
        return rows

    def close(self) -> None:
        self._result = None


def result_table_from_response(resp: Dict[str, Any]) -> ResultTable:
    rt = resp.get("resultTable") or {}
    out = ResultTable(
        columns=list((rt.get("dataSchema") or {}).get("columnNames", [])),
        rows=[tuple(r) for r in rt.get("rows", [])])
    out.num_segments = resp.get("numSegmentsQueried", 0)
    out.num_segments_pruned = resp.get("numSegmentsPruned", 0)
    out.num_docs_scanned = resp.get("numDocsScanned", 0)
    out.time_ms = resp.get("timeUsedMs", 0.0)
    return out


def connect_url(broker_url: str, timeout: float = 60.0) -> HttpConnection:
    return HttpConnection(broker_url, timeout)
