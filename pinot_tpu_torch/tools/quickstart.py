"""Quickstart: controller + server + broker in one process, example
data ingested, sample queries executed.

Reference parity: pinot-tools/.../Quickstart.java:93-128 — launches
ZK+controller+broker+server in one JVM, ingests
examples/batch/baseballStats, runs sample queries. Here the example
table is a synthetic baseballStats-shaped dataset (players x seasons
with runs/hits/homeRuns), batch-ingested through the job runner into a
local deep store, served by a real controller/server/broker trio over
HTTP.

Port of ``pinot_tpu/tools/quickstart.py``: the same data, table and
queries. The server node serves its segments from ``device`` (the card
unless the caller passes ``"cpu"``), so every sample query's group-by
runs on the card; ``python -m pinot_tpu_torch.tools.admin QuickStart``
starts it.
"""
from __future__ import annotations

import csv
import os
import tempfile
import time
from typing import List, Optional

import numpy as np

SAMPLE_QUERIES = [
    "SELECT COUNT(*) FROM baseballStats",
    "SELECT SUM(runs), SUM(homeRuns) FROM baseballStats",
    "SELECT playerName, SUM(runs) AS total_runs FROM baseballStats "
    "GROUP BY playerName ORDER BY total_runs DESC LIMIT 5",
    "SELECT yearID, COUNT(*) AS seasons FROM baseballStats "
    "WHERE homeRuns > 20 GROUP BY yearID ORDER BY yearID LIMIT 5",
    "SELECT teamID, AVG(hits) AS avg_hits FROM baseballStats "
    "GROUP BY teamID ORDER BY avg_hits DESC LIMIT 3",
]


def write_example_data(out_dir: str, rows: int = 5000,
                       seed: int = 7) -> str:
    """Synthetic baseballStats-shaped CSV (players x seasons)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "baseballStats.csv")
    players = [f"player_{i:03d}" for i in range(200)]
    teams = ["ATL", "BOS", "CHC", "LAD", "NYY", "SEA", "SFG", "TEX"]
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, ["playerName", "teamID", "yearID",
                                "runs", "hits", "homeRuns"])
        w.writeheader()
        for _ in range(rows):
            w.writerow({
                "playerName": players[rng.integers(0, len(players))],
                "teamID": teams[rng.integers(0, len(teams))],
                "yearID": int(rng.integers(2000, 2025)),
                "runs": int(rng.integers(0, 130)),
                "hits": int(rng.integers(0, 220)),
                "homeRuns": int(rng.integers(0, 50)),
            })
    return path


def example_schema():
    from ..spi import DataType, FieldSpec, FieldType, Schema
    return Schema("baseballStats", [
        FieldSpec("playerName", DataType.STRING),
        FieldSpec("teamID", DataType.STRING),
        FieldSpec("yearID", DataType.INT),
        FieldSpec("runs", DataType.INT, FieldType.METRIC),
        FieldSpec("hits", DataType.INT, FieldType.METRIC),
        FieldSpec("homeRuns", DataType.INT, FieldType.METRIC),
    ])


class Quickstart:
    """One-process cluster with the example table loaded."""

    def __init__(self, work_dir: Optional[str] = None, rows: int = 5000,
                 device: Optional[str] = None):
        from ..device import resolve_device
        # resolved before anything starts: no card, no cluster
        self.device = resolve_device(device)
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ptpu_quick_")
        self.rows = rows
        self.controller = None
        self.server = None
        self.broker = None

    def start(self) -> "Quickstart":
        from ..cluster import BrokerNode, Controller, ServerNode
        from ..ingestion import run_batch_ingestion
        from ..spi import TableConfig

        self.controller = Controller(
            os.path.join(self.work_dir, "controller"),
            heartbeat_timeout=10.0, reconcile_interval=0.2)
        self.server = ServerNode("quickstart_server", self.controller.url,
                                 poll_interval=0.1, device=self.device)
        self.broker = BrokerNode(self.controller.url, routing_refresh=0.1)

        schema = example_schema()
        write_example_data(os.path.join(self.work_dir, "rawdata"),
                           self.rows)
        self.controller.add_table("baseballStats", schema.to_dict(),
                                  replication=1)
        run_batch_ingestion({
            "inputDirURI": os.path.join(self.work_dir, "rawdata"),
            "outputDirURI": os.path.join(self.work_dir, "segments"),
            "tableName": "baseballStats",
            "schema": schema.to_dict(),
            "tableConfig": TableConfig("baseballStats").to_dict(),
            "rowsPerSegment": max(self.rows // 4, 1),
            "push": {
                "controllerUrl": self.controller.url,
                "deepstoreURI": "file://"
                + os.path.join(self.work_dir, "deepstore"),
            },
        })
        v = self.controller.routing_snapshot()["version"]
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if self.server.wait_for_version(v, timeout=1.0) and \
                    self.broker.wait_for_version(v, timeout=1.0):
                break
        return self

    def execute(self, sql: str):
        from ..clients import connect_url
        return connect_url(self.broker.url).execute(sql)

    def run_sample_queries(self, out=print) -> List:
        results = []
        for q in SAMPLE_QUERIES:
            r = self.execute(q)
            results.append(r)
            out(f"\n> {q}")
            out("  " + " | ".join(r.columns))
            for row in r.rows:
                out("  " + " | ".join(str(v) for v in row))
        return results

    def resident_devices(self) -> List[str]:
        """The devices the server holds the example table's columns on,
        from its ``/debug/memory``: the card's after the sample queries
        ran there."""
        from ..cluster.http_util import http_json
        mem = http_json("GET", f"{self.server.url}/debug/memory")
        cols = (mem.get("columns") or {}).get("baseballStats") or {}
        return sorted({d for by_col in cols.values()
                       for d in by_col.values()})

    def stop(self) -> None:
        for node in (self.broker, self.server, self.controller):
            if node is not None:
                try:
                    node.stop()
                except Exception:
                    pass


def main(keep_running: bool = False, rows: int = 5000,
         device: Optional[str] = None,
         work_dir: Optional[str] = None) -> None:
    qs = Quickstart(work_dir=work_dir, rows=rows, device=device).start()
    try:
        print(f"Quickstart cluster up: controller={qs.controller.url} "
              f"broker={qs.broker.url} device={qs.device}")
        qs.run_sample_queries()
        print(f"\nserved from: {', '.join(qs.resident_devices())}")
        if keep_running:
            print("\nCluster is running; press Ctrl-C to stop. POST "
                  f"{{'sql': ...}} to {qs.broker.url}/query/sql")
            while True:
                time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        qs.stop()


if __name__ == "__main__":
    main()
