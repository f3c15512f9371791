"""Admin CLI (pinot-admin analog).

Reference parity: pinot-tools/.../admin/PinotAdministrator.java:92 — the
`pinot-admin.sh` command surface. Subcommands mirror the reference's
most-used ones:

    python -m pinot_tpu_torch.tools.admin StartController --data-dir D [--port P]
    python -m pinot_tpu_torch.tools.admin StartServer --controller URL --id ID \
        [--device cuda|cpu]
    python -m pinot_tpu_torch.tools.admin StartBroker --controller URL
    python -m pinot_tpu_torch.tools.admin AddTable --controller URL \
        --schema-file schema.json [--config-file table.json] [--replicas N]
    python -m pinot_tpu_torch.tools.admin LaunchDataIngestionJob --job-spec job.json
    python -m pinot_tpu_torch.tools.admin PostQuery --broker URL --query SQL
    python -m pinot_tpu_torch.tools.admin QuickStart [--rows N] [--exit-after] \
        [--device cuda|cpu] [--work-dir DIR]

Role-starting commands block until Ctrl-C (the reference's foreground
mode); everything else exits when done.

Port of ``pinot_tpu/tools/admin.py``: the same commands and arguments,
running the port's nodes. StartServer and QuickStart take ``--device``
(default ``cuda``, as every entry point of the port): their server
serves its segments from the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _wait_forever(label: str, url: str) -> None:
    print(f"{label} running at {url}; press Ctrl-C to stop")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass


def cmd_start_controller(args) -> int:
    from ..cluster import Controller
    c = Controller(args.data_dir, port=args.port,
                   lease_ttl=args.lease_ttl, instance_id=args.id)
    try:
        _wait_forever("controller", c.url)
    finally:
        c.stop()
    return 0


def cmd_start_server(args) -> int:
    from ..cluster import ServerNode
    s = ServerNode(args.id, args.controller, port=args.port,
                   tags=args.tag or [],
                   advertise_host=args.advertise_host,
                   device=args.device)
    try:
        _wait_forever(f"server {args.id}", s.url)
    finally:
        s.stop()
    return 0


def cmd_start_broker(args) -> int:
    from ..cluster import BrokerNode
    b = BrokerNode(args.controller, port=args.port,
                   instance_selector=args.selector,
                   slow_query_ms=args.slow_query_ms,
                   query_stats_path=args.query_stats,
                   trace_ratio=args.trace_ratio)
    try:
        _wait_forever("broker", b.url)
    finally:
        b.stop()
    return 0


def cmd_add_table(args) -> int:
    from ..cluster.http_util import http_json
    with open(args.schema_file) as fh:
        schema = json.load(fh)
    config = None
    if args.config_file:
        with open(args.config_file) as fh:
            config = json.load(fh)
    name = args.name or (config or {}).get("tableName") \
        or schema.get("schemaName") or schema.get("name")
    if not name:
        print("no table name: pass --name or put tableName in the config",
              file=sys.stderr)
        return 2
    http_json("POST", f"{args.controller}/tables", {
        "name": name, "schema": schema, "config": config,
        "replication": args.replicas})
    print(f"table {name!r} added")
    return 0


def cmd_launch_ingestion(args) -> int:
    from ..ingestion import run_batch_ingestion
    with open(args.job_spec) as fh:
        spec = json.load(fh)
    locations = run_batch_ingestion(spec)
    print(f"built {len(locations)} segment(s)")
    for loc in locations:
        print(f"  {loc}")
    return 0


def cmd_post_query(args) -> int:
    from ..clients import connect_url
    r = connect_url(args.broker).execute(args.query)
    print(" | ".join(r.columns))
    for row in r.rows:
        print(" | ".join(str(v) for v in row))
    print(f"-- {len(r.rows)} row(s), {r.num_segments} segment(s), "
          f"{r.time_ms:.1f}ms")
    return 0


def cmd_list_tables(args) -> int:
    """Admin REST reads (controller/api/resources analog)."""
    import json as _json

    from ..cluster.http_util import http_json
    out = http_json("GET", f"{args.controller}/tables")
    print(_json.dumps(out, indent=1))
    return 0


def cmd_list_segments(args) -> int:
    import json as _json

    from ..cluster.http_util import http_json
    out = http_json("GET", f"{args.controller}/segments/{args.table}")
    print(_json.dumps(out, indent=1))
    return 0


def cmd_delete_segment(args) -> int:
    from ..cluster.http_util import http_json
    http_json("DELETE",
              f"{args.controller}/segments/{args.table}/{args.segment}")
    print(f"deleted {args.table}/{args.segment}")
    return 0


def cmd_quickstart(args) -> int:
    from .quickstart import main
    main(keep_running=not args.exit_after, rows=args.rows,
         device=args.device, work_dir=args.work_dir)
    return 0


def cmd_reload_table(args) -> int:
    """Reload a table's segments on every hosting server (rebuild
    secondary indexes). With --config-file, the config first persists at
    the controller — it is the source of truth, or the next restart/
    rebalance would silently revert the indexes."""
    from ..cluster.http_util import http_json
    snap = http_json("GET", f"{args.controller}/routing")
    if args.table not in (snap.get("tables") or {}):
        print(f"unknown table {args.table!r}", file=sys.stderr)
        return 1
    if args.config_file:
        with open(args.config_file) as fh:
            cfg = json.load(fh)
        http_json("POST", f"{args.controller}/tableconfig/{args.table}",
                  cfg)
    servers = {h for holders in
               (snap.get("assignment", {}).get(args.table) or {}).values()
               for h in holders}
    total = {"added": [], "removed": []}
    for sid in sorted(servers):
        inst = snap.get("instances", {}).get(sid)
        if inst is None:
            continue
        url = f"http://{inst['host']}:{inst['port']}"
        # no inline config: servers pull the (just-updated) controller one
        r = http_json("POST", f"{url}/reload", {"table": args.table},
                      timeout=120)
        total["added"].extend(r.get("added", []))
        total["removed"].extend(r.get("removed", []))
    print(json.dumps(total))
    return 0


def cmd_rebalance(args) -> int:
    from ..cluster.http_util import http_json
    r = http_json("POST", f"{args.controller}/rebalance/{args.table}",
                  {"dryRun": args.dry_run}, timeout=120)
    print(json.dumps(r))
    return 0


def cmd_convert_format(args) -> int:
    """SegmentFormatConverter analog: repack a segment dir between v1
    (file per index) and v3 (single packed columns.psf)."""
    from ..segment import segdir
    if args.to == "v3":
        segdir.convert_to_v3(args.segment_dir)
    else:
        segdir.convert_to_v1(args.segment_dir)
    print(json.dumps({"segmentDir": args.segment_dir,
                      "formatVersion": args.to}))
    return 0


def cmd_recommend(args) -> int:
    """Rule-based config advice from a schema + weighted query workload
    file (one `weight<TAB>sql` per line, or bare sql = weight 1)."""
    from ..spi.schema import Schema
    from .recommender import recommend
    with open(args.schema_file) as fh:
        schema = Schema.from_dict(json.load(fh))
    workload = []
    with open(args.workload_file) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            w, _, rest = line.partition("\t")
            try:
                workload.append((rest, float(w)))
            except ValueError:
                # no numeric weight prefix (SQL may itself contain tabs)
                workload.append((line, 1.0))
    cards = None
    if args.cardinalities:
        with open(args.cardinalities) as fh:
            cards = json.load(fh)
    rec = recommend(schema, workload, cardinalities=cards,
                    n_rows=args.rows)
    print(json.dumps(rec.to_dict(), indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pinot-tpu-torch-admin",
        description="Cluster administration commands")
    sub = p.add_subparsers(dest="command", required=True)

    sc = sub.add_parser("StartController")
    sc.add_argument("--data-dir", required=True)
    sc.add_argument("--port", type=int, default=0)
    sc.add_argument("--lease-ttl", type=float, default=None,
                    help="enable HA leadership: controllers sharing "
                    "--data-dir contend for the file lease")
    sc.add_argument("--id", default=None,
                    help="controller instance id (HA observability)")
    sc.set_defaults(fn=cmd_start_controller)

    ss = sub.add_parser("StartServer")
    ss.add_argument("--controller", required=True)
    ss.add_argument("--id", required=True)
    ss.add_argument("--port", type=int, default=0)
    ss.add_argument("--tag", action="append")
    ss.add_argument("--advertise-host", default=None,
                    help="host other nodes dial (container/service "
                    "name; default 127.0.0.1 or PINOT_ADVERTISE_HOST)")
    ss.add_argument("--device", default="cuda",
                    help="where the server keeps and scans its segments")
    ss.set_defaults(fn=cmd_start_server)

    sb = sub.add_parser("StartBroker")
    sb.add_argument("--controller", required=True)
    sb.add_argument("--port", type=int, default=0)
    sb.add_argument("--selector", default="balanced")
    sb.add_argument("--slow-query-ms", type=float, default=None,
                    help="slow-query ring threshold (default 500 or "
                    "PINOT_SLOW_QUERY_MS; per-query override "
                    "OPTION(slowQueryMs=...))")
    sb.add_argument("--query-stats", default=None,
                    help="append a validated query_stats ledger record "
                    "per query to this JSONL path (default "
                    "PINOT_QUERY_STATS_LEDGER)")
    sb.add_argument("--trace-ratio", type=float, default=None,
                    help="production-sample this fraction of queries "
                    "into query_trace ledger records (default 0 or "
                    "PINOT_TRACE_RATIO; per-query override "
                    "OPTION(traceRatio=...))")
    sb.set_defaults(fn=cmd_start_broker)

    at = sub.add_parser("AddTable")
    at.add_argument("--controller", required=True)
    at.add_argument("--schema-file", required=True)
    at.add_argument("--config-file")
    at.add_argument("--name")
    at.add_argument("--replicas", type=int, default=1)
    at.set_defaults(fn=cmd_add_table)

    li = sub.add_parser("LaunchDataIngestionJob")
    li.add_argument("--job-spec", required=True)
    li.set_defaults(fn=cmd_launch_ingestion)

    pq = sub.add_parser("PostQuery")
    pq.add_argument("--broker", required=True)
    pq.add_argument("--query", required=True)
    pq.set_defaults(fn=cmd_post_query)

    qs = sub.add_parser("QuickStart")
    qs.add_argument("--rows", type=int, default=5000)
    qs.add_argument("--exit-after", action="store_true")
    qs.add_argument("--device", default="cuda",
                    help="where the server keeps and scans its segments")
    qs.add_argument("--work-dir", default=None,
                    help="the cluster's state, data and deep store "
                    "(default: a new temporary directory)")
    qs.set_defaults(fn=cmd_quickstart)

    rl = sub.add_parser("ReloadTable")
    rl.add_argument("--controller", required=True)
    rl.add_argument("--table", required=True)
    rl.add_argument("--config-file")
    rl.set_defaults(fn=cmd_reload_table)

    rb = sub.add_parser("RebalanceTable")
    rb.add_argument("--controller", required=True)
    rb.add_argument("--table", required=True)
    rb.add_argument("--dry-run", action="store_true")
    rb.set_defaults(fn=cmd_rebalance)

    cf = sub.add_parser("ConvertSegmentFormat")
    cf.add_argument("--segment-dir", required=True)
    cf.add_argument("--to", choices=("v1", "v3"), default="v3")
    cf.set_defaults(fn=cmd_convert_format)

    rc = sub.add_parser("RecommendConfig")
    rc.add_argument("--schema-file", required=True)
    rc.add_argument("--workload-file", required=True)
    rc.add_argument("--cardinalities")
    rc.add_argument("--rows", type=int, default=1_000_000)
    rc.set_defaults(fn=cmd_recommend)

    lt = sub.add_parser("ListTables")
    lt.add_argument("--controller", required=True)
    lt.set_defaults(fn=cmd_list_tables)

    ls = sub.add_parser("ListSegments")
    ls.add_argument("--controller", required=True)
    ls.add_argument("--table", required=True)
    ls.set_defaults(fn=cmd_list_segments)

    ds = sub.add_parser("DeleteSegment")
    ds.add_argument("--controller", required=True)
    ds.add_argument("--table", required=True)
    ds.add_argument("--segment", required=True)
    ds.set_defaults(fn=cmd_delete_segment)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
