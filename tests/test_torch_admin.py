"""The operator entry points of the port against the JAX package, on the
CPU.

``python -m pinot_tpu_torch.tools.admin`` starts a controller, a server
(``--device cpu``) and a broker as processes of their own, which then
answer queries. Against a port cluster on ``device="cpu"`` the port's
AddTable, LaunchDataIngestionJob, PostQuery, ListTables, ListSegments,
ReloadTable, RebalanceTable, DeleteSegment, ConvertSegmentFormat and
RecommendConfig print what the reference's CLI prints against the same
cluster (less the query's time), and leave the same state behind.
QuickStart runs the example cluster with its queries, and the
quickstart's answers equal the reference's.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the engine)

import pinot_tpu.tools.admin as jadmin
import pinot_tpu.tools.quickstart as jqs
import pinot_tpu_torch.cluster as tcluster
import pinot_tpu_torch.tools.admin as tadmin
import pinot_tpu_torch.tools.quickstart as tqs
from pinot_tpu_torch.cluster.http_util import http_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(pred, what):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        try:
            if pred():
                return
        except OSError:
            pass
        time.sleep(0.1)
    pytest.fail(f"{what} not within {WAIT_S} s")


def _run(admin, argv, capsys):
    rc = admin.main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture
def cluster(tmp_path):
    ctrl = tcluster.Controller(str(tmp_path / "ctrl"), heartbeat_timeout=30.0,
                               reconcile_interval=0.1)
    server = tcluster.ServerNode("server_0", ctrl.url, poll_interval=0.1,
                                 device="cpu")
    broker = tcluster.BrokerNode(ctrl.url, routing_refresh=0.1)
    yield ctrl, server, broker
    broker.stop()
    server.stop()
    for dm in list(server._tables.values()):
        for seg in dm.acquire_segments():
            seg.evict_device()
    ctrl.stop()


def _sync(ctrl, server, broker):
    v = ctrl.routing_snapshot()["version"]
    assert server.wait_for_version(v, WAIT_S)
    assert broker.wait_for_version(v, WAIT_S)


def test_commands_match_the_reference_cli(cluster, tmp_path, capsys):
    ctrl, server, broker = cluster
    schema = tqs.example_schema()
    sf = tmp_path / "schema.json"
    sf.write_text(json.dumps(schema.to_dict()))
    raw = tmp_path / "raw"
    tqs.write_example_data(str(raw), 400)
    out = {}
    for name, admin in (("jax", jadmin), ("torch", tadmin)):
        table = f"bs_{name}"
        outs = []
        rc, text = _run(admin, ["AddTable", "--controller", ctrl.url,
                                "--schema-file", str(sf), "--name", table],
                        capsys)
        outs.append((rc, text.replace(name, "<pkg>")))
        spec = tmp_path / f"job_{name}.json"
        spec.write_text(json.dumps({
            "inputDirURI": str(raw),
            "outputDirURI": str(tmp_path / f"segments_{name}"),
            "tableName": table, "schema": schema.to_dict(),
            "rowsPerSegment": 100,
            "push": {"controllerUrl": ctrl.url,
                     "deepstoreURI": f"file://{tmp_path}/deep_{name}"}}))
        rc, text = _run(admin, ["LaunchDataIngestionJob", "--job-spec",
                                str(spec)], capsys)
        outs.append((rc, text.replace(name, "<pkg>")))
        _sync(ctrl, server, broker)
        for sql in ("SELECT COUNT(*), SUM(runs) FROM {t}",
                    "SELECT teamID, MAX(hits) FROM {t} GROUP BY teamID "
                    "ORDER BY teamID"):
            rc, text = _run(admin, ["PostQuery", "--broker", broker.url,
                                    "--query", sql.format(t=table)],
                            capsys)
            lines = text.splitlines()
            # the last line carries the query's time
            outs.append((rc, lines[:-1],
                         lines[-1].split(", ")[0]))
        rc, text = _run(admin, ["ListSegments", "--controller", ctrl.url,
                                "--table", table], capsys)
        listed = json.loads(text.replace(name, "<pkg>"))
        for seg in listed["segments"].values():
            # each build's wall clock, the one field apart
            assert seg["metadata"].pop("creationTimeMs") > 0
        outs.append((rc, listed))
        rc, text = _run(admin, ["RebalanceTable", "--controller", ctrl.url,
                                "--table", table, "--dry-run"], capsys)
        outs.append((rc, json.loads(text)["status"]))
        cfg = {"tableName": table, "indexing": {
            "invertedIndexColumns": ["teamID"]}}
        cf = tmp_path / f"cfg_{name}.json"
        cf.write_text(json.dumps(cfg))
        rc, text = _run(admin, ["ReloadTable", "--controller", ctrl.url,
                                "--table", table, "--config-file", str(cf)],
                        capsys)
        outs.append((rc, json.loads(text)))
        rc, text = _run(admin, ["DeleteSegment", "--controller", ctrl.url,
                                "--table", table, "--segment",
                                f"{table}_0"], capsys)
        outs.append((rc, text.replace(name, "<pkg>")))
        _sync(ctrl, server, broker)
        rc, text = _run(admin, ["PostQuery", "--broker", broker.url,
                                "--query", f"SELECT COUNT(*) FROM {table}"],
                        capsys)
        outs.append((rc, text.splitlines()[:-1]))
        out[name] = outs
    assert out["torch"] == out["jax"]
    assert out["torch"][-1] == (0, ["count(*)", "300"])
    rc, text = _run(tadmin, ["ListTables", "--controller", ctrl.url], capsys)
    rc_j, text_j = _run(jadmin, ["ListTables", "--controller", ctrl.url],
                        capsys)
    assert (rc, text) == (rc_j, text_j)
    listed = json.loads(text)["tables"]
    names = set(listed) if isinstance(listed, dict) else {
        t["name"] if isinstance(t, dict) else t for t in listed}
    assert {"bs_jax", "bs_torch"} <= names
    # the port's server holds the reloaded index on the CPU
    seg = server._tables["bs_torch"].acquire_segments()[0]
    assert "inverted" in seg.columns["teamID"].indexes
    assert seg.device.type == "cpu"


def test_offline_commands_match(tmp_path, capsys):
    """ConvertSegmentFormat leaves byte-equal directories; RecommendConfig
    prints the reference's advice."""
    import pinot_tpu.segment as jseg
    import pinot_tpu.spi as jspi

    schema = jspi.Schema("r", [
        jspi.FieldSpec("cust", jspi.DataType.STRING),
        jspi.FieldSpec("amount", jspi.DataType.LONG,
                       jspi.FieldType.METRIC)])
    rng = np.random.default_rng(4)
    cols = {"cust": rng.choice(["a", "b", "c"], 500),
            "amount": rng.integers(0, 99, 500).astype(np.int64)}
    files = {}
    for name, admin in (("jax", jadmin), ("torch", tadmin)):
        d = jseg.SegmentBuilder(schema, jspi.TableConfig("r")).build(
            cols, str(tmp_path / name), "seg_0")
        got = []
        for to in ("v3", "v1", "v3"):
            rc, text = _run(admin, ["ConvertSegmentFormat", "--segment-dir",
                                    d, "--to", to], capsys)
            got.append((rc, json.loads(text)["formatVersion"]))
        listing = {}
        for f in sorted(os.listdir(d)):
            if f != "metadata.json":
                with open(os.path.join(d, f), "rb") as fh:
                    listing[f] = fh.read()
        files[name] = (got, listing)
    assert files["torch"] == files["jax"]
    sf = tmp_path / "schema.json"
    sf.write_text(json.dumps(schema.to_dict()))
    wf = tmp_path / "workload.txt"
    wf.write_text("10\tSELECT COUNT(*) FROM r WHERE cust = 'a'\n"
                  "SELECT SUM(amount) FROM r WHERE amount > 5\n")
    cf = tmp_path / "cards.json"
    cf.write_text(json.dumps({"cust": 5000}))
    args = ["RecommendConfig", "--schema-file", str(sf), "--workload-file",
            str(wf), "--cardinalities", str(cf)]
    assert _run(tadmin, args, capsys) == _run(jadmin, args, capsys)


def test_quickstart_matches(tmp_path, capsys):
    """QuickStart on the CPU answers the reference quickstart's rows."""
    rc, text = _run(tadmin, ["QuickStart", "--exit-after", "--rows", "800",
                             "--device", "cpu", "--work-dir",
                             str(tmp_path / "qs")], capsys)
    assert rc == 0 and "served from: cpu" in text
    ref = jqs.Quickstart(work_dir=str(tmp_path / "ref"), rows=800).start()
    try:
        want = [[tuple(r) for r in res.rows]
                for res in ref.run_sample_queries(out=lambda s: None)]
    finally:
        ref.stop()
    got = []
    for block in text.split("\n> ")[1:]:
        rows = [ln.strip() for ln in block.splitlines()[2:] if ln.strip()]
        got.append([r for r in rows if not r.startswith("served from")])
    assert len(got) == len(tqs.SAMPLE_QUERIES) == len(want)
    for g, w in zip(got, want):
        assert g == [" | ".join(str(v) for v in row) for row in w]


def test_roles_start_as_processes(tmp_path):
    """StartController, StartServer --device cpu and StartBroker run as
    processes of their own; a query posted through the CLI's broker is
    answered by the CLI's server."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    base = [sys.executable, "-m", "pinot_tpu_torch.tools.admin"]
    # the server retries its registration until the controller is up
    procs = [subprocess.Popen(base + args, cwd=ROOT, env=env,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
             for args in (["StartController", "--data-dir",
                           str(tmp_path / "ctrl"), "--port", str(port)],
                          ["StartServer", "--controller", url, "--id",
                           "cli_s0", "--device", "cpu"])]
    try:
        _wait(lambda: http_json("GET", f"{url}/health")["status"] == "OK",
              "the controller")
        procs.append(subprocess.Popen(
            base + ["StartBroker", "--controller", url], cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))

        def roles():
            inst = http_json("GET", f"{url}/routing")["instances"]
            return sorted(i.get("role", "server") for i in inst.values())

        _wait(lambda: roles() == ["broker", "server"], "the server and "
              "the broker")
        schema = tqs.example_schema()
        tqs.write_example_data(str(tmp_path / "raw"), 200)
        http_json("POST", f"{url}/tables", {
            "name": "baseballStats", "schema": schema.to_dict(),
            "replication": 1})
        from pinot_tpu_torch.ingestion import run_batch_ingestion
        run_batch_ingestion({
            "inputDirURI": str(tmp_path / "raw"),
            "outputDirURI": str(tmp_path / "segs"),
            "tableName": "baseballStats", "schema": schema.to_dict(),
            "rowsPerSegment": 200,
            "push": {"controllerUrl": url,
                     "deepstoreURI": f"file://{tmp_path}/deep"}})
        inst = http_json("GET", f"{url}/routing")["instances"]
        burl = next(f"http://{i['host']}:{i['port']}" for i in inst.values()
                    if i.get("role") == "broker")
        answer = {}

        def counted():
            answer["r"] = http_json("POST", f"{burl}/query/sql", {
                "sql": "SELECT COUNT(*) FROM baseballStats"})
            return answer["r"]["resultTable"]["rows"] == [[200]]

        _wait(counted, "the CLI cluster's answer")
    finally:
        for p in procs[::-1]:
            p.terminate()
        for p in procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
