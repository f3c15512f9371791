"""The port's rolling-upgrade verifier (pinot_tpu_torch/tools/compat.py)
against the JAX package's on the CPU.

The yaml op suite rolls every role of a port cluster over its persistent
state; a failed expectation raises CompatError; the golden segment and
wire blobs committed from an earlier incarnation load and decode through
the port; the upgrade from the JAX package's incarnation to the port's,
over the same controller store and segment directories, answers with the
JAX verifier's rows; and a device error inside a server, or a wrong
answer, fails the op at once instead of being retried through the roll
window.
"""
import os
import time

import pytest
import yaml

from pinot_tpu_torch.tools.compat import (CompatError, CompatVerifier,
                                          check_golden_segment,
                                          check_golden_wire, run_suite_file)

RES = os.path.join(os.path.dirname(__file__), "resources")
GOLDEN = os.path.join(RES, "golden")
SUITE = os.path.join(RES, "compat_suite.yaml")


def _seed_ops(table="t"):
    return [
        {"op": "createTable", "table": table, "replication": 1,
         "schema": {"k": "STRING", "v": "INT"}, "metrics": ["v"]},
        {"op": "ingestRows", "table": table, "segment": "s0",
         "rows": [{"k": "a", "v": 1}, {"k": "b", "v": 2}]},
    ]


def test_rolling_upgrade_suite_on_the_port(tmp_path):
    log = run_suite_file(SUITE, str(tmp_path / "compat"), device="cpu")
    assert any(entry.startswith("rolled controller") for entry in log)
    assert any(entry.startswith("rolled server") for entry in log)
    assert any(entry.startswith("rolled broker") for entry in log)
    assert log[-1] == "phase ok: roll-broker-and-everything"


def test_failed_expectation_raises_compat_error(tmp_path):
    v = CompatVerifier(str(tmp_path / "c2"), n_servers=1, device="cpu")
    try:
        v.run_phase({"name": "seed", "ops": _seed_ops()})
        with pytest.raises(CompatError, match="want"):
            v.op_query({"sql": "SELECT SUM(v) FROM t", "expect": [[999]]},
                       retry_window=0.5)
    finally:
        v.stop()


def test_golden_segment_and_wire_blobs_through_the_port():
    seg = check_golden_segment(GOLDEN, device="cpu")
    assert seg["n_docs"] == 500 and seg["queries"] == 3
    wire = check_golden_wire(GOLDEN)
    assert wire == {"relation_rows": 4, "stage_plan": "golden-q",
                    "mailbox_rows": 4}


def test_upgrade_from_the_jax_incarnation_to_the_port(tmp_path):
    """Seed with the JAX package's verifier, stop it, and start the
    port's over the same directories: every query phase of the suite
    answers through the port, the seed's query with the JAX verifier's
    very rows."""
    from pinot_tpu.tools.compat import CompatVerifier as JaxVerifier

    with open(SUITE) as fh:
        suite = yaml.safe_load(fh)
    seed, rest = suite["phases"][0], suite["phases"][1:]
    check_sql = seed["ops"][-1]["sql"]
    work = str(tmp_path / "upgrade")
    jv = JaxVerifier(work, n_servers=suite["servers"])
    try:
        jv.run_phase(seed)
        from pinot_tpu.cluster.http_util import http_json
        jax_rows = [tuple(r) for r in http_json(
            "POST", f"{jv.broker.url}/query/sql",
            {"sql": check_sql})["resultTable"]["rows"]]
    finally:
        jv.stop()
    pv = CompatVerifier(work, n_servers=suite["servers"], device="cpu")
    try:
        assert pv.query_rows(check_sql) == jax_rows
        for ph in rest:
            pv.run_phase(ph)
        assert pv.log[-1] == "phase ok: roll-broker-and-everything"
        # the port's segment s2 beside the JAX package's s0 and s1
        assert pv.query_rows(check_sql) == sorted(
            jax_rows + [("north", 100, 1)])
        # the segments the JAX incarnation built are the ones served
        held = {x.name for s in pv.servers
                for x in s._tables["sales"].acquire_segments()}
        assert held == {"s0", "s1", "s2"}
    finally:
        pv.stop()


def test_a_device_error_in_a_server_is_not_retried_away(tmp_path,
                                                        monkeypatch):
    from pinot_tpu_torch.engine import serving

    v = CompatVerifier(str(tmp_path / "dev"), n_servers=1, device="cpu")
    try:
        v.run_phase({"name": "seed", "ops": _seed_ops()})
        calls = []

        def broken(ex):
            calls.append(ex)
            raise RuntimeError("compaction kernel launch failed: CUDA "
                               "error 700 (an illegal memory access was "
                               "encountered)")

        monkeypatch.setattr(serving, "execute_planned", broken)
        t0 = time.monotonic()
        with pytest.raises(CompatError, match="device or kernel failed"):
            v.op_query({"sql": "SELECT SUM(v) FROM t", "expect": [[3]]},
                       retry_window=30.0)
        # failed on the first answer, well inside the retry window
        assert time.monotonic() - t0 < 10.0 and len(calls) == 1
        monkeypatch.undo()
        v.op_query({"sql": "SELECT SUM(v) FROM t", "expect": [[3]]})
    finally:
        v.stop()


def test_a_wrong_answer_fails_the_op_at_once(tmp_path, monkeypatch):
    """A server that answers one wrong SUM (and right ever after) fails
    the op on that answer: a roll has synced every node's routing, so a
    wrong answer is never retried into a right one."""
    from pinot_tpu_torch.engine import serving

    v = CompatVerifier(str(tmp_path / "wrong"), n_servers=1, device="cpu")
    try:
        v.run_phase({"name": "seed", "ops": _seed_ops()})
        real, calls = serving.execute_planned, []

        def wrong_once(ex):
            out = real(ex)
            calls.append(ex)
            if len(calls) == 1:
                out[0].states = [s + 1 for s in out[0].states]
            return out

        monkeypatch.setattr(serving, "execute_planned", wrong_once)
        t0 = time.monotonic()
        with pytest.raises(CompatError, match=r"got \[\(4,\)\], want"):
            v.op_query({"sql": "SELECT SUM(v) FROM t", "expect": [[3]]},
                       retry_window=30.0)
        assert time.monotonic() - t0 < 10.0 and len(calls) == 1
        v.op_query({"sql": "SELECT SUM(v) FROM t", "expect": [[3]]})
        assert len(calls) == 2
    finally:
        v.stop()
