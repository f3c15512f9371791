"""The segment completion protocol of the port against the JAX package, on
the CPU.

``pinot_tpu_torch.cluster.completion.SegmentCompletionManager`` answers
the reference FSM's call sequences (the cases of the reference's own FSM
tests, a TTL purge with the registry fallback, a takeover) with the same
responses under the same clock: the port's FSM takes an injected clock,
the reference's module clock is replaced for the test. Then two replicas
of a realtime table (``RealtimeTableDataManager`` with a
``CompletionClient``) commit through a controller over loopback HTTP in
every fleet: all reference, all port, port replicas with a reference
controller, reference replicas with a port controller, and one replica of
each package; with no fault plan and with a ``commit.http_error`` on a
``segmentCommitEnd`` leg plus a ``handoff.stall`` on an adopt. Every fleet
gives the reference fleet's segments, committers, offsets, checkpoints,
rows, segment files (byte for byte; metadata.json less its creation
time) and fired faults, and each row lands once.
"""
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the engine)

import pinot_tpu.cluster as jcluster
import pinot_tpu.cluster.completion as jcomp
import pinot_tpu.realtime as jrt
import pinot_tpu.spi as jspi
import pinot_tpu.utils.faults as jfaults
import pinot_tpu_torch.cluster as tcluster
import pinot_tpu_torch.cluster.completion as tcomp
import pinot_tpu_torch.realtime as trt
import pinot_tpu_torch.spi as tspi
import pinot_tpu_torch.utils.faults as tfaults

TABLE = "events_REALTIME"
PARTS = 2
ROUNDS = 2
FLUSH = 16
WAIT_S = 30.0


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _fsm(name, clock, replicas=2, window=0.2, timeout=30.0, ttl=300.0,
         registered=None):
    if name == "jax":
        return jcomp.SegmentCompletionManager(
            lambda t: replicas, decision_window_s=window,
            commit_timeout_s=timeout, committed_ttl_s=ttl,
            registered_segment=registered)
    return tcomp.SegmentCompletionManager(
        lambda t: replicas, decision_window_s=window,
        commit_timeout_s=timeout, committed_ttl_s=ttl,
        registered_segment=registered, clock=clock)


# each case: FSM settings and steps; a step is ("consumed", server, offset),
# ("start", server), ("end", server, uri), ("advance", seconds) or
# ("status",); the segment is "seg" of table "t" unless a step names one
FSM_CASES = {
    "election_largest_offset_wins": ({}, [
        ("consumed", "s1", 100), ("consumed", "s2", 120),
        ("consumed", "s1", 100), ("status",)]),
    "catchup_then_commit_visibility": ({}, [
        ("consumed", "s1", 50), ("consumed", "s2", 90), ("start", "s2"),
        ("end", "s2", "file:///x.tar.gz"), ("consumed", "s1", 50),
        ("status",)]),
    "laggard_gets_catchup": ({"window": 0.05}, [
        ("consumed", "s1", 10), ("advance", 0.1), ("consumed", "s1", 10),
        ("consumed", "s2", 5), ("consumed", "s2", 10)]),
    "commit_start_rejects_non_winner": ({"replicas": 1}, [
        ("consumed", "s1", 10), ("start", "s2"), ("end", "s2", "u"),
        ("start", "s1")]),
    "takeover_after_commit_timeout": ({"window": 0.01, "timeout": 0.05}, [
        ("consumed", "s1", 10), ("advance", 0.02), ("consumed", "s1", 10),
        ("advance", 0.1), ("consumed", "s2", 10), ("start", "s1"),
        ("start", "s2"), ("end", "s2", "file:///y.tar.gz"),
        ("consumed", "s1", 10), ("status",)]),
    "winner_past_target_commits_all": ({}, [
        ("consumed", "s1", 40), ("consumed", "s2", 30),
        ("consumed", "s1", 44), ("consumed", "s2", 31),
        ("consumed", "s2", 44)]),
    "ttl_purge_then_registry": ({"ttl": 5.0}, [
        ("consumed", "s1", 7), ("consumed", "s2", 7), ("start", "s1"),
        ("end", "s1", "file:///z.tar.gz"), ("advance", 6.0),
        ("consumed", "s3", 3), ("status",),
        ("consumed", "s2", 7, "other")]),
}


def _drive(fsm, clock, steps, registry):
    out = []
    for step in steps:
        op = step[0]
        seg = step[3] if op == "consumed" and len(step) > 3 else "seg"
        if op == "advance":
            clock.t += step[1]
        elif op == "consumed":
            out.append(fsm.segment_consumed("t", seg, step[1], step[2]))
        elif op == "start":
            out.append(fsm.segment_commit_start("t", "seg", step[1]))
        elif op == "end":
            def register(uri=step[2]):
                registry[("t", "seg")] = {"downloadURI": uri,
                                          "offset": None}
            out.append(fsm.segment_commit_end("t", "seg", step[1],
                                              step[2], register=register))
        else:
            st = fsm.status("t", "seg")
            out.append(None if st is None else {
                k: v for k, v in st.items()
                if k not in ("first_ts", "commit_ts")})
    return out


@pytest.mark.parametrize("case", sorted(FSM_CASES))
def test_fsm_answers_match(case, monkeypatch):
    """The same call sequence under the same clock gives the same
    responses and final state in both FSMs."""
    settings, steps = FSM_CASES[case]
    answers = {}
    for name in ("torch", "jax"):
        clock, registry = FakeClock(), {}

        class _Time:
            monotonic = staticmethod(lambda c=clock: c.t)

        # the reference FSM reads time.monotonic() of its module
        monkeypatch.setattr(jcomp, "time", _Time)
        fsm = _fsm(name, clock,
                   registered=lambda t, s, r=registry: r.get((t, s)),
                   **settings)
        answers[name] = _drive(fsm, clock, steps, registry)
    assert answers["torch"] == answers["jax"]
    assert answers["torch"]


def test_fsm_clock_drives_the_window():
    """The injected clock alone decides the window: a solo report HOLDs
    until the clock passes the window, then elects its reporter."""
    clock = FakeClock()
    fsm = _fsm("torch", clock, window=0.5)
    assert fsm.segment_consumed("t", "s", "a", 5) == {"status": "HOLD"}
    clock.t += 0.49
    assert fsm.segment_consumed("t", "s", "a", 5) == {"status": "HOLD"}
    clock.t += 0.02
    assert fsm.segment_consumed("t", "s", "a", 5) == {"status": "COMMIT",
                                                      "offset": 5}


# -- two replicas over HTTP ---------------------------------------------------

def _pkg(name):
    if name == "jax":
        return SimpleNamespace(
            name=name, spi=jspi, rt=jrt, comp=jcomp, faults=jfaults,
            controller=jcluster.Controller,
            manager=lambda *a, **k: jrt.RealtimeTableDataManager(*a, **k))
    return SimpleNamespace(
        name=name, spi=tspi, rt=trt, comp=tcomp, faults=tfaults,
        controller=tcluster.Controller,
        manager=lambda *a, **k: trt.RealtimeTableDataManager(
            *a, device="cpu", **k))


def _schema(ns):
    s = ns.spi
    return s.Schema("events", [
        s.FieldSpec("k", s.DataType.STRING),
        s.FieldSpec("p", s.DataType.INT),
        s.FieldSpec("v", s.DataType.LONG, s.FieldType.METRIC)])


def _rows():
    rng = np.random.default_rng(11)
    out = [[] for _ in range(PARTS)]
    for p in range(PARTS):
        for i in range(ROUNDS * FLUSH):
            out[p].append({"k": f"k{int(rng.integers(0, 5))}", "p": p,
                           "v": int(rng.integers(0, 1 << 40))})
    return out


FAULTS = ("seed=5; commit.http_error: match=segmentCommitEnd/"
          f"{TABLE}__1__0, times=1; handoff.stall: match={TABLE}__0__1, "
          "times=1")


def _commit_fleet(tmp_path, ctrl_pkg, rep_pkgs, plan):
    """Two replicas commit ROUNDS segments in each of PARTS partitions
    through a controller; returns what each replica ended with."""
    ctrl_ns = _pkg(ctrl_pkg)
    ctrl = ctrl_ns.controller(str(tmp_path / "ctrl"), heartbeat_timeout=30.0,
                              reconcile_interval=5.0)
    plans = {}
    try:
        ctrl.add_table(TABLE, _schema(ctrl_ns).to_dict(), replication=2)
        rows = _rows()
        reps, streams, log = [], [], []
        for i, name in enumerate(rep_pkgs):
            ns = _pkg(name)
            stream = ns.rt.InMemoryStream(PARTS, name="events")
            cfg = ns.rt.StreamConfig(
                "events", num_partitions=PARTS, flush_threshold_rows=FLUSH,
                flush_threshold_seconds=1e9, consumer_factory=stream)
            cc = ns.comp.CompletionClient(ctrl.url, f"replica_{i}",
                                          f"file://{tmp_path}/deep")
            real = cc.split_commit

            def split(table, segment, seg_dir, metadata=None, _real=real,
                      _id=f"replica_{i}"):
                ok = _real(table, segment, seg_dir, metadata)
                log.append((_id, segment, ok))
                return ok

            cc.split_commit = split
            m = ns.manager(TABLE, _schema(ns), cfg,
                           str(tmp_path / f"replica_{i}"),
                           completion_client=cc)
            m.report_interval_s = 0.0
            reps.append(m)
            streams.append(stream)
        for name in set(rep_pkgs):
            plans[name] = _pkg(name).faults.install(plan) if plan else None
        for r in range(ROUNDS):
            for stream in streams:
                for p in range(PARTS):
                    stream.produce_many(rows[p][r * FLUSH:(r + 1) * FLUSH],
                                        partition=p)
            for p in range(PARTS):
                name = f"{TABLE}__{p}__{r}"
                order = reps if p % 2 == 0 else reps[::-1]
                for m in order:
                    m.consume_once(p)
                deadline = time.monotonic() + WAIT_S
                while not all(name in m._partition_state(p)["segments"]
                              for m in order):
                    assert time.monotonic() < deadline, name
                    for m in order:
                        if name not in m._partition_state(p)["segments"]:
                            m._maybe_seal(p)
        out = []
        for m in reps:
            with open(os.path.join(m.data_dir, "state.json")) as fh:
                state = json.load(fh)
            segs = sorted(m.acquire_segments(), key=lambda s: s.name)
            data = sorted(
                (s.name, k, int(p), int(v)) for s in segs
                for k, p, v in zip(*(np.asarray(s.raw_values(c)).tolist()
                                     for c in ("k", "p", "v"))))
            metas = {s.name: {k: s.metadata.get(k) for k in
                              ("startOffset", "endOffset", "partition",
                               "totalDocs")} for s in segs}
            files = {}
            for seg in segs:
                for f in sorted(os.listdir(seg.dir)):
                    with open(os.path.join(seg.dir, f), "rb") as fh:
                        raw = fh.read()
                    if f == "metadata.json":
                        # the build's wall clock is the one field apart
                        meta = json.loads(raw)
                        assert meta.pop("creationTimeMs") > 0
                        raw = json.dumps(meta, sort_keys=True).encode()
                    files[f"{seg.name}/{f}"] = raw
            out.append({"state": state, "rows": data, "meta": metas,
                        "consuming": m.consuming_docs, "files": files})
        fired = sorted(f for pl in plans.values() if pl is not None
                       for f in pl.fired_summary())
        statuses = {n: ctrl.completion.status(TABLE, n)["state"]
                    for n in out[0]["meta"]}
        registered = sorted(ctrl.routing_snapshot()["segments"][TABLE])
        return {"replicas": out, "commits": sorted(
            (seg, rid) for rid, seg, ok in log if ok),
            "fired": fired, "statuses": statuses, "registered": registered,
            "rows": rows}
    finally:
        for name in set(rep_pkgs):
            _pkg(name).faults.clear()
        ctrl.stop()


FLEETS = {
    "all_port": ("torch", ("torch", "torch")),
    "port_replicas_jax_controller": ("jax", ("torch", "torch")),
    "jax_replicas_port_controller": ("torch", ("jax", "jax")),
    "one_replica_each": ("torch", ("jax", "torch")),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The all-reference fleet's outcome without and with the plan."""
    return {plan: _commit_fleet(tmp_path_factory.mktemp(f"ref{i}"), "jax",
                                ("jax", "jax"), plan)
            for i, plan in enumerate(("", FAULTS))}


@pytest.mark.parametrize("plan", ("", FAULTS), ids=("clean", "faults"))
@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_two_replica_commit_matches(fleet, plan, reference, tmp_path):
    ctrl_pkg, reps = FLEETS[fleet]
    got = _commit_fleet(tmp_path, ctrl_pkg, reps, plan)
    want = reference[plan]
    assert got["commits"] == want["commits"]
    assert got["statuses"] == want["statuses"]
    assert set(got["statuses"].values()) == {"COMMITTED"}
    assert got["registered"] == want["registered"]
    assert got["fired"] == want["fired"]
    if plan:
        assert [f[0] for f in got["fired"]] == ["commit.http_error",
                                                "handoff.stall"]
    for g, w in zip(got["replicas"], want["replicas"]):
        assert g["state"] == w["state"]
        assert g["meta"] == w["meta"]
        assert g["rows"] == w["rows"]
        assert sorted(g["files"]) == sorted(w["files"])
        differ = [f for f in g["files"] if g["files"][f] != w["files"][f]]
        assert differ == [], differ
        assert g["consuming"] == w["consuming"] == 0
    # each produced row lands exactly once on each replica
    produced = sorted((r["k"], r["p"], r["v"]) for part in got["rows"]
                      for r in part)
    for rep in got["replicas"]:
        assert sorted(x[1:] for x in rep["rows"]) == produced
    # one COMMIT_SUCCESS a segment
    assert len({seg for seg, _r in got["commits"]}) == \
        len(got["commits"]) == PARTS * ROUNDS
