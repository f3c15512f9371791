"""Batch ingestion job: read input files -> transform -> build segments
-> push.

Port of ``pinot_tpu/ingestion/batch.py``: the standalone and the
parallel runner, byte-equal segments, and the push to a controller
(``push.controllerUrl``, with a deep-store tar upload when
``push.deepstoreURI`` is set) through ``cluster/deepstore``.

Reference parity: pinot-spi/.../ingestion/batch/spec/
SegmentGenerationJobSpec + pinot-plugins/pinot-batch-ingestion/
pinot-batch-ingestion-standalone (the standalone runner) with the two
push modes: tar/metadata push to a controller (deep store) or plain
local segment output. The reference's Spark/Hadoop runners
(pinot-batch-ingestion-spark SparkSegmentGenerationJobRunner) map one
input file to one segment-generation task across executors; the
"parallel" execution framework here does the same over a local process
pool (executionFrameworkSpec: {"name": "parallel", "numWorkers": N}) —
per-file tasks, worker-disjoint segment names, pushes serialized in the
launching process in file order, like the reference's runner.

Job spec (dict; JSON/YAML-friendly, SegmentGenerationJobSpec analog):
    {
      "inputDirURI": "/data/in",            # or "inputFiles": [...]
      "includeFileNamePattern": "*.csv",    # fnmatch, default all
      "format": "csv",                # csv|json|jsonl|avro|parquet|orc|
                                      # protobuf|thrift|clp
      "formatArgs": {...},            # reader config (protobuf:
                                      # descriptor_file+message_type;
                                      # thrift: field_names; clp: fields)
      "outputDirURI": "/data/segments",
      "tableName": "mytable",
      "schema": {...},                      # Schema.to_dict()
      "tableConfig": {...},                 # TableConfig.to_dict()
      "segmentNamePrefix": "mytable",       # default tableName
      "rowsPerSegment": 1000000,
      "push": {                             # optional
        "controllerUrl": "http://...",
        "deepstoreURI": "file:///deepstore" # tar push when set,
      }                                     # location push otherwise
    }
"""
from __future__ import annotations

import fnmatch
import os
from typing import Any, Dict, List

from ..inputformat import read_records
from ..segment.builder import SegmentBuilder
from ..spi.config import TableConfig
from ..spi.schema import Schema
from .transformers import CompositeTransformer


class BatchIngestionJob:
    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec
        self.schema = Schema.from_dict(spec["schema"])
        self.table_config = TableConfig.from_dict(
            spec.get("tableConfig")
            or {"tableName": spec["tableName"]})
        self.table = spec.get("tableName") or self.table_config.table_name

    # -- input discovery ---------------------------------------------------
    def input_files(self) -> List[str]:
        if self.spec.get("inputFiles"):
            return list(self.spec["inputFiles"])
        root = self.spec["inputDirURI"]
        pattern = self.spec.get("includeFileNamePattern", "*")
        out: List[str] = []
        for dirpath, _dirs, files in os.walk(root):
            for f in sorted(files):
                if fnmatch.fnmatch(f, pattern):
                    out.append(os.path.join(dirpath, f))
        if not out:
            raise FileNotFoundError(
                f"no input files under {root!r} matching {pattern!r}")
        return out

    # -- run ---------------------------------------------------------------
    def run(self) -> List[str]:
        fw = (self.spec.get("executionFrameworkSpec") or {})
        if fw.get("name") in ("parallel", "spark", "hadoop"):
            return self._run_parallel(int(fw.get("numWorkers") or 0))
        return self._run_standalone()

    def _run_parallel(self, workers: int) -> List[str]:
        """Per-file fan-out over WORKER PROCESSES this process launches
        (Spark runner analog: one segment-generation task per input
        file; rowsPerSegment splits within a file). Plain subprocesses
        running ``python -m pinot_tpu_torch.ingestion.batch --file-task``,
        not a multiprocessing pool: fork would deadlock a parent holding
        torch's runtime threads, and spawn/forkserver re-import the
        parent's __main__ (broken for a REPL or stdin script). Segment
        names carry the file index so tasks never collide; pushes happen
        in this process, in file order."""
        import json as _json
        import shutil
        import subprocess
        import sys
        import tempfile
        import time as _time

        files = self.input_files()
        workers = workers or min(len(files), os.cpu_count() or 1)
        push = self.spec.get("push") or {}
        work_dir = tempfile.mkdtemp(prefix="pinot_ingest_")
        spec_path = os.path.join(work_dir, "spec.json")
        with open(spec_path, "w") as fh:
            _json.dump(self.spec, fh)
        # workers must import pinot_tpu_torch in a FRESH interpreter: carry
        # this process's sys.path (a REPL session patches it rather than
        # installing the package)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [p for p in sys.path if p]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        procs: List[tuple] = []
        pending = list(enumerate(files))
        results: Dict[int, List[str]] = {}
        try:
            while pending or procs:
                while pending and len(procs) < workers:
                    idx, path = pending.pop(0)
                    out_path = os.path.join(work_dir, f"task_{idx}.json")
                    log_path = os.path.join(work_dir, f"task_{idx}.log")
                    # results travel via --out FILES and worker output
                    # via a redirected log file, never pipes: a chatty
                    # worker can neither block on a full pipe nor
                    # corrupt the result protocol with stray prints
                    log_fh = open(log_path, "wb")
                    procs.append((idx, subprocess.Popen(
                        [sys.executable, "-m",
                         "pinot_tpu_torch.ingestion.batch", "--file-task",
                         spec_path, path, str(idx), "--out", out_path],
                        stdout=log_fh, stderr=subprocess.STDOUT,
                        env=env), out_path, log_path, log_fh))
                # reap ANY finished worker (no head-of-line blocking: a
                # big file must not idle the other slots)
                done = [i for i, entry in enumerate(procs)
                        if entry[1].poll() is not None]
                if not done:
                    _time.sleep(0.05)
                    continue
                for i in reversed(done):
                    idx, p, out_path, log_path, log_fh = procs.pop(i)
                    p.wait()
                    log_fh.close()
                    if p.returncode != 0 or not os.path.exists(out_path):
                        with open(log_path, "rb") as lf:
                            lf.seek(max(0, os.path.getsize(log_path)
                                        - 2000))
                            tail = lf.read().decode(errors="replace")
                        raise RuntimeError(
                            f"ingestion task {idx} failed: {tail}")
                    with open(out_path) as rf:
                        results[idx] = _json.load(rf)
            seg_dirs = [d for idx in sorted(results)
                        for d in results[idx]]
        finally:
            # a failed task must not leave siblings running (they would
            # keep writing segments after the job reported failure)
            for entry in procs:
                entry[1].kill()
                entry[1].wait()
                entry[4].close()
            shutil.rmtree(work_dir, ignore_errors=True)
        if not push.get("controllerUrl"):
            return seg_dirs
        return [self._push(d, push) for d in seg_dirs]

    def job_params(self):
        """(fmt, pipeline, out_dir, prefix, per_seg, builder) — the ONE
        derivation of spec keys both runners share."""
        return (self.spec.get("format", ""),
                CompositeTransformer.from_table_config(
                    self.table_config, self.schema),
                self.spec["outputDirURI"],
                self.spec.get("segmentNamePrefix", self.table),
                int(self.spec.get("rowsPerSegment", 1_000_000)),
                SegmentBuilder(self.schema, self.table_config))

    def _run_standalone(self) -> List[str]:
        """Execute the job; returns the registered segment locations
        (deep-store URIs in tar-push mode, local dirs otherwise).

        Streaming: each input file is read + transformed on its own and
        segments flush as the buffer reaches rowsPerSegment, so peak
        memory is one file plus one segment of rows — never the whole
        dataset (the transform pipeline is row-independent, so chunking
        preserves semantics)."""
        fmt, pipeline, out_dir, prefix, per_seg, builder = \
            self.job_params()
        push = self.spec.get("push") or {}

        locations: List[str] = []
        buf: List[Dict[str, Any]] = []

        def flush(chunk: List[Dict[str, Any]]) -> None:
            name = f"{prefix}_{len(locations)}"
            seg_dir = builder.build(chunk, out_dir, name)
            locations.append(self._push(seg_dir, push)
                             if push.get("controllerUrl") else seg_dir)

        for path in self.input_files():
            buf.extend(pipeline.transform(read_records(
                path, fmt, **(self.spec.get("formatArgs") or {}))))
            while len(buf) >= per_seg:
                flush(buf[:per_seg])
                buf = buf[per_seg:]
        if buf:
            flush(buf)
        return locations

    def _push(self, seg_dir: str, push: Dict[str, Any]) -> str:
        """Metadata push: optional deep-store upload, then register the
        segment + pruning metadata with the controller."""
        from ..cluster.deepstore import pruning_metadata, upload_segment
        from ..cluster.http_util import http_json
        location = seg_dir
        if push.get("deepstoreURI"):
            location = upload_segment(
                seg_dir, push["deepstoreURI"].rstrip("/") + "/"
                + self.table)
        http_json("POST", f"{push['controllerUrl']}/segments", {
            "table": self.table,
            "segment": os.path.basename(seg_dir.rstrip("/")),
            "location": location,
            "metadata": pruning_metadata(seg_dir),
        })
        return location


def _build_file_segments(spec: Dict[str, Any], path: str,
                         file_idx: int) -> List[str]:
    """One parallel task: read + transform + build segments for ONE
    input file (the body of the ``--file-task`` worker subprocess)."""
    job = BatchIngestionJob(spec)
    fmt, pipeline, out_dir, prefix, per_seg, builder = job.job_params()
    rows = pipeline.transform(read_records(
        path, fmt, **(spec.get("formatArgs") or {})))
    out: List[str] = []
    for k in range(0, len(rows), per_seg):
        name = f"{prefix}_{file_idx}_{k // per_seg}"
        out.append(builder.build(rows[k:k + per_seg], out_dir, name))
    return out


def run_batch_ingestion(spec: Dict[str, Any]) -> List[str]:
    return BatchIngestionJob(spec).run()


if __name__ == "__main__":
    # worker entry: --file-task spec.json path idx --out result.json
    import json as _json
    import sys as _sys

    if len(_sys.argv) == 7 and _sys.argv[1] == "--file-task" \
            and _sys.argv[5] == "--out":
        with open(_sys.argv[2]) as _fh:
            _spec = _json.load(_fh)
        _dirs = _build_file_segments(_spec, _sys.argv[3],
                                     int(_sys.argv[4]))
        _tmp = _sys.argv[6] + ".tmp"
        with open(_tmp, "w") as _out:
            _json.dump(_dirs, _out)
        os.replace(_tmp, _sys.argv[6])  # exists == complete
    else:
        raise SystemExit(
            "usage: python -m pinot_tpu_torch.ingestion.batch "
            "--file-task <spec.json> <input-file> <file-idx> "
            "--out <result.json>")
