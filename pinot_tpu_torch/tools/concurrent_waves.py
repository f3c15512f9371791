"""chip_smoke.py's concurrent phase at several counts of measured waves,
in one process on the card: whether the count moves the phase's
queries/s, which are averaged over the measured waves.

Run from the repository's root on a machine with a card:

    python3 -m pinot_tpu_torch.tools.concurrent_waves

It builds what the check builds before its concurrent phase (the
kernels, the SSB segment and the 8-segment table, at chip_smoke.py's
rows), runs the 13 SSB queries once on each table as the check's main
and multi phases do, then runs ``chip_smoke.concurrent_phase`` once for each count of
ORDER with ``MEASURED_WAVES`` set to it. Besides chip_smoke.py's
own lines it prints a ``waves_run`` line for each run (the count, the
phase's seconds and, per table and shape, the fields of KEYS) and,
last, one JSON object with every run and the card. Exit 2 without a
card.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORDER = (3, 2, 2, 3)             # each count twice, each first once
# each run's fields, per table and shape, from the phase's concurrent lines
KEYS = ("qps_fused", "qps_serial", "p50_fused_ms", "p50_serial_ms",
        "measured_cube_builds", "measured_cube_misses")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("concurrent_waves: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    from ..broker import Broker, connect
    from ..server import TableDataManager
    from . import ssb

    rows: list = []
    printed = CS.phase

    def phase(label, /, **fields):
        printed(label, **fields)
        if label == "concurrent":
            rows.append(fields)

    CS.phase = phase
    smi = CS.device_phase()
    table_job = CS.start_table_build()
    kernels_built = CS._in_background(CS.build_phase)
    seg_dir = CS.segment_phase()
    kernels_built()
    CS.native_phase()
    table_dir = CS.table_phase(table_job)
    single_dm = TableDataManager("lineorder", device="cuda")
    single = single_dm.add_segment_dir(seg_dir)
    segs_dm = TableDataManager("lineorder", device="cuda")
    segs = segs_dm.add_table_dir(table_dir)
    # the check's main and multi phases run the 13 queries on both tables
    # before its concurrent phase, whose leak check takes the columns they
    # made resident as its start
    for dm in (single_dm, segs_dm):
        broker = Broker(device="cuda")
        broker.register_table(dm)
        query = connect(broker)
        for _qid, p, v, g in ssb.QUERIES:
            query(ssb.spec_to_sql(p, v, g))
    runs = []
    for waves in ORDER:
        CS.MEASURED_WAVES = waves
        del rows[:]
        t0 = time.perf_counter()
        CS.concurrent_phase(single, segs)
        runs.append({"waves": waves,
                     "seconds": time.perf_counter() - t0,
                     **{key: {f"{r['table']} {r['shape']}": r[key]
                              for r in rows} for key in KEYS}})
        printed("waves_run", **runs[-1])
    print(json.dumps({"runs": runs, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
