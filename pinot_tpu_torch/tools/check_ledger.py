"""Validate a ledger file against the unified v2 schema.

Every line must parse as JSON; lines carrying ``"v": 2`` must satisfy
the per-kind field contract in ``pinot_tpu_torch/utils/ledger.py`` —
unknown or missing fields fail, so a typo'd field name can never
silently fork the schema. Lines WITHOUT a ``v`` field are grandfathered
pre-v2 history (``--strict`` rejects them too, for freshly-started
ledgers). The port's copy of the root ``tools/check_ledger.py``: same
arguments, output and exit codes, over the port's ledger contracts. It
touches no device.

    python -m pinot_tpu_torch.tools.check_ledger [path ...] [--strict]

Exit 0 when every line validates, 1 otherwise; one summary JSON line
per path.
"""
from __future__ import annotations

import json
import os
import sys

from ..utils import ledger as uledger

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def check(path: str, strict: bool = False) -> int:
    res = uledger.validate_file(path)
    for lineno, msg in res["errors"]:
        print(f"{path}:{lineno}: {msg}")
    rc = 1 if res["errors"] else 0
    if strict and res["legacy"]:
        print(f"{path}: {res['legacy']} legacy (pre-v2) line(s) "
              "rejected by --strict")
        rc = 1
    print(json.dumps({"path": path, "lines": res["lines"],
                      "v2": res["v2"], "legacy": res["legacy"],
                      "kinds": res["kinds"],
                      "errors": len(res["errors"]),
                      "ok": rc == 0}))
    return rc


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    strict = "--strict" in args
    paths = [a for a in args if a != "--strict"] \
        or [os.path.join(REPO, "PERF_LEDGER.jsonl")]
    rc = 0
    for p in paths:
        if not os.path.exists(p):
            print(f"{p}: not found")
            rc = 1
            continue
        rc = max(rc, check(p, strict))
    return rc


if __name__ == "__main__":
    sys.exit(main())
