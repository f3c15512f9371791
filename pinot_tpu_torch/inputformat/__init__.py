"""Input-format record readers (batch ingestion sources).

Port of ``pinot_tpu/inputformat/__init__.py``: CSV and JSON (array or
JSON lines) read with the standard library, as the reference reads them.
Avro, Parquet, ORC, protobuf, Thrift and CLP
(``pinot_tpu/inputformat/{avro,extended}.py``) come with the cluster
plane; ``read_records`` raises ``NotImplementedError`` naming the module
for them.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List

FORMATS = ("csv", "json", "avro", "parquet", "orc", "protobuf",
           "thrift", "clp")


def _infer(v: str) -> Any:
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def read_csv(path: str) -> List[Dict[str, Any]]:
    with open(path, newline="") as fh:
        return [{k: _infer(v) if v != "" else None for k, v in row.items()}
                for row in csv.DictReader(fh)]


def read_json(path: str) -> List[Dict[str, Any]]:
    """A JSON array file, or JSON-lines (one object per line)."""
    with open(path) as fh:
        text = fh.read().strip()
    if text.startswith("["):
        rows = json.loads(text)
    else:
        rows = [json.loads(line) for line in text.splitlines() if line]
    if not isinstance(rows, list):
        raise ValueError(f"{path}: expected a JSON array or JSON lines")
    return rows


_PENDING = {"avro": "pinot_tpu/inputformat/avro.py",
            "parquet": "pinot_tpu/inputformat/__init__.py (pyarrow)",
            "orc": "pinot_tpu/inputformat/extended.py",
            "protobuf": "pinot_tpu/inputformat/extended.py",
            "thrift": "pinot_tpu/inputformat/extended.py",
            "clp": "pinot_tpu/inputformat/extended.py"}

_READERS = {"csv": read_csv, "json": read_json}


def read_records(path: str, fmt: str = "",
                 **format_args: Any) -> List[Dict[str, Any]]:
    """Read a CSV or JSON file into row dicts; the format is inferred
    from the extension when not given."""
    fmt = (fmt or os.path.splitext(path)[1].lstrip(".")).lower()
    if fmt == "jsonl":
        fmt = "json"
    if fmt in _PENDING:
        raise NotImplementedError(
            f"{fmt} input is not ported yet: it waits for the port of "
            f"{_PENDING[fmt]}, which comes with the cluster plane")
    reader = _READERS.get(fmt)
    if reader is None:
        raise ValueError(f"unknown input format {fmt!r}; have {FORMATS}")
    return reader(path, **format_args)
