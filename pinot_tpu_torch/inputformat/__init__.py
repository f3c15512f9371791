"""Input-format record readers (batch ingestion sources).

Port of ``pinot_tpu/inputformat/__init__.py`` (pinot-plugins/
pinot-input-format/ — RecordReader SPI implementations for csv, json,
avro, parquet, orc, protobuf, thrift, clp). CSV and JSON(L) read with
the standard library; Avro container files decode through the port's
own binary codec (``inputformat/avro.py``); Parquet loads through
pyarrow when present and raises the reference's gating error when not;
ORC, protobuf, Thrift and CLP come from ``inputformat/extended.py``.
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


def read_avro(path: str) -> List[Dict[str, Any]]:
    """Object-container-file reader — the binary codec of
    inputformat/avro.py, no fastavro dependency."""
    from .avro import read_container
    return read_container(path)


def read_parquet(path: str) -> List[Dict[str, Any]]:
    try:
        import pyarrow.parquet as pq  # type: ignore[import-not-found]
    except ImportError:
        raise RuntimeError(
            "parquet input needs the 'pyarrow' package, which is not "
            "installed in this environment") from None
    return pq.read_table(path).to_pylist()


_READERS = {"csv": read_csv, "json": read_json, "avro": read_avro,
            "parquet": read_parquet}


def read_records(path: str, fmt: str = "",
                 **format_args: Any) -> List[Dict[str, Any]]:
    """Read a file into row dicts; format inferred from the extension when
    not given. protobuf needs (descriptor_file, message_type), thrift
    needs field_names={id: name}, clp accepts fields=(...) — see
    inputformat/extended.py."""
    fmt = (fmt or os.path.splitext(path)[1].lstrip(".")).lower()
    if fmt == "jsonl":
        fmt = "json"
    if fmt in ("orc", "protobuf", "thrift", "clp") \
            and fmt not in _READERS:
        from . import extended
        _READERS.update(orc=extended.read_orc,
                        protobuf=extended.read_protobuf,
                        thrift=extended.read_thrift,
                        clp=extended.read_clp)
    reader = _READERS.get(fmt)
    if reader is None:
        raise ValueError(f"unknown input format {fmt!r}; have {FORMATS}")
    return reader(path, **format_args)
