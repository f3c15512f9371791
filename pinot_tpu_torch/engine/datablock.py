"""Binary columnar partial codec — the DataTable/DataBlock analog.

Reference parity: pinot-common/.../datatable/ (versioned binary server->
broker result blocks, DataTableBuilderV4) and common/datablock/
ColumnarDataBlock.java. Pinot ships aggregation partials as length-
prefixed binary blocks over Netty; the JSON wire (engine/serde.py) kept
partials debuggable but costs ~10-70 bytes per group. This codec stores
partials columnar:

- group keys and numeric states as minimal-width little-endian arrays
  (int8/16/32/64 chosen by range, float64 for doubles);
- string key columns dictionary-encoded (unique values + narrow ids) —
  the ColumnarDataBlock trick, which also makes repeated group-key
  strings nearly free;
- AVG states as a (sum, count) column pair; object states (distinct
  sets, mode maps) fall back to the tagged-JSON cell encoding;
- frames > 4 KiB are zlib-compressed (the chunk-codec analog of
  pinot-segment-local io/compression; zlib is the always-available
  codec — see native/ for the zstd path used by segment storage).

`encode_partial`/`decode_partial` are the binary peers of serde.py's
`partial_to_wire`/`partial_from_wire`; cluster/server_node.py streams
them length-prefixed over the /query/bin data plane.

Port of ``pinot_tpu/engine/datablock.py``. For the same partial the
port's bytes equal the reference's, and each package decodes the other's
frames. Partials are host values (Python and numpy) before they reach
the wire.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, List, Tuple

import numpy as np

from .executor import AggPartial, GroupByPartial, SelectionPartial
from .serde import _dec_state, _enc_state

_MAGIC = b"PDB1"
_MAGIC_Z = b"PDBZ"
_COMPRESS_MIN = 4096

_INT_DTYPES = [np.int8, np.int16, np.int32, np.int64]

# column type tags
_C_INT, _C_FLOAT, _C_STRDICT, _C_OBJ, _C_AVG = range(5)
# partial type tags
_P_AGG, _P_GROUPBY, _P_SELECTION = range(3)


def _pack_json(buf: bytearray, obj: Any) -> None:
    b = json.dumps(obj).encode()
    buf += struct.pack("<I", len(b))
    buf += b


def _unpack_json(mv: memoryview, off: int) -> Tuple[Any, int]:
    (n,) = struct.unpack_from("<I", mv, off)
    off += 4
    return json.loads(bytes(mv[off:off + n])), off + n


def _shuffle(arr: np.ndarray) -> bytes:
    """Byte-transpose (blosc shuffle filter): group the k-th byte of every
    element together so zlib sees the near-constant high-byte planes as
    long runs. Self-inverting given (n, itemsize)."""
    n, isz = len(arr), arr.dtype.itemsize
    return arr.view(np.uint8).reshape(n, isz).T.tobytes()


def _unshuffle(raw: memoryview, dtype, n: int) -> np.ndarray:
    isz = np.dtype(dtype).itemsize
    planes = np.frombuffer(raw, dtype=np.uint8, count=n * isz)
    return np.ascontiguousarray(
        planes.reshape(isz, n).T).view(dtype).reshape(n)


def _int_col(buf: bytearray, vals: np.ndarray) -> None:
    if len(vals):
        lo, hi = int(vals.min()), int(vals.max())
    else:
        lo = hi = 0
    for code, dt in enumerate(_INT_DTYPES):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            break
    raw = _shuffle(vals.astype(dt))
    buf += struct.pack("<BBI", _C_INT, code, len(raw))
    buf += raw


def _encode_column(buf: bytearray, vals: List[Any]) -> None:
    """Encode one column of python cell values, picking the layout."""
    probe = next((v for v in vals if v is not None), None)
    if probe is None and vals:
        buf += struct.pack("<B", _C_OBJ)
        _pack_json(buf, [_enc_state(v) for v in vals])
        return
    if isinstance(probe, bool):
        kind = "obj"
    elif isinstance(probe, (int, np.integer)):
        kind = "int"
    elif isinstance(probe, (float, np.floating)):
        kind = "float"
    elif isinstance(probe, str):
        kind = "str"
    elif (isinstance(probe, tuple) and len(probe) == 2
          and isinstance(probe[1], (int, np.integer))
          and isinstance(probe[0], (int, float, np.integer, np.floating))):
        kind = "avg"
    else:
        kind = "obj"
    # np.asarray probes the whole column at C speed: a None or mixed-type
    # cell lands on dtype object and demotes the column to OBJ
    if kind in ("int", "float"):
        arr = np.asarray(vals)
        if kind == "int" and arr.dtype.kind == "i":
            _int_col(buf, arr)
            return
        if arr.dtype.kind == "f" or (kind == "float"
                                     and arr.dtype.kind == "i"):
            raw = _shuffle(arr.astype(np.float64))
            buf += struct.pack("<BI", _C_FLOAT, len(raw))
            buf += raw
            return
    if kind == "str":
        arr = np.asarray(vals)
        if arr.dtype.kind == "U":
            uniq, inv = np.unique(arr, return_inverse=True)
            buf += struct.pack("<B", _C_STRDICT)
            _pack_json(buf, uniq.tolist())
            _int_col(buf, inv.astype(np.int64))
            return
    if kind == "avg" and all(isinstance(v, tuple) and len(v) == 2
                             for v in vals):
        buf += struct.pack("<B", _C_AVG)
        _encode_column(buf, [v[0] for v in vals])
        _encode_column(buf, [int(v[1]) for v in vals])
        return
    buf += struct.pack("<B", _C_OBJ)
    _pack_json(buf, [_enc_state(v) for v in vals])


def _decode_column(mv: memoryview, off: int) -> Tuple[List[Any], int]:
    (ctype,) = struct.unpack_from("<B", mv, off)
    off += 1
    if ctype == _C_INT:
        code, n = struct.unpack_from("<BI", mv, off)
        off += 5
        dt = _INT_DTYPES[code]
        arr = _unshuffle(mv[off:off + n], dt, n // np.dtype(dt).itemsize)
        return arr.tolist(), off + n
    if ctype == _C_FLOAT:
        (n,) = struct.unpack_from("<I", mv, off)
        off += 4
        arr = _unshuffle(mv[off:off + n], np.float64, n // 8)
        return arr.tolist(), off + n
    if ctype == _C_STRDICT:
        uniq, off = _unpack_json(mv, off)
        ids, off = _decode_column(mv, off)
        return [uniq[i] for i in ids], off
    if ctype == _C_AVG:
        sums, off = _decode_column(mv, off)
        cnts, off = _decode_column(mv, off)
        return list(zip(sums, cnts)), off
    assert ctype == _C_OBJ, ctype
    cells, off = _unpack_json(mv, off)
    return [_dec_state(c) for c in cells], off


def encode_partial(p: Any) -> bytes:
    buf = bytearray(_MAGIC)
    if isinstance(p, AggPartial):
        buf += struct.pack("<BH", _P_AGG, len(p.states))
        for s in p.states:
            _encode_column(buf, [s])
    elif isinstance(p, GroupByPartial):
        key_cols = list(zip(*p.groups.keys()))
        state_cols = list(zip(*p.groups.values()))
        buf += struct.pack("<BIHH", _P_GROUPBY, len(p.groups),
                           len(key_cols), len(state_cols))
        for col in key_cols:
            _encode_column(buf, col)
        for col in state_cols:
            _encode_column(buf, col)
    elif isinstance(p, SelectionPartial):
        buf += struct.pack("<B", _P_SELECTION)
        _pack_json(buf, p.labels)
        nc = len(p.rows[0]) if p.rows else 0
        no = len(p.order_keys[0]) if p.order_keys else 0
        buf += struct.pack("<IHH", len(p.rows), nc, no)
        for i in range(nc):
            _encode_column(buf, [r[i] for r in p.rows])
        for i in range(no):
            _encode_column(buf, [k[i] for k in p.order_keys])
    else:
        raise TypeError(f"unknown partial {type(p)}")
    if len(buf) >= _COMPRESS_MIN:
        z = zlib.compress(bytes(buf[4:]), 3)
        if len(z) + 8 < len(buf):
            return _MAGIC_Z + struct.pack("<I", len(buf) - 4) + z
    return bytes(buf)


_REL_MAGIC = b"PREL"
_REL_MAGIC_Z = b"PRLZ"


def encode_relation(rel) -> bytes:
    """Columnar binary for a multistage Relation block (the RowDataBlock/
    ColumnarDataBlock wire form of mailbox.proto MailboxContent). Same
    column layouts as partials; null masks ship bit-packed."""
    buf = bytearray(_REL_MAGIC)
    names = list(rel.data.keys())
    null_cols = [n for n in names if n in rel.nulls]
    _pack_json(buf, {"name": rel.name, "columns": names,
                     "nullColumns": null_cols, "rows": rel.n_rows})
    for n in names:
        _encode_column(buf, np.asarray(rel.data[n]).tolist())
    for n in null_cols:
        raw = np.packbits(np.asarray(rel.nulls[n], dtype=bool)).tobytes()
        buf += struct.pack("<I", len(raw))
        buf += raw
    if len(buf) >= _COMPRESS_MIN:
        z = zlib.compress(bytes(buf[4:]), 3)
        if len(z) + 8 < len(buf):
            return _REL_MAGIC_Z + struct.pack("<I", len(buf) - 4) + z
    return bytes(buf)


def decode_relation(data: bytes):
    from ..multistage.relation import Relation

    magic = bytes(data[:4])
    if magic == _REL_MAGIC_Z:
        (raw_len,) = struct.unpack_from("<I", data, 4)
        body = zlib.decompress(data[8:], bufsize=raw_len)
    elif magic == _REL_MAGIC:
        body = bytes(data[4:])
    else:
        raise ValueError(f"bad relation magic {magic!r}")
    mv = memoryview(body)
    header, off = _unpack_json(mv, 0)
    n = header["rows"]
    cols = {}
    for name in header["columns"]:
        cells, off = _decode_column(mv, off)
        arr = np.asarray(cells)
        if arr.dtype.kind in "USO":  # strings/mixed stay object cells
            a2 = np.empty(n, dtype=object)
            a2[:] = cells
            arr = a2
        cols[name] = arr
    nulls = {}
    for name in header["nullColumns"]:
        (ln,) = struct.unpack_from("<I", mv, off)
        off += 4
        bits = np.frombuffer(mv, dtype=np.uint8, count=ln, offset=off)
        off += ln
        nulls[name] = np.unpackbits(bits)[:n].astype(bool)
    return Relation(cols, nulls, header.get("name"))


_FRAME_MAGIC = b"PWR1"


def encode_wire_frame(header: Any, partials: List[Any]) -> bytes:
    """Length-prefixed response frame: JSON header + N partial blocks
    (the InstanceResponseBlock -> DataTable-bytes serialization at
    QueryScheduler.java:134, minus the thrift envelope)."""
    return encode_wire_frame_blocks(header,
                                    [encode_partial(p) for p in partials])


def encode_wire_frame_blocks(header: Any, blocks: List[bytes]) -> bytes:
    """Frame assembly over ALREADY-encoded partial blocks — the server
    times the block encode separately (serde vs network split) and the
    header must carry that measurement, so encode and assembly are two
    steps."""
    out = bytearray(_FRAME_MAGIC)
    h = json.dumps(header).encode()
    out += struct.pack("<I", len(h))
    out += h
    out += struct.pack("<I", len(blocks))
    for b in blocks:
        out += struct.pack("<I", len(b))
        out += b
    return bytes(out)


def decode_wire_frame(data: bytes) -> Tuple[Any, List[Any]]:
    if bytes(data[:4]) != _FRAME_MAGIC:
        raise ValueError("bad wire frame magic")
    mv = memoryview(data)
    (hn,) = struct.unpack_from("<I", mv, 4)
    header = json.loads(bytes(mv[8:8 + hn]))
    off = 8 + hn
    (n,) = struct.unpack_from("<I", mv, off)
    off += 4
    partials = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", mv, off)
        off += 4
        partials.append(decode_partial(bytes(mv[off:off + ln])))
        off += ln
    return header, partials


def decode_partial(data: bytes) -> Any:
    magic = bytes(data[:4])
    if magic == _MAGIC_Z:
        (raw_len,) = struct.unpack_from("<I", data, 4)
        body = zlib.decompress(data[8:], bufsize=raw_len)
    elif magic == _MAGIC:
        body = bytes(data[4:])
    else:
        raise ValueError(f"bad partial magic {magic!r}")
    mv = memoryview(body)
    (ptype,) = struct.unpack_from("<B", mv, 0)
    off = 1
    if ptype == _P_AGG:
        (n,) = struct.unpack_from("<H", mv, off)
        off += 2
        states = []
        for _ in range(n):
            cells, off = _decode_column(mv, off)
            states.append(cells[0])
        return AggPartial(states)
    if ptype == _P_GROUPBY:
        ng, kw, ns = struct.unpack_from("<IHH", mv, off)
        off += 8
        key_cols = []
        for _ in range(kw):
            col, off = _decode_column(mv, off)
            key_cols.append(col)
        state_cols = []
        for _ in range(ns):
            col, off = _decode_column(mv, off)
            state_cols.append(col)
        keys = list(zip(*key_cols)) if kw else [()] * ng
        states = ([list(s) for s in zip(*state_cols)] if ns
                  else [[] for _ in range(ng)])
        return GroupByPartial(dict(zip(keys, states)))
    assert ptype == _P_SELECTION, ptype
    labels, off = _unpack_json(mv, off)
    nr, nc, no = struct.unpack_from("<IHH", mv, off)
    off += 8
    cols = []
    for _ in range(nc):
        col, off = _decode_column(mv, off)
        cols.append(col)
    ocols = []
    for _ in range(no):
        col, off = _decode_column(mv, off)
        ocols.append(col)
    rows = [tuple(cols[i][r] for i in range(nc)) for r in range(nr)]
    okeys = [tuple(ocols[i][r] for i in range(no)) for r in range(nr)]
    return SelectionPartial(labels, rows, okeys)
