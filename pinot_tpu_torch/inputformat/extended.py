"""Extended input formats: protobuf, thrift, CLP, ORC (reference:
pinot-plugins/pinot-input-format/{pinot-protobuf, pinot-thrift,
pinot-clp-log, pinot-orc}).

Port of ``pinot_tpu/inputformat/extended.py``, unchanged: the same rows
from the same files, and the same errors where a library is missing.

- protobuf: real wire-format reader — a FileDescriptorSet (protoc
  --descriptor_set_out) names the message type; records are
  varint-delimited on disk (java writeDelimitedTo framing, the
  reference ProtoBufRecordReader's layout). Needs ``google.protobuf``;
  without it the import raises ``ModuleNotFoundError``.
- thrift: from-scratch TBinaryProtocol struct decoder (no thrift lib
  needed): records are concatenated structs; field ids map to column
  names through the caller-provided schema, unknown fields skip.
- CLP: from-scratch CLP-style log encoding (reference
  CLPLogRecordReader): each configured message field becomes three
  columns — <f>_logtype (the message with variables replaced by
  placeholder bytes), <f>_dictionaryVars (word-like variables),
  <f>_encodedVars (numeric variables) — and clp_decode() reassembles
  the original string.
- ORC: served through pyarrow.orc when present, with a clear gating
  error otherwise — same contract as parquet.
"""
from __future__ import annotations

import json
import re
import struct
from typing import Any, Dict, Iterable, List, Optional, Tuple

# ---------------------------------------------------------------------------
# protobuf
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        out |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return out, pos
        shift += 7


def write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _message_class(descriptor_file: str, message_type: str):
    from google.protobuf import (descriptor_pb2, descriptor_pool,
                                 message_factory)

    with open(descriptor_file, "rb") as fh:
        fds = descriptor_pb2.FileDescriptorSet.FromString(fh.read())
    pool = descriptor_pool.DescriptorPool()
    for f in fds.file:
        pool.Add(f)
    return message_factory.GetMessageClass(
        pool.FindMessageTypeByName(message_type))


def _msg_to_row(msg) -> Dict[str, Any]:
    row: Dict[str, Any] = {}
    for f in msg.DESCRIPTOR.fields:
        v = getattr(msg, f.name)
        repeated = f.is_repeated if hasattr(f, "is_repeated") \
            else f.label == f.LABEL_REPEATED  # protobuf<5 fallback
        if f.message_type is not None and \
                f.message_type.GetOptions().map_entry:
            # map fields iterate as keys — materialize the mapping
            val_f = f.message_type.fields_by_name["value"]
            row[f.name] = {k: (_msg_to_row(v[k])
                               if val_f.message_type else v[k])
                           for k in v}
        elif repeated:
            row[f.name] = [(_msg_to_row(x) if f.message_type else x)
                           for x in v]
        elif f.message_type is not None:
            row[f.name] = _msg_to_row(v)
        elif f.type == f.TYPE_BYTES:
            row[f.name] = bytes(v)
        else:
            row[f.name] = v
    return row


def read_protobuf(path: str, descriptor_file: str,
                  message_type: str) -> List[Dict[str, Any]]:
    """Varint-delimited protobuf records -> row dicts."""
    cls = _message_class(descriptor_file, message_type)
    with open(path, "rb") as fh:
        data = fh.read()
    rows: List[Dict[str, Any]] = []
    pos = 0
    while pos < len(data):
        ln, pos = _read_varint(data, pos)
        rows.append(_msg_to_row(cls.FromString(data[pos:pos + ln])))
        pos += ln
    return rows


def write_protobuf(path: str, messages: Iterable[Any]) -> None:
    """Varint-delimited writer (the producing side of the contract)."""
    with open(path, "wb") as fh:
        for m in messages:
            b = m.SerializeToString()
            fh.write(write_varint(len(b)) + b)


# ---------------------------------------------------------------------------
# thrift (TBinaryProtocol)
# ---------------------------------------------------------------------------

_T_STOP, _T_BOOL, _T_BYTE, _T_DOUBLE = 0, 2, 3, 4
_T_I16, _T_I32, _T_I64, _T_STRING = 6, 8, 10, 11
_T_STRUCT, _T_MAP, _T_SET, _T_LIST = 12, 13, 14, 15


def _thrift_value(buf: bytes, pos: int, ttype: int) -> Tuple[Any, int]:
    if ttype == _T_BOOL:
        return buf[pos] != 0, pos + 1
    if ttype == _T_BYTE:
        return struct.unpack_from(">b", buf, pos)[0], pos + 1
    if ttype == _T_DOUBLE:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if ttype == _T_I16:
        return struct.unpack_from(">h", buf, pos)[0], pos + 2
    if ttype == _T_I32:
        return struct.unpack_from(">i", buf, pos)[0], pos + 4
    if ttype == _T_I64:
        return struct.unpack_from(">q", buf, pos)[0], pos + 8
    if ttype == _T_STRING:
        (ln,) = struct.unpack_from(">i", buf, pos)
        raw = buf[pos + 4:pos + 4 + ln]
        try:
            return raw.decode("utf-8"), pos + 4 + ln
        except UnicodeDecodeError:
            return raw, pos + 4 + ln
    if ttype == _T_STRUCT:
        return _thrift_struct(buf, pos)
    if ttype in (_T_LIST, _T_SET):
        etype = buf[pos]
        (n,) = struct.unpack_from(">i", buf, pos + 1)
        pos += 5
        out = []
        for _ in range(n):
            v, pos = _thrift_value(buf, pos, etype)
            out.append(v)
        return out, pos
    if ttype == _T_MAP:
        ktype, vtype = buf[pos], buf[pos + 1]
        (n,) = struct.unpack_from(">i", buf, pos + 2)
        pos += 6
        out: Dict[Any, Any] = {}
        for _ in range(n):
            k, pos = _thrift_value(buf, pos, ktype)
            v, pos = _thrift_value(buf, pos, vtype)
            out[k] = v
        return out, pos
    raise ValueError(f"unsupported thrift type {ttype}")


def _thrift_struct(buf: bytes, pos: int
                   ) -> Tuple[Dict[int, Any], int]:
    """-> ({field_id: value}, next_pos); TBinaryProtocol field layout:
    u8 type | i16 field_id | value, terminated by T_STOP."""
    out: Dict[int, Any] = {}
    while True:
        ttype = buf[pos]
        pos += 1
        if ttype == _T_STOP:
            return out, pos
        (fid,) = struct.unpack_from(">h", buf, pos)
        pos += 2
        v, pos = _thrift_value(buf, pos, ttype)
        out[fid] = v


def read_thrift(path: str,
                field_names: Dict[int, str]) -> List[Dict[str, Any]]:
    """Concatenated TBinaryProtocol structs -> row dicts. field_names
    maps thrift field ids to column names (the role the generated
    thrift class plays for ThriftRecordReader); unmapped fields drop."""
    with open(path, "rb") as fh:
        data = fh.read()
    rows: List[Dict[str, Any]] = []
    pos = 0
    while pos < len(data):
        fields, pos = _thrift_struct(data, pos)
        rows.append({field_names[fid]: v for fid, v in fields.items()
                     if fid in field_names})
    return rows


# ---------------------------------------------------------------------------
# CLP-style log encoding
# ---------------------------------------------------------------------------

# placeholders (CLP's scheme: logtype keeps structure, vars extracted)
_PH_INT = "\x11"
_PH_FLOAT = "\x12"
_PH_DICT = "\x13"
_ESC = "\x1b"   # literal 0x11-0x13 (or 0x1b) bytes in the message are
# escaped in the logtype so they can never be misread as var slots

_VAR_TOKEN = re.compile(
    r"(?P<float>-?\d+\.\d+)|(?P<int>-?\d+)|(?P<dict>[A-Za-z0-9_./:\-]*"
    r"\d[A-Za-z0-9_./:\-]*)")


def clp_encode(message: str) -> Tuple[str, List[str], List[int]]:
    """-> (logtype, dictionary_vars, encoded_vars). Numeric tokens
    become encoded vars (floats bit-cast to int64 like CLP), tokens
    containing digits become dictionary vars, everything else stays in
    the logtype."""
    dict_vars: List[str] = []
    enc_vars: List[int] = []
    for ch in (_ESC, _PH_INT, _PH_FLOAT, _PH_DICT):
        message = message.replace(ch, _ESC + ch)

    def sub(m: re.Match) -> str:
        tok = m.group()
        # losslessness gate (real CLP does the same): tokens whose
        # numeric form does not reproduce the exact text — leading-zero
        # ints, trailing-zero floats — go to the dictionary instead
        if m.group("float") is not None:
            if repr(float(tok)) == tok:
                enc_vars.append(struct.unpack(
                    ">q", struct.pack(">d", float(tok)))[0])
                return _PH_FLOAT
            dict_vars.append(tok)
            return _PH_DICT
        if m.group("int") is not None:
            if str(int(tok)) == tok:
                enc_vars.append(int(tok))
                return _PH_INT
            dict_vars.append(tok)
            return _PH_DICT
        dict_vars.append(tok)
        return _PH_DICT

    return _VAR_TOKEN.sub(sub, message), dict_vars, enc_vars


def clp_decode(logtype: str, dict_vars: List[str],
               enc_vars: List[int]) -> str:
    di = iter(dict_vars)
    ei = iter(enc_vars)
    out: List[str] = []
    it = iter(logtype)
    for ch in it:
        if ch == _ESC:
            out.append(next(it))          # escaped literal byte
        elif ch == _PH_INT:
            out.append(str(next(ei)))
        elif ch == _PH_FLOAT:
            out.append(repr(struct.unpack(
                ">d", struct.pack(">q", next(ei)))[0]))  # exact: the
            # encoder only takes floats whose repr matches the token
        elif ch == _PH_DICT:
            out.append(next(di))
        else:
            out.append(ch)
    return "".join(out)


def read_clp(path: str, fields: Tuple[str, ...] = ("message",)
             ) -> List[Dict[str, Any]]:
    """JSON-lines log events; each configured field is CLP-encoded into
    <f>_logtype / <f>_dictionaryVars / <f>_encodedVars columns
    (CLPLogRecordReader's output shape), other fields pass through."""
    rows: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            row: Dict[str, Any] = {}
            for k, v in ev.items():
                if k in fields and isinstance(v, str):
                    lt, dv, evars = clp_encode(v)
                    row[f"{k}_logtype"] = lt
                    row[f"{k}_dictionaryVars"] = dv
                    row[f"{k}_encodedVars"] = evars
                else:
                    row[k] = v
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# ORC (gated)
# ---------------------------------------------------------------------------

def read_orc(path: str) -> List[Dict[str, Any]]:
    try:
        from pyarrow import orc  # type: ignore[import-not-found]
    except ImportError:
        raise RuntimeError(
            "orc input needs the 'pyarrow' package, which is not "
            "installed in this environment") from None
    return orc.read_table(path).to_pylist()
