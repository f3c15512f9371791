"""Scalar (transform) function registry: name -> vectorized numpy impl.

Reference parity: pinot-common/.../function/FunctionRegistry.java:43
(annotation-scanned @ScalarFunction registry shared by both engines) plus
pinot-core/.../operator/transform/function/ (the 71 transform-function
classes). TPU-native stance: every function is a vectorized numpy ufunc
over whole columns (no per-row evaluation loop); dictionary-encoded string
columns evaluate once per dictionary value and gather (host_eval applies
that). Device (XLA) lowering exists separately for the arithmetic subset
in ops/kernels.py; everything else rides the host path.

Functions are looked up lowercased (the SQL parser lowercases call names).
"""
from __future__ import annotations

import hashlib
import re
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np

from .sql import SqlError


class FunctionDef:
    __slots__ = ("name", "fn", "min_args", "max_args", "elementwise")

    def __init__(self, name: str, fn: Callable, min_args: int,
                 max_args: Optional[int], elementwise: bool = True):
        self.name = name
        self.fn = fn
        self.min_args = min_args
        self.max_args = max_args
        self.elementwise = elementwise  # safe to eval over dict values+gather


REGISTRY: Dict[str, FunctionDef] = {}


def register(name: str, min_args: int = 1, max_args: Optional[int] = None,
             elementwise: bool = True):
    if max_args is None:
        max_args = min_args

    def deco(fn):
        REGISTRY[name] = FunctionDef(name, fn, min_args, max_args,
                                     elementwise)
        return fn
    return deco


def register_alias(alias: str, name: str) -> None:
    REGISTRY[alias] = REGISTRY[name]


def canonical(name: str) -> str:
    """FunctionRegistry.canonicalize analog: case-insensitive and
    underscore-insensitive (ST_DISTANCE == stDistance == stdistance)."""
    return name.replace("_", "").lower()


def lookup(name: str) -> Optional[FunctionDef]:
    fd = REGISTRY.get(name)
    if fd is None:
        fd = REGISTRY.get(canonical(name))
    return fd


def call(name: str, *args: Any) -> np.ndarray:
    fd = lookup(name)
    if fd is None:
        raise SqlError(f"unknown function {name!r}")
    n = len(args)
    if n < fd.min_args or (fd.max_args is not None and n > fd.max_args):
        raise SqlError(f"{name} expects {fd.min_args}"
                       + (f"..{fd.max_args}" if fd.max_args != fd.min_args
                          else "") + f" args, got {n}")
    return fd.fn(*args)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _f(v: Any) -> np.ndarray:
    return np.asarray(v, dtype=np.float64)


def _i(v: Any) -> np.ndarray:
    return np.asarray(v).astype(np.int64)


def _s(v: Any) -> np.ndarray:
    a = np.asarray(v)
    if a.dtype == object or a.dtype.kind in "US":
        return a.astype(str)
    if a.dtype.kind == "f":
        # render integral floats without the trailing .0 (Pinot prints
        # string casts of longs without decimals)
        flat = a.reshape(-1)
        out = np.asarray([_num_str(x) for x in flat], dtype=object)
        return out.reshape(a.shape).astype(str)
    return a.astype(str)


def _num_str(x) -> str:
    xf = float(x)
    return str(int(xf)) if xf.is_integer() else str(xf)


def _vec_str(fn: Callable[[str], Any], v: Any, dtype=None) -> np.ndarray:
    a = _s(v)
    if a.ndim == 0:
        r = fn(str(a))
        return np.asarray(r, dtype=dtype) if dtype else np.asarray(r)
    out = [fn(x) for x in a]
    return np.asarray(out, dtype=dtype) if dtype else np.asarray(out,
                                                                 dtype=object)


# ---------------------------------------------------------------------------
# math (ArithmeticFunctions.java / transform function analogs)
# ---------------------------------------------------------------------------

register("abs")(lambda v: np.abs(np.asarray(v)))
register("ceil")(lambda v: np.ceil(_f(v)))
register_alias("ceiling", "ceil")
register("floor")(lambda v: np.floor(_f(v)))
register("exp")(lambda v: np.exp(_f(v)))
register("ln")(lambda v: np.log(_f(v)))
register("log")(lambda v: np.log(_f(v)))
register("log2")(lambda v: np.log2(_f(v)))
register("log10")(lambda v: np.log10(_f(v)))
register("sqrt")(lambda v: np.sqrt(_f(v)))
register("cbrt")(lambda v: np.cbrt(_f(v)))
register("sign")(lambda v: np.sign(_f(v)))
register("power", 2)(lambda a, b: np.power(_f(a), _f(b)))
register_alias("pow", "power")
register("mod", 2)(lambda a, b: np.mod(_f(a), _f(b)))


@register("round", 1, 2)
def _round(v, scale=0):
    s = int(np.asarray(scale))
    return np.round(_f(v), s)


register_alias("rounddecimal", "round")


@register("truncate", 1, 2)
def _truncate(v, scale=0):
    s = int(np.asarray(scale))
    m = 10.0 ** s
    return np.trunc(_f(v) * m) / m


register_alias("trunc", "truncate")
def _reduce_pair(op, args):
    out = _f(args[0])
    for x in args[1:]:
        out = op(out, _f(x))
    return out


register("least", 2, 16)(lambda *a: _reduce_pair(np.minimum, a))
register("greatest", 2, 16)(lambda *a: _reduce_pair(np.maximum, a))

# trig (TrigonometricFunctions.java analog)
for _name, _fn in (("sin", np.sin), ("cos", np.cos), ("tan", np.tan),
                   ("asin", np.arcsin), ("acos", np.arccos),
                   ("atan", np.arctan), ("sinh", np.sinh),
                   ("cosh", np.cosh), ("tanh", np.tanh),
                   ("degrees", np.degrees), ("radians", np.radians)):
    register(_name)(lambda v, _fn=_fn: _fn(_f(v)))
register("cot")(lambda v: 1.0 / np.tan(_f(v)))
register("atan2", 2)(lambda a, b: np.arctan2(_f(a), _f(b)))
register("e", 0, 0)(lambda: np.float64(np.e))
register("pi", 0, 0)(lambda: np.float64(np.pi))


# ---------------------------------------------------------------------------
# string (StringFunctions.java analog; substr is 0-based with exclusive end,
# -1 meaning end-of-string, matching the reference's substr contract)
# ---------------------------------------------------------------------------

register("upper")(lambda v: _vec_str(str.upper, v))
register("lower")(lambda v: _vec_str(str.lower, v))
register("trim")(lambda v: _vec_str(str.strip, v))
register("ltrim")(lambda v: _vec_str(str.lstrip, v))
register("rtrim")(lambda v: _vec_str(str.rstrip, v))
register("length")(lambda v: _vec_str(len, v, dtype=np.int64))
register_alias("strlen", "length")
register("reverse")(lambda v: _vec_str(lambda x: x[::-1], v))


@register("substr", 2, 3)
def _substr(v, start, end=None):
    st = int(np.asarray(start))
    en = None if end is None else int(np.asarray(end))
    if en is not None and en == -1:
        en = None
    return _vec_str(lambda x: x[st:en], v)


@register("substring", 2, 3)
def _substring(v, start, ln=None):
    # SQL-style: 1-based start, optional length
    st = max(int(np.asarray(start)) - 1, 0)
    if ln is None:
        return _vec_str(lambda x: x[st:], v)
    n = int(np.asarray(ln))
    return _vec_str(lambda x: x[st:st + n], v)


@register("concat", 2, 16)
def _concat(*args):
    parts = [_s(a) for a in args]
    if len(parts) == 3 and parts[2].ndim == 0:
        sep = str(parts[2])   # concat(col1, col2, separator) — ref semantics
        parts = [parts[0], parts[1]]
    else:
        sep = ""
    shp = None
    for p in parts:
        if p.ndim > 0:
            shp = p.shape
    if shp is None:
        return np.asarray(sep.join(str(p) for p in parts))
    cols = [np.broadcast_to(p, shp) for p in parts]
    out = [sep.join(str(c[i]) for c in cols) for i in range(shp[0])]
    return np.asarray(out, dtype=object)


@register("replace", 3)
def _replace(v, find, sub):
    f, s = str(np.asarray(find)), str(np.asarray(sub))
    return _vec_str(lambda x: x.replace(f, s), v)


@register("startswith", 2)
def _startswith(v, p):
    pp = str(np.asarray(p))
    return _vec_str(lambda x: x.startswith(pp), v, dtype=bool)


@register("endswith", 2)
def _endswith(v, p):
    pp = str(np.asarray(p))
    return _vec_str(lambda x: x.endswith(pp), v, dtype=bool)


@register("contains", 2)
def _contains(v, p):
    pp = str(np.asarray(p))
    return _vec_str(lambda x: pp in x, v, dtype=bool)


@register("strpos", 2, 3)
def _strpos(v, sub, occurrence=1):
    s = str(np.asarray(sub))
    occ = int(np.asarray(occurrence))

    def find(x: str) -> int:
        pos = -1
        for _ in range(max(occ, 1)):
            pos = x.find(s, pos + 1)
            if pos < 0:
                return -1
        return pos
    return _vec_str(find, v, dtype=np.int64)


@register("lpad", 3)
def _lpad(v, size, pad):
    n, p = int(np.asarray(size)), str(np.asarray(pad))
    return _vec_str(
        lambda x: (p * n + x)[-n:] if len(x) < n else x[:n], v)


@register("rpad", 3)
def _rpad(v, size, pad):
    n, p = int(np.asarray(size)), str(np.asarray(pad))
    return _vec_str(
        lambda x: (x + p * n)[:n] if len(x) < n else x[:n], v)


@register("repeat", 2, 3)
def _repeat(v, times, sep=None):
    n = int(np.asarray(times))
    s = "" if sep is None else str(np.asarray(sep))
    return _vec_str(lambda x: s.join([x] * n), v)


@register("remove", 2)
def _remove(v, sub):
    s = str(np.asarray(sub))
    return _vec_str(lambda x: x.replace(s, ""), v)


register("codepoint")(lambda v: _vec_str(lambda x: ord(x[0]) if x else 0, v,
                                         dtype=np.int64))
register("chr")(lambda v: np.asarray(
    [chr(int(x)) for x in np.atleast_1d(_i(v))], dtype=object)
    if np.asarray(v).ndim else np.asarray(chr(int(np.asarray(v)))))


@register("splitpart", 3)
def _splitpart(v, delim, index):
    d, idx = str(np.asarray(delim)), int(np.asarray(index))

    def part(x: str) -> str:
        ps = x.split(d)
        return ps[idx] if 0 <= idx < len(ps) else "null"
    return _vec_str(part, v)


@register("regexpextract", 2, 4, elementwise=True)
def _regexp_extract(v, pattern, group=0, default=""):
    rx = re.compile(str(np.asarray(pattern)))
    g = int(np.asarray(group))
    dflt = str(np.asarray(default))

    def ex(x: str) -> str:
        m = rx.search(x)
        return m.group(g) if m else dflt
    return _vec_str(ex, v)


@register("regexpreplace", 3)
def _regexp_replace(v, pattern, sub):
    rx = re.compile(str(np.asarray(pattern)))
    s = str(np.asarray(sub))
    return _vec_str(lambda x: rx.sub(s, x), v)


@register("regexplike", 2)
def _regexp_like(v, pattern):
    rx = re.compile(str(np.asarray(pattern)))
    return _vec_str(lambda x: bool(rx.search(x)), v, dtype=bool)


# hash (HashFunctions.java analog)
register("md5")(lambda v: _vec_str(
    lambda x: hashlib.md5(x.encode()).hexdigest(), v))
register("sha")(lambda v: _vec_str(
    lambda x: hashlib.sha1(x.encode()).hexdigest(), v))
register("sha256")(lambda v: _vec_str(
    lambda x: hashlib.sha256(x.encode()).hexdigest(), v))
register("sha512")(lambda v: _vec_str(
    lambda x: hashlib.sha512(x.encode()).hexdigest(), v))
register("crc32")(lambda v: _vec_str(
    lambda x: zlib.crc32(x.encode()), v, dtype=np.int64))
register("adler32")(lambda v: _vec_str(
    lambda x: zlib.adler32(x.encode()), v, dtype=np.int64))


# ---------------------------------------------------------------------------
# datetime (DateTimeFunctions.java analog; epoch millis, UTC)
# ---------------------------------------------------------------------------

_MS = {"milliseconds": 1, "seconds": 1000, "minutes": 60_000,
       "hours": 3_600_000, "days": 86_400_000}


def _dt64(millis) -> np.ndarray:
    return _i(millis).astype("datetime64[ms]")


def _field(millis, unit: str) -> np.ndarray:
    d = _dt64(millis)
    y = d.astype("datetime64[Y]")
    if unit == "year":
        return y.astype(np.int64) + 1970
    mo = d.astype("datetime64[M]")
    if unit == "month":
        return (mo - y).astype(np.int64) + 1
    day = d.astype("datetime64[D]")
    if unit == "day":
        return (day - mo).astype(np.int64) + 1
    if unit == "dayofweek":
        # 1=Monday..7=Sunday (ISO, matches the reference's dayOfWeek)
        return (day.astype(np.int64) + 3) % 7 + 1
    if unit == "dayofyear":
        return (day - y).astype(np.int64) + 1
    h = d.astype("datetime64[h]")
    if unit == "hour":
        return (h - day).astype(np.int64)
    mi = d.astype("datetime64[m]")
    if unit == "minute":
        return (mi - h).astype(np.int64)
    s = d.astype("datetime64[s]")
    if unit == "second":
        return (s - mi).astype(np.int64)
    if unit == "millisecond":
        return (d - s).astype(np.int64)
    if unit == "quarter":
        return ((mo - y).astype(np.int64)) // 3 + 1
    if unit == "week":
        # ISO week number
        dow = (day.astype(np.int64) + 3) % 7          # 0=Monday
        thursday = day - dow.astype("timedelta64[D]") \
            + np.timedelta64(3, "D")
        ty = thursday.astype("datetime64[Y]")
        return ((thursday - ty).astype(np.int64)) // 7 + 1
    raise SqlError(f"unknown datetime field {unit}")


for _u in ("year", "month", "hour", "minute", "second", "millisecond",
           "quarter", "week", "dayofweek", "dayofyear"):
    register(_u)(lambda v, _u=_u: _field(v, _u))
register("day")(lambda v: _field(v, "day"))
register_alias("dayofmonth", "day")
register_alias("weekofyear", "week")

for _unit, _mul in (("seconds", 1000), ("minutes", 60_000),
                    ("hours", 3_600_000), ("days", 86_400_000)):
    register(f"toepoch{_unit}")(
        lambda v, _m=_mul: _i(v) // _m)
    register(f"fromepoch{_unit}")(
        lambda v, _m=_mul: _i(v) * _m)
    register(f"toepoch{_unit}rounded", 2)(
        lambda v, b, _m=_mul: (_i(v) // _m) // _i(b) * _i(b))
register("toepochmillis")(lambda v: _i(v))


@register("datetrunc", 2, 3)
def _datetrunc(unit, millis, out_unit=None):
    u = str(np.asarray(unit)).lower()
    d = _dt64(millis)
    trunc_map = {"year": "Y", "month": "M", "day": "D",
                 "hour": "h", "minute": "m", "second": "s",
                 "millisecond": "ms", "quarter": None, "week": None}
    if u == "week":
        # ISO Monday anchor (java.time/joda semantics the reference
        # uses); numpy datetime64[W] anchors on the Thursday epoch and
        # would disagree with the device lowering
        days = np.floor_divide(_i(millis), 86_400_000)
        res = (np.floor_divide(days + 3, 7) * 7 - 3) * 86_400_000
    elif u == "quarter":
        y = d.astype("datetime64[Y]")
        mo = (d.astype("datetime64[M]") - y).astype(np.int64) // 3 * 3
        out = (y.astype("datetime64[M]") + mo.astype("timedelta64[M]"))
        res = out.astype("datetime64[ms]").astype(np.int64)
    else:
        code = trunc_map.get(u)
        if code is None:
            raise SqlError(f"dateTrunc: unknown unit {u!r}")
        res = d.astype(f"datetime64[{code}]").astype("datetime64[ms]") \
            .astype(np.int64)
    if out_unit is not None:
        ou = str(np.asarray(out_unit)).lower()
        res = res // _MS.get(ou, 1)
    return res


@register("timestampadd", 3)
def _timestampadd(unit, count, millis):
    u = str(np.asarray(unit)).lower()
    c = _i(count)
    m = _i(millis)
    if u in _MS:
        return m + c * _MS[u]
    unit_ms = {"second": 1000, "minute": 60_000, "hour": 3_600_000,
               "day": 86_400_000, "week": 7 * 86_400_000}
    if u in unit_ms:
        return m + c * unit_ms[u]
    d = m.astype("datetime64[ms]").astype("datetime64[M]")
    rem = m - d.astype("datetime64[ms]").astype(np.int64)
    if u == "month":
        nd = d + c.astype("timedelta64[M]")
    elif u in ("year",):
        nd = d + (c * 12).astype("timedelta64[M]")
    elif u == "quarter":
        nd = d + (c * 3).astype("timedelta64[M]")
    else:
        raise SqlError(f"timestampAdd: unknown unit {u!r}")
    return nd.astype("datetime64[ms]").astype(np.int64) + rem


@register("timestampdiff", 3)
def _timestampdiff(unit, a, b):
    u = str(np.asarray(unit)).lower()
    diff = _i(b) - _i(a)
    unit_ms = {"millisecond": 1, "second": 1000, "minute": 60_000,
               "hour": 3_600_000, "day": 86_400_000, "week": 7 * 86_400_000}
    if u in unit_ms:
        return diff // unit_ms[u]
    if u in ("month", "year", "quarter"):
        ma = _dt64(a).astype("datetime64[M]").astype(np.int64)
        mb = _dt64(b).astype("datetime64[M]").astype(np.int64)
        months = mb - ma
        if u == "month":
            return months
        return months // (12 if u == "year" else 3)
    raise SqlError(f"timestampDiff: unknown unit {u!r}")


_JODA_MAP = [("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
             ("HH", "%H"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f")]


def _joda_to_strftime(fmt: str) -> str:
    out = fmt
    for j, s in _JODA_MAP:
        out = out.replace(j, s)
    return out


@register("todatetime", 2)
def _todatetime(millis, fmt):
    import datetime as _dt
    f = _joda_to_strftime(str(np.asarray(fmt)))
    # millisecond precision: format %f out-of-band so trailing literals
    # (e.g. a 'Z' after SSS) survive
    f_ms = f.replace("%f", "\x00")

    def conv(ms: int) -> str:
        t = _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)
        s = t.strftime(f_ms)
        return s.replace("\x00", f"{t.microsecond // 1000:03d}")
    m = _i(millis)
    if m.ndim == 0:
        return np.asarray(conv(int(m)))
    return np.asarray([conv(int(x)) for x in m], dtype=object)


@register("fromdatetime", 2)
def _fromdatetime(s, fmt):
    import calendar
    import datetime as _dt
    f = _joda_to_strftime(str(np.asarray(fmt)))

    def conv(x: str) -> int:
        t = _dt.datetime.strptime(x, f)
        return calendar.timegm(t.timetuple()) * 1000 + t.microsecond // 1000
    return _vec_str(conv, s, dtype=np.int64)


@register("now", 0, 0, elementwise=False)
def _now():
    import time
    return np.int64(int(time.time() * 1000))


@register("ago", 1, 1, elementwise=False)
def _ago(period):
    import time
    p = str(np.asarray(period))
    m = re.fullmatch(
        r"PT?(?:(\d+)D)?(?:(\d+)H)?(?:(\d+)M)?(?:(\d+(?:\.\d+)?)S)?", p,
        re.IGNORECASE)
    if not m:
        raise SqlError(f"ago: cannot parse ISO-8601 period {p!r}")
    days, hours, mins, secs = (float(g) if g else 0.0 for g in m.groups())
    delta_ms = int(((days * 24 + hours) * 60 + mins) * 60_000 + secs * 1000)
    return np.int64(int(time.time() * 1000) - delta_ms)


# ---------------------------------------------------------------------------
# json (JsonFunctions.java analog — host-side; '$.a.b[0]' paths)
# ---------------------------------------------------------------------------

_JSON_PATH_RE = re.compile(r"\.([A-Za-z_][A-Za-z_0-9]*)|\[(\d+)\]")


def _json_path_steps(path: str):
    if not path.startswith("$"):
        raise SqlError(f"json path must start with $: {path!r}")
    steps = []
    for m in _JSON_PATH_RE.finditer(path, 1):
        steps.append(m.group(1) if m.group(1) is not None
                     else int(m.group(2)))
    return steps


def _json_get(obj: Any, steps) -> Any:
    for s in steps:
        if obj is None:
            return None
        try:
            obj = obj[s]
        except (KeyError, IndexError, TypeError):
            return None
    return obj


@register("jsonextractscalar", 2, 4)
def _jsonextractscalar(v, path, result_type="STRING", default=None):
    import json as _json
    steps = _json_path_steps(str(np.asarray(path)))
    rt = str(np.asarray(result_type)).upper()
    dflt = None if default is None else np.asarray(default).item()

    def ex(x: str):
        try:
            val = _json_get(_json.loads(x), steps)
        except (ValueError, TypeError):
            val = None
        if val is None:
            return dflt
        return val
    raw = _vec_str(ex, v)
    flat = raw.reshape(-1) if raw.ndim else raw
    if rt in ("INT", "LONG"):
        conv = [int(float(x)) if x is not None else
                (int(dflt) if dflt is not None else -(2 ** 31))
                for x in np.atleast_1d(flat)]
        out = np.asarray(conv, dtype=np.int64)
    elif rt in ("FLOAT", "DOUBLE"):
        conv = [float(x) if x is not None else
                (float(dflt) if dflt is not None else np.nan)
                for x in np.atleast_1d(flat)]
        out = np.asarray(conv, dtype=np.float64)
    else:
        out = np.asarray(["null" if x is None else str(x)
                          for x in np.atleast_1d(flat)], dtype=object)
    return out.reshape(raw.shape) if raw.ndim else out[0]


@register("jsonformat", 1)
def _jsonformat(v):
    import json as _json
    return _vec_str(lambda x: _json.dumps(_json.loads(x),
                                          separators=(",", ":")), v)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

_CAST_TARGETS = {
    "int": np.int32, "integer": np.int32, "long": np.int64,
    "bigint": np.int64, "float": np.float32, "double": np.float64,
    "boolean": np.bool_, "timestamp": np.int64,
    "string": None, "varchar": None, "json": None,
}


def cast_value(v: Any, type_name: str) -> np.ndarray:
    t = type_name.lower()
    if t not in _CAST_TARGETS:
        raise SqlError(f"CAST: unknown type {type_name!r}")
    a = np.asarray(v)
    tgt = _CAST_TARGETS[t]
    if tgt is None:
        return _s(a)
    if a.dtype == object or a.dtype.kind in "US":
        a = a.astype(str)
        if tgt in (np.int32, np.int64):
            return np.asarray([int(float(x)) for x in np.atleast_1d(a)],
                              dtype=tgt).reshape(a.shape)
        if tgt is np.bool_:
            return np.asarray([x.lower() == "true"
                               for x in np.atleast_1d(a)],
                              dtype=bool).reshape(a.shape)
        return a.astype(np.float64).astype(tgt)
    if tgt in (np.int32, np.int64) and a.dtype.kind == "f":
        return a.astype(tgt)  # C-style truncation toward zero via astype
    return a.astype(tgt)


register("cast", 2)(lambda v, t: cast_value(v, str(np.asarray(t))))


# geospatial ST_* family (query/geo_functions.py) registers on import
from . import geo_functions as _geo_functions  # noqa: E402,F401
