"""JSON index: flattened path/value posting lists serving JSON_MATCH.

Port of ``pinot_tpu/index/json_index.py``: the same host numpy code, so the files it
writes are byte-equal to the JAX package's.

Reference parity: pinot-segment-local/.../segment/index/json/ (json index
creator flattens nested documents into path.value posting lists) consumed
by operator/filter/JsonMatchFilterOperator. Filter syntax subset:
    '"$.a.b" = ''x''' | != | IS NULL | IS NOT NULL, combined with AND/OR,
    parentheses; array elements flatten under the [*] wildcard path.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np

from .csr import CsrPostings, postings_from_doc_keys, write_csr

SUFFIX = ".json"
SEP = "\x00"  # path/value separator: cannot appear in a JSON path


def _flatten(prefix: str, v: Any, out: List[Tuple[str, str]]) -> None:
    if isinstance(v, dict):
        for k, vv in v.items():
            _flatten(f"{prefix}.{k}", vv, out)
    elif isinstance(v, list):
        for vv in v:
            _flatten(f"{prefix}[*]", vv, out)
    elif v is None:
        out.append((prefix, SEP + "null"))
    else:
        out.append((prefix, json.dumps(v) if isinstance(v, bool)
                    else str(v)))


def flatten_doc(text: Any) -> List[Tuple[str, str]]:
    try:
        doc = json.loads(text) if isinstance(text, str) else text
    except (json.JSONDecodeError, TypeError):
        return []
    out: List[Tuple[str, str]] = []
    _flatten("$", doc, out)
    return out


def build(col: str, seg_dir: str, *, values: np.ndarray,
          **_: Any) -> Dict[str, Any]:
    doc_pairs = [flatten_doc(v) for v in values]
    vocab: Dict[str, int] = {}
    for pairs in doc_pairs:
        for path, val in pairs:
            for key in (path + SEP + val, path):  # value key + existence key
                if key not in vocab:
                    vocab[key] = len(vocab)
    keys_sorted = sorted(vocab)
    remap = {k: i for i, k in enumerate(keys_sorted)}
    doc_keys = [[remap[k] for path, val in pairs
                 for k in (path + SEP + val, path)] for pairs in doc_pairs]
    write_csr(os.path.join(seg_dir, col + SUFFIX),
              postings_from_doc_keys(doc_keys, len(keys_sorted)))
    with open(os.path.join(seg_dir, col + SUFFIX + ".keys.json"), "w") as fh:
        json.dump(keys_sorted, fh)
    return {"keyCount": len(keys_sorted)}


_TOK_RX = re.compile(
    r"\(|\)|\"[^\"]*\"|'(?:[^']|'')*'|!=|<>|=|IS\s+NOT\s+NULL|IS\s+NULL"
    r"|AND|OR|NOT", re.IGNORECASE)


class _FilterParser:
    def __init__(self, f: str):
        self.toks = [t for t in _TOK_RX.findall(f)]
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def parse(self):
        node = self._or()
        if self.peek() is not None:
            raise ValueError(f"bad JSON_MATCH filter near {self.peek()!r}")
        return node

    def _or(self):
        parts = [self._and()]
        while self.peek() and self.peek().upper() == "OR":
            self.i += 1
            parts.append(self._and())
        return ("or", parts) if len(parts) > 1 else parts[0]

    def _and(self):
        parts = [self._unary()]
        while self.peek() and self.peek().upper() == "AND":
            self.i += 1
            parts.append(self._unary())
        return ("and", parts) if len(parts) > 1 else parts[0]

    def _unary(self):
        t = self.peek()
        if t is None:
            raise ValueError("empty JSON_MATCH filter")
        if t.upper() == "NOT":
            self.i += 1
            return ("not", self._unary())
        if t == "(":
            self.i += 1
            node = self._or()
            if self.peek() != ")":
                raise ValueError("unbalanced parens in JSON_MATCH filter")
            self.i += 1
            return node
        if not t.startswith('"'):
            raise ValueError(f"expected a quoted JSON path, got {t!r}")
        self.i += 1
        path = t.strip('"')
        op = self.peek()
        if op is None:
            raise ValueError(f"dangling JSON path {path!r}")
        self.i += 1
        up = re.sub(r"\s+", " ", op.upper())
        if up == "IS NULL":
            return ("eq", path, SEP + "null")
        if up == "IS NOT NULL":
            return ("exists", path)
        if op in ("=", "!=", "<>"):
            lit = self.peek()
            if lit is None or not lit.startswith("'"):
                raise ValueError(f"expected a literal after {op}")
            self.i += 1
            value = lit[1:-1].replace("''", "'")
            return ("eq", path, value) if op == "=" else \
                ("not", ("eq", path, value))
        raise ValueError(f"unsupported JSON_MATCH operator {op!r}")


class JsonIndexReader:
    def __init__(self, seg_dir: str, col: str, meta: Dict[str, Any]):
        self.postings = CsrPostings(seg_dir, col + SUFFIX)
        from ..segment import segdir
        keys = segdir.read_json(seg_dir, col + SUFFIX + ".keys.json")
        self.keys = {k: i for i, k in enumerate(keys)}

    def _mask_for_key(self, key: str, n_docs: int) -> np.ndarray:
        mask = np.zeros(n_docs, dtype=bool)
        k = self.keys.get(key)
        if k is not None:
            mask[self.postings.docs_for(k)] = True
        return mask

    def _eval(self, node, n_docs: int) -> np.ndarray:
        kind = node[0]
        if kind == "eq":
            return self._mask_for_key(node[1] + SEP + node[2], n_docs)
        if kind == "exists":
            return self._mask_for_key(node[1], n_docs)
        if kind == "and":
            mask = np.ones(n_docs, dtype=bool)
            for c in node[1]:
                mask &= self._eval(c, n_docs)
            return mask
        if kind == "or":
            mask = np.zeros(n_docs, dtype=bool)
            for c in node[1]:
                mask |= self._eval(c, n_docs)
            return mask
        if kind == "not":
            return ~self._eval(node[1], n_docs)
        raise ValueError(kind)

    def match(self, filter_str: str, n_docs: int) -> np.ndarray:
        return self._eval(_FilterParser(filter_str).parse(), n_docs)
