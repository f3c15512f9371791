"""Text index: tokenized positional inverted index serving TEXT_MATCH.

Port of ``pinot_tpu/index/text.py``: the same host numpy code, so the files it
writes are byte-equal to the JAX package's.

Reference parity: pinot-segment-local/.../segment/creator/impl/text/
LuceneTextIndexCreator.java:28-30 (Lucene StandardAnalyzer index),
.../utils/nativefst/ (the in-house FST for prefix/regex term lookup), and
operator/filter/TextMatchFilterOperator. Lucene stays host-side in the
reference; here the analyzer is a lowercase alphanumeric tokenizer and
the index is CSR postings (token -> sorted doc ids) plus a positional
occurrence file ("quoted phrases" match true adjacency, like Lucene
PhraseQuery). The FST's job — ordered term lookup so `prefix*` resolves
to a contiguous term range without scanning — falls to the SORTED vocab
+ binary search (the same trick the sorted dictionaries use); only
infix/complex wildcards scan. Query syntax is a Lucene subset: terms,
"quoted phrases", prefix*/wild?cards, AND / OR / NOT, parentheses; bare
terms combine with OR like Lucene's default operator.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List

import numpy as np

from .csr import CsrPostings, postings_from_doc_keys, write_csr

SUFFIX = ".text"
_TOKEN_RX = re.compile(r"[a-z0-9]+")


def tokenize(text: Any) -> List[str]:
    return _TOKEN_RX.findall(str(text).lower())


def build(col: str, seg_dir: str, *, values: np.ndarray,
          **_: Any) -> Dict[str, Any]:
    doc_tokens = [tokenize(v) for v in values]
    vocab: Dict[str, int] = {}
    for toks in doc_tokens:
        for t in toks:
            if t not in vocab:
                vocab[t] = len(vocab)
    tokens_sorted = sorted(vocab)
    remap = {t: i for i, t in enumerate(tokens_sorted)}
    doc_keys = [[remap[t] for t in toks] for toks in doc_tokens]
    write_csr(os.path.join(seg_dir, col + SUFFIX),
              postings_from_doc_keys(doc_keys, len(tokens_sorted)))
    with open(os.path.join(seg_dir, col + SUFFIX + ".vocab.json"), "w") as fh:
        json.dump(tokens_sorted, fh)
    # positional occurrences (PhraseQuery support): (key, doc, pos)
    # triples sorted by key, plus per-key offsets for O(1) slicing
    occ = [(remap[t], d, p)
           for d, toks in enumerate(doc_tokens)
           for p, t in enumerate(toks)]
    occ.sort()
    arr = (np.asarray(occ, dtype=np.int32).reshape(-1, 3)
           if occ else np.zeros((0, 3), dtype=np.int32))
    offsets = np.searchsorted(arr[:, 0],
                              np.arange(len(tokens_sorted) + 1,
                                        dtype=np.int32)).astype(np.int64)
    arr[:, 1:].T.tofile(os.path.join(seg_dir, col + SUFFIX + ".pos.bin"))
    offsets.tofile(os.path.join(seg_dir, col + SUFFIX + ".pos.off.bin"))
    max_pos = int(arr[:, 2].max()) + 1 if len(arr) else 1
    return {"vocabSize": len(tokens_sorted), "maxPos": max_pos}


class _QueryParser:
    """query := or ; or := and (OR and)* ; and := unary ((AND)? unary)* ;
    unary := NOT unary | '(' or ')' | phrase | term.
    Adjacent units with no operator combine with OR (Lucene default)."""

    def __init__(self, q: str):
        # regex tokens allow backslash-escaped slashes (Lucene /a\/b/);
        # the closing / must END the token, so a path-like literal
        # ('/foo/bar') stays ONE term instead of regex-plus-term
        self.toks = re.findall(
            r"\(|\)|\"[^\"]*\"|/(?:\\.|[^/\\])*/(?=[\s()]|$)|[^\s()]+", q)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def parse(self):
        node = self._or()
        if self.peek() is not None:
            raise ValueError(f"bad TEXT_MATCH query near {self.peek()!r}")
        return node

    def _or(self):
        parts = [self._and()]
        while self.peek() is not None and self.peek().upper() != "AND" \
                and self.peek() != ")":
            if self.peek().upper() == "OR":
                self.i += 1
            parts.append(self._and())
        return ("or", parts) if len(parts) > 1 else parts[0]

    def _and(self):
        parts = [self._unary()]
        while self.peek() is not None and self.peek().upper() == "AND":
            self.i += 1
            parts.append(self._unary())
        return ("and", parts) if len(parts) > 1 else parts[0]

    def _unary(self):
        t = self.peek()
        if t is None:
            raise ValueError("empty TEXT_MATCH query")
        if t.upper() == "NOT":
            self.i += 1
            return ("not", self._unary())
        if t == "(":
            self.i += 1
            node = self._or()
            if self.peek() != ")":
                raise ValueError("unbalanced parens in TEXT_MATCH query")
            self.i += 1
            return node
        self.i += 1
        if t.startswith('"'):
            return ("phrase", tokenize(t.strip('"')))
        if len(t) >= 2 and t.startswith("/") and t.endswith("/"):
            # Lucene RegexpQuery: /pattern/ full-matches vocabulary
            # terms; \/ unescapes. Matching is case-insensitive (the
            # vocabulary is lowercased at build, so a verbatim-cased
            # pattern would silently miss everything) — IGNORECASE, not
            # pattern lowercasing, which would corrupt classes like \W.
            return ("regex", t[1:-1].replace("\\/", "/"))
        m = re.fullmatch(r"(.+?)~(\d*)", t)
        if m:
            # Lucene FuzzyQuery: term~ / term~N (max edit distance,
            # default 2; >2 is a parse error like Lucene — never a
            # silent literal-term lookup)
            edits = int(m.group(2)) if m.group(2) else 2
            if edits > 2:
                raise ValueError(
                    f"fuzzy edit distance {edits} > 2 in {t!r}")
            return ("fuzzy", m.group(1).lower(), edits)
        return ("term", t.lower())


class TextIndexReader:
    def __init__(self, seg_dir: str, col: str, meta: Dict[str, Any]):
        self.postings = CsrPostings(seg_dir, col + SUFFIX)
        from ..segment import segdir
        # sorted: the FST-analog ordering
        self.terms = segdir.read_json(seg_dir, col + SUFFIX + ".vocab.json")
        self.vocab = {t: i for i, t in enumerate(self.terms)}
        self.max_pos = int(meta.get("maxPos", 0) or 0)
        if segdir.exists(seg_dir, col + SUFFIX + ".pos.bin"):
            # memmap like the CSR postings — the occurrence file is the
            # biggest text artifact and phrase queries may never come
            # (older segments have no positions at all)
            raw = segdir.read_array(seg_dir, col + SUFFIX + ".pos.bin",
                                    np.int32)
            half = len(raw) // 2
            self._occ_doc, self._occ_pos = raw[:half], raw[half:]
            self._occ_off = segdir.read_array(
                seg_dir, col + SUFFIX + ".pos.off.bin", np.int64)
        else:
            self._occ_doc = None

    def _wildcard_keys(self, term: str) -> List[int]:
        if term.endswith("*") and not any(c in "*?" for c in term[:-1]):
            # pure prefix: binary-search the sorted term list — the
            # nativefst/Lucene-FST capability (ordered term dictionary);
            # bisect on the list itself, no O(vocab) array conversion
            import bisect
            prefix = term[:-1]
            lo = bisect.bisect_left(self.terms, prefix)
            hi = bisect.bisect_left(self.terms, prefix + "￿")
            return list(range(lo, hi))
        # infix/complex wildcard: scan, with metachars escaped
        pattern = "".join(".*" if c == "*" else "." if c == "?"
                          else re.escape(c) for c in term)
        rx = re.compile("^" + pattern + "$")
        return [i for t, i in self.vocab.items() if rx.match(t)]

    def _term_mask(self, term: str, n_docs: int) -> np.ndarray:
        if "*" in term or "?" in term:
            return self.postings.mask_for(self._wildcard_keys(term), n_docs)
        key = self.vocab.get(term)
        mask = np.zeros(n_docs, dtype=bool)
        if key is not None:
            mask[self.postings.docs_for(key)] = True
        return mask

    def _phrase_mask(self, tokens: List[str], n_docs: int) -> np.ndarray:
        """True adjacency (Lucene PhraseQuery): doc matches when the i-th
        phrase token occurs at position start+i for some start. Falls back
        to conjunctive containment on position-less (older) indexes."""
        mask = np.zeros(n_docs, dtype=bool)
        if not tokens:
            return ~mask
        if self._occ_doc is None or len(tokens) == 1:
            out = np.ones(n_docs, dtype=bool)
            for t in tokens:
                out &= self._term_mask(t, n_docs)
            return out
        span = self.max_pos + len(tokens) + 1
        cand = None
        for i, t in enumerate(tokens):
            key = self.vocab.get(t)
            if key is None:
                return mask
            s, e = self._occ_off[key], self._occ_off[key + 1]
            # phrase-start coordinates this occurrence is consistent with
            starts = (self._occ_doc[s:e].astype(np.int64) * span
                      + (self._occ_pos[s:e].astype(np.int64) - i))
            cand = starts if cand is None else np.intersect1d(
                cand, starts, assume_unique=False)
            if len(cand) == 0:
                return mask
        mask[np.unique(cand // span)] = True
        return mask

    def _regex_mask(self, pattern: str, n_docs: int) -> np.ndarray:
        """Lucene RegexpQuery analog: the pattern full-matches terms of
        the sorted vocabulary; matching terms' postings OR together.
        Where Lucene compiles the regex to an automaton intersected
        with the FST, the vocabulary here is small enough that a direct
        vectorized scan is the honest TPU-host form."""
        try:
            rx = re.compile(pattern, re.IGNORECASE)
        except re.error as e:
            raise ValueError(f"bad TEXT_MATCH regex {pattern!r}: {e}")
        keys = [i for i, t in enumerate(self.terms) if rx.fullmatch(t)]
        return self.postings.mask_for(keys, n_docs)

    def _fuzzy_keys(self, term: str, max_edits: int) -> List[int]:
        """Vocabulary terms within Levenshtein distance max_edits:
        one vectorized DP over the (pre-filtered by length) term list —
        the FuzzyQuery Levenshtein-automaton role."""
        lens = np.array([len(t) for t in self.terms])
        cand = np.nonzero(np.abs(lens - len(term)) <= max_edits)[0]
        if len(cand) == 0:
            return []
        maxlen = int(lens[cand].max())
        # (n_cand, maxlen) code-point matrix, -1 padded
        mat = np.full((len(cand), maxlen), -1, dtype=np.int32)
        for r, i in enumerate(cand):
            t = self.terms[i]
            mat[r, :len(t)] = [ord(c) for c in t]
        q = np.array([ord(c) for c in term], dtype=np.int32)
        # DP rows vectorized across candidates
        prev = np.broadcast_to(np.arange(maxlen + 1, dtype=np.int32),
                               (len(cand), maxlen + 1)).copy()
        for qi in range(1, len(term) + 1):
            cur = np.empty_like(prev)
            cur[:, 0] = qi
            sub = prev[:, :-1] + (mat != q[qi - 1])
            for j in range(1, maxlen + 1):
                cur[:, j] = np.minimum(np.minimum(
                    cur[:, j - 1] + 1, prev[:, j] + 1), sub[:, j - 1])
            prev = cur
        dist = prev[np.arange(len(cand)), lens[cand]]
        return [int(cand[r]) for r in np.nonzero(dist <= max_edits)[0]]

    def _eval(self, node, n_docs: int) -> np.ndarray:
        kind = node[0]
        if kind == "term":
            return self._term_mask(node[1], n_docs)
        if kind == "regex":
            return self._regex_mask(node[1], n_docs)
        if kind == "fuzzy":
            return self.postings.mask_for(
                self._fuzzy_keys(node[1], node[2]), n_docs)
        if kind == "phrase":
            return self._phrase_mask(node[1], n_docs)
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

    def match(self, query: str, n_docs: int) -> np.ndarray:
        return self._eval(_QueryParser(query).parse(), n_docs)
