"""Normalized-SQL shape hash: ONE key per query *shape*.

The port's copy of ``pinot_tpu/utils/shapehash.py`` (pure ``hashlib`` and
``re``): ``pinot_tpu_torch/tools/span_diff.py`` keys its baseline on it,
so a baseline's shape keys are the same strings in both packages
(``tests/test_torch_gates.py`` holds the two functions equal).

The normalization is deliberately minimal — collapse whitespace, case-
fold — because qids are per-instance uuids and literal values are PART
of the shape the span baseline keys on (edit a corpus query, re-capture
the baseline). Anything smarter (literal masking) would change every
checked-in baseline key.
"""
from __future__ import annotations

import hashlib
import re


def shape_key(sql: str) -> str:
    """12-hex-digit sha1 of the whitespace-collapsed, lowercased SQL."""
    norm = re.sub(r"\s+", " ", sql.strip().lower())
    return hashlib.sha1(norm.encode()).hexdigest()[:12]
