"""Per-column secondary indexes of the port.

Port of ``pinot_tpu/index/``: inverted, range, bloom, text and json
indexes are host numpy, the same code as the JAX package's, and write
byte-equal files; they answer filters host-side as boolean doc masks that
reach the device as a ``docmask`` kernel param. The vector index
(``vector.py``) keeps its matrix on the segment's device and searches it
with the hand-written CUDA kernels of ``ops/vecsearch.py``. The geo index
is not ported yet: building one raises ``NotImplementedError``.
"""
from .registry import INDEX_KINDS, build_indexes_for_column, load_index
from .predicates import index_filter_mask

__all__ = ["INDEX_KINDS", "build_indexes_for_column", "load_index",
           "index_filter_mask"]
