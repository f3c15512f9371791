"""Device-memory accounting: what lives on the device, right now.

Port of ``pinot_tpu/utils/devmem.py``. Each device cache reports its
inserts and removals here keyed by (pool, entry key); the registry keeps
per-entry byte sizes, mirrors per-pool totals into ``global_metrics``
gauges (``device_bytes_<pool>`` / ``device_entries_<pool>``) and counts
evictions (``device_evictions_<pool>``). The tier (``engine/tier.py``)
compares the sum over every pool with its budget.

Invariant the tests pin: a pool's byte gauge always equals the sum of its
tracked entries' sizes, and ``engine/tier.reconcile_devmem`` holds the
tracked bytes to the tensors the caches really hold.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

from .metrics import global_metrics

# the pools the port has:
#   segment_cols  segment/immutable.ImmutableSegment._device tensors
#   stack_cache   engine/batch._STACK_CACHE stacked column tuples
#   cube_cache    ops/plan_cache.CubeCache per-segment cubes (micro-batching)
#   cube_stacked  ops/plan_cache.CubeCache stacks of those cubes
#   vector        index/vector.VectorIndexReader device tensors
#   mesh_stack    parallel/distributed.DistributedTable per-shard stacks
# The JAX package's plan_cache_acc pool comes with the slice that ports
# the donated plan-cache accumulators.
POOLS = ("segment_cols", "stack_cache", "cube_cache", "cube_stacked",
         "vector", "mesh_stack")


def nbytes_of(tree: Any) -> int:
    """Total tensor bytes of a dict/list/tuple nest of tensors or arrays
    (anything with ``.nbytes``: ``Tensor.nbytes``, ``ndarray.nbytes``)."""
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        else:
            nb = getattr(x, "nbytes", None)
            if nb is not None:
                total += int(nb)
    return total


class DeviceMemoryRegistry:
    """Live device bytes per cache pool (module docstring).

    add/remove take one lock and run on the host serving path next to the
    cache mutations they mirror, never inside kernels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pools: Dict[str, Dict[Any, int]] = {}
        self._evictions: Dict[str, int] = {}

    def _export(self, pool: str) -> None:
        # caller holds self._lock; global_metrics has its own lock and
        # never calls back into this registry (leaf lock, no cycles)
        entries = self._pools.get(pool, {})
        global_metrics.gauge(f"device_bytes_{pool}", sum(entries.values()))
        global_metrics.gauge(f"device_entries_{pool}", len(entries))

    def add(self, pool: str, key: Any, nbytes: int) -> None:
        """Register (or re-size) one cache entry's device bytes."""
        with self._lock:
            self._pools.setdefault(pool, {})[key] = int(nbytes)
            self._export(pool)

    def remove(self, pool: str, key: Any, evicted: bool = True) -> bool:
        """Drop one entry; True when it was tracked. ``evicted`` counts
        it as an eviction (False for wholesale clears)."""
        with self._lock:
            entries = self._pools.get(pool)
            present = entries is not None and \
                entries.pop(key, None) is not None
            if present and evicted:
                self._evictions[pool] = self._evictions.get(pool, 0) + 1
            if present:
                self._export(pool)
        if present and evicted:
            global_metrics.count(f"device_evictions_{pool}")
        return present

    def drop_pool(self, pool: str) -> None:
        """Forget a whole pool without counting evictions."""
        with self._lock:
            self._pools.pop(pool, None)
            self._export(pool)

    def pool_bytes(self, pool: str) -> int:
        with self._lock:
            return sum(self._pools.get(pool, {}).values())

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """{pool: {bytes, entries, evictions}} plus a ``total`` rollup."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            pools = set(self._pools) | set(self._evictions) | set(POOLS)
            for pool in sorted(pools):
                entries = self._pools.get(pool, {})
                out[pool] = {"bytes": sum(entries.values()),
                             "entries": len(entries),
                             "evictions": self._evictions.get(pool, 0)}
            out["total"] = {
                "bytes": sum(p["bytes"] for p in out.values()),
                "entries": sum(p["entries"] for p in out.values()),
                "evictions": sum(p["evictions"] for p in out.values())}
            return out

    def clear(self) -> None:
        with self._lock:
            pools = list(self._pools)
            self._pools.clear()
            self._evictions.clear()
            for pool in pools:
                self._export(pool)


global_device_memory = DeviceMemoryRegistry()
