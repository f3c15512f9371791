"""Vector similarity index: dense matrix + IVF coarse quantizer, both
searched on the segment's device.

Port of ``pinot_tpu/index/vector.py``. The build half (seeded k-means, the
balanced list assignment, the CSR page layout, the files) is the JAX
package's numpy code, copied: the same data and seed give the same
centroids, pages and pageptr, bitwise, and byte-equal files. The reader
uploads the same arrays as the reference's ``_host_arrays`` (the
sentinel-padded matrix, squared norms, centroids, the page table with its
all-sentinel pad page and the page-major matrix copy) as torch tensors on
its device, accounted in the ``vector`` pool of ``utils/devmem`` (which the
device tier's budget sums), and searches them with the hand-written CUDA
kernels of ``ops/vecsearch.py`` (K15: flat and IVF), or their plain
versions for CPU tensors. A tier demotion of the owning segment drops the
tensors (``evict_device``); the next search uploads them again.

``search_batch`` takes a stack of queries in one launch; each query's
result is the same bits whatever the batch (the kernels' contract), so the
batcher (engine/vector_exec.py) is a throughput policy only. The reference
pads the batch to a power of two for its compile cache; the port has no
compile cache and does not pad. ``_build_lock`` is held across the whole
build and upload, with a re-check inside, so two threads never upload
twice; inserts publish under ``_res_lock``.
"""
from __future__ import annotations

import itertools
import math
import os
import threading
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops import vecsearch
from ..utils.devmem import global_device_memory

SUFFIX = ".vec.bin"
IVF_CENT_SUFFIX = ".vec.cent.bin"
IVF_PAGES_SUFFIX = ".vec.pages.bin"
IVF_PAGEPTR_SUFFIX = ".vec.pageptr.bin"

POOL = "vector"                 # utils/devmem pool name
PAGE_SIZE = 64                  # doc ids per IVF page
KMEANS_ITERS = 8
KMEANS_SAMPLE = 1 << 16         # centroid fit sample cap (assignment is full)

# live readers (reconcile_devmem sums their actual device bytes against
# the tracked pool); a WeakSet, so an unloaded segment's reader never pins
_LIVE_LOCK = threading.Lock()
_LIVE_READERS: "weakref.WeakSet[VectorIndexReader]" = weakref.WeakSet()
# process-unique reader identity for memo and batch keys, never id(): a
# collected reader's address can be reused and would alias cache entries
_READER_SEQ = itertools.count(1)

# devmem entries whose reader was collected while resident: the weakref
# finalizer appends here without a lock (collection can run on a thread
# that already holds the devmem lock) and the next ensure_device or
# live_readers drains it on a normal thread
_DEAD_ENTRIES: list = []


def _reap_dead_entries() -> None:
    while _DEAD_ENTRIES:
        pool_key, names = _DEAD_ENTRIES.pop()
        for name in names:
            global_device_memory.remove(POOL, (pool_key, name),
                                        evicted=False)


def live_readers():
    _reap_dead_entries()
    with _LIVE_LOCK:
        return list(_LIVE_READERS)


def default_n_lists(n_docs: int) -> int:
    """sqrt(n) clamped — the standard IVF list-count heuristic."""
    return max(8, min(1024, int(round(math.sqrt(max(n_docs, 1))))))


def default_nprobe(n_lists: int) -> int:
    """Probe ~1/32 of the lists by default — the recall/QPS knee the
    bench's nprobe sweep documents (recall ~0.98 at ~5x the exact
    scan's QPS on the CPU smoke with balanced lists; raise per query
    via the 4th VECTOR_SIMILARITY argument when recall matters more)."""
    return max(1, (n_lists + 31) // 32)


# ---------------------------------------------------------------------------
# build: seeded k-means + CSR page layout
# ---------------------------------------------------------------------------

def _fit_centroids(x: np.ndarray, n_lists: int, seed: int,
                   iters: int = KMEANS_ITERS) -> np.ndarray:
    """Seeded Lloyd k-means on a bounded sample; deterministic in
    (data, n_lists, seed). Empty clusters re-seed to random rows."""
    rng = np.random.default_rng(seed)
    n = len(x)
    fit = x if n <= KMEANS_SAMPLE else \
        x[rng.choice(n, size=KMEANS_SAMPLE, replace=False)]
    c = fit[rng.choice(len(fit), size=n_lists, replace=False)].astype(
        np.float64)
    for _ in range(iters):
        a = _assign(fit, c)
        sums = np.zeros_like(c)
        np.add.at(sums, a, fit.astype(np.float64))
        cnt = np.bincount(a, minlength=n_lists)
        nz = cnt > 0
        c[nz] = sums[nz] / cnt[nz, None]
        if not nz.all():
            c[~nz] = fit[rng.choice(len(fit), size=int((~nz).sum()))]
    return c.astype(np.float32)


def _assign(x: np.ndarray, c: np.ndarray, chunk: int = 1 << 16
            ) -> np.ndarray:
    """argmin-L2 list assignment, chunked so the (rows, n_lists)
    distance block stays bounded at any matrix size."""
    out = np.empty(len(x), dtype=np.int32)
    c64 = c.astype(np.float64)
    csq = (c64 * c64).sum(axis=1)
    for i in range(0, len(x), chunk):
        xb = x[i: i + chunk].astype(np.float64)
        d = csq[None, :] - 2.0 * (xb @ c64.T)
        out[i: i + chunk] = np.argmin(d, axis=1)
    return out


# balanced-assignment slack: every list is capped at slack * (n / L)
# docs, overflow spills to the doc's next-nearest centroid — the probe
# bound becomes TIGHT (nprobe * cap pages, no worst-list blowup), which
# is what makes the ragged scan actually cheaper than the flat matmul
# (1.1 measured better than 1.25 on the CPU smoke: ~13% less padded
# probe work for a ~0.5pt recall cost at the default nprobe)
BALANCE_SLACK = 1.1
_BALANCE_CHOICES = 8


def _balanced_assign(x: np.ndarray, c: np.ndarray,
                     cap: int, chunk: int = 1 << 16) -> np.ndarray:
    """Capacity-bounded list assignment: closest-first seat claiming
    over each doc's ranked centroid choices (deterministic in the
    inputs). Guarantees every list holds <= cap docs, every doc lands
    somewhere (cap * n_lists >= n by construction)."""
    n, n_lists = len(x), len(c)
    r_max = min(n_lists, _BALANCE_CHOICES)
    choice = np.empty((n, r_max), dtype=np.int32)
    choice_d = np.empty((n, r_max), dtype=np.float64)
    c64 = c.astype(np.float64)
    csq = (c64 * c64).sum(axis=1)
    for i in range(0, n, chunk):
        xb = x[i: i + chunk].astype(np.float64)
        d = csq[None, :] - 2.0 * (xb @ c64.T)
        top = np.argpartition(d, r_max - 1, axis=1)[:, :r_max]
        td = np.take_along_axis(d, top, axis=1)
        order = np.argsort(td, axis=1, kind="stable")
        choice[i: i + chunk] = np.take_along_axis(top, order, axis=1)
        choice_d[i: i + chunk] = np.take_along_axis(td, order, axis=1)
    assign = np.full(n, -1, dtype=np.int32)
    counts = np.zeros(n_lists, dtype=np.int64)
    for r in range(r_max):
        idx = np.nonzero(assign < 0)[0]
        if not len(idx):
            break
        lists = choice[idx, r]
        d = choice_d[idx, r]
        # group by target list, closest docs claim the free seats
        order = np.lexsort((d, lists))
        sl = lists[order]
        starts = np.searchsorted(sl, np.arange(n_lists))
        rank = np.arange(len(order)) - starts[sl]
        take = rank < (cap - counts)[sl]
        won = order[take]
        assign[idx[won]] = sl[take]
        counts += np.bincount(sl[take], minlength=n_lists)
    left = np.nonzero(assign < 0)[0]
    if len(left):
        # pathological spill (every ranked choice full): deterministic
        # round-robin over the remaining free seats
        free = np.repeat(np.arange(n_lists),
                         np.maximum(cap - counts, 0))
        assign[left] = free[: len(left)].astype(np.int32)
    return assign


def _page_layout(assign: np.ndarray, n_docs: int, n_lists: int,
                 page: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (pages (n_pages, page) int32 doc ids padded with the n_docs
    sentinel, pageptr (n_lists+1) int32): list l owns pages
    [pageptr[l], pageptr[l+1]) — contiguous, CSR-style."""
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=n_lists)
    pages_per = (counts + page - 1) // page
    pageptr = np.zeros(n_lists + 1, dtype=np.int32)
    np.cumsum(pages_per, out=pageptr[1:])
    pages = np.full((int(pageptr[-1]), page), n_docs, dtype=np.int32)
    flat = pages.reshape(-1)
    off = np.cumsum(counts) - counts
    for li in range(n_lists):
        c = int(counts[li])
        if c:
            p0 = int(pageptr[li]) * page
            flat[p0: p0 + c] = order[off[li]: off[li] + c]
    return pages, pageptr


def build(col: str, seg_dir: str, *, values: np.ndarray,
          metric: str = "cosine", nLists: Optional[int] = None,
          seed: int = 7, pageSize: int = PAGE_SIZE,
          **_: Any) -> Dict[str, Any]:
    rows = [np.asarray(v, dtype=np.float32) for v in values]
    if not rows:
        raise ValueError(f"vector index on empty column {col}")
    dim = len(rows[0])
    for r in rows:
        if r.shape != (dim,):
            raise ValueError(f"ragged vector column {col}: "
                             f"{r.shape} != ({dim},)")
    mat = np.stack(rows)
    mat.tofile(os.path.join(seg_dir, col + SUFFIX))
    meta: Dict[str, Any] = {"dim": int(dim), "metric": str(metric)}
    if nLists:
        # clamp an oversized config instead of crashing the build: the
        # k-means fit samples at most KMEANS_SAMPLE rows, so that also
        # bounds how many distinct centroids can be seeded
        n_lists = max(1, min(int(nLists), len(mat), KMEANS_SAMPLE))
        space = _ivf_space(mat, metric)
        cents = _fit_centroids(space, n_lists, int(seed))
        cap = _list_cap(len(mat), n_lists)
        pages, pageptr = _page_layout(
            _balanced_assign(space, cents, cap), len(mat), n_lists,
            int(pageSize))
        cents.tofile(os.path.join(seg_dir, col + IVF_CENT_SUFFIX))
        pages.tofile(os.path.join(seg_dir, col + IVF_PAGES_SUFFIX))
        pageptr.tofile(os.path.join(seg_dir, col + IVF_PAGEPTR_SUFFIX))
        meta["ivf"] = {"nLists": int(n_lists), "pageSize": int(pageSize),
                       "nPages": int(pages.shape[0]), "seed": int(seed),
                       "nprobe": default_nprobe(n_lists)}
    return meta


def _list_cap(n_docs: int, n_lists: int) -> int:
    """Per-list doc capacity (balanced assignment): slack * mean,
    rounded up so cap * n_lists always covers n."""
    return max(int(math.ceil(n_docs / n_lists * BALANCE_SLACK)), 1)


def _ivf_space(mat: np.ndarray, metric: str) -> np.ndarray:
    """The space k-means partitions: normalized rows for cosine
    (spherical k-means — centroid dot ranks like row dot), raw for l2."""
    if metric == "cosine":
        norms = np.linalg.norm(mat, axis=1, keepdims=True)
        return (mat / np.maximum(norms, 1e-30)).astype(np.float32)
    return mat.astype(np.float32)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class VectorIndexReader:
    def __init__(self, seg_dir: str, col: str, meta: Dict[str, Any]):
        from ..segment import segdir
        raw = segdir.read_array(seg_dir, col + SUFFIX, np.float32)
        ivf = None
        im = meta.get("ivf")
        if im:
            cents = np.asarray(segdir.read_array(
                seg_dir, col + IVF_CENT_SUFFIX, np.float32,
                mmap=False)).reshape(int(im["nLists"]), -1)
            pages = np.asarray(segdir.read_array(
                seg_dir, col + IVF_PAGES_SUFFIX, np.int32,
                mmap=False)).reshape(int(im["nPages"]),
                                     int(im["pageSize"]))
            pageptr = np.asarray(segdir.read_array(
                seg_dir, col + IVF_PAGEPTR_SUFFIX, np.int32, mmap=False))
            ivf = {"centroids": cents, "pages": pages,
                   "pageptr": pageptr,
                   "nprobe": int(im.get("nprobe")
                                 or default_nprobe(int(im["nLists"])))}
        # the device comes from the owning segment (attach_owner)
        self._init(raw.reshape(-1, int(meta["dim"])),
                   meta.get("metric", "cosine"), ivf, None)

    def _init(self, matrix: np.ndarray, metric: str,
              ivf: Optional[Dict[str, Any]],
              device: Optional[torch.device]) -> None:
        self.dim = matrix.shape[1]
        self.metric = metric
        self.matrix = matrix
        self.ivf = ivf
        self.device = device
        self.token: int = next(_READER_SEQ)
        # devmem identity: (owner uid, col) once attached to a segment,
        # the token for in-memory readers
        self._pool_key: Any = f"reader_{self.token}"
        self._owner: Optional[Any] = None       # weakref to the segment
        self._finalizer: Optional[Any] = None   # devmem-entry reaper
        # device residents, published under _res_lock; _build_lock is
        # held across the whole host prep and upload so two threads never
        # upload twice
        self._res_lock = threading.Lock()
        self._build_lock = threading.Lock()
        self._dev: Dict[str, torch.Tensor] = {}
        self._max_pages: Dict[int, int] = {}
        with _LIVE_LOCK:
            _LIVE_READERS.add(self)

    @classmethod
    def from_matrix(cls, matrix: np.ndarray, metric: str = "cosine",
                    device: Union[str, torch.device, None] = None
                    ) -> "VectorIndexReader":
        """Reader over an in-memory matrix on ``device`` (default CUDA)."""
        r = cls.__new__(cls)
        r._init(np.asarray(matrix, dtype=np.float32), metric, None,
                resolve_device(device))
        return r

    def build_ivf(self, n_lists: Optional[int] = None, seed: int = 7,
                  page: int = PAGE_SIZE,
                  nprobe: Optional[int] = None) -> "VectorIndexReader":
        """In-memory IVF layer (the file path builds it at segment-build
        time)."""
        n_lists = min(n_lists or default_n_lists(len(self.matrix)),
                      len(self.matrix), KMEANS_SAMPLE)
        space = _ivf_space(self.matrix, self.metric)
        cents = _fit_centroids(space, n_lists, seed)
        cap = _list_cap(len(self.matrix), n_lists)
        pages, pageptr = _page_layout(
            _balanced_assign(space, cents, cap), len(self.matrix),
            n_lists, page)
        self.evict_device()
        self.ivf = {"centroids": cents, "pages": pages,
                    "pageptr": pageptr,
                    "nprobe": nprobe or default_nprobe(n_lists)}
        self._max_pages = {}
        return self

    # -- ownership / tier --------------------------------------------------
    def attach_owner(self, segment, col: str) -> None:
        """Bind to the owning segment: the reader lives on its device,
        devmem keys become (uid, col) and every upload is an admission of
        that segment to the tier."""
        self._pool_key = (segment.uid, col)
        self._owner = weakref.ref(segment)
        self.device = segment.device

    def owner(self):
        return self._owner() if self._owner is not None else None

    @property
    def n_lists(self) -> int:
        return len(self.ivf["centroids"]) if self.ivf else 0

    @property
    def nprobe_default(self) -> int:
        return int(self.ivf["nprobe"]) if self.ivf else 0

    # -- device residency --------------------------------------------------
    def _host_arrays(self) -> Dict[str, np.ndarray]:
        """The upload set, array for array the reference's: the
        sentinel-padded matrix (rows normalised for cosine) and its squared
        norms (zeros for cosine, never read), and with an IVF layer the
        centroids and their squared norms, the page table with an
        all-sentinel pad page, pageptr, and the page-major matrix copy
        (``paged[p, i] = matrix[pages[p, i]]``) whose contiguous (page,
        dim) blocks the probe kernel reads."""
        m = self.matrix
        if self.metric == "cosine":
            norms = np.linalg.norm(m, axis=1, keepdims=True)
            m = m / np.maximum(norms, 1e-30)
        m = np.ascontiguousarray(m, dtype=np.float32)
        m_pad = np.concatenate(
            [m, np.zeros((1, self.dim), dtype=np.float32)])
        out = {"matrix": m_pad}
        if self.metric != "cosine":
            row_sq = np.concatenate(
                [np.sum(m.astype(np.float64) * m, axis=1),
                 [0.0]]).astype(np.float32)
        else:
            row_sq = np.zeros(len(m) + 1, dtype=np.float32)
        out["row_sq"] = row_sq
        if self.ivf:
            cents = self.ivf["centroids"]
            out["centroids"] = cents
            if self.metric != "cosine":
                out["cent_sq"] = np.sum(
                    cents.astype(np.float64) * cents, axis=1).astype(
                    np.float32)
            else:
                out["cent_sq"] = np.zeros(len(cents), dtype=np.float32)
            pages_pad = np.concatenate(
                [self.ivf["pages"],
                 np.full((1, self.ivf["pages"].shape[1]),
                         len(self.matrix), dtype=np.int32)])
            out["pages"] = pages_pad
            out["pageptr"] = self.ivf["pageptr"].astype(np.int32)
            out["paged"] = m_pad[pages_pad]      # (n_pages+1, page, dim)
            out["paged_sq"] = row_sq[pages_pad]
        return out

    def _device(self) -> torch.device:
        if self.device is None:
            self.device = resolve_device(None)
        return self.device

    def ensure_device(self) -> Dict[str, torch.Tensor]:
        """Upload-once device residency, serialised by ``_build_lock``
        (the second thread re-checks inside and returns the first upload);
        inserts publish and account under ``_res_lock`` so a concurrent
        ``evict_device`` cannot strand devmem bytes."""
        dev = self._dev
        if dev:
            return dev
        _reap_dead_entries()
        device = self._device()
        with self._build_lock:
            if self._dev:
                return self._dev
            hosts = self._host_arrays()
            arrs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in hosts.items()}
            with self._res_lock:
                self._dev = arrs
                for k, v in arrs.items():
                    global_device_memory.add(
                        POOL, (self._pool_key, k), int(v.nbytes))
                # a resident reader collected without evict_device must
                # not leave pool bytes charging the tier budget (the
                # callback takes no lock: see _DEAD_ENTRIES)
                self._finalizer = weakref.finalize(
                    self, _DEAD_ENTRIES.append,
                    (self._pool_key, tuple(arrs)))
        owner = self.owner()
        if owner is not None:
            from ..engine.tier import global_tier
            global_tier.admitted(owner)
        return self._dev

    def evict_device(self) -> None:
        """Drop the device residents (tier demotion of the owning segment,
        budget eviction); the next search uploads again."""
        with self._res_lock:
            for k in self._dev:
                global_device_memory.remove(POOL, (self._pool_key, k))
            self._dev = {}
            if self._finalizer is not None:
                self._finalizer.detach()
                self._finalizer = None

    def device_bytes(self) -> int:
        with self._res_lock:
            return sum(int(v.nbytes) for v in self._dev.values())

    # -- search ------------------------------------------------------------
    def _query_vec(self, query: np.ndarray) -> np.ndarray:
        q = np.asarray(query, dtype=np.float32)
        if q.shape != (self.dim,):
            raise ValueError(f"query dim {q.shape} != ({self.dim},)")
        if self.metric == "cosine":
            q = q / max(float(np.linalg.norm(q)), 1e-30)
        return q

    def max_pages_for(self, nprobe: int) -> int:
        """Bound on the ragged page-run total of a probe: the nprobe
        largest lists' page counts, rounded up to a multiple of 8 pages
        (the reference's value, so the probe's slots and padding match)."""
        got = self._max_pages.get(nprobe)
        if got is None:
            ptr = self.ivf["pageptr"].astype(np.int64)
            counts = np.sort(ptr[1:] - ptr[:-1])[::-1]
            worst = int(counts[:nprobe].sum())
            got = min(-(-max(worst, 1) // 8) * 8, int(ptr[-1]))
            got = max(got, 1)
            self._max_pages[nprobe] = got
        return got

    def effective_nprobe(self, nprobe: Optional[int]) -> int:
        """Clamped probe count: None -> the index default; >= n_lists
        (or no IVF layer) -> the exact flat scan (0 means flat)."""
        if not self.ivf:
            return 0
        np_ = int(nprobe) if nprobe else self.nprobe_default
        return 0 if np_ >= self.n_lists else max(np_, 1)

    def search_batch(self, queries, k: int, nprobe: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for a [B, dim] stack of queries in one launch -> (scores
        [B, k] float32, docs [B, k] int32, -1 where a probe found fewer
        than k). Each query's row is the same bits at any B."""
        qs = np.stack([self._query_vec(q) for q in queries])
        b = len(qs)
        n = len(self.matrix)
        k = min(max(int(k), 1), n)
        eff = self.effective_nprobe(nprobe)
        dev = self.ensure_device()
        qt = torch.from_numpy(qs).to(self._device())
        if eff:
            page = self.ivf["pages"].shape[1]
            max_pages = self.max_pages_for(eff)
            k_pad = min(_pow2(k), max_pages * page)
            scores, docs = vecsearch.ivf_search(
                qt, dev["paged"], dev["paged_sq"], dev["centroids"],
                dev["cent_sq"], dev["pages"], dev["pageptr"], self.metric,
                k_pad, eff, max_pages, n)
        else:
            k_pad = min(_pow2(k), n)
            scores, docs = vecsearch.flat_search(
                qt, dev["matrix"], dev["row_sq"], self.metric, k_pad)
        scores = scores.cpu().numpy()[:b, :k]
        docs = docs.cpu().numpy()[:b, :k].astype(np.int32)
        docs = np.where(np.isneginf(scores), np.int32(-1), docs)
        if scores.shape[1] < k:
            # a tiny IVF layout can bound the probe below k: pad the
            # contract shape with explicit misses
            pad = k - scores.shape[1]
            scores = np.concatenate(
                [scores, np.full((b, pad), -np.inf, np.float32)], axis=1)
            docs = np.concatenate(
                [docs, np.full((b, pad), -1, np.int32)], axis=1)
        return scores, docs

    def host_scores(self, query: np.ndarray,
                    sel: Optional[np.ndarray] = None) -> np.ndarray:
        """Exact per-doc similarity scores, host-side (ORDER BY keys,
        oracles): cosine = normalized dot, l2 = negated squared
        distance. The same whatever the batching or placement."""
        qn = self._query_vec(query)
        m = np.asarray(self.matrix if sel is None else self.matrix[sel],
                       dtype=np.float32)
        if self.metric == "cosine":
            norms = np.linalg.norm(m, axis=1, keepdims=True)
            return (m / np.maximum(norms, 1e-30)) @ qn
        d = m - qn
        return -np.sum(d * d, axis=1)
