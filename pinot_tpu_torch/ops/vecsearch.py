"""Vector search top-k (K15): the CUDA kernels, their plain versions.

Port of the two traced device programs of the JAX package's vector index,
``_batched_flat_kernel`` (``pinot_tpu/index/vector.py:284``) and
``_batched_ivf_kernel`` (``:316``):

* ``flat_search(qs, matrix, row_sq, metric, k_pad)``: per query, the
  similarity of every document row (cosine: ``m . q`` over rows normalised
  at upload; l2: ``2 m . q - |m|^2 - |q|^2``), then the top ``k_pad``;
* ``ivf_search(qs, paged, paged_sq, cents, cent_sq, pages, pageptr,
  metric, k_pad, nprobe, max_pages, n_docs)``: centroid scores (l2 without the
  ``|q|^2`` term, as the reference), the top ``nprobe`` lists, the ragged
  expansion of their page runs into ``max_pages`` page slots (past the
  ragged total: the all-sentinel pad page), the scores of those pages'
  rows with sentinel documents (``== n_docs``) at -inf, and the top
  ``k_pad``, mapped to document ids.

The order is ``lax.top_k``'s: score descending, ties to the lower position
(the document row for the flat scan, the slot of the flattened
(max_pages x page) probe for IVF), -0.0 below +0.0. The matrix holds the
documents' rows plus one sentinel row (the JAX upload set); the sentinel
is never a candidate, as ``k_pad`` never exceeds the documents.

On CUDA tensors both launch ``csrc/vecsearch.cu`` (design and bound in
its header) or raise; on CPU tensors they run the plain versions,
``flat_search_reference`` and ``ivf_search_reference``, which follow the
JAX bodies query by query (``lax.map``), so batched equals solo there too.
The kernels are held against them on the card: scores to float32 rounding
(the sums run in another order), ids exactly where the scores are apart.
``score`` and ``select`` expose the kernels' two stages, with
``score_reference`` and ``select_reference`` beside them; the selection is
bitwise equal to its plain version on the same scores. For ``k_pad`` up to
128 a search fuses them (the scan keeps each block's top keys on chip), and
``select(score(...))`` returns its results bitwise. No single PyTorch
call computes either function (``torch.topk(torch.matmul(...))`` is the
two-call yardstick the chip check times, used nowhere here).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import cuda_build

METRICS = ("cosine", "l2")
# score modes of the kernels: m.q; 2 m.q - |m|^2 - |q|^2; 2 m.q - |m|^2
MODE_DOT, MODE_L2, MODE_L2_NOQ = 0, 1, 2

# calls that launched the CUDA kernels (chip_smoke.py resets and reads
# them); concurrent queries search from many threads, hence the lock
flat_launches = 0
ivf_launches = 0
_LAUNCH_LOCK = threading.Lock()


def _mode(metric: str, with_q: bool = True) -> int:
    if metric not in METRICS:
        raise ValueError(f"unsupported metric {metric!r}; have {METRICS}")
    if metric == "cosine":
        return MODE_DOT
    return MODE_L2 if with_q else MODE_L2_NOQ


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _check_f32(name: str, t: torch.Tensor, dims: int,
               device: torch.device) -> None:
    if t.dtype != torch.float32 or t.dim() != dims or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dims}-D float32 "
                         "tensor")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, queries on {device}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def orderable(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is float32's total order (-0.0 < +0.0,
    NaN above +inf), the order of XLA's top_k."""
    bits = scores.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def select_reference(scores: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of ``scores`` (nq, S) in lax.top_k's order:
    a stable descending sort of the orderable keys."""
    order = torch.sort(orderable(scores), dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return torch.gather(scores, -1, order), order.to(torch.int32)


def score_reference(matrix: torch.Tensor, row_sq: Optional[torch.Tensor],
                    q: torch.Tensor, mode: int) -> torch.Tensor:
    """Scores of every row of ``matrix`` (..., dim) against one query
    ``q``. Each row's dot product is reduced by the same code wherever the
    row sits (a row-wise sum, not a matrix-vector product, whose blocked
    code paths can round two equal rows differently), so duplicate rows
    tie exactly and the tie rule decides between them."""
    dots = (matrix * q).sum(-1)
    if mode == MODE_DOT:
        return dots
    s = 2.0 * dots - row_sq
    return s - torch.sum(q * q) if mode == MODE_L2 else s


def flat_search_reference(qs, matrix, row_sq, metric, k_pad
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX flat body, one query at a time (rows past the sentinel are
    not candidates)."""
    mode = _mode(metric)
    n = matrix.shape[0] - 1
    outs = [select_reference(
        score_reference(matrix[:n], row_sq[:n], q, mode)[None], k_pad)
        for q in qs]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def expand_pages(lists: torch.Tensor, pageptr: torch.Tensor,
                 max_pages: int, pad_page: int) -> torch.Tensor:
    """The ragged page-run expansion of ``lists`` (nprobe,) into
    ``max_pages`` page indices (cumsum + searchsorted), the JAX body's."""
    lists = lists.long()
    starts = pageptr.long()[lists]
    counts = pageptr.long()[lists + 1] - starts
    cum = torch.cumsum(counts, 0)
    j = torch.arange(max_pages, device=lists.device)
    li = torch.clamp(torch.searchsorted(cum, j, right=True),
                     max=len(lists) - 1)
    pos = j - (cum[li] - counts[li])
    return torch.where(j < cum[-1], starts[li] + pos,
                       torch.full_like(j, pad_page))


def ivf_search_reference(qs, paged, paged_sq, cents, cent_sq, pages,
                         pageptr, metric, k_pad, nprobe, max_pages, n_docs
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX IVF body, one query at a time."""
    out_s, out_d = [], []
    for q in qs:
        cscore = score_reference(cents, cent_sq, q, _mode(metric, False))
        _, lists = select_reference(cscore[None], nprobe)
        page_idx = expand_pages(lists[0], pageptr, max_pages,
                                pages.shape[0] - 1)
        docs = pages[page_idx]                        # (max_pages, page)
        sims = score_reference(paged[page_idx], paged_sq[page_idx], q,
                               _mode(metric))
        sims = torch.where(docs == n_docs, float("-inf"), sims)
        scores, idx = select_reference(sims.reshape(1, -1), k_pad)
        out_s.append(scores)
        out_d.append(docs.reshape(-1)[idx.long()])
    return torch.cat(out_s), torch.cat(out_d).to(torch.int32)


# ---------------------------------------------------------------------------
# the searches
# ---------------------------------------------------------------------------

def flat_search(qs: torch.Tensor, matrix: torch.Tensor,
                row_sq: torch.Tensor, metric: str, k_pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (nq, k_pad) float32, doc rows (nq, k_pad) int32) of the
    exact scan; ``matrix`` is (n + 1, dim) with the sentinel row last."""
    _check_f32("qs", qs, 2, qs.device)
    _check_f32("matrix", matrix, 2, qs.device)
    _check_f32("row_sq", row_sq, 1, qs.device)
    n = matrix.shape[0] - 1
    if not 1 <= k_pad <= n or qs.shape[1] != matrix.shape[1]:
        raise ValueError(f"k_pad {k_pad} outside [1, {n}] or query dim "
                         f"{qs.shape[1]} != {matrix.shape[1]}")
    if qs.device.type == "cpu":
        return flat_search_reference(qs, matrix, row_sq, metric, k_pad)
    global flat_launches
    kb = _bound_kernel()
    nq, dim = qs.shape
    _check_dim(dim)
    k2 = _pow2(k_pad)
    vals, idx = _outputs(nq, k_pad, qs.device)
    with _on(qs.device):                   # the grid is the card's
        scratch = _empty(kb["flat_scratch"](nq, n, k2), qs.device)
        rc = kb["flat"](matrix.data_ptr(), n, dim, row_sq.data_ptr(),
                        qs.data_ptr(), nq, _mode(metric), k_pad, k2,
                        scratch.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                        _stream(qs.device))
    _raise_on(rc, "flat search")
    with _LAUNCH_LOCK:
        flat_launches += 1
    return vals, idx


def ivf_search(qs: torch.Tensor, paged: torch.Tensor, paged_sq: torch.Tensor,
               cents: torch.Tensor, cent_sq: torch.Tensor,
               pages: torch.Tensor, pageptr: torch.Tensor, metric: str,
               k_pad: int, nprobe: int, max_pages: int, n_docs: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (nq, k_pad) float32, document ids (nq, k_pad) int32) of the
    IVF probe; ``paged`` (n_pages + 1, page, dim) and ``pages`` (n_pages +
    1, page) end with the all-sentinel pad page (every id ``n_docs``)."""
    dev = qs.device
    _check_f32("qs", qs, 2, dev)
    _check_f32("paged", paged, 3, dev)
    _check_f32("paged_sq", paged_sq, 2, dev)
    _check_f32("cents", cents, 2, dev)
    _check_f32("cent_sq", cent_sq, 1, dev)
    for name, t in (("pages", pages), ("pageptr", pageptr)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}")
    page = pages.shape[1]
    if not 1 <= nprobe < cents.shape[0] or max_pages < 1 \
            or not 1 <= k_pad <= max_pages * page \
            or qs.shape[1] != paged.shape[2]:
        raise ValueError(f"bad IVF call: nprobe {nprobe}, max_pages "
                         f"{max_pages}, k_pad {k_pad}")
    if dev.type == "cpu":
        return ivf_search_reference(qs, paged, paged_sq, cents, cent_sq,
                                    pages, pageptr, metric, k_pad, nprobe,
                                    max_pages, n_docs)
    global ivf_launches
    kb = _bound_kernel()
    nq, dim = qs.shape
    _check_dim(dim)
    n_lists, k2 = cents.shape[0], _pow2(k_pad)
    vals, idx = _outputs(nq, k_pad, dev)
    with _on(dev):
        scratch = _empty(kb["ivf_scratch"](nq, n_lists, nprobe, max_pages,
                                           page, k2), dev)
        rc = kb["ivf"](paged.data_ptr(), paged_sq.data_ptr(),
                       pages.data_ptr(), pageptr.data_ptr(),
                       cents.data_ptr(), cent_sq.data_ptr(), qs.data_ptr(),
                       nq, n_lists, nprobe, max_pages, pages.shape[0] - 1,
                       page, dim, n_docs, _mode(metric, False),
                       _mode(metric), k_pad, k2, scratch.data_ptr(),
                       vals.data_ptr(), idx.data_ptr(), _stream(dev))
    _raise_on(rc, "IVF search")
    with _LAUNCH_LOCK:
        ivf_launches += 1
    return vals, idx


# ---------------------------------------------------------------------------
# the kernels' stages (CUDA tensors)
# ---------------------------------------------------------------------------

def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"vector search {what} kernel launch failed: "
                           f"CUDA error {rc}")


def _empty(nbytes: int, dev: torch.device) -> torch.Tensor:
    return torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=dev)


def _outputs(nq: int, k: int, dev: torch.device):
    """(vals (nq, k) float32, idx (nq, k) int32), one allocation."""
    both = torch.empty((2, nq, k), dtype=torch.int32, device=dev)
    return both[0].view(torch.float32), both[1]


def _on(dev: torch.device):
    """The launch's device scope: nothing to switch when dev is current
    (a search's common case, and the switch costs the host microseconds)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _check_dim(dim: int) -> None:
    limit = _bound_kernel()["max_dim"][dim % 4 == 0]
    if not 1 <= dim <= limit:
        raise ValueError(f"dim {dim} outside what the CUDA kernel takes "
                         f"(1..{limit})")


def score(matrix: torch.Tensor, n: int, sq: torch.Tensor, qs: torch.Tensor,
          mode: int) -> torch.Tensor:
    """(nq, n) float32 scores of the first ``n`` rows of ``matrix`` (CUDA
    kernel ``vec_flat_scores``: the fused scan's bits); ``sq`` holds the
    rows' squared norms (read for the l2 modes)."""
    if qs.device.type == "cpu":
        return torch.stack([score_reference(matrix[:n], sq[:n], q, mode)
                            for q in qs])
    k = _bound_kernel()
    _check_dim(qs.shape[1])
    out = torch.empty((qs.shape[0], n), dtype=torch.float32,
                      device=qs.device)
    with torch.cuda.device(qs.device):
        rc = k["score"](matrix.data_ptr(), n, qs.shape[1], sq.data_ptr(),
                        qs.data_ptr(), qs.shape[0], mode, out.data_ptr(), n,
                        _stream(qs.device))
    _raise_on(rc, "score")
    return out


def score_pages(qs: torch.Tensor, paged: torch.Tensor,
                paged_sq: torch.Tensor, pages: torch.Tensor,
                pageptr: torch.Tensor, lists: torch.Tensor, max_pages: int,
                n_docs: int, mode: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (nq, max_pages * page), page_idx (nq, max_pages)) of the IVF
    probe of ``lists`` (nq, nprobe) (CUDA kernels ``vec_expand`` and
    ``vec_ivf_scores``)."""
    if qs.device.type == "cpu":
        out, pidx = [], []
        for q, lst in zip(qs, lists):
            p = expand_pages(lst, pageptr, max_pages, pages.shape[0] - 1)
            sims = score_reference(paged[p], paged_sq[p], q, mode)
            out.append(torch.where(pages[p] == n_docs, float("-inf"),
                                   sims).reshape(-1))
            pidx.append(p.to(torch.int32))
        return torch.stack(out), torch.stack(pidx)
    k = _bound_kernel()
    nq, dim = qs.shape
    _check_dim(dim)
    page = pages.shape[1]
    out = torch.empty((nq, max_pages * page), dtype=torch.float32,
                      device=qs.device)
    page_idx = torch.empty((nq, max_pages), dtype=torch.int32,
                           device=qs.device)
    with torch.cuda.device(qs.device):
        rc = k["pages"](paged.data_ptr(), paged_sq.data_ptr(),
                        pages.data_ptr(), pageptr.data_ptr(),
                        lists.data_ptr(), nq, lists.shape[1], max_pages,
                        pages.shape[0] - 1, page, dim, n_docs, qs.data_ptr(),
                        mode, out.data_ptr(), page_idx.data_ptr(),
                        _stream(qs.device))
    _raise_on(rc, "page")
    return out, page_idx


def select(scores: torch.Tensor, k: int,
           pages: Optional[torch.Tensor] = None,
           page_idx: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of ``scores`` (nq, S) in lax.top_k's order
    (CUDA kernels ``vec_radix``, ``vec_emit``, the bitonic sort and
    ``vec_unpack``); positions map through ``pages[page_idx]`` when
    given."""
    if scores.device.type == "cpu":
        vals, pos = select_reference(scores, k)
        if pages is None:
            return vals, pos
        page = pages.shape[1]
        slot = page_idx.long().gather(1, pos.long() // page)
        return vals, pages.reshape(-1)[slot * page + pos.long() % page]
    kb = _bound_kernel()
    nq, S = scores.shape
    if not scores.is_contiguous() or scores.dtype != torch.float32:
        raise ValueError("scores must be contiguous float32")
    dev = scores.device
    k2 = _pow2(k)
    scratch = _empty(kb["select_scratch"](nq, S, k2), dev)
    vals, idx = _outputs(nq, k, dev)
    with torch.cuda.device(dev):
        rc = kb["select"](scores.data_ptr(), nq, S, k, k2,
                          scratch.data_ptr(), vals.data_ptr(),
                          idx.data_ptr(),
                          None if pages is None else pages.data_ptr(),
                          None if page_idx is None else page_idx.data_ptr(),
                          0 if pages is None else pages.shape[1],
                          0 if page_idx is None else page_idx.shape[1],
                          _stream(dev))
    _raise_on(rc, "select")
    return vals, idx


_KERNEL = None  # the bound functions of vecsearch.cu


def _bound_kernel():
    global _KERNEL
    if _KERNEL is None:
        lib = cuda_build.library("vecsearch")  # builds under its lock
        with cuda_build._LOCK:                 # bind once, for every thread
            if _KERNEL is None:
                _KERNEL = bind(lib)
    return _KERNEL


def bind(lib: ctypes.CDLL) -> dict:
    """The functions of a loaded build of vecsearch.cu."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "score": ("pinot_vec_score",
                  [vp, i64, i32, vp, vp, i32, i32, vp, i64, vp], i32),
        "pages": ("pinot_vec_pages", [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                      i32, i32, i32, vp, i32, vp, vp, vp],
                  i32),
        "select": ("pinot_vec_select", [vp, i32, i64, i32, i32, vp, vp, vp,
                                        vp, vp, i32, i32, vp], i32),
        "flat": ("pinot_vec_flat", [vp, i64, i32, vp, vp, i32, i32, i32, i32,
                                    vp, vp, vp, vp], i32),
        "ivf": ("pinot_vec_ivf", [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                  i32, i32, i32, i32, i32, i32, i32, i32,
                                  i32, vp, vp, vp, vp], i32),
        "select_scratch": ("pinot_vec_select_scratch", [i32, i64, i32], i64),
        "flat_scratch": ("pinot_vec_flat_scratch", [i32, i64, i32], i64),
        "ivf_scratch": ("pinot_vec_ivf_scratch",
                        [i32, i32, i32, i32, i32, i32], i64),
        "max_dim": ("pinot_vec_max_dim", [i32], i32),
    }
    out = {}
    for key, (name, args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
        out[key] = fn
    # the largest dim with 16-byte loads (dim % 4 == 0) and without
    out["max_dim"] = {vec: out["max_dim"](int(vec)) for vec in (True, False)}
    return out


def search_bytes(n_rows: int, dim: int, nq: int, k: int,
                 with_sq: bool) -> int:
    """The least bytes a scan of ``n_rows`` rows must move: each row (and
    its squared norm for l2) and each query read once, each (score, id)
    result written once."""
    return (n_rows * dim * 4 + (n_rows * 4 if with_sq else 0)
            + nq * dim * 4 + nq * k * 8)
