"""The hash partition wrapper's host path, on the CPU.

The kernel (``ops/csrc/hashpart.cu``) runs only on the card; what
surrounds it is Python that these tests reach: the one allocation carved
into every column's ``(n_dev, cap)`` buckets and the flag, the scratch's
size for ``n``, ``n_dev`` and the tile, and the argument block the C
entry reads (its layout against the source's ``ARG_HEADER`` and
``MAX_COLS``). The JAX parity checks of ``hash_partition`` at 1, 2, 4
and 8 shards are in ``tests/test_torch_mesh_join.py``.
"""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from pinot_tpu_torch.ops import cuda_build
from pinot_tpu_torch.ops import hashpart as H


def _define(name: str) -> int:
    with open(os.path.join(cuda_build.CSRC, "hashpart.cu")) as fh:
        src = fh.read()
    m = re.search(rf"^#define {name} (\d+)\b", src, re.M)
    assert m, name
    return int(m.group(1))


def _cols(widths, n=5):
    return tuple(torch.zeros(n, dtype=torch.int32 if w == 4 else torch.int64)
                 for w in widths)


MIXES = [(4,), (4, 4, 4, 4), (4, 8), (4, 8, 4, 8, 8),
         (4,) + (8,) * 16, (4,) + (4, 8) * 8]


@pytest.mark.parametrize("n_dev", [1, 3, 64])
@pytest.mark.parametrize("cap", [1, 2, 4, 1024])
@pytest.mark.parametrize("widths", MIXES, ids=lambda w: f"{len(w) - 1}pay")
def test_buckets_are_carved_from_one_allocation(widths, n_dev, cap):
    cols = _cols(widths)
    outs, flag, dsts, flag_addr = H._buckets(cols, n_dev, cap)
    offs, flag_at, size = H.bucket_layout(widths, n_dev, cap)
    base = dsts[0] - offs[0]
    assert size % H.ALIGN == 0 and flag_at + 1 <= size
    spans = []
    for c, o, off, addr in zip(cols, outs, offs, dsts):
        assert o.dtype == c.dtype and o.shape == (n_dev, cap)
        assert o.is_contiguous() and o.data_ptr() == addr == base + off
        assert addr % H.ALIGN == 0
        # the column's -1 fill region: whole 16-byte chunks, its own
        nbytes = n_dev * cap * c.element_size()
        spans.append((off, off + -(-nbytes // H.ALIGN) * H.ALIGN))
    spans.append((flag_at, flag_at + 1))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert flag.dtype == torch.bool and flag.shape == (1,)
    assert flag.data_ptr() == flag_addr == base + flag_at
    # each view writes only its own bytes: fill each with its index
    for k, o in enumerate(outs):
        o.fill_(k)
    flag.fill_(True)
    for k, o in enumerate(outs):
        assert bool((o == k).all())
        o.fill_(-1)
        assert bool((o == -1).all())
    assert bool(flag)


def test_buckets_and_flag_share_one_storage():
    outs, flag, _d, _f = H._buckets(_cols((4, 8, 4)), 4, 8)
    storage = {o.untyped_storage().data_ptr() for o in (*outs, flag)}
    assert len(storage) == 1


@pytest.mark.parametrize("n, n_dev, tile, words", [
    (0, 4, 4096, 1), (1, 4, 4096, 5), (4095, 3, 4096, 4),
    (4096, 64, 4096, 65), (4097, 64, 4096, 129),
    (1 << 20, 4, 4096, 1 + 256 * 4), (1 << 20, 64, 2048, 1 + 512 * 64),
    (200 * 4096 + 3, 64, 4096, 1 + 201 * 64)])
def test_scratch_words(n, n_dev, tile, words):
    assert H.scratch_words(n, n_dev, tile) == words
    assert _define("HEADER_WORDS") == 1


def test_argument_block_layout_matches_the_source():
    max_cols = _define("MAX_COLS")
    header = _define("ARG_HEADER")
    assert max_cols == H.MAX_PAYLOADS + 1
    args = (ctypes.c_int64 * (header + 3 * max_cols))()
    cols = _cols((4, 8, 4), n=7)
    outs, flag, dsts, flag_addr = H._buckets(cols, 3, 16)
    scratch = torch.zeros(33, dtype=torch.int64)
    H._marshal(args, cols, dsts, flag_addr, 3, 16, scratch, 9)
    got = list(args)
    assert got[:header] == [7, 3, 16, 3, flag_addr, scratch.data_ptr(), 33,
                            9]
    assert got[header:header + 3] == [c.data_ptr() for c in cols]
    assert got[header + 3:header + 6] == dsts
    assert got[header + 6:header + 9] == [4, 8, 4]
    # the widest call fits the block
    wide = _cols((4,) + (8,) * H.MAX_PAYLOADS)
    _o, _f, dsts, flag_addr = H._buckets(wide, 64, 4)
    H._marshal(args, wide, dsts, flag_addr, 64, 4, scratch, 1)
    assert list(args)[header + 2 * len(wide):] == [4] + [8] * 16


def test_checks_stay_strict():
    c = torch.zeros(8, dtype=torch.int32)
    for bad in (dict(codes=c.view(2, 4)), dict(codes=c[::2]),
                dict(codes=c.to(torch.int64)),
                dict(payloads=(torch.zeros(8, dtype=torch.float32),)),
                dict(payloads=(torch.zeros(7, dtype=torch.int32),)),
                dict(payloads=(torch.zeros(16, dtype=torch.int64)[::2],)),
                dict(payloads=(c,) * 17), dict(n_dev=0), dict(n_dev=65),
                dict(n_dev=2.0), dict(cap=0), dict(cap=12), dict(cap=4.0)):
        kw = dict(codes=c, payloads=(), n_dev=2, cap=4)
        kw.update(bad)
        with pytest.raises(ValueError):
            H.hash_partition(kw["codes"], kw["payloads"], kw["n_dev"],
                             kw["cap"])
    np.testing.assert_array_equal(
        H.hash_partition(c, (c,), 2, 4)[0][0].numpy(),
        H.hash_partition_reference(c, (c,), 2, 4)[0][0].numpy())
