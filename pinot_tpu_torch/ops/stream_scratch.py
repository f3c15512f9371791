"""Device scratch kept per (device, stream) for the hand-written kernels.

A kernel call that needs scratch starting at zero (a ticket counter,
status words) would otherwise pay an allocation and a memset every call.
Calls on one CUDA stream run in the order they were issued, so one buffer
a (device, stream) serves every call on that stream: it is zeroed once,
when allocated (``torch.zeros`` on that stream, ordered before the first
launch that uses it), replaced by a larger one when a call needs more,
and left by each kernel fit for the next call (its counter back at 0;
status words tagged with the call's epoch, so an earlier call's words read
as stale). Callers take a buffer and launch under ``lock``, so threads
that issue on one stream get their epochs in launch order. A call whose
launch failed drops its buffer (``drop``): its counter may be off.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Tuple

import torch

EPOCH_MAX = (1 << 32) - 1      # epochs are 32-bit and never 0


class StreamScratch:
    """int64 scratch buffers keyed by (device index, stream handle)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self._bufs: Dict[Tuple[int, int], List] = {}

    def take(self, dev: torch.device, stream: int, words: int
             ) -> Tuple[torch.Tensor, int]:
        """(buffer of at least ``words`` int64 words, this call's epoch).
        The caller holds ``lock`` until its launch is issued."""
        key = (dev.index, stream)
        entry = self._bufs.get(key)
        if entry is None or entry[0].numel() < words \
                or entry[1] >= EPOCH_MAX:
            size = 1 << max(words - 1, 0).bit_length()
            entry = self._bufs[key] = [
                torch.zeros(size, dtype=torch.int64, device=dev), 0]
        entry[1] += 1
        return entry[0], entry[1]

    def drop(self, dev: torch.device, stream: int) -> None:
        self._bufs.pop((dev.index, stream), None)


def device_scope(dev: torch.device):
    """The launch's device scope: nothing to switch when ``dev`` is
    current (the common case; the switch costs the host microseconds)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
