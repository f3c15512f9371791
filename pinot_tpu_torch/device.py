"""Device policy of the port.

Every entry point (``Broker(device=...)``, ``TableDataManager(...,
device=...)``, ``ImmutableSegment.load(dir, device=...)``) resolves its
device here. The default is ``"cuda"``; when CUDA is unavailable that
raises instead of dropping to the CPU, so a run never reports CPU work as
device work. Tests and CPU tools pass ``device="cpu"`` explicitly.

Numerics: integer accumulators are ``torch.int64`` and float
accumulators ``torch.float64`` on every device, matching the JAX
package's CPU results (its ``kernels.float_acc_dtype``), not its TPU f32
path. No matrix product runs on the port's main path; TF32 is switched
off for CUDA matmuls all the same, so any later one stays full f32.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"
INT_ACC = torch.int64
FLOAT_ACC = torch.float64


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) as a torch.device; raises when
    CUDA is requested and unavailable, or for any other device type."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pinot_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def tool_device(device: Union[str, torch.device, None]
                ) -> Optional[torch.device]:
    """A command-line tool's ``--device`` resolved, or None when it
    cannot run there (CUDA asked for and absent), with the reason on
    stderr; the tool then exits 2."""
    import sys

    try:
        return resolve_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"refusing to run: {e}", file=sys.stderr)
        return None
