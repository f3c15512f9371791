"""The segment mesh: logical shards over the devices of one process.

Port of ``pinot_tpu/parallel/mesh.py``. The JAX package runs one program
over a ``jax.sharding.Mesh`` from one controller; the port does the same
from one process: a ``Mesh`` is an ordered tuple of ``torch.device``s, one
per logical shard, and the mesh code launches each shard's work from this
process, then combines or exchanges across shards with
``parallel/collectives.py``. A mesh may repeat a device: four shards on
one card are the counterpart of the JAX suite's virtual devices
(``--xla_force_host_platform_device_count``), and hold the combine and
exchange semantics of four shards on the card.

``segment_mesh()`` gives one shard per visible device of the asked type
(one on a host with one card, one on the CPU). A mesh of more shards than
devices is asked for explicitly: ``logical_mesh(n, device)``, or
``segment_mesh(n, devices=[...])``. The process-wide default that the
engine reads (``jax.devices()``'s counterpart) is set in one place:
``set_default_mesh`` or the ``using_mesh`` context manager. Unset, it is
``segment_mesh`` over the engine's device type.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch

SEG_AXIS = "seg"

DeviceLike = Union[str, torch.device]


class Mesh:
    """An ordered tuple of devices, one per logical shard (module doc)."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence[DeviceLike]):
        devs = tuple(_canonical(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's shards share one device type, got "
                             f"{[str(d) for d in devs]}")
        self.devices: Tuple[torch.device, ...] = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def platform(self) -> str:
        """The device type of every shard ("cuda" or "cpu")."""
        return self.devices[0].type

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The devices the shards lie on, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self) -> Iterator[torch.device]:
        return iter(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _canonical(device: DeviceLike) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on cuda needs a CUDA device; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}; use 'cuda' or "
                         "'cpu'")
    return dev


def visible_devices(device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """Every device of ``device_type`` this process sees (the CPU is
    one device)."""
    if device_type == "cpu":
        return (torch.device("cpu"),)
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass 'cpu'")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def segment_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 device_type: str = "cuda") -> Mesh:
    """1-D mesh over devices; the axis is segment parallelism (the
    analogue of Pinot's scatter-gather across servers). ``devices`` may
    repeat a device (logical shards); without it the mesh takes the first
    ``n_devices`` visible devices of ``device_type`` and refuses more
    shards than there are devices."""
    if devices is None:
        devices = visible_devices(device_type)
        if n_devices is not None and n_devices > len(devices):
            raise ValueError(
                f"{n_devices} shards asked of {len(devices)} {device_type} "
                "device(s); ask for logical shards with logical_mesh(n, "
                "device)")
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(devices)


def logical_mesh(n_shards: int, device: DeviceLike = "cuda") -> Mesh:
    """``n_shards`` logical shards laid over the visible devices of
    ``device``'s type in turn (all on ``device`` when it names one)."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    dev = torch.device(device)
    pool = (_canonical(dev),) if dev.index is not None or dev.type == "cpu" \
        else visible_devices(dev.type)
    return Mesh([pool[i % len(pool)] for i in range(n_shards)])


_DEFAULT: Optional[Mesh] = None
_DEFAULT_LOCK = threading.Lock()


def set_default_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Set the process-wide mesh the engine reads (None: one shard per
    visible device); returns the one it replaces."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        old, _DEFAULT = _DEFAULT, mesh
    return old


@contextlib.contextmanager
def using_mesh(mesh: Optional[Mesh]):
    """The default mesh is ``mesh`` inside the block."""
    old = set_default_mesh(mesh)
    try:
        yield mesh
    finally:
        set_default_mesh(old)


def default_mesh(device: DeviceLike = "cuda") -> Mesh:
    """The mesh the engine runs on for work on ``device``: the one set by
    ``set_default_mesh`` when its shards are of ``device``'s type (a mesh
    asked for on the card never takes work of a CPU broker, nor the other
    way round), else one shard per visible device of that type."""
    kind = torch.device(device).type
    mesh = _DEFAULT
    if mesh is not None and mesh.platform == kind:
        return mesh
    return segment_mesh(device_type=kind)
