"""Device meshes: ordered named axes and their sizes (port of
``repro/launch/mesh.py``).

A :class:`Mesh` is plain data: the production meshes are abstract (a
plan over 256 or 512 chips, no devices), the host mesh holds the
devices of this machine, a device mesh the one device a run uses.  It
is not ``torch.distributed.DeviceMesh``, which needs a process group:
:func:`fake_device_mesh` builds that one for a production mesh, over a
fake process group of the mesh's size in this one process (the
reference's ``--xla_force_host_platform_device_count=512`` with
``jax.make_mesh``), so that DTensors can run each partition's step.
Functions, not module constants: importing this module touches no
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names in order, their sizes, and the devices (row-major over
    the axes) when the mesh is concrete."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips a pod ("data", "model"); 2 pods = 512 chips with
    a leading "pod" axis.  DP runs over ("pod", "data"), TP over
    "model".  Abstract: no devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device=None) -> Mesh:
    """A 1-D ("data",) mesh over this machine's devices of ``device``'s
    type: every visible CUDA device (one on a one-card machine), or with
    ``device="cpu"`` the CPU, one device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    elif dev.type == "cpu":
        devices = (torch.device("cpu"),)
    else:
        raise ValueError(f"no host mesh over {dev}")
    return Mesh(("data",), (len(devices),), devices)


def make_device_mesh(device=None) -> Mesh:
    """A 1-D ("data",) mesh of the one device a run trains or records on
    (the CUDA device by default, its index made explicit)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(("data",), (1,), (dev,))


def _fake_backend() -> str:
    """The fake process group's backend name, ``dist.Backend.FAKE``, its
    creator registered: by the installed torch where it does, else by
    importing ``torch.testing._internal.distributed.fake_pg``, which
    registers it."""
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available: no fake "
                           "process group for a partitioned step")
    name = getattr(dist.Backend, "FAKE", "fake")
    if name.upper() not in getattr(dist.Backend, "_plugins", {}):
        try:
            from torch.testing._internal.distributed import fake_pg  # noqa: F401
        except ImportError:
            pass    # init_process_group below raises if torch has none
    return name


@contextlib.contextmanager
def fake_device_mesh(mesh: Mesh, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``mesh``'s axes (names and sizes) over a fake
    process group of ``mesh.size`` ranks, this process rank 0; the group
    is destroyed on exit, so it never outlives the block.  Collectives
    on it move no data (each allocates its result).  Raises when a
    process group is already open or none can be made."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    backend = _fake_backend()
    if dist.is_initialized():
        raise RuntimeError("a process group is already open")
    try:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=mesh.size)
    except (AssertionError, ValueError) as e:
        raise RuntimeError(f"no fake process group: {e}") from e
    try:
        yield init_device_mesh(device_type, mesh.axis_sizes,
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()
