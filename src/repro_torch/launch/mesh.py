"""Device meshes: ordered named axes and their sizes (port of
``repro/launch/mesh.py``).

A :class:`Mesh` is plain data: the production meshes are abstract (a
plan over 256 or 512 chips, no devices), the host mesh holds the
devices of this machine, a device mesh the one device a run uses.  It
is not ``torch.distributed.DeviceMesh``, which needs a process group.
Functions, not module constants: importing this module touches no
device.
"""
from __future__ import annotations

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
