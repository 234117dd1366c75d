"""Meshes: the logical device grids the sharding rules resolve against.

Port of ``repro/launch/mesh.py``. The reference builds ``jax`` meshes over
real (or forced host) devices. The port runs every shard on one card, as
``core.workers.LocalWorkers`` runs D workers on one card, so a
:class:`Mesh` here is a descriptor: axis names and sizes, no devices.
The production meshes keep the reference's logical shapes, so that the
partition specs the rules give (``models.params.logical_to_spec``) equal
the reference's entry for entry:

* ``make_production_mesh()``: ``(16, 16)`` over ``("data", "model")``;
* ``make_production_mesh(multi_pod=True)``: ``(2, 16, 16)`` over
  ``("pod", "data", "model")``;
* ``make_host_mesh()``: the devices this process runs on along
  ``"data"``: ``(1, 1)``, one card.

:data:`HW` holds the card's published constants, read by the dry-run
tools: ``launch.roofline.roofline_terms`` (its compute, memory and
collective terms) and ``launch.dryrun`` (whether a cell fits the card's
``hbm_bytes``). They are the data sheet's, so a dry-run gives the same
numbers on any host. What a card reports about itself (its name, its
memory) is read at run time by :func:`device_hw` (``python -m
repro_torch.launch.dryrun --device cuda``).

The collective term prices every collective byte at ``nvlink_bw``, the
rate of one NVLink domain (the GPUs of one NVLink 4 switch fabric, 8 in
an HGX H100 node). The production meshes (256 and 512 devices) span many
domains: off one domain a byte crosses the network (InfiniBand NDR, 400
Gb/s = 50 GB/s per GPU), at about a ninth of that rate, so the term is a
lower bound there.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_host_mesh",
           "HW", "device_hw"]

# NVIDIA H100 SXM5 80GB (the card of every chip run of this port,
# ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
# "NVIDIA H100 80GB HBM3, 700.00 W"), per card, from NVIDIA's H100 data
# sheet at the 700 W power limit. A card held below 700 W runs slower
# than these under load.
HW = {
    "card": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,      # FLOP/s, dense bf16 tensor cores
    "peak_flops_fp32": 67e12,       # FLOP/s, fp32 without tensor cores
    "hbm_bw": 3.35e12,              # bytes/s, HBM3
    "hbm_bytes": 80e9,              # bytes, HBM3 ("80GB")
    "nvlink_bw": 450e9,             # bytes/s each way (NVLink 4, 18 links)
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical device grid: ``axis_names`` and their sizes. ``shape``
    maps each name to its size, as ``jax.sharding.Mesh.shape`` does."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(int(s) < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes {self.axis_sizes} must be >= 1")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh(shape, axes) -> Mesh:
    """``Mesh(axes, shape)``, in ``jax.make_mesh``'s argument order."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The devices this process runs on, on ``("data", "model")``: the
    port runs on one card, so ``(1, 1)``."""
    return make_mesh((1, 1), ("data", "model"))


def device_hw(device=None) -> dict:
    """:data:`HW` with what the CUDA ``device`` reports about itself: its
    name, and its memory in bytes (``hbm_bytes``, ``total_memory``)."""
    props = torch.cuda.get_device_properties(
        torch.device("cuda") if device is None else device)
    return dict(HW, card=props.name, hbm_bytes=props.total_memory)
