"""Module-free parameter trees: specs and init.

Port of ``repro/models/params.py``. Models declare nested dicts of
:class:`ParamSpec` (shape + *logical axes* + init); :func:`init_params`
materializes one on a device, leaf by leaf, and :func:`spec_bytes` sizes
it. The mesh half of the reference (``abstract_params``,
``tree_shardings``, ``LOGICAL_RULES``, ``logical_to_spec``) comes with
``mesh.py`` (ROADMAP A15, slice 3); the logical axes are kept so that the
specs equal the reference's leaf for leaf.

Each leaf draws from its own ``torch.Generator``, seeded from ``(seed,
crc32 of the leaf's path)``. The reference keys its streams with Python's
``hash(part)``, which is salted per process for strings, so its weights for
one seed differ between processes; the port's do not. Neither package can
reproduce the other's random stream: tests carry the reference's weights
across with :func:`repro_torch.convert.lm_params_from_reference`.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Mapping

import torch

from ..runtime.device import resolve_device

__all__ = ["ParamSpec", "init_params", "spec_bytes", "torch_dtype",
           "iter_leaves", "leaf_seed"]


def torch_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (a config's dtype string) → torch."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names per dim
    init: str = "normal"                  # normal | zeros | ones | small
    dtype: torch.dtype = torch.float32
    fan_in_dims: tuple[int, ...] = ()     # dims forming fan-in (default dim 0..-2)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def iter_leaves(tree, path=()):
    """``(path, leaf)`` pairs of a nested dict, keys sorted at each level
    (the reference's order)."""
    if not isinstance(tree, Mapping):
        yield path, tree
        return
    for k in sorted(tree):
        yield from iter_leaves(tree[k], path + (k,))


def leaf_seed(seed: int, path) -> int:
    """The generator seed of the leaf at ``path``: the crc32 of the
    ``/``-joined path, started from the low 32 bits of ``seed``. Stable
    across processes (no salted ``hash``); 32 bits, since the CPU
    generator keeps no more of a seed."""
    return zlib.crc32("/".join(path).encode("utf-8"),
                      int(seed) & 0xFFFFFFFF)


def _init_leaf(spec: ParamSpec, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    fan_dims = spec.fan_in_dims or tuple(range(max(1, len(spec.shape) - 1)))
    fan_in = math.prod(spec.shape[d] for d in fan_dims) or 1
    scale = 0.02 if spec.init == "small" else 1.0 / math.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(spec.dtype)


def init_params(spec_tree, seed: int = 0, device=None):
    """Materialize the tree on ``device`` (``None``: CUDA), each leaf from
    its own generator (:func:`leaf_seed`), at the reference's scales:
    ``0.02`` for ``small``, ``1/sqrt(fan_in)`` for ``normal``."""
    dev = resolve_device(device)
    out: dict = {}
    for path, spec in iter_leaves(spec_tree):
        gen = torch.Generator(device=dev)
        gen.manual_seed(leaf_seed(seed, path))
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _init_leaf(spec, gen, dev)
    return out


def spec_bytes(spec_tree) -> int:
    return sum(math.prod(spec.shape) * spec.dtype.itemsize
               for _, spec in iter_leaves(spec_tree))
