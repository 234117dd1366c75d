"""Module-free parameter trees: specs, init, and mesh partition specs.

Port of ``repro/models/params.py``. Models declare nested dicts of
:class:`ParamSpec` (shape + *logical axes* + init). From one spec tree
come:

* materialized parameters on a device, leaf by leaf (:func:`init_params`),
  and their size (:func:`spec_bytes`);
* abstract trees of :class:`ShapeDtypeStruct` (shape, dtype and partition
  spec; no allocation) for the dry-run (:func:`abstract_params`);
* partition specs from the logical → mesh-axis rules
  (:data:`LOGICAL_RULES`, :func:`logical_to_spec`,
  :func:`tree_shardings`), the indirection that lets one model definition
  run on any mesh (``launch.mesh``).

A partition spec is a plain tuple with one entry per dimension, the
entries of the reference's ``PartitionSpec``: ``None`` (replicated), a
mesh-axis name, or a tuple of names. The port runs every shard on one
card, so a spec says how the reference's mesh would split a tensor; the
tensor itself stays whole.

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
           "iter_leaves", "leaf_seed", "LOGICAL_RULES", "logical_to_spec",
           "ShapeDtypeStruct", "abstract_params", "tree_shardings",
           "map_specs"]


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


# Logical axis → mesh axes. `embed` is the FSDP axis (params sharded over
# `data`); head/ffn/expert/vocab dims are the TP/EP axis (`model`). The
# `pod` axis is pure DP: params replicated across pods, batch split.
LOGICAL_RULES: dict = {
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "embed": ("pod", "data"),   # FSDP for params (ZeRO-3 across pods too)
    "vocab": "model",
    "heads": "model",       # fused n_heads*head_dim param dims
    "kv": "model",
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,     # expert inner dim (experts already take `model`)
    "layers": None,
    "seq": None,
    "seq_shard": "model",   # KV-cache seq dim (batch occupies `data`);
                            # long_context_rules remaps to ("data","model")
    "conv": None,
    "state": None,
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
}


def logical_to_spec(axes, rules: Mapping | None = None,
                    mesh=None) -> tuple:
    """The partition spec of logical ``axes`` under ``rules`` (default
    :data:`LOGICAL_RULES`): each name's mesh axes, keeping only those of
    ``mesh`` (``launch.mesh.Mesh``; ``None`` keeps all). An unknown name
    or one whose axes the mesh lacks is replicated (``None``)."""
    rules = LOGICAL_RULES if rules is None else rules
    names = set(mesh.axis_names) if mesh is not None else None

    def resolve(a):
        if a is None:
            return None
        r = rules.get(a)
        if r is None:
            return None
        if isinstance(r, tuple):
            kept = tuple(x for x in r if names is None or x in names)
            return kept if kept else None
        if names is not None and r not in names:
            return None
        return r

    return tuple(resolve(a) for a in axes)


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """An abstract tensor: shape, dtype and partition spec (``None``
    without a mesh), the port's ``jax.ShapeDtypeStruct`` with its
    sharding. :meth:`meta` gives it as a ``device="meta"`` tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: tuple | None = None

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


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


def map_specs(fn, tree):
    """``fn`` of every :class:`ParamSpec` of a nested dict, same
    structure."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def abstract_params(spec_tree, mesh=None, rules: Mapping | None = None):
    """The tree as :class:`ShapeDtypeStruct` leaves, with their partition
    specs when a mesh is given: the dry-run's parameters, no
    allocation."""
    return map_specs(lambda s: ShapeDtypeStruct(
        tuple(s.shape), s.dtype,
        None if mesh is None else logical_to_spec(s.axes, rules, mesh)),
        spec_tree)


def tree_shardings(spec_tree, mesh, rules: Mapping | None = None):
    """The partition spec of every leaf on ``mesh`` under ``rules``."""
    return map_specs(lambda s: logical_to_spec(s.axes, rules, mesh),
                     spec_tree)


def spec_bytes(spec_tree) -> int:
    return sum(math.prod(spec.shape) * spec.dtype.itemsize
               for _, spec in iter_leaves(spec_tree))
