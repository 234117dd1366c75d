"""The benchmark's tensor generator: a configuration's COO stand-in from a
seed, made on the device in a few large calls.

A configuration file gives ``shape``, ``nnz`` (the distinct coordinates
the tensor holds), ``draws`` (how many coordinates are drawn, room for
those drawn twice) and ``distribution``:

* ``uniform``: each coordinate uniform over its mode;
* ``powerlaw``: each coordinate ``floor(dim * x / scale)`` with ``x`` drawn
  from a Pareto of shape ``alpha`` shifted to start at 0 and truncated at
  ``scale``, so low ids are hubs and row ``i``'s share falls as
  ``(1 + i * scale / dim) ** -(alpha + 1)``.

Values are standard normal float32, an exact 0 replaced by 1. The tensor
is the draws up to the one that brings the ``nnz``-th distinct coordinate,
as if coordinates were drawn one at a time until ``nnz`` were distinct:
duplicates among them are summed in the order drawn, and the nonzeros come
out sorted lexicographically by coordinate. Too few distinct coordinates
in ``draws`` is an error. The same seed on the same device type
gives the same tensor.
"""
from __future__ import annotations

import torch


def _coordinates(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    n = int(cfg["draws"])
    cols = []
    for dim in cfg["shape"]:
        if cfg["distribution"] == "uniform":
            cols.append(torch.randint(0, dim, (n,), generator=gen,
                                      device=device))
        elif cfg["distribution"] == "powerlaw":
            alpha, scale = float(cfg["alpha"]), float(cfg["scale"])
            u = torch.rand(n, generator=gen, device=device,
                           dtype=torch.float64)
            top = 1.0 - (1.0 + scale) ** -alpha
            x = (1.0 - u * top) ** (-1.0 / alpha) - 1.0
            cols.append(torch.clamp((x * (dim / scale)).long(), max=dim - 1))
            del u, x
        else:
            raise ValueError(f"unknown distribution {cfg['distribution']!r}")
    return torch.stack(cols, dim=1)


def make_tensor(cfg: dict, seed: int, device) -> tuple:
    """``(indices (nnz, N) int32, values (nnz,) float32)`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = _coordinates(cfg, gen, device)
    val = torch.randn(idx.shape[0], generator=gen, device=device)
    val = torch.where(val == 0, torch.ones_like(val), val)
    order = torch.arange(idx.shape[0], device=device)
    for n in reversed(range(idx.shape[1])):
        order = order[torch.sort(idx[order, n], stable=True).indices]
    idx, val = idx[order], val[order]
    # Within a coordinate the stable sorts keep the draw order, so each
    # run's first entry holds the draw that brought its coordinate.
    first = torch.nonzero(_run_starts(idx)).squeeze(1)
    nnz = int(cfg["nnz"])
    if first.numel() < nnz:
        raise ValueError(f"{cfg['draws']} draws give {first.numel()} "
                         f"distinct coordinates, fewer than nnz {nnz}")
    last_draw = torch.kthvalue(order[first], nnz).values
    keep = order <= last_draw
    idx, val = idx[keep], val[keep]
    del order, first, keep
    first = torch.nonzero(_run_starts(idx)).squeeze(1)
    length = torch.diff(first, append=first.new_tensor([idx.shape[0]]))
    summed = val[first].clone()
    for k in range(1, int(length.max()) if first.numel() else 1):
        more = length > k
        summed[more] += val[first[more] + k]
    return idx[first].to(torch.int32), summed


def _run_starts(idx: torch.Tensor) -> torch.Tensor:
    """Where a new coordinate starts in lexicographically sorted ``idx``."""
    start = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    start[1:] = (idx[1:] != idx[:-1]).any(dim=1)
    return start
