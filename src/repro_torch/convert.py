"""Carry the JAX package's CP-ALS state into the port.

:func:`state_from_reference` takes the reference's numpy arrays — the
permuted-row-space factors of ``repro.core.distributed.init_factors`` or
of a ``repro.resilience.checkpoint.make_state`` state, λ, and optionally
the remapped nonzero stream with its ``(D, cap, ...)`` worker axis — and
returns the port's tensors on the device, so one port sweep and one
reference sweep can start from the same state.

:func:`lm_params_from_reference` carries an LM parameter tree (or a
cache tree) of ``repro.models`` across: the same keys, shapes and dtypes,
as the port's ``models`` hold them. The reference's init draws from
streams the port cannot reproduce, so this is how the tests give both
packages the same weights. :func:`lm_train_state_from_reference` does
the same for a whole train state: parameters, optimizer state and step.
"""
from __future__ import annotations

import numpy as np
import torch

from .runtime.device import resolve_device

__all__ = ["state_from_reference", "lm_params_from_reference",
           "lm_train_state_from_reference"]


def state_from_reference(factors, lam, stream=None, *, device=None,
                         workers=None):
    """Reference state → ``(factors, lam, stream)`` tensors on the device.

    Args:
      factors: ``(i_pad_n, R)`` float32 arrays, permuted row space.
      lam: ``(R,)`` column weights.
      stream: optional ``(stream_idx, stream_val, stream_mask)`` as the
        reference's runtime and checkpoint hold them, ``(D, cap, N)``,
        ``(D, cap)``, ``(D, cap)``; a stream without the worker axis is
        one worker's.
      device: ``None`` (CUDA), ``"cuda"`` or ``"cpu"``; with ``workers``,
        their device (another one raises ``ValueError``).
      workers: ``None`` keeps every worker's layout, stacked, as
        :class:`~.core.workers.LocalWorkers` holds them; a
        :class:`~.core.workers.GroupWorkers` (or any ``core.workers``
        object) keeps the slice of the workers it holds, its one rank.

    Returns ``stream`` as ``(idx int32 (L, cap, N), val float32 (L, cap),
    mask bool (L, cap))`` over the ``L`` workers kept, or ``None`` when
    none was given.
    """
    if workers is None:
        dev = resolve_device(device)
    else:
        dev = workers.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device!r} is not the workers' device "
                             f"{dev}")
    tf = [torch.from_numpy(np.array(f, dtype=np.float32)).to(dev)
          for f in factors]
    tlam = torch.from_numpy(np.array(lam, dtype=np.float32)).to(dev)
    if stream is None:
        return tf, tlam, None
    idx, val, mask = (np.asarray(a) for a in stream)
    if idx.ndim == 2:
        idx, val, mask = idx[None], val[None], mask[None]
    if workers is not None:
        if idx.shape[0] != workers.num_workers:
            raise ValueError(f"a stream of {idx.shape[0]} workers for "
                             f"{workers.num_workers} workers")
        sel = list(workers.ranks)
        idx, val, mask = idx[sel], val[sel], mask[sel]
    return tf, tlam, (
        torch.from_numpy(np.array(idx, dtype=np.int32)).to(dev),
        torch.from_numpy(np.array(val, dtype=np.float32)).to(dev),
        torch.from_numpy(np.array(mask, dtype=bool)).to(dev))


def _leaf_to_torch(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes: no numpy buffer type
        t = torch.from_numpy(np.array(a).view(np.uint16))
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_reference(params, *, device=None):
    """Reference LM parameter tree → the port's, on ``device`` (``None``:
    CUDA).

    ``params`` is a nested dict of arrays, as ``repro.models.params.
    init_params`` gives it (after ``np.asarray`` on each leaf, or as JAX
    arrays). Returns a nested dict with the same keys, each leaf a tensor
    of the same shape and dtype (bfloat16 included)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf_to_torch(node, dev)

    return conv(params)


def lm_train_state_from_reference(state, *, device=None):
    """Reference train state ``{"params", "opt", "step"}`` → the port's,
    on ``device`` (``None``: CUDA).

    ``opt`` is AdamW's ``{"m", "v", "count"}`` or Adafactor's ``{"v",
    "count"}`` (``v`` a tree of ``vr`` / ``vc`` / ``v`` leaves), as
    ``repro.optim`` builds them; every leaf keeps its shape and dtype
    (``count`` and ``step`` int32 0-d tensors)."""
    if set(state) != {"params", "opt", "step"}:
        raise ValueError(f"a train state has keys params, opt and step, "
                         f"not {sorted(state)}")
    dev = resolve_device(device)
    return {"params": lm_params_from_reference(state["params"], device=dev),
            "opt": lm_params_from_reference(state["opt"], device=dev),
            "step": _leaf_to_torch(state["step"], dev)}
