"""Carry the JAX package's CP-ALS state into the port.

:func:`state_from_reference` takes the reference's numpy arrays — the
permuted-row-space factors of ``repro.core.distributed.init_factors`` or
of a ``repro.resilience.checkpoint.make_state`` state, λ, and optionally
the remapped nonzero stream — and returns the port's tensors on
``device``, so one port sweep and one reference sweep can start from the
same state.
"""
from __future__ import annotations

import numpy as np
import torch

from .runtime.device import resolve_device

__all__ = ["state_from_reference"]


def state_from_reference(factors, lam, stream=None, *, device):
    """Reference state → ``(factors, lam, stream)`` tensors on ``device``.

    Args:
      factors: ``(i_pad_n, R)`` float32 arrays, permuted row space.
      lam: ``(R,)`` column weights.
      stream: optional ``(stream_idx, stream_val, stream_mask)`` as the
        reference's checkpoint holds them, with or without the leading
        worker axis; only one worker is ported (ROADMAP A9).
      device: ``None`` (CUDA), ``"cuda"`` or ``"cpu"``.

    Returns ``stream`` as ``(idx int32 (cap, N), val float32 (cap,), mask
    bool (cap,))``, or ``None`` when none was given.
    """
    dev = resolve_device(device)
    tf = [torch.from_numpy(np.array(f, dtype=np.float32)).to(dev)
          for f in factors]
    tlam = torch.from_numpy(np.array(lam, dtype=np.float32)).to(dev)
    if stream is None:
        return tf, tlam, None
    idx, val, mask = (np.asarray(a) for a in stream)
    if idx.ndim == 3:
        if idx.shape[0] != 1:
            raise NotImplementedError(
                f"a stream of {idx.shape[0]} workers: the multi-GPU path is "
                "not ported yet (ROADMAP A9)")
        idx, val, mask = idx[0], val[0], mask[0]
    return tf, tlam, (
        torch.from_numpy(np.array(idx, dtype=np.int32)).to(dev),
        torch.from_numpy(np.array(val, dtype=np.float32)).to(dev),
        torch.from_numpy(np.array(mask, dtype=bool)).to(dev))
