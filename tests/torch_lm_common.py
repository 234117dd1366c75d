"""Helpers the port's LM tests share (not collected: no ``test_`` prefix).

The ``xattn`` layers' tanh gate ``x_gate`` has a published init of 0, at
which a cross-attention layer adds nothing and gets no gradient, so every
test of the ``vlm`` family opens it (:func:`open_gates`). The stub
frontend's input (``frames`` for ``encdec``, ``img`` for ``vlm``) is drawn
by :func:`frontend_inputs` from the caller's generator.
"""
from __future__ import annotations

import numpy as np

GATE = 0.5                    # the xattn layers' x_gate in every test


def open_gates(params, gate: float = GATE):
    """``params`` with every ``x_gate`` leaf set to ``gate``: a new tree
    (the input is not changed), for numpy, JAX and torch leaves alike."""
    out = dict(params, blocks=dict(params["blocks"]))
    for g, leaves in out["blocks"].items():
        if "x_gate" in leaves:
            x = leaves["x_gate"]
            if hasattr(x, "fill_"):                  # a torch tensor
                full = x.detach().clone().fill_(gate)
            else:
                full = np.full(np.shape(x), gate, np.float32)
            out["blocks"][g] = dict(leaves, x_gate=full)
    return out


def frontend_inputs(cfg, rng, batch: int, src: int) -> dict:
    """The stub frontend's input of ``cfg``, numpy float32 drawn from
    ``rng``: ``frames`` of ``(batch, src, d_in)`` (``encdec``), ``img`` of
    ``(batch, n_img_tokens, d_in)`` (``vlm``), else nothing."""
    d_in = cfg.d_frontend or cfg.d_model
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((batch, src, d_in)).astype(
            np.float32)}
    if cfg.family == "vlm":
        return {"img": rng.standard_normal(
            (batch, cfg.n_img_tokens, d_in)).astype(np.float32)}
    return {}
