"""Step factories: the prefill and decode steps of serving.

Port of ``make_prefill_step`` / ``make_decode_step`` of
``repro/models/steps.py``. The reference closes over a mesh and its
sharding rules and returns functions for ``jax.jit``; the port runs
eagerly on one device, so each factory closes over the config alone.
``loss_fn`` and ``make_train_step`` come with training (ROADMAP A15,
slice 2); ``rules_for``, ``input_specs``, ``abstract_cache``,
``train_state_specs`` and ``MEM_LEN_DIV`` with the mesh (slice 3).
"""
from __future__ import annotations

from . import model as model_lib

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return model_lib.prefill(
            cfg, params, batch["tokens"], frames=batch.get("frames"),
            img=batch.get("img"))

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, cache, token, pos):
        return model_lib.decode_step(cfg, params, cache, token, pos)

    return decode_step
