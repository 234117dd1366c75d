"""Roofline terms of a dry-run cell: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference compiles each cell and reads three things off the compiled
program: ``cost_analysis()`` (FLOPs and HBM bytes of the per-device SPMD
program), ``memory_analysis()`` (argument and temporary bytes) and the
collectives it parses out of the optimized HLO text. The port has no
compiler and no HLO: the dry-run runs the step on meta tensors, and

* the costs come from ``launch.flops.step_costs`` (global counts; the
  dry-run divides them by the chips);
* the memory dict from ``launch.dryrun`` (argument bytes from the
  partition specs, the meta peak of one microbatch);
* the collective bytes from a ``core.workers`` object
  (:func:`collective_bytes`): what the step handed its collectives. For a
  meshed MoE step that is the owner dispatch's ``psum``
  (``models.moe.moe_apply_owner``, ``moe_sent_bytes``). The port runs no
  sharded step: the FSDP / tensor-parallel all-gathers and
  reduce-scatters XLA inserts around every sharded product are not
  executed, so not counted, and the collective term is a lower bound.

Terms (seconds), :data:`launch.mesh.HW`'s H100 constants:
  compute    = flops / peak_flops_bf16 + fp32_flops / peak_flops_fp32
  memory     = hbm_bytes / hbm_bw
  collective = collective bytes / nvlink_bw (one NVLink domain; lower
                 off it, ``launch.mesh``)
With ``fp32_flops=0`` these are the reference's terms and keys.
"""
from __future__ import annotations

from typing import Any

from .mesh import HW

__all__ = ["collective_bytes", "roofline_terms", "summarize_cell"]


def collective_bytes(workers) -> dict[str, Any]:
    """Bytes and calls per collective kind of a ``core.workers`` object
    (``sent_bytes`` / ``sent_counts``: an all_to_all's self-buckets
    included, a psum's inputs), in the reference's form: kinds are
    ``all-to-all``, ``all-gather``, ``all-reduce`` (psum, pmax)."""
    kind = {"all_to_all": "all-to-all", "all_gather": "all-gather",
            "psum": "all-reduce", "pmax": "all-reduce"}
    per_kind: dict[str, int] = {}
    count: dict[str, int] = {}
    counts = getattr(workers, "sent_counts", {})
    for op, n in sorted(workers.sent_bytes.items()):
        k = kind.get(op, op)
        per_kind[k] = per_kind.get(k, 0) + int(n)
        count[k] = count.get(k, 0) + int(counts.get(op, 0))
    return {"bytes_by_kind": per_kind, "count_by_kind": count,
            "total_bytes": sum(per_kind.values())}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float, *,
                   fp32_flops: float = 0.0, hw=None) -> dict[str, Any]:
    """The three terms (module docstring), the dominant one, the bound
    (their maximum) and ``overlap_fraction`` (bound ÷ their sum: 1 where
    one term is all the time, 1/3 where three equal terms would not
    overlap at all). ``hw``: the constants (default :data:`HW`)."""
    hw = HW if hw is None else hw
    compute = (flops / hw["peak_flops_bf16"]
               + fp32_flops / hw["peak_flops_fp32"])
    memory = hbm_bytes / hw["hbm_bw"]
    collective = coll_bytes / hw["nvlink_bw"]
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return dict(terms, dominant=dom, bound_s=bound,
                overlap_fraction=bound / total if total else 0.0)


def summarize_cell(costs: dict, memory: dict, workers, *, n_chips: int = 1,
                   hw=None) -> dict:
    """The measurable quantities of one (arch × shape × mesh) cell, as the
    reference's: ``costs`` (``flops.step_costs``, global) divided by
    ``n_chips`` into per-chip ``flops`` / ``hbm_bytes`` and their roofline
    terms, the collectives of ``workers`` (their per-chip share in the
    terms) and the ``memory`` dict as ``memory_analysis``."""
    coll = collective_bytes(workers)
    flops = costs["flops"] / n_chips
    hbm = costs["hbm_bytes_model"] / n_chips
    terms = roofline_terms(costs["flops_bf16"] / n_chips, hbm,
                           coll["total_bytes"] / n_chips,
                           fp32_flops=costs["flops_fp32"] / n_chips, hw=hw)
    return {"flops": flops, "hbm_bytes": hbm, "collectives": coll,
            "memory_analysis": dict(memory), "roofline": terms}
