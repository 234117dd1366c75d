"""Mixture-of-Experts with Dynasor-style sort-into-buckets dispatch.

Port of ``repro/models/moe.py``. MoE dispatch is the paper's sparse
problem in disguise: tokens are nonzeros, experts are output owners, and
routing is the dynamic remap. The (token, slot) pairs are stable-sorted by
expert id into a capacity-padded ``(E, cap, d)`` buffer (each expert's GEMM
reads a private contiguous slab), processed with stacked-expert batched
products, and combined back per token. Over-capacity pairs are dropped
(``moe_dropped``), as the remap's capacity accounting in ``core.remap``.

The combine. The reference scatter-adds every slot's weighted output into
its token's row (``y.at[buf_tok].add``); on the card ``index_add_`` would
add a token's k rows with atomics, in an order (and so a bf16 rounding)
that changes from run to run. The port inverts the slot map instead: each
(token, k) pair finds its slot, the k weighted rows are gathered, sorted by
expert id, and added in that order, each add rounded to the activation
dtype. That is the order in which the reference's scatter visits a
token's slots (slot = expert · cap + rank), so the two sums round alike;
what differs between the packages is the rounding inside the expert
products, hence the tolerance of the activation dtype (1e-5 of max|y| at
float32, the reference's 2e-2 at bfloat16). Dropped pairs add an exact
zero.

Without a mesh the reference always takes the gather path, so
``impl="auto"``, ``"owner"`` and ``"gather"`` all run it here.
:func:`moe_apply_owner` (expert parallelism under ``shard_map``) comes with
the mesh (ROADMAP A15 (3)) and raises until then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import ParamSpec

__all__ = ["moe_specs", "moe_apply", "moe_apply_owner", "router_assign",
           "capacity"]

_IMPLS = ("auto", "owner", "gather")


def moe_specs(d: int, d_ff: int, n_experts_padded: int, n_shared: int,
              n_experts_real: int, dtype=torch.float32) -> dict:
    E = n_experts_padded
    specs = {
        "router": ParamSpec((d, E), ("embed", None), init="small",
                            dtype=torch.float32),
        "w_gate": ParamSpec((E, d, d_ff), ("experts", "embed", "expert_mlp"),
                            dtype=dtype, fan_in_dims=(1,)),
        "w_up": ParamSpec((E, d, d_ff), ("experts", "embed", "expert_mlp"),
                          dtype=dtype, fan_in_dims=(1,)),
        "w_down": ParamSpec((E, d_ff, d), ("experts", "expert_mlp", "embed"),
                            dtype=dtype, fan_in_dims=(1,)),
    }
    if n_shared:
        f = n_shared * d_ff
        specs["shared"] = {
            "w_gate": ParamSpec((d, f), ("embed", "mlp"), dtype=dtype),
            "w_up": ParamSpec((d, f), ("embed", "mlp"), dtype=dtype),
            "w_down": ParamSpec((f, d), ("mlp", "embed"), dtype=dtype),
        }
    return specs


def router_assign(xf, router_w, n_real: int, top_k: int):
    """Router: returns ``(probs[(T,k)], ids[(T,k)] int32, aux_loss)``.
    Padding experts (``>= n_real``) get ``-1e30`` logits, so with
    ``top_k <= n_real`` they are never routed."""
    T = xf.shape[0]
    logits = torch.matmul(xf.float(), router_w)
    E_pad = logits.shape[-1]
    pad_mask = torch.arange(E_pad, device=logits.device) < n_real
    logits = torch.where(pad_mask[None, :], logits, -1e30)
    probs_full = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(probs_full, top_k, dim=-1)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss over real experts.
    density = torch.bincount(ids.reshape(-1), minlength=E_pad).float() / (
        T * top_k)
    mean_prob = probs_full.mean(0)
    aux = n_real * torch.sum(density * mean_prob)
    return probs, ids.to(torch.int32), aux


def capacity(T: int, top_k: int, capacity_factor: float, n_experts: int,
             deterministic_cap: int = 0) -> int:
    """Slots per expert: ``max(8, ceil(T·k·cf / E))`` over the *padded*
    expert count, as the reference computes it, unless
    ``deterministic_cap`` is given."""
    return deterministic_cap or max(
        8, int(-(-T * top_k * capacity_factor // n_experts)))


def moe_apply(params, x, *, n_real: int, top_k: int,
              capacity_factor: float = 1.25, deterministic_cap: int = 0,
              impl: str = "auto"):
    """Apply the MoE block to ``x[(b, l, d)]`` → ``(y, metrics)``, metrics
    ``{"moe_aux": 0-d float32, "moe_dropped": 0-d int64}``."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; one of {_IMPLS}")
    return _moe_apply_gather(params, x, n_real=n_real, top_k=top_k,
                             capacity_factor=capacity_factor,
                             deterministic_cap=deterministic_cap)


def moe_apply_owner(params, x, *, n_real: int, top_k: int,
                    capacity_factor: float = 1.25,
                    deterministic_cap: int = 0):
    """Expert-parallel MoE (owner-computes under a mesh): not ported."""
    raise NotImplementedError(
        "moe_apply_owner (expert parallelism over a mesh) is not ported "
        "yet: ROADMAP A15 (3)")


def _moe_apply_gather(params, x, *, n_real: int, top_k: int,
                      capacity_factor: float = 1.25,
                      deterministic_cap: int = 0):
    b, l, d = x.shape
    T = b * l
    dev = x.device
    xf = x.reshape(T, d)
    E = params["w_gate"].shape[0]
    probs, ids, aux = router_assign(xf, params["router"], n_real, top_k)
    cap = capacity(T, top_k, capacity_factor, E, deterministic_cap)

    # --- Dynasor dispatch: sort (token, slot) pairs by owning expert -----
    e_flat = ids.reshape(-1)                              # (T·k,)
    p_flat = probs.reshape(-1)
    pair = torch.arange(T * top_k, dtype=torch.int32, device=dev)
    tok = pair // top_k
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    tok_s = tok[order]
    p_s = p_flat[order]
    start = torch.searchsorted(e_s, e_s, right=False)
    pos = pair - start.to(torch.int32)                    # rank in bucket
    ok = pos < cap
    dump = E * cap                                        # the dump slot
    slot = torch.where(ok, e_s * cap + pos, dump).long()
    # Only the dump slot has duplicate targets; it is sliced off.
    buf_tok = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    buf_tok[slot] = tok_s
    buf_p = torch.zeros(dump + 1, dtype=p_s.dtype, device=dev)
    buf_p[slot] = p_s
    buf_ok = torch.zeros(dump + 1, dtype=torch.bool, device=dev)
    buf_ok[slot] = ok
    buf_tok, buf_p, buf_ok = buf_tok[:-1], buf_p[:-1], buf_ok[:-1]
    dropped = torch.sum(~ok)

    # --- owner-computes expert GEMMs ------------------------------------
    dt = x.dtype
    xe = xf[buf_tok.long()].reshape(E, cap, d)
    xe.masked_fill_(~buf_ok.reshape(E, cap, 1), 0)
    gate = torch.bmm(xe, params["w_gate"].to(dt))
    up = torch.bmm(xe, params["w_up"].to(dt))
    h = F.silu(gate) * up
    out = torch.bmm(h, params["w_down"].to(dt))

    # --- combine: each pair's weighted row, added in expert order --------
    w = torch.where(buf_ok, buf_p, 0.0).to(out.dtype)
    contrib = out.reshape(dump, d) * w[:, None]
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot                               # a permutation
    by_expert = torch.argsort(ids, dim=1)                 # ids distinct
    pair_slot = pair_slot.reshape(T, top_k).gather(1, by_expert)
    kept = pair_slot < dump
    rows = torch.where(kept[..., None],
                       contrib[torch.where(kept, pair_slot, 0)], 0)
    y = rows[:, 0]
    for j in range(1, top_k):
        y = y + rows[:, j]

    if "shared" in params:
        sh = params["shared"]
        g = torch.matmul(xf, sh["w_gate"].to(dt))
        u = torch.matmul(xf, sh["w_up"].to(dt))
        y = y + torch.matmul(F.silu(g) * u, sh["w_down"].to(dt))

    metrics = {"moe_aux": aux, "moe_dropped": dropped}
    return y.reshape(b, l, d), metrics
