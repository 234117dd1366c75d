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

Owner-computes dispatch. Under a mesh context (``sharding.
use_mesh_rules``) whose ``"experts"`` rule resolves, ``impl="auto"`` (and
``"owner"``) takes :func:`moe_apply_owner`, the reference's expert
parallelism under ``shard_map``, emulated on one card: each of the
``n_tok × n_exp`` shards buckets only its token shard's pairs routed to
the ``E / n_exp`` experts it owns into ``(E_local, cap)`` slabs, runs its
slab GEMMs and combines into a local partial output (a token shard is
routed once: its owners hold the same tokens and router); the ``n_exp``
partials of a token shard are summed by
``core.workers.LocalWorkers(n_exp).psum`` (in worker order; its bytes are
the metric ``moe_sent_bytes``). Without a mesh (or with no ``"experts"``
axis on it) every impl runs the gather path, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.workers import LocalWorkers
from .params import ParamSpec
from .sharding import active_mesh_rules, shard

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
    # Switch-style load-balance aux loss over real experts. The counts
    # are a scatter of ones into E_pad zeros (exact integers, so any add
    # order gives them): bincount's would do, but it has no meta kernel,
    # and the dry-run (launch.dryrun) runs this on meta tensors.
    flat = ids.reshape(-1)
    counts = torch.zeros(E_pad, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    density = counts.float() / (T * top_k)
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
    ``{"moe_aux": 0-d float32, "moe_dropped": 0-d int64}`` (and the owner
    path's ``moe_sent_bytes``). ``impl="auto"`` is the owner path when a
    mesh context is active, else the gather path (module docstring)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; one of {_IMPLS}")
    ctx = active_mesh_rules()
    if impl == "auto":
        impl = "owner" if ctx is not None else "gather"
    if impl == "owner" and ctx is not None:
        return moe_apply_owner(params, x, n_real=n_real, top_k=top_k,
                               capacity_factor=capacity_factor,
                               deterministic_cap=deterministic_cap)
    return _moe_apply_gather(params, x, n_real=n_real, top_k=top_k,
                             capacity_factor=capacity_factor,
                             deterministic_cap=deterministic_cap)


def _dispatch(xf, ids, probs, w_gate, w_up, w_down, cap: int,
              e0: int = 0):
    """Bucket the (token, k) pairs routed to experts ``[e0, e0 + E)``
    (``E = w_gate.shape[0]``) into capacity-padded ``(E, cap)`` slabs,
    run the slab GEMMs and combine: ``(y[(T, d)], dropped)``.

    The pairs are stable-sorted by local expert (pairs of other experts
    last), so each expert's pairs keep their (token, k) order and a
    pair's rank is its place in that order; ranks ``>= cap`` are dropped
    into the dump slot. The combine adds a token's k weighted rows in
    expert order (the reference's scatter order; rows of other experts,
    and dropped ones, add an exact zero). ``dropped`` counts this range's
    pairs past capacity."""
    T, top_k = ids.shape
    d = xf.shape[1]
    E = w_gate.shape[0]
    dev = xf.device
    e_flat = ids.reshape(-1) - e0                         # (T·k,) local ids
    p_flat = probs.reshape(-1)
    pair = torch.arange(T * top_k, dtype=torch.int32, device=dev)
    tok = pair // top_k
    valid = (e_flat >= 0) & (e_flat < E)
    dest = torch.where(valid, e_flat, E)                  # others: last
    order = torch.argsort(dest, stable=True)
    d_s = dest[order]
    tok_s = tok[order]
    p_s = p_flat[order]
    start = torch.searchsorted(d_s, d_s, right=False)
    pos = pair - start.to(torch.int32)                    # rank in bucket
    ok = valid[order] & (pos < cap)
    dump = E * cap                                        # the dump slot
    slot = torch.where(ok, d_s * cap + pos, dump).long()
    # Only the dump slot has duplicate targets; it is sliced off.
    buf_tok = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    buf_tok[slot] = tok_s
    buf_p = torch.zeros(dump + 1, dtype=p_s.dtype, device=dev)
    buf_p[slot] = p_s
    buf_ok = torch.zeros(dump + 1, dtype=torch.bool, device=dev)
    buf_ok[slot] = ok
    buf_tok, buf_p, buf_ok = buf_tok[:-1], buf_p[:-1], buf_ok[:-1]
    dropped = torch.sum(valid) - torch.sum(ok)

    # --- owner-computes expert GEMMs ------------------------------------
    dt = xf.dtype
    xe = xf[buf_tok.long()].reshape(E, cap, d)
    xe.masked_fill_(~buf_ok.reshape(E, cap, 1), 0)
    xe = shard(xe, "experts", "batch", None)
    gate = torch.bmm(xe, w_gate.to(dt))
    up = torch.bmm(xe, w_up.to(dt))
    h = shard(F.silu(gate) * up, "experts", "batch", None)
    out = shard(torch.bmm(h, w_down.to(dt)), "experts", "batch", None)

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
    return y, dropped


def _shared(xf, sh, cols=slice(None)):
    """The shared experts' SwiGLU on ``xf``, over the columns ``cols`` of
    their fused inner dimension ``f``."""
    dt = xf.dtype
    g = torch.matmul(xf, sh["w_gate"][:, cols].to(dt))
    u = torch.matmul(xf, sh["w_up"][:, cols].to(dt))
    return torch.matmul(F.silu(g) * u, sh["w_down"][cols].to(dt))


def _moe_apply_gather(params, x, *, n_real: int, top_k: int,
                      capacity_factor: float = 1.25,
                      deterministic_cap: int = 0):
    b, l, d = x.shape
    T = b * l
    xf = shard(x.reshape(T, d), "batch", None)
    E = params["w_gate"].shape[0]
    probs, ids, aux = router_assign(xf, params["router"], n_real, top_k)
    cap = capacity(T, top_k, capacity_factor, E, deterministic_cap)
    y, dropped = _dispatch(xf, ids, probs, params["w_gate"],
                           params["w_up"], params["w_down"], cap)
    y = shard(y, "batch", None)
    if "shared" in params:
        y = y + _shared(xf, params["shared"])
    metrics = {"moe_aux": aux, "moe_dropped": dropped}
    return y.reshape(b, l, d), metrics


# ---------------------------------------------------------------------------
# Owner-computes dispatch (Dynasor super-shard semantics)
# ---------------------------------------------------------------------------

def _resolve_axes(rules, name, mesh):
    r = rules.get(name)
    if r is None:
        return ()
    if isinstance(r, str):
        r = (r,)
    return tuple(a for a in r if a in mesh.axis_names)


def moe_apply_owner(params, x, *, n_real: int, top_k: int,
                    capacity_factor: float = 1.25,
                    deterministic_cap: int = 0):
    """Expert-parallel MoE with the paper's owner-computes invariant,
    under the active mesh context (``sharding.use_mesh_rules``).

    The tokens split into ``n_tok`` shards over the mesh axes of
    ``"batch"``, the experts into ``n_exp`` contiguous ranges over those
    of ``"experts"`` (no such axis: the gather path). Token shard ``t``
    is routed once: its ``n_exp`` owners hold the same replicated tokens
    and router, so each would route it alike. Owner ``o`` then buckets
    only the pairs routed to its ``E / n_exp`` experts into ``(E_local,
    cap)`` slabs, ``cap`` from the shard's ``T_local`` tokens as in the
    reference, runs its slab GEMMs on its experts' weights and combines
    into a local ``(T_local, d)`` partial; it adds its ``f / n_exp``
    columns of the shared experts (split over the owners, as the
    reference shards their ``mlp`` dimension). A
    ``LocalWorkers(n_exp).psum`` adds the owners' partials in worker
    order. ``moe_dropped`` is summed over every shard, ``moe_aux`` is the
    mean over the token shards, and ``moe_sent_bytes`` is what the psums
    were handed. No atomics: a rerun gives the same bits.

    Against the gather path on the same routes: the same capacity (at
    ``n_tok = 1``), drops and expert products; the psum adds each owner's
    partial sum, so a token whose k rows span owners is summed in another
    grouping than the gather path's left-to-right expert order (equal
    bits at ``top_k <= 2``), and the shared experts' ``f`` sum is split
    into ``n_exp`` partial sums.
    """
    ctx = active_mesh_rules()
    if ctx is None:
        raise ValueError("moe_apply_owner needs a mesh context "
                         "(sharding.use_mesh_rules)")
    mesh, rules = ctx
    b, l, d = x.shape
    T = b * l
    tok_axes = _resolve_axes(rules, "batch", mesh)
    exp_axes = _resolve_axes(rules, "experts", mesh)
    if not exp_axes:
        return _moe_apply_gather(params, x, n_real=n_real, top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 deterministic_cap=deterministic_cap)
    n_tok = math.prod(mesh.shape[a] for a in tok_axes)
    n_exp = math.prod(mesh.shape[a] for a in exp_axes)
    E = params["w_gate"].shape[0]
    if E % n_exp or T % n_tok:
        raise ValueError(f"{E} experts and {T} tokens do not split over "
                         f"{n_exp} expert owners and {n_tok} token shards")
    E_local, T_local = E // n_exp, T // n_tok
    cap = capacity(T_local, top_k, capacity_factor, E, deterministic_cap)
    sh = params.get("shared")
    if sh is not None and sh["w_gate"].shape[1] % n_exp:
        raise ValueError(f"shared experts' {sh['w_gate'].shape[1]} columns "
                         f"do not split over {n_exp} owners")
    f_local = sh["w_gate"].shape[1] // n_exp if sh is not None else 0
    workers = LocalWorkers(n_exp, x.device)
    xf = x.reshape(T, d)
    ys, auxes, dropped = [], [], 0
    for t in range(n_tok):
        xf_l = xf[t * T_local:(t + 1) * T_local]
        probs, ids, aux = router_assign(xf_l, params["router"], n_real,
                                        top_k)
        parts = []
        for o in range(n_exp):
            e = slice(o * E_local, (o + 1) * E_local)
            y_o, drop_o = _dispatch(
                xf_l, ids, probs, params["w_gate"][e], params["w_up"][e],
                params["w_down"][e], cap, e0=o * E_local)
            if sh is not None:
                y_o = y_o + _shared(
                    xf_l, sh, slice(o * f_local, (o + 1) * f_local))
            parts.append(y_o)
            dropped = dropped + drop_o
        ys.append(workers.psum(torch.stack(parts)))
        auxes.append(aux)
    aux = auxes[0]
    for a in auxes[1:]:
        aux = aux + a
    metrics = {"moe_aux": aux / n_tok, "moe_dropped": dropped,
               "moe_sent_bytes": workers.sent_bytes.get("psum", 0)}
    return torch.cat(ys).reshape(b, l, d), metrics
