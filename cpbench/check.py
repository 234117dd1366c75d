"""The comparison that decides ``correct``.

Numbers, each held to the cell's limit:

* ``mttkrp_rel``: per checked sweep and mode, ``max|M - M_ref|`` over
  ``max|M_ref|``, the largest of them;
* ``factor_rel``: the same for the normalised factors;
* ``lam_rel``: the same for λ;
* ``pad_nonzero``: entries of the padding rows (the slots past ``I_n``)
  of any checked MTTKRP output or factor that are not 0 (exact, limit 0);
* ``stream_mismatch``: after the window, the nonzeros of the remapped
  stream against the tensor: live entries missing or changed, live
  entries after a padding slot, live entries out of mode-0 order, and
  padding slots with a value (exact, limit 0).

``fit_gap``, the largest ``|fit - fit_ref|``, is held to a limit in
the cells whose file gives one, and reported beside the others.
"""
from __future__ import annotations

import math

import torch

import reference


def _rel(a, b) -> float:
    a, b = a.to(torch.float64), b.to(torch.float64)
    scale = b.abs().max()
    return float((a - b).abs().max() / torch.clamp(scale, min=1e-300))


def compare_sweep(out: dict, ref: reference.Sweep) -> dict:
    """``out``: ``mttkrp`` and ``factors`` per mode in slot order (rows
    past ``I_n`` are padding), ``lam``, ``fit``."""
    nums = {"mttkrp_rel": 0.0, "factor_rel": 0.0, "pad_nonzero": 0}
    for key, refs, name in (("mttkrp", ref.mttkrp, "mttkrp_rel"),
                            ("factors", ref.factors, "factor_rel")):
        for got, want in zip(out[key], refs):
            dev = want.device
            slots = reference.row_slots(want.shape[0]).to(dev)
            got = got.to(dev)
            live = torch.zeros(got.shape[0], dtype=torch.bool, device=dev)
            live[slots] = True
            nums[name] = max(nums[name], _rel(got[slots], want))
            nums["pad_nonzero"] += int((got[~live] != 0).sum())
    nums["lam_rel"] = _rel(out["lam"].to(ref.lam.device), ref.lam)
    nums["fit_gap"] = abs(float(out["fit"]) - ref.fit)
    return nums


def stream_mismatch(stream, indices, values) -> int:
    """Count of faults in the stream ``(idx (1, cap, N), val (1, cap),
    mask (1, cap))`` against the tensor's ``indices`` and ``values``
    (natural order; at one worker a slot is its natural row)."""
    idx, val, mask = (t[0] for t in stream)
    nnz = values.shape[0]
    live = int(mask.sum())
    bad = abs(live - nnz)
    bad += int((mask[1:] & ~mask[:-1]).sum())
    bad += int((val[~mask] != 0).sum())
    rows = idx[:live, 0].long()
    bad += int((rows[1:] < rows[:-1]).sum())
    n = min(live, nnz)
    got_i, got_v = idx[:live], val[:live]
    order = reference.lexsort_rows(got_i)[:n]
    want = reference.lexsort_rows(indices)[:n]
    same = ((got_i[order].long() == indices[want].long()).all(dim=1)
            & (got_v[order] == values[want]))
    return bad + int((~same).sum())


def merge(*parts: dict) -> dict:
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = v if k not in out else max(out[k], v)
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the limited numbers;
    a number that is not finite fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = nums.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
