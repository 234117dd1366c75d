"""Multi-pod dry-run: every (arch × shape × mesh) cell, counted on meta
tensors.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell's step for 512 forced host devices, without allocating, and reads
the compiled program's memory and cost analyses and its collectives. The
port has no compiler. Its counterpart of "lower + compile without
allocating" is to build the step exactly as the reference does and run it
once on ``device="meta"`` tensors (shapes and dtypes, no data) under
``launch.flops.CostMode``, which counts what the step executes and
refuses any tensor not on meta: nothing is allocated, on any device.

Per cell:
  * skipped cells (``configs.skip_reason``) return the reference's record;
  * build the step (``models.steps``: ``make_train_step(mesh=, rules=,
    param_shardings=)``, ``make_prefill_step``, ``make_decode_step``; the
    abstract inputs ``input_specs`` / ``train_state_specs`` /
    ``abstract_params`` on ``make_production_mesh(multi_pod=)``), timed
    as ``dryrun.lower_s``;
  * run it once on meta at the global batch, the train step with
    :data:`GRAD_ACCUM` microbatches, timed as ``dryrun.compile_s``: the
    global FLOPs and modeled bytes (``costs_global``, per chip ÷
    ``n_chips`` as the reference divides its jaxpr costs) and the bytes
    its collectives were handed (``launch.roofline.collective_bytes``);
  * ``memory_analysis``: ``argument_size_in_bytes`` exactly (each
    argument leaf's bytes over the mesh axes its partition spec names);
    ``temp_size_in_bytes`` the meta peak of live bytes of one more run,
    one microbatch at the per-device batch (global ÷ data shards ÷
    ``GRAD_ACCUM``) with no mesh and the weights, gradients and caches
    unsharded: an upper bound where tensor parallelism or FSDP would
    split them (that run's own arguments excluded);
  * the reference's analytic per-chip model (:func:`_analytic_memory`),
    judged against this card's bytes.

The reference's ``cost_analysis_raw`` (XLA's per-device cost analysis,
which counts a loop body once) has no counterpart: there is no compiled
program to ask. Its ``--save-hlo`` has none either. The hardware is
``launch.mesh.HW`` (the H100's data sheet, so a dry-run gives the same
numbers on any host); ``--device cuda`` reads the card's own
(``mesh.device_hw``) and raises without one.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all          # every cell, 16x16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback

from ..configs import ARCHS, SHAPES, get_config, skip_reason
from ..core.workers import LocalWorkers, tally_into
from ..models import model as model_lib
from ..models import steps as steps_lib
from ..models.params import (ShapeDtypeStruct, abstract_params,
                             logical_to_spec, torch_dtype)
from ..obs import counters as _obs
from .. import optim as optim_lib
from .flops import step_costs
from .mesh import HW, device_hw, make_production_mesh
from .roofline import summarize_cell

__all__ = ["dryrun_cell", "main", "iter_cells", "GRAD_ACCUM",
           "build_step", "count_step", "argument_bytes", "run_cells",
           "line"]

# Microbatches per train step (activation-memory fit): per-device
# microbatch is exactly one sequence on either mesh (256/16/16 = 1,
# 256/8/32 = 1).
GRAD_ACCUM = {"16x16": 16, "2x16x16": 8}


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes)


def _specs(tree):
    """The partition specs of a tree of ``ShapeDtypeStruct`` leaves."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tree.spec


def _train_step(cfg, shape, mesh, rules, grad_accum=None):
    if grad_accum is None:
        grad_accum = GRAD_ACCUM[_mesh_name(mesh)]
    opt = optim_lib.make_optimizer(cfg.optimizer)
    state = steps_lib.train_state_specs(cfg, opt, mesh, rules)
    p_sh = _specs(state["params"]) if mesh is not None else None
    step_fn = steps_lib.make_train_step(cfg, opt, mesh, rules,
                                        grad_accum=grad_accum,
                                        param_shardings=p_sh)
    batch = steps_lib.input_specs(cfg, shape, mesh, rules)
    return step_fn, (state, batch), (state, batch)


def _prefill_step(cfg, shape, mesh, rules):
    step_fn = steps_lib.make_prefill_step(cfg, mesh, rules)
    params = abstract_params(model_lib.model_specs(cfg), mesh, rules)
    batch = steps_lib.input_specs(cfg, shape, mesh, rules)
    return step_fn, (params, batch), (params, batch)


def _decode_step(cfg, shape, mesh, rules):
    step_fn = steps_lib.make_decode_step(cfg, mesh, rules)
    params = abstract_params(model_lib.model_specs(cfg), mesh, rules)
    specs = steps_lib.input_specs(cfg, shape, mesh, rules)
    # The port's decode step takes the slot as a Python int (it writes
    # the cache there); the last slot of the cache. The reference's is a
    # traced int32, an argument of 4 bytes.
    run = (params, specs["cache"], specs["token"], shape.seq_len - 1)
    return step_fn, run, (params, specs["cache"], specs["token"],
                          specs["pos"])


def build_step(cfg, shape, mesh, rules, grad_accum=None):
    """``(step_fn, run_args, arguments)`` of a cell: the step built as the
    reference's ``_train_lowered`` / ``_prefill_lowered`` /
    ``_decode_lowered`` build it, the abstract arguments to run it on,
    and its arguments as the reference's program takes them."""
    if shape.kind == "train":
        return _train_step(cfg, shape, mesh, rules, grad_accum)
    if shape.kind == "prefill":
        return _prefill_step(cfg, shape, mesh, rules)
    return _decode_step(cfg, shape, mesh, rules)


def argument_bytes(tree, mesh) -> int:
    """Per-device bytes of a tree (dicts, lists, tuples) of
    ``ShapeDtypeStruct`` leaves: each leaf's bytes divided by the sizes of
    the mesh axes its partition spec names (``None``: replicated)."""
    if isinstance(tree, dict):
        return sum(argument_bytes(v, mesh) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(argument_bytes(v, mesh) for v in tree)
    if not isinstance(tree, ShapeDtypeStruct):
        return 0
    return math.prod(tree.shape) * tree.dtype.itemsize // math.prod(
        mesh.shape[axis] for entry in tree.spec or ()
        for axis in (entry if isinstance(entry, tuple)
                     else (entry,) if entry else ()))


def _data_shards(mesh, rules) -> int:
    """The shards of the batch: the sizes of the mesh axes ``"batch"``
    resolves to."""
    spec = logical_to_spec(("batch",), rules, mesh)[0]
    axes = spec if isinstance(spec, tuple) else (spec,) if spec else ()
    return math.prod(mesh.shape[a] for a in axes)


def count_step(cfg, shape, mesh, *, grad_accum=None) -> dict:
    """Build ``cfg``'s step at ``shape`` (a ``ShapeSpec``) on ``mesh`` as
    :func:`build_step` does and run it once on meta. Returns ``costs``
    (``step_costs``: global counts and ``peak_bytes``), ``workers`` (what
    its collectives were handed), ``argument_bytes`` (per device),
    ``rules``, and ``lower_s`` / ``compile_s`` (building, running)."""
    rules = steps_lib.rules_for(shape, cfg)
    t0 = time.perf_counter()
    fn, run, arguments = build_step(cfg, shape, mesh, rules, grad_accum)
    t_lower = time.perf_counter() - t0
    workers = LocalWorkers(1, "meta")
    with tally_into(workers):
        costs = step_costs(fn, *run)
    return {"costs": costs, "workers": workers, "rules": rules,
            "argument_bytes": argument_bytes(arguments, mesh),
            "lower_s": t_lower,
            "compile_s": time.perf_counter() - t0 - t_lower}


def _temp_bytes(cfg, shape, mesh, rules, grad_accum: int) -> int:
    """The meta peak of one microbatch at the per-device batch, no mesh,
    the weights unsharded (module docstring)."""
    per_dev = shape.global_batch // _data_shards(mesh, rules)
    if shape.kind == "train":
        per_dev //= grad_accum
    local = dataclasses.replace(shape, global_batch=max(1, per_dev))
    fn, run, _ = build_step(cfg, local, None, rules, grad_accum=1)
    return step_costs(fn, *run)["peak_bytes"]


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                overrides=None, hw=None) -> dict:
    """One cell's record (module docstring). ``hw``: the card's constants
    (default :data:`launch.mesh.HW`)."""
    hw = HW if hw is None else hw
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    counted = count_step(cfg, shape, mesh)
    costs = counted["costs"]
    t_lower, t_compile = counted["lower_s"], counted["compile_s"]
    _obs.add("dryrun.lower_s", t_lower, arch=arch, shape=shape_name)
    _obs.add("dryrun.compile_s", t_compile, arch=arch, shape=shape_name)
    ga = GRAD_ACCUM[mesh_name]
    memory = {
        "argument_size_in_bytes": counted["argument_bytes"],
        "temp_size_in_bytes": _temp_bytes(cfg, shape, mesh,
                                          counted["rules"], ga),
    }
    n_chips = mesh.size
    info = summarize_cell(costs, memory, counted["workers"],
                          n_chips=n_chips, hw=hw)
    flops_chip = info.pop("flops")
    bytes_chip = info.pop("hbm_bytes")
    model_flops = _model_flops(cfg, shape, n_chips)
    costs_global = {k: v for k, v in costs.items() if k != "peak_bytes"}
    info.update({
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "n_chips": n_chips,
        "costs_global": costs_global,
        "flops_per_chip": flops_chip,
        "hbm_bytes_per_chip_model": bytes_chip,
        "model_flops_per_chip": model_flops,
        "useful_flops_ratio": (model_flops / flops_chip
                               if flops_chip else None),
        "param_count": cfg.param_count(),
        "param_count_active": cfg.param_count(active_only=True),
        "peak_hbm_frac": (memory["temp_size_in_bytes"]
                          + memory["argument_size_in_bytes"])
        / hw["hbm_bytes"],
    })
    info.update(_analytic_memory(cfg, shape, n_chips, ga, hw=hw))
    return info


def _analytic_memory(cfg, shape, n_chips: int, grad_accum: int,
                     hw=None) -> dict:
    """The reference's per-chip HBM model (bytes), its parts unchanged:
    params + optimizer state + gradient accumulator + one micro-grad tree
    + remat checkpoints + KV/state caches + a transient allowance (weight
    gathers + attention/SSD working set ≈ 2 GB). ``analytic_fits`` is
    judged against ``hw["hbm_bytes"]`` (default :data:`HW`: the H100's
    80 GB, where the reference judges a v5e's 16 GiB)."""
    hw = HW if hw is None else hw
    P = cfg.param_count()
    psz = torch_dtype(cfg.param_dtype).itemsize
    params = P * psz / n_chips
    if shape.kind == "train":
        gsz = torch_dtype(cfg.grad_accum_dtype).itemsize
        opt = (2 * P * 4 if cfg.optimizer == "adamw" else P * 0.05) / n_chips
        grads = 2 * P * gsz / n_chips            # accumulator + micro tree
        batch_shards = max(1, n_chips // 16)      # data (× pod) axes
        tokens_dev = (shape.global_batch // grad_accum * shape.seq_len
                      // batch_shards)
        # per-group carry checkpoints (bf16) over the layer loop
        ckpt = cfg.n_repeats * tokens_dev * cfg.d_model * 2
        cache = 0
    else:
        opt = grads = ckpt = 0
        cache = 0
        if shape.kind == "decode":
            kv_layers = sum(1 for k in cfg.pattern
                            if k.startswith(("attn", "xattn"))) \
                * cfg.n_repeats
            cache = (2 * kv_layers * shape.global_batch * shape.seq_len
                     * cfg.kv_dim * 2) / n_chips
            if "mamba" in "".join(cfg.pattern):
                di = cfg.d_inner
                cache += (cfg.n_layers * shape.global_batch
                          * (cfg.ssm_heads * cfg.ssm_headdim * cfg.d_state
                             + (cfg.d_conv - 1)
                             * (di + 2 * cfg.ssm_groups * cfg.d_state))
                          * 4) / n_chips
    transient = 2e9
    total = params + opt + grads + ckpt + cache + transient
    return {"analytic_hbm_gb": round(total / 1e9, 2),
            "analytic_fits": bool(total <= hw["hbm_bytes"]),
            "analytic_parts_gb": {
                "params": round(params / 1e9, 2),
                "opt": round(opt / 1e9, 2),
                "grads": round(grads / 1e9, 2),
                "ckpt": round(ckpt / 1e9, 2),
                "cache": round(cache / 1e9, 2),
                "transient_allowance": 2.0}}


def _model_flops(cfg, shape, n_chips: int) -> float:
    """6·N_active·D per chip (training); forward-only thirds for serving."""
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * shape.seq_len
    if cfg.family == "encdec":
        # encoder params see L/2 frames, decoder params L/2 tokens
        tokens //= 2
    if shape.kind == "train":
        return 6.0 * n_active * tokens / n_chips
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens / n_chips
    # decode: one token per sequence (matmul flops only; attention reads
    # the KV cache — that cost shows up in the memory term, not FLOPs)
    return 2.0 * n_active * shape.global_batch / n_chips


def _parse_overrides(pairs):
    """['kv_cache_dtype=int8', 'exact_causal_attn=true'] → kwargs."""
    out = {}
    for p in pairs or ():
        k, _, v = p.partition("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def iter_cells():
    for arch in ARCHS:
        for shape_name in SHAPES:
            yield arch, shape_name


def line(info: dict, tag: str) -> str:
    """One cell's summary line: status, dominant term, bound, per-device
    GB (arguments + temp) and whether the analytic model fits."""
    status = info["status"]
    if status != "ok":
        return f"[dryrun] {tag}: {status}"
    r, m = info["roofline"], info["memory_analysis"]
    dev_gb = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]) / 1e9
    return (f"[dryrun] {tag}: ok dom={r['dominant']} "
            f"bound={r['bound_s'] * 1e3:.2f}ms dev={dev_gb:.2f}GB "
            f"analytic={info['analytic_hbm_gb']}GB "
            f"fits={info['analytic_fits']} compile={info['compile_s']}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Count every (arch x shape x mesh) cell's step on meta "
                    "tensors (no allocation, no card needed).",
        epilog="The reference's --save-hlo has no counterpart: the port "
               "compiles no program, so there is no HLO to save.")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--override", action="append", default=None,
                    help="cfg field override, e.g. kv_cache_dtype=int8 "
                         "(repeatable); result tagged with --variant")
    ap.add_argument("--variant", default=None,
                    help="suffix for the output JSON of an override run")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--device", choices=("cuda",), default=None,
                    help="judge fits against this card's own memory "
                         "(default: the H100 data sheet, launch.mesh.HW)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    hw = device_hw() if args.device == "cuda" else HW
    os.makedirs(args.out, exist_ok=True)
    cells = (list(iter_cells()) if args.all
             else [(args.arch, args.shape)])
    jobs = [(arch, shape_name, args.multi_pod, args.override, args.variant,
             hw, args.out) for arch, shape_name in cells]
    failed = 0
    for text, info in run_cells(jobs, args.jobs):
        print(text, flush=True)
        failed += info["status"] == "error"
    if failed:
        raise SystemExit(f"{failed} cell(s) failed")


def run_cells(jobs, processes: int = 1):
    """Yield ``(line, record)`` of each :func:`_run_cell` job, as they
    finish; ``processes > 1`` runs them in that many processes at once
    (spawned, one cell each, all stopped on return)."""
    if processes <= 1:
        for job in jobs:
            yield _run_cell(job)
        return
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes, maxtasksperchild=1) as pool:
        yield from pool.imap_unordered(_run_cell, jobs)


def _run_cell(job) -> tuple[str, dict]:
    """One cell: ``job`` is ``(arch, shape_name, multi_pod, override
    pairs, variant, hw, out)``; its record is written to ``out`` as JSON
    (``out`` None: not written). Returns its summary line (and trace, on
    error) and the record."""
    arch, shape_name, multi_pod, override, variant, hw, out = job
    tag = f"{arch}__{shape_name}__{'2x16x16' if multi_pod else '16x16'}"
    if variant:
        tag += f"__{variant}"
    t0 = time.perf_counter()
    try:
        info = dryrun_cell(arch, shape_name, multi_pod=multi_pod,
                           overrides=_parse_overrides(override), hw=hw)
    except Exception:
        info = {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "error", "trace": traceback.format_exc()}
    info["cell_s"] = round(time.perf_counter() - t0, 1)
    if out is not None:
        with open(os.path.join(out, tag + ".json"), "w") as f:
            json.dump(info, f, indent=1, default=str)
    text = line(info, tag) + f" cell={info['cell_s']}s"
    if info["status"] == "error":
        text += "\n" + info["trace"]
    return text, info


if __name__ == "__main__":
    main()
