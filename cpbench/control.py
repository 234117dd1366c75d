"""Readings that set a cell's limits: the program's, and the control's.

    python3 cpbench/control.py --workload nell2-r16 --mode program \
        --seeds 1 2 3 --seconds 3 [--out chiprun_out/control.jsonl]

Every seed is one whole run of the harness (``run.drive``: set-up, a
window of ``--seconds``, the check), all in this process, and its numbers
are appended to ``--out``. ``--mode``:

* ``program``: the cell as it stands: the lower readings;
* ``tf32``: the control: :func:`tf32_sweep` in the program's place, the
  plain reference in float32 with TF32 products, the nearest precision
  below the float32 (TF32 off) the configurations state;
* ``bf16``: the program's own lower path, its factor rows gathered in
  bfloat16 (``gather_dtype``), a second witness.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

import reference
import run


class ControlSweep(NamedTuple):
    """The fields of a program sweep's result that the harness reads."""

    stream: tuple
    factors: list
    lam: torch.Tensor
    fit: torch.Tensor
    mttkrp: list


def tf32_sweep(stream, factors, lam, x_norm_sq, rt, *, workers, sweep0,
               backend="auto"):
    """``cpals.als_sweep``'s call, answered by the reference in TF32 on
    the stream's nonzeros. The stream stays as it is (in mode-0 order);
    factors and MTTKRP outputs are padded to the program's slots."""
    idx, val, mask = (t[0] for t in stream)
    dims = rt.shape
    out = reference.sweep(idx[mask], val[mask],
                          [f[reference.row_slots(d).to(f.device)]
                           for f, d in zip(factors, dims)],
                          sweep0=sweep0, tf32=True)

    def pad(a, rows):
        full = a.new_zeros((rows, a.shape[1]), dtype=torch.float32)
        full[reference.row_slots(a.shape[0]).to(a.device)] = a.float()
        return full

    return ControlSweep(
        stream, [pad(a, f.shape[0]) for a, f in zip(out.factors, factors)],
        out.lam.float(), torch.tensor(out.fit),
        [pad(m, rows)[None] for m, rows in zip(out.mttkrp, rt.rows_cap)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "tf32", "bf16"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="chiprun_out/control.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    _, cell = run.load_cell(args.workload)
    if args.mode == "bf16":
        cell["traffic"] = dict(cell["traffic"], gather_dtype="bfloat16")
    if args.mode == "tf32":
        sys.path.insert(0, str(run.ROOT / "src"))
        from repro_torch.core import cpals
        cpals.als_sweep = tf32_sweep
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        record, nums = run.drive(cell, seed, args.seconds, False, "cuda:0")
        row = {"workload": args.workload, "mode": args.mode, "seed": seed,
               "sweeps": len(record["sweep_s"]),
               "wall_s": time.perf_counter() - t0, "nums": nums}
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
