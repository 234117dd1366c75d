"""Training driver: real steps on one device, reduced or full configs.

Port of ``repro/launch/train.py``. CPU-scale entry point (examples,
tests):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b --smoke --steps 20 --device cpu

On hardware the same driver runs the full config at a production shape
(``--shape``, whose global batch and sequence length it takes):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b --shape train_4k --ckpt-dir /ckpt/qwen3 --steps 10000

Runs on CUDA unless ``--device cpu``; with no CUDA device it raises.
With a checkpoint directory the loop runs under ``runtime.
TrainLoopRunner`` (atomic checkpoints, auto-resume, bounded retry,
straggler telemetry). Only the dense family trains so far: an arch with
a ``moe`` or ``mamba`` layer raises ``NotImplementedError`` before any
parameter is drawn (``steps.require_trainable``), the ``encdec`` / ``vlm``
families from ``model_specs`` (ROADMAP A15 (3)), and there is no mesh
(``use_mesh`` is accepted and does nothing).

Resuming. A checkpoint of step ``s`` holds the state after step ``s``,
and its ``state["step"]`` counts the steps taken. The driver resumes the
data and the loop at that count, so a resumed run replays no step and
skips none. (The reference's driver restarts its data iterator at step 0
and so fails its runner's ``data_step == step`` check on resume.)
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..checkpoint import CheckpointManager
from ..configs import SHAPES, get_config, smoke_config
from ..data import make_batch_iterator
from ..models import model as model_lib
from ..models import steps as steps_lib
from ..models.params import init_params
from ..runtime.device import resolve_device
from ..runtime.fault_tolerance import TrainLoopRunner
from .. import optim as optim_lib

__all__ = ["train", "main"]


def train(arch: str, *, smoke: bool = False, steps: int = 20,
          batch: int = 2, seq: int = 64, ckpt_dir: str | None = None,
          ckpt_every: int = 10, seed: int = 0, lr: float = 1e-3,
          log_fn=print, use_mesh: bool = True, device=None):
    """Train ``arch`` for ``steps`` steps on ``device`` (``None``: CUDA).
    Returns ``(state, history)``; ``history`` holds ``{"step", "loss"}``
    per step run (and ``"time_s"`` under the runner)."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    steps_lib.require_trainable(cfg)
    opt = optim_lib.make_optimizer(
        cfg.optimizer, optim_lib.cosine_schedule(lr, max(2, steps // 10),
                                                 max(steps, 10)))
    params = init_params(model_lib.model_specs(cfg), seed=seed, device=dev)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step_fn = steps_lib.make_train_step(cfg, opt)

    if ckpt_dir:
        runner = TrainLoopRunner(step_fn, CheckpointManager(ckpt_dir),
                                 ckpt_every=ckpt_every, log_fn=log_fn)
        state, _ = runner.resume_or(state, device=dev)
        start = int(state["step"])
        data = make_batch_iterator(cfg.vocab, seq, batch, seed=seed,
                                   start_step=start)
        return runner.run(state, data, steps, start_step=start)

    history = []
    for step, b in make_batch_iterator(cfg.vocab, seq, batch, seed=seed):
        if step >= steps:
            break
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        history.append({"step": step, "loss": loss})
        if step % 5 == 0:
            log_fn(f"step {step} loss {loss:.4f}")
    return state, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="full production shape (hardware only)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.shape:
        shape = SHAPES[args.shape]
        args.batch, args.seq = shape.global_batch, shape.seq_len
    _, history = train(args.arch, smoke=args.smoke or not args.shape,
                       steps=args.steps, batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, lr=args.lr,
                       device=args.device)
    if history:
        print(f"final loss {history[-1]['loss']:.4f} "
              f"(start {history[0]['loss']:.4f})")


if __name__ == "__main__":
    sys.exit(main())
