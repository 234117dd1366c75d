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
straggler telemetry). Every family trains. ``use_mesh`` runs the steps
under the host mesh when the process has more than one device, as the
reference's driver: the port runs on one card, so it trains without a
mesh (``models.steps.make_train_step(mesh=...)`` takes one). The
``encdec`` and ``vlm`` families get the stub frontend's inputs of
``repro/launch/train.py`` with each batch: ``frames`` ``(batch, seq, d_frontend)`` or
``img`` ``(batch, n_img_tokens, d_frontend)``, standard normal float32
from ``numpy.random.default_rng(seed * 131 + step)``.

Resuming. A checkpoint of step ``s`` holds the state after step ``s``,
and its ``state["step"]`` counts the steps taken. The driver resumes the
data and the loop at that count, so a resumed run replays no step and
skips none. (The reference's driver restarts its data iterator at step 0
and so fails its runner's ``data_step == step`` check on resume.)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
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
from .mesh import make_host_mesh

__all__ = ["train", "main", "with_frontend"]


def with_frontend(cfg, data, batch: int, seq: int, seed: int):
    """``(step, batch)`` pairs of ``data`` with the stub frontend's input
    added for the ``encdec`` (``frames``) and ``vlm`` (``img``) families,
    drawn as ``repro/launch/train.py``'s ``batched`` draws them."""
    input_ = model_lib.frontend_shape(cfg, batch, seq)
    for step, b in data:
        if input_ is not None:
            key, shape = input_
            rng = np.random.default_rng(seed * 131 + step)
            b = dict(b, **{key: rng.standard_normal(shape).astype(
                np.float32)})
        yield step, b


def train(arch: str, *, smoke: bool = False, steps: int = 20,
          batch: int = 2, seq: int = 64, ckpt_dir: str | None = None,
          ckpt_every: int = 10, seed: int = 0, lr: float = 1e-3,
          log_fn=print, use_mesh: bool = True, device=None):
    """Train ``arch`` for ``steps`` steps on ``device`` (``None``: CUDA).
    Returns ``(state, history)``; ``history`` holds ``{"step", "loss"}``
    per step run (and ``"time_s"`` under the runner)."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    opt = optim_lib.make_optimizer(
        cfg.optimizer, optim_lib.cosine_schedule(lr, max(2, steps // 10),
                                                 max(steps, 10)))
    host = make_host_mesh()
    mesh = {"mesh": host} if use_mesh and host.size > 1 else {}
    params = init_params(model_lib.model_specs(cfg), seed=seed, device=dev)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step_fn = steps_lib.make_train_step(cfg, opt, **mesh)

    if ckpt_dir:
        runner = TrainLoopRunner(step_fn, CheckpointManager(ckpt_dir),
                                 ckpt_every=ckpt_every, log_fn=log_fn)
        state, _ = runner.resume_or(state, device=dev)
        start = int(state["step"])
        data = make_batch_iterator(cfg.vocab, seq, batch, seed=seed,
                                   start_step=start)
        return runner.run(state, with_frontend(cfg, data, batch, seq, seed),
                          steps, start_step=start)

    history = []
    data = make_batch_iterator(cfg.vocab, seq, batch, seed=seed)
    for step, b in with_frontend(cfg, data, batch, seq, seed):
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
