"""End-to-end LM training of the PyTorch port: deterministic data →
stacked model → AdamW → atomic checkpoints → auto-resume.

The counterpart of ``examples/lm_train.py`` on ``repro_torch``: the dense
default arch (qwen3-32b's smoke config), and any other with ``--arch``,
among them the two that example names, ``--arch qwen2-moe-a2.7b`` and
``--arch mamba2-370m --full-width`` (the published widths instead of the
smoke config; for a card). The ``encdec`` / ``vlm`` archs
(seamless-m4t-large-v2, llama-3.2-vision-11b) train on ``launch.train``'s
stub-frontend inputs, and their held-out batch gets its own.

The synthetic stream is close to uniform over the vocabulary (its loss
sits near ln 256 ≈ 5.545 for this config), so a 200-step run lowers the
training loss by less than its step-to-step noise. The example therefore
checks learning on a held-out batch of another seed's stream: its loss
after training must be below its loss at the starting weights.

  PYTHONPATH=src python examples/torch_lm_train.py --steps 200                 # CUDA
  PYTHONPATH=src python examples/torch_lm_train.py --resume-demo --device cpu
  PYTHONPATH=src python examples/torch_lm_train.py --arch qwen2-moe-a2.7b --device cpu
  PYTHONPATH=src python examples/torch_lm_train.py --arch mamba2-370m --full-width --steps 300
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch.train import train, with_frontend
from repro_torch.models import model as M
from repro_torch.models import steps as S
from repro_torch.models.params import init_params
from repro_torch.runtime.device import resolve_device


def held_out_loss(cfg, params, seq: int, device) -> float:
    """Cross-entropy on 64 sequences of a stream the run never sees (with
    the stub frontend's input of that stream's seed, where the family
    takes one)."""
    data = [(0, SyntheticLMData(cfg.vocab, seq, 64, seed=1).batch(0))]
    (_, batch), = with_frontend(cfg, data, 64, seq, seed=1)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    with torch.no_grad():
        _, metrics = S.loss_fn(cfg, params, batch, remat=False)
    return float(metrics["ce"])


def main(device=None, arch: str = "qwen3-32b", steps: int = 200,
         batch: int = 4, seq: int = 64, resume_demo: bool = False,
         full_width: bool = False):
    """Train on ``device`` (``None``: CUDA; ``"cpu"``); ``full_width``
    trains the published config instead of the smoke one."""
    dev = resolve_device(device)
    smoke = not full_width
    cfg = smoke_config(arch) if smoke else get_config(arch)
    start = held_out_loss(
        cfg, init_params(M.model_specs(cfg), seed=0, device=dev), seq, dev)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        if resume_demo:
            half = steps // 2
            print(f"--- phase 1: train to step {half}, checkpointing ---")
            train(arch, smoke=smoke, steps=half, batch=batch, seq=seq,
                  ckpt_dir=ckpt_dir, ckpt_every=10, device=dev)
            print("--- phase 2: fresh process would auto-resume ---")
        state, history = train(arch, smoke=smoke, steps=steps, batch=batch,
                               seq=seq, ckpt_dir=ckpt_dir, ckpt_every=25,
                               device=dev)
        first, last = history[0], history[-1]
        print(f"training loss {first['loss']:.4f} (step {first['step']}) "
              f"-> {last['loss']:.4f} (step {last['step']}) over "
              f"{len(history)} steps (arch={arch}, {dev})")
        end = held_out_loss(cfg, state["params"], seq, dev)
        print(f"held-out loss {start:.4f} -> {end:.4f}")
        assert end < start, "held-out loss should decrease"
        print("OK")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"start": start, "end": end, "history": history}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--resume-demo", action="store_true",
                    help="train to step N/2, then auto-resume")
    ap.add_argument("--full-width", action="store_true",
                    help="the published config, not the smoke one")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.device, args.arch, args.steps, args.batch, args.seq,
         args.resume_demo, args.full_width)
