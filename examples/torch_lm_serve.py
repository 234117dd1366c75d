"""Batched serving example of the PyTorch port: prefill + decode over the
cache tree, for a dense, an MoE, and an attention-free (Mamba2)
architecture.

The counterpart of ``examples/lm_serve.py`` on ``repro_torch``, with its
asserts, for the same three archs' smoke configs: qwen3-32b (qk_norm,
GQA), qwen2-moe-a2.7b (top-2 routing with a shared expert) and
mamba2-370m (the SSD mixer, tied embeddings).

  PYTHONPATH=src python examples/torch_lm_serve.py --tokens 24               # CUDA
  PYTHONPATH=src python examples/torch_lm_serve.py --tokens 24 --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.launch.serve import ServeSession
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.runtime.device import resolve_device


def main(device=None, tokens: int = 24, batch: int = 4):
    """Serve on ``device`` (``None``: CUDA; ``"cpu"``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    for arch in ("qwen3-32b", "qwen2-moe-a2.7b", "mamba2-370m"):
        cfg = smoke_config(arch)
        params = init_params(M.model_specs(cfg), seed=0, device=dev)
        sess = ServeSession(cfg, params, max_len=16 + tokens + 1, device=dev)
        prompts = rng.integers(0, cfg.vocab, (batch, 16)).astype(np.int32)
        t0 = time.perf_counter()
        out = sess.generate(prompts, tokens, temperature=0.8, seed=1)
        dt = time.perf_counter() - t0
        assert out.shape == (batch, tokens)
        assert (out >= 0).all() and (out < cfg.vocab).all()
        print(f"{arch:20s} generated {out.shape[0]}x{out.shape[1]} tokens "
              f"in {dt:.2f}s on {dev}; sample: {out[0, :8].tolist()}")
    print("OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.device, args.tokens, args.batch)
