"""Batched serving driver: prefill + decode loop over the cache tree.

Port of ``repro/launch/serve.py``. Requests (prompts) are padded into a
fixed batch, prefilled once, then decoded token by token with the
per-layer cache tree, written in place. Greedy or temperature sampling.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b --smoke --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --smoke

Runs on CUDA unless ``--device cpu``; with no CUDA device it raises.
Every arch of the dense, MoE, SSM and hybrid families runs; the
``encdec`` and ``vlm`` families (and the int8 KV cache) raise
``NotImplementedError`` (ROADMAP A15 (3)).

Timing: ``serve.prefill_s`` and ``serve.decode_s`` fence the device before
each clock read, so they time the card's work and not the launches. (The
reference fences only when a tracer is enabled; JAX's host-side reads at
the end of its decode loop wait for the device in any case.)
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..models import model as model_lib
from ..models import steps as steps_lib
from ..models.params import init_params, iter_leaves
from ..obs import counters as _obs
from ..obs import tracer as _tracer_mod
from ..runtime.device import resolve_device

__all__ = ["ServeSession", "main"]


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeSession:
    """Serve ``cfg`` with ``params`` on ``device`` (``None``: CUDA).

    ``params`` must already lie on that device (``init_params(...,
    device=)`` or ``convert.lm_params_from_reference(..., device=)``).
    """

    def __init__(self, cfg, params, *, max_len: int = 128, tracer=None,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        for path, leaf in iter_leaves(params):
            if leaf.device != self.device:
                raise ValueError(
                    f"parameter {'/'.join(path)} is on {leaf.device}, the "
                    f"session on {self.device}")
        # Default: resolve the process tracer per generate() call so a
        # session built before `use_tracer(...)` still records into it.
        self._tracer = tracer
        self._prefill = steps_lib.make_prefill_step(cfg)
        self._decode = steps_lib.make_decode_step(cfg)

    def generate(self, prompts: np.ndarray, n_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 extras: dict | None = None):
        """prompts: (b, l_prompt) int32 → (b, n_tokens) int32 numpy."""
        tracer = self._tracer or _tracer_mod.get_tracer()
        dev = self.device
        b, lp = prompts.shape
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=dev)}
        batch.update(extras or {})
        with tracer.span("generate", batch=b, prompt_len=lp,
                         tokens=n_tokens):
            _fence(dev)
            t0 = time.perf_counter()
            with tracer.span("prefill"):
                logits, cache = self._prefill(self.params, batch)
                _fence(dev)
            _obs.add("serve.prefill_s", time.perf_counter() - t0)
            # prefill's caches hold l_prompt slots; re-pad the attention
            # K/V slots to max_len.
            cache = _pad_caches(cache, lp, self.max_len)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            tok = _sample(logits[:, -1, :], temperature, gen, self.cfg.vocab)
            out = [tok]
            _fence(dev)
            t0 = time.perf_counter()
            with tracer.span("decode", tokens=n_tokens - 1):
                for i in range(n_tokens - 1):
                    logits, cache = self._decode(self.params, cache,
                                                 tok[:, None], lp + i)
                    tok = _sample(logits[:, -1, :], temperature, gen,
                                  self.cfg.vocab)
                    out.append(tok)
                result = torch.stack(out, dim=1).cpu().numpy()
            _fence(dev)
            _obs.add("serve.decode_s", time.perf_counter() - t0)
            _obs.add("serve.tokens", b * n_tokens)
        return result.astype(np.int32)


def _pad_caches(cache, prompt_len: int, max_len: int):
    """Grow the seq dim (axis 2 after layer stacking) of the K/V (and
    ``k_scale``) entries to ``max_len``; other entries (mamba's ``conv``
    and ``ssd`` state) stay as they are."""
    out = {}
    for key, c in cache.items():
        if isinstance(c, dict):
            out[key] = _pad_caches(c, prompt_len, max_len)
        elif key in ("k", "v", "k_scale") and c.shape[2] == prompt_len:
            grown = c.new_zeros(c.shape[:2] + (max_len,) + c.shape[3:])
            grown[:, :, :prompt_len] = c
            out[key] = grown
        else:
            out[key] = c
    return out


def _sample(logits, temperature, generator, vocab):
    """Greedy (``temperature <= 0``) or one categorical draw per row from
    ``generator``, over the first ``vocab`` logits."""
    logits = logits[:, :vocab].float()
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(model_lib.model_specs(cfg), seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)
                           ).astype(np.int32)
    sess = ServeSession(cfg, params, device=dev,
                        max_len=args.prompt_len + args.tokens + 1)
    t0 = time.perf_counter()
    out = sess.generate(prompts, args.tokens, temperature=args.temperature)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s on {dev})")
    print(out[:, :12])


if __name__ == "__main__":
    sys.exit(main())
