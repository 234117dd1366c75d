"""Where the LM phases' time goes, op by op, on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/lm_profile.py                    # every phase
    python3 bench_torch/lm_profile.py serve-vlm train-vlm  # some of them

Each phase of ``chip_smoke.py``'s LM paths at its widths and depth
(``[serve]`` / ``[train]`` phi3-mini-3.8b, ``[serve-moe]``
qwen2-moe-a2.7b, ``[serve-ssm]`` / ``[train-ssm]`` mamba2-370m,
``[train-moe]`` qwen2-moe-a2.7b at 4 layers, ``[serve-encdec]`` /
``[train-encdec]`` seamless-m4t-large-v2, ``[serve-vlm]``
llama-3.2-vision-11b and ``[train-vlm]`` at 10 layers; the ``xattn``
gates at 0.5; the port's weights, seed 0, on the card), and for each
``chip_smoke.profile_ops``' reading of one call under ``torch.profiler``
(wall ms, kernel ms, the device's idle share, the aten ops with the most
self device time): serving, one prefill of 8 x 1024 tokens (the stub
frontend's input drawn as ``launch.serve.main`` draws it) and one decode
step at position 1024; training, one step of 8 x 1024 tokens in 2
microbatches (AdamW, ``SyntheticLMData`` seed 0) after a warm one. The
card's name and power limit go beside each line. ``chip_smoke.py``
leaves these profiles out for its time limit: reading one train step's
trace takes up to ~35 s.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402

# phase -> (arch, layers: None for the published depth)
SERVE = {"serve": (C.SERVE_ARCH, None), "serve-moe": (C.SERVE_MOE_ARCH, None),
         "serve-ssm": (C.SERVE_SSM_ARCH, None),
         "serve-encdec": (C.ENCDEC_ARCH, None), "serve-vlm": (C.VLM_ARCH, None)}
TRAIN = {"train": (C.TRAIN_ARCH, None), "train-ssm": (C.TRAIN_SSM_ARCH, None),
         "train-moe": (C.TRAIN_MOE_ARCH, C.TRAIN_MOE_LAYERS),
         "train-encdec": (C.ENCDEC_ARCH, None),
         "train-vlm": (C.VLM_ARCH, C.TRAIN_VLM_LAYERS)}


def _model(arch: str, n_layers):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(M.model_specs(cfg), seed=0, device="cuda")
    C.open_gates(params)
    return cfg, params


def profile_serve(tag: str, arch: str, n_layers, gpu: str) -> dict:
    from repro_torch.launch.serve import _pad_caches, frontend_extras
    from repro_torch.models import model as M
    cfg, params = _model(arch, n_layers)
    b, lp, n = C.SERVE_BATCH, C.SERVE_PROMPT, C.SERVE_TOKENS
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (b, lp)).astype(
        np.int32)).cuda()
    extras = frontend_extras(cfg, rng, b, lp, "cuda")
    logits, cache = M.prefill(cfg, params, prompts, **extras)   # warm
    cache = _pad_caches(cache, lp, lp + n + 1)
    tok = logits[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
    M.decode_step(cfg, params, cache, tok, lp)                   # warm
    out = {"prefill": C.profile_ops(
        lambda: M.prefill(cfg, params, prompts, **extras),
        f"one prefill ({b} x {lp} tokens) [{gpu}]", tag=tag),
        "decode": C.profile_ops(
            lambda: M.decode_step(cfg, params, cache, tok, lp),
            f"one decode step (pos {lp}, cache {lp + n + 1} slots) [{gpu}]",
            tag=tag)}
    del params, cache
    return out


def profile_train(tag: str, arch: str, n_layers, gpu: str) -> dict:
    from repro_torch import optim
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.train import with_frontend
    from repro_torch.models import steps as S
    cfg, params = _model(arch, n_layers)
    b, l, k = C.TRAIN_BATCH, C.TRAIN_SEQ, C.TRAIN_ACCUM
    opt = optim.make_optimizer(cfg.optimizer,
                               optim.cosine_schedule(1e-3, 2, 10))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    data = SyntheticLMData(cfg.vocab, l, b, seed=0)
    step_fn = S.make_train_step(cfg, opt, grad_accum=k)

    def batch_of(i):
        return next(with_frontend(cfg, [(i, data.batch(i))], b, l, 0))[1]

    step_fn(state, batch_of(0))                                  # warm
    batch = batch_of(1)
    out = {"step": C.profile_ops(
        lambda: step_fn(state, batch),
        f"one train step of {cfg.n_layers} layers ({b} x {l} tokens, "
        f"grad_accum {k}) [{gpu}]", top=12, tag=tag)}
    del state, params, opt, step_fn
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device", file=sys.stderr)
        return 2
    names = (argv if argv is not None else sys.argv[1:]) or (
        list(SERVE) + list(TRAIN))
    gpu = C.gpu_info()
    out = {}
    for name in names:
        t0 = time.perf_counter()
        if name in SERVE:
            out[name] = profile_serve(name, *SERVE[name], gpu)
        else:
            out[name] = profile_train(name, *TRAIN[name], gpu)
        out[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"lm_profile": out, "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
