"""How far the float32 summation order alone moves mamba2-370m's
gradients, leaf by leaf, beside the card-against-CPU difference.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/ssm_grad_order.py

mamba2-370m at 2 layers and every published width, fp32 activations, one
train step's gradients (``accumulate_grads``, 2 microbatches of 1 x 256
tokens, ``SyntheticLMData`` seed 0, the port's weights drawn on the card,
seed 0, copied to the CPU): per leaf, max error / max|g| of the card
against the CPU (all threads), of the CPU with 1 thread against all, of
a rerun on the card, of ``grad_accum=1`` against 2 on the card, and of
the 1-thread CPU against the card. It is what ``chip_smoke.py``'s
per-leaf tolerances for the card-against-CPU check of ``[train-ssm]``
rest on.
"""
from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402


def _rel(a, w) -> float:
    a, w = a.float().cpu(), w.float().cpu()
    return float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_grad_order: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.models.params import init_params, iter_leaves
    threads = torch.get_num_threads()
    print(f"{C.gpu_info()}; {threads} CPU threads", flush=True)
    cfg = C.two_layer_config(get_config(C.TRAIN_SSM_ARCH))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData(
        cfg.vocab, cfg.ssm_chunk, 2, seed=0).batch(0).items()}
    on_card = {k: v.cuda() for k, v in batch.items()}
    card = init_params(M.model_specs(cfg), seed=0, device="cuda")
    cpu = C._to(card, "cpu")
    runs = {"card": S.accumulate_grads(cfg, card, on_card, 2)[1],
            "card rerun": S.accumulate_grads(cfg, card, on_card, 2)[1],
            "cpu": S.accumulate_grads(cfg, cpu, batch, 2)[1],
            "card grad_accum 1": S.accumulate_grads(cfg, card, on_card,
                                                    1)[1]}
    torch.set_num_threads(1)
    runs["cpu 1 thread"] = S.accumulate_grads(cfg, cpu, batch, 2)[1]
    torch.set_num_threads(threads)
    pairs = (("card", "cpu"), ("cpu 1 thread", "cpu"),
             ("card rerun", "card"), ("card grad_accum 1", "card"),
             ("cpu 1 thread", "card"))
    leaves = {key: dict(iter_leaves(tree)) for key, tree in runs.items()}
    for path in leaves["card"]:
        errs = "  ".join(f"{a} vs {b} {_rel(leaves[a][path], leaves[b][path]):.3e}"
                         for a, b in pairs)
        print(f"{'/'.join(path)} {tuple(leaves['card'][path].shape)}: {errs}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
