"""Kernel times on the main paths of one checkout, for A/B runs on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 bench_torch/kernel_ab.py [--tree DIR]

Imports ``chip_smoke.py`` and the port from DIR (default: this checkout;
another commit unpacked with ``git archive <commit> | tar -x -C DIR``),
builds its kernels into DIR's ``build/kernels``, and runs its ``[gpu]``
L2 probe and its ``[main]``, ``[fused-main]``, ``[stream-main]`` and
``[bf16-main]`` phases on the nell-2 stand-in. Prints those phases' lines,
then one JSON line ``{"tree": DIR, "gpu": ..., "kernels": {name: {"ms":
..., "per_mode": [...]}}}``: each kernel's CUDA-event ms per call at its
main path's inputs, mean over the modes, as ``chip_smoke.py``'s kernels
line gives it. Two commits compare only within one call, in turns:

    A="python3 bench_torch/kernel_ab.py"; $A --tree build/parent; $A; $A; \\
        $A --tree build/parent
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout to time")
    tree = os.path.abspath(parser.parse_args().tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    dev = torch.device("cuda")
    gpu = cs.gpu_info()
    cs.phase_build()
    cs.phase_l2_rate(dev, gpu)
    ft, b1_fits, rows = cs.phase_main(dev, gpu)
    rows.update(cs.phase_fused_main(ft, b1_fits, dev, gpu))
    rows.update(cs.phase_stream_main(ft, dev, gpu))
    rows.update(cs.phase_bf16_main(ft, dev, gpu))
    kernels = {name: {"ms": sum(r["ms"] for r in per) / len(per),
                      "per_mode": [round(r["ms"], 4) for r in per]}
               for name, (_, per) in rows.items()}
    print(json.dumps({"tree": tree, "gpu": gpu, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
