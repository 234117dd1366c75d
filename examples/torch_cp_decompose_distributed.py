"""Distributed Dynasor CP decomposition on the PyTorch/CUDA port.

The counterpart of ``examples/cp_decompose_distributed.py`` on
``repro_torch``, with the same steps and asserts: Dynasor's
owner-computes spMTTKRP with dynamic tensor remapping on 8 workers
decomposes a dense low-rank tensor exactly (3 modes, and 4 modes through
``backend="auto"``), then runs against the nonzero-parallel + all-reduce
baseline (the ALTO/HiCOO traffic pattern) on a FROSTT profile.

The 8 workers run in this process on one device
(``core.workers.LocalWorkers``): NCCL refuses two ranks on one card.
Their collectives are then device copies, not interconnect traffic, so
the times compare the two paths' work on one device, and the bytes each
path hands to its collectives are what an interconnect would carry.

  PYTHONPATH=src python examples/torch_cp_decompose_distributed.py               # CUDA
  PYTHONPATH=src python examples/torch_cp_decompose_distributed.py --device cpu  # plain versions
"""
import argparse
import itertools
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import distributed as dist
from repro_torch.core.cpals import cp_als_distributed
from repro_torch.core.flycoo import build_flycoo
from repro_torch.core.tensors import SparseTensor, frostt_like
from repro_torch.core.workers import LocalWorkers
from repro_torch.runtime.device import resolve_device

WORKERS = 8


def dense_tensor(shape, rank, rng):
    """A dense rank-``rank`` tensor stored as COO, and its dense values."""
    facs = [rng.standard_normal((d, rank)) for d in shape]
    letters = "ijkl"[:len(shape)]
    dense = np.einsum(",".join(f"{c}r" for c in letters) + "->" + letters,
                      *facs)
    idx = np.array(list(itertools.product(*map(range, shape))), np.int32)
    return SparseTensor(idx, dense.reshape(-1).astype(np.float32),
                        shape), dense


def recover(t, dense, rank, workers, **kw):
    """CP-ALS of ``t`` on ``workers``; returns ``(result, rel_err)``."""
    ft = build_flycoo(t, WORKERS, m_bounds=(2, 8), g_bounds=(8, 64),
                      fused_gather=t.nmodes > 3)
    res = cp_als_distributed(ft, rank, workers=workers, seed=1, **kw)
    letters = "ijkl"[:t.nmodes]
    rec = np.einsum("r," + ",".join(f"{c}r" for c in letters) + "->"
                    + letters, res.lam, *res.factors)
    return res, np.linalg.norm(rec - dense) / np.linalg.norm(dense)


def timed_ms(fn, dev, reps: int = 3) -> float:
    """Mean milliseconds of ``fn()`` after one warm-up call: CUDA events
    on a card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def dynasor_vs_baseline(workers, *, scale: float = 0.15, rank: int = 16):
    """Dynasor's all-modes spMTTKRP against the all-reduce baseline on
    ``frostt_like("nell-2", scale=scale)``. Returns ``{path: (ms, bytes
    handed to the collectives per call)}`` and the nonzero count."""
    t2 = frostt_like("nell-2", scale=scale)
    ft2 = build_flycoo(t2, WORKERS)
    rt, packed = dist.prepare_runtime(ft2, rank=rank)
    factors, _, stream = convert.state_from_reference(
        dist.init_factors(ft2, rt, seed=0), np.ones(rank, np.float32),
        packed, workers=workers)
    base = tuple(torch.from_numpy(a).to(workers.device)
                 for a in dist.even_split_pack(ft2, rt))
    dynasor = dist.make_spmttkrp_all_modes(rt, workers, backend="segsum")
    baseline = dist.make_baseline_all_modes(rt, workers)
    out = {}
    for name, fn, args in (("dynasor", dynasor, stream),
                           ("allreduce-baseline", baseline, base)):
        workers.reset_bytes()
        fn(*args, *factors)
        sent = sum(workers.sent_bytes.values())
        out[name] = (timed_ms(lambda: fn(*args, *factors), workers.device),
                     sent)
    return out, t2.nnz


def main(device=None):
    """Run the example on ``device`` (``None``: CUDA; ``"cpu"``: the
    kernels' plain versions). Returns the fits and the two paths'
    times."""
    dev = resolve_device(device)
    print(f"=== distributed Dynasor CP-ALS ({WORKERS} workers on {dev}) ===")
    workers = LocalWorkers(WORKERS, dev)
    rng = np.random.default_rng(0)

    # exact recovery of a dense rank-4 tensor
    t, dense = dense_tensor((32, 24, 16), 4, rng)
    res, rel = recover(t, dense, 4, workers, iters=20)
    print(f"fit={res.fit:.5f}  reconstruction rel-err={rel:.2e}  "
          f"iters={res.iters}")
    assert res.fit > 0.99

    # 4-mode decomposition through the fused N-mode path end to end
    # (backend="auto": the residency ladder's first rung, B1, whose
    # factors easily fit L2).
    t4, dense4 = dense_tensor((12, 10, 8, 6), 8, rng)
    res4, rel4 = recover(t4, dense4, 8, workers, iters=15, backend="auto")
    print(f"4-mode fused CP-ALS: fit={res4.fit:.5f}  rel-err={rel4:.2e}")
    assert res4.fit > 0.99

    # Dynasor vs nonzero-parallel all-reduce baseline on a FROSTT profile
    paths, nnz = dynasor_vs_baseline(workers)
    for name, (ms, sent) in paths.items():
        print(f"{name:20s} all-modes spMTTKRP: {ms:.1f} ms, {sent} B to "
              f"the collectives (nnz={nnz}, R=16, {WORKERS} workers)")
    print(f"note: the {WORKERS} workers share one {dev.type} device, so "
          "their collectives are device copies: the times compare the two "
          "paths' work on one device, and the bytes each path hands to its "
          "collectives are what an interconnect would carry.")
    print("OK")
    return dict(fit3=res.fit, fit4=res4.fit,
                ms={k: v[0] for k, v in paths.items()},
                bytes={k: v[1] for k, v in paths.items()})


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    main(ap.parse_args().device)
