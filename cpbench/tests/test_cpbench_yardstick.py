"""The yardstick on the CPU: the least-time count, the trace reduction,
the generator, and the plain reference against the port's CPU path."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "cpbench"))
sys.path.insert(0, str(ROOT / "src"))

import devtrace  # noqa: E402
import leasttime  # noqa: E402
import reference  # noqa: E402
import tensorgen  # noqa: E402

TINY = json.loads((ROOT / "cpbench/tests/data/tiny.json").read_text())
LAYERS = ("mttkrp", "remap")
H100 = "NVIDIA H100 80GB HBM3"


def test_least_time_counts_a_tiny_tensor():
    # 3 modes × (5 nonzeros × (3 indices + 1 value) × 4 B + 9 rows × R 2 × 4 B)
    nbytes, flops = leasttime.sweep_work((2, 3, 4), 5, 2)
    assert nbytes == 3 * (5 * 16 + 9 * 2 * 4)
    assert flops == 3 * 5 * 2 * 3
    t, bound = leasttime.least_seconds((2, 3, 4), 5, 2, H100)
    assert bound == "bytes" and t == nbytes / 3.35e12
    assert leasttime.least_seconds((2, 3, 4), 5, 2, "cpu") is None


def test_least_time_of_the_nell2_cell():
    t, bound = leasttime.least_seconds((12092, 9184, 28818), 76_879_419, 16,
                                       H100)
    assert bound == "bytes" and 1.10e-3 < t < 1.11e-3


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_reduction_attributes_device_time_by_launch():
    ev = [
        _ev("user_annotation", "cpbench.sweep", 0, 100),
        _ev("user_annotation", "cpbench.mttkrp", 5, 20),
        _ev("user_annotation", "cpbench.remap", 40, 30),
        _ev("cpu_op", "aten::mul", 6, 2, **{"External id": 1}),
        _ev("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=11,
            **{"External id": 1}),
        _ev("cpu_op", "aten::sort", 41, 2, **{"External id": 2}),
        _ev("cuda_runtime", "cudaLaunchKernel", 42, 1, correlation=12,
            **{"External id": 2}),
        _ev("cpu_op", "aten::item", 80, 2, **{"External id": 3}),
        _ev("cuda_runtime", "cudaMemcpyAsync", 81, 1, correlation=13,
            **{"External id": 3}),
        _ev("kernel", "mul_kernel", 10, 30, correlation=11),
        _ev("kernel", "sort_kernel", 45, 10, correlation=12),
        _ev("gpu_memcpy", "Memcpy DtoH", 85, 5, correlation=13),
    ]
    rec = devtrace.reduce_trace({"traceEvents": ev}, LAYERS)
    assert rec["sweeps"] == 1
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["busy_s"] == pytest.approx(45e-6)
    assert rec["layer_device_s"] == pytest.approx({"mttkrp": 30e-6,
                                                   "remap": 10e-6})
    assert rec["device_ops"][0] == ["mul_kernel", pytest.approx(30e-6)]
    names = dict(rec["idle_gaps"])
    assert names["sweep: aten::item"] == pytest.approx(30e-6)
    assert names["mttkrp: aten::mul"] == pytest.approx(10e-6)
    assert names["remap: aten::sort"] == pytest.approx(5e-6)
    assert devtrace.reduce_trace({"traceEvents": ev[3:]}, LAYERS) is None


def test_trace_reduction_counts_nested_layers_in_both():
    # A layer range inside another (``solve`` inside ``mttkrp``) counts
    # the device operations launched inside it, and the outer one keeps
    # them too, whatever the files' order; the innermost names the gap.
    ev = [
        _ev("user_annotation", "cpbench.sweep", 0, 100),
        _ev("user_annotation", "cpbench.mttkrp", 5, 50),
        _ev("user_annotation", "cpbench.solve", 20, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=11),
        _ev("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=12),
        _ev("kernel", "a", 10, 4, correlation=11),
        _ev("kernel", "b", 30, 6, correlation=12),
    ]
    for layers in (("mttkrp", "solve"), ("solve", "mttkrp")):
        rec = devtrace.reduce_trace({"traceEvents": ev}, layers)
        assert rec["layer_device_s"] == pytest.approx({"mttkrp": 10e-6,
                                                       "solve": 6e-6})
        assert dict(rec["idle_gaps"])["solve: host"] == pytest.approx(16e-6)


def test_layer_files_name_the_ports_entries():
    import importlib

    import run
    layers = run.load_layers()
    assert set(layers) == set(LAYERS)
    for where in layers.values():
        assert set(where) == {"module", "entry"}
        assert callable(getattr(importlib.import_module(where["module"]),
                                where["entry"]))


def test_generator_is_seeded_sorted_and_duplicate_free():
    seed = 2**31 + 77
    a = tensorgen.make_tensor(TINY, seed, "cpu")
    b = tensorgen.make_tensor(TINY, seed, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    idx, val = a
    assert idx.shape[0] == TINY["nnz"]
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    flat = np.ravel_multi_index(tuple(idx.long().numpy().T), TINY["shape"])
    assert (np.diff(flat) > 0).all()
    assert (val != 0).all()
    c = tensorgen.make_tensor(TINY, seed + 1, "cpu")
    assert not torch.equal(a[0][:100], c[0][:100])


@pytest.mark.parametrize("nnz", [5, 9, 12])
def test_generator_draws_until_nnz_are_distinct(nnz):
    cfg = dict(TINY, shape=[3, 2, 2], nnz=nnz, draws=200,
               distribution="uniform")
    idx, val = tensorgen.make_tensor(cfg, 5, "cpu")
    assert idx.shape[0] == nnz
    gen = torch.Generator().manual_seed(5)
    raw = torch.stack([torch.randint(0, d, (200,), generator=gen)
                       for d in cfg["shape"]], 1)
    v = torch.randn(200, generator=gen)
    seen, cut = set(), 0
    while len(seen) < nnz:
        seen.add(tuple(raw[cut].tolist()))
        cut += 1
    raw, v = raw[:cut], v[:cut]
    want = torch.zeros(cfg["shape"], dtype=torch.float64)
    want.index_put_(tuple(raw.T), v.double(), accumulate=True)
    got = torch.zeros(cfg["shape"], dtype=torch.float64)
    got[tuple(idx.long().T)] = val.double()
    assert torch.allclose(got, want, atol=1e-5)


def test_generator_refuses_too_few_distinct_draws():
    cfg = dict(TINY, shape=[3, 2, 2], nnz=13, draws=200,
               distribution="uniform")
    with pytest.raises(ValueError, match="fewer than nnz 13"):
        tensorgen.make_tensor(cfg, 5, "cpu")


@pytest.fixture(scope="module")
def program_cpu():
    """Three sweeps of the port on the CPU, with their inputs."""
    from repro_torch.core import cpals, distributed as dist, flycoo, tensors
    from repro_torch.core.workers import LocalWorkers
    seed = 2**31 + 5
    idx, val = tensorgen.make_tensor(TINY, seed, "cpu")
    shape = tuple(TINY["shape"])
    ft = flycoo.build_flycoo(tensors.SparseTensor(
        idx.numpy().copy(), val.numpy().copy(), shape), 1)
    rt, packed = dist.prepare_runtime(ft, 16)
    workers = LocalWorkers(1, "cpu")
    stream, factors, lam, xn = cpals.device_state(ft, rt, packed, seed=seed,
                                                  workers=workers)
    sweeps = []
    for k in range(3):
        res = cpals.als_sweep(stream, factors, lam, xn, rt, workers=workers,
                              sweep0=k == 0, backend="auto")
        sweeps.append((factors, res))
        stream, factors, lam = res.stream, res.factors, res.lam
    return idx, val, shape, seed, sweeps


def test_reference_initial_factors_are_the_ports(program_cpu):
    _, _, shape, seed, sweeps = program_cpu
    init = reference.initial_factors(shape, 16, seed)
    for f, want, d in zip(sweeps[0][0], init, shape):
        assert torch.equal(f[reference.row_slots(d)], torch.from_numpy(want))
        assert not f[d:].any()


def test_reference_sweeps_agree_with_the_ports_cpu_path(program_cpu):
    # Each sweep of the reference starts from the port's own inputs (the
    # first from the seed's factors, as the test above holds), so float32
    # rounding does not build up from sweep to sweep.
    idx, val, shape, _, sweeps = program_cpu
    for k, (inputs, res) in enumerate(sweeps):
        f = [x[:d] for x, d in zip(inputs, shape)]
        ref = reference.sweep(idx, val, f, sweep0=k == 0)
        for got, want, d in zip(res.mttkrp, ref.mttkrp, shape):
            assert torch.allclose(got[0][:d].double(), want,
                                  atol=1e-5 * float(want.abs().max()))
        for got, want, d in zip(res.factors, ref.factors, shape):
            assert torch.allclose(got[:d].double(), want, atol=1e-4)
        assert torch.allclose(res.lam.double(), ref.lam, rtol=1e-5)
        assert float(res.fit) == pytest.approx(ref.fit, abs=1e-5)


def test_reference_follow_steps_along_the_given_sweep(program_cpu):
    idx, val, shape, _, sweeps = program_cpu
    inputs, res = sweeps[2]
    nat = [f[:d] for f, d in zip(inputs, shape)]
    follow = [f[:d] for f, d in zip(res.factors, shape)]
    ref = reference.sweep(idx, val, nat, sweep0=False, follow=follow)
    for n in range(3):
        want = reference.mttkrp(idx, val, follow[:n] + nat[n:], n,
                                torch.float64)
        assert torch.equal(ref.mttkrp[n], want)


def test_lexsort_rows():
    idx = torch.tensor([[1, 0, 2], [0, 5, 1], [1, 0, 1], [0, 5, 0]])
    order = reference.lexsort_rows(idx)
    assert order.tolist() == [3, 1, 2, 0]


def test_tf32_rounding_drops_thirteen_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, -3.0 - 2**-12])
    assert reference.to_tf32(x).tolist() == [1.0 + 2**-10, 1.0, -3.0]
