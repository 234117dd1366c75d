"""The port's dry-run tools (``repro_torch.launch.flops``, ``roofline``,
``dryrun``) against the reference's ``repro.launch``, mirroring
``tests/test_launch.py`` and ``tests/test_perf_levers.py::
test_exact_causal_matches_and_saves_flops`` on the CPU.

FLOP parity: for every arch at its smoke config, for the train step,
prefill and a decode step, the FLOPs and product bytes the port counts
(the step run on meta tensors) equal the reference's ``step_costs`` (its
jaxpr walked), exactly, once the work one package runs and the other does
not, and the product operands the two read at different bytes, are added
by the per-site formulas below, each with its reason. The formulas take
their shapes from the port's own calls of each site, recorded while it is
counted."""
import contextlib
import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.configs import smoke_shape as j_smoke_shape  # noqa: E402
from repro.launch import flops as JF  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models.params import abstract_params as j_abstract  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, skip_reason, \
    smoke_config, smoke_shape  # noqa: E402
from repro_torch.core.workers import LocalWorkers, tally_into  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import flops as TF  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch.mesh import HW, make_production_mesh  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.params import ShapeDtypeStruct, abstract_params, \
    init_params, torch_dtype  # noqa: E402
from repro_torch.obs import counters as ocnt  # noqa: E402


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` restored: it
    forces 512 host devices at import, which must not reach the JAX of
    this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


JD = _reference_dryrun()


def _meta(shape, dtype=torch.float32):
    return ShapeDtypeStruct(tuple(shape), dtype)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def test_flops_counter_counts_python_loop_trips():
    """The reference's scan of 8 matmuls: a Python loop, executed."""
    def f(x, w):
        for _ in range(8):
            x = x @ w
        return x

    costs = TF.step_costs(f, _meta((128, 128)), _meta((128, 128)))
    assert costs["flops"] == costs["flops_fp32"] == 8 * 2 * 128 ** 3
    assert costs["dot_bytes"] == 8 * 3 * 128 * 128 * 4
    assert costs["scan_io_bytes"] == 0


def test_flops_counter_handles_remat_and_grad():
    """grad under a checkpoint: forward, recompute, and two products per
    product backward (the reference: >= 3x the forward)."""
    from torch.utils.checkpoint import checkpoint

    def body(c, w):
        return torch.tanh(c @ w)

    def loss(w, x):
        for _ in range(4):
            x = checkpoint(body, x, w, use_reentrant=False)
        return (x ** 2).sum()

    def grad(w, x):
        w = w.detach().requires_grad_(True)
        loss(w, x).backward()
        return w.grad

    w, x = _meta((64, 64)), _meta((8, 64))
    fwd = TF.step_costs(loss, w, x)["flops"]
    both = TF.step_costs(grad, w, x)["flops"]
    assert fwd == 4 * 2 * 8 * 64 * 64
    assert both >= 3 * fwd
    assert both == 4 * fwd - 2 * 8 * 64 * 64   # no input gradient at layer 0


def test_bf16_products_and_gathers_are_split_and_counted():
    def f(a, b, table, idx):
        return (a @ b).float() @ b.float(), table[idx]

    costs = TF.step_costs(f, _meta((4, 8), torch.bfloat16),
                          _meta((8, 8), torch.bfloat16),
                          _meta((16, 8)), _meta((5,), torch.int64))
    assert costs["flops_bf16"] == 2 * 4 * 8 * 8
    assert costs["flops_fp32"] == 2 * 4 * 8 * 8
    # Widened operands are read at their bf16 bytes (a convert fuses into
    # the product's read); the fp32 output is written at its own.
    assert costs["dot_bytes"] == (4 * 8 + 8 * 8 + 4 * 8) * 2 + (
        4 * 8 * 2 + 8 * 8 * 2 + 4 * 8 * 4)
    assert costs["gather_bytes"] == 5 * 8 * 4


@pytest.mark.parametrize("eq, shapes, k1", [
    ("bhp,bhn->bhpn", [(2, 3, 4), (2, 3, 5)], [2 * 3 * 4 * 5]),
    ("bzlhn,bhzl,bzlhp->bzhpn", [(1, 2, 4, 3, 8), (1, 3, 2, 4),
                                 (1, 2, 4, 3, 5)], [1 * 2 * 4 * 3 * 5]),
    ("bzlhn,bzhpn,bzlh->bzlhp", [(1, 2, 4, 3, 8), (1, 2, 3, 5, 8),
                                 (1, 2, 4, 3)], [1 * 2 * 4 * 3 * 5]),
    ("btc,tc->bc", [(2, 4, 6), (4, 6)], []),
])
def test_einsum_products_with_nothing_summed_are_counted(eq, shapes, k1):
    """The pairs jnp.einsum lowers to a K=1 dot_general, on the
    reference's own count of the same einsum."""
    ops = [_meta(s) for s in shapes]
    got = TF.step_costs(lambda *t: TL.einsum(eq, *t), *ops)
    want = JF.step_costs(lambda *t: jnp.einsum(eq, *t),
                         *[jax.ShapeDtypeStruct(s, jnp.float32)
                           for s in shapes])
    assert got["flops"] == want["flops"]
    size = dict(zip("".join(eq.split("->")[0].split(",")),
                    [n for s in shapes for n in s]))
    assert [math.prod(size[c] for c in p["out"])
            for p in TF.einsum_pairs(eq, shapes) if p["k"] == 1] == k1


def test_einsum_products_are_counted_backward_and_in_the_recompute():
    """A K=1 pair's two transposed products are counted when the gradient
    reaches it, and the model's checkpoint (``model._checkpointed``),
    whose recompute re-enters the forward's einsum watchers, counts it
    again. ``torch.einsum`` itself is not watched: the counter changes
    nothing outside the port."""
    # tanh saves its output, so the recompute runs the einsum whole.
    remat = TM._checkpointed(
        dataclasses.make_dataclass("Cfg", [("remat_policy", str)])(
            "nothing"),
        lambda a, b: torch.tanh(TL.einsum("ij,ik->ijk", a, b)))

    def f(x, y):
        x = x.detach().requires_grad_(True)
        y = y.detach().requires_grad_(True)
        remat(x, y).sum().backward()

    got = TF.step_costs(f, _meta((3, 4)), _meta((3, 5)))
    assert got["flops"] == 4 * 2 * 3 * 4 * 5
    assert TF.step_costs(lambda a, b: torch.einsum("ij,ik->ijk", a, b),
                         _meta((3, 4)), _meta((3, 5)))["flops"] == 0
    assert not TL.einsum_watchers()


def test_the_counting_mode_refuses_an_output_off_meta():
    with pytest.raises(RuntimeError, match="allocates nothing"):
        TF.step_costs(lambda x: x + torch.ones(3), _meta((3,)))


def test_peak_counts_what_the_step_creates_not_its_arguments():
    def f(x):
        y = x * 2                 # 4096 B
        z = y + 1                 # 4096 B, y alive
        del y
        return z[:2] * 3          # 32 B, z alive

    got = TF.step_costs(f, _meta((1024,)))
    assert got["peak_bytes"] == 8192


# ---------------------------------------------------------------------------
# Collectives and the roofline
# ---------------------------------------------------------------------------

def test_collective_bytes_of_local_workers_are_their_bytes_per_kind():
    w = LocalWorkers(4, "cpu")
    tally = LocalWorkers(1, "cpu")
    a2a = torch.zeros((4, 4, 3), dtype=torch.float32)
    with tally_into(tally):
        w.all_to_all(a2a)
        w.all_gather(torch.zeros((4, 5), dtype=torch.int32))
        w.psum(torch.zeros((4, 7), dtype=torch.bfloat16))
        w.psum(torch.zeros((4, 2), dtype=torch.float32))
        w.pmax(torch.zeros((4, 1), dtype=torch.float32))
    for workers in (w, tally):
        out = TR.collective_bytes(workers)
        assert out["bytes_by_kind"] == {
            "all-to-all": 4 * 4 * 3 * 4, "all-gather": 4 * 5 * 4,
            "all-reduce": 4 * 7 * 2 + 4 * 2 * 4 + 4 * 1 * 4}
        assert out["count_by_kind"] == {"all-to-all": 1, "all-gather": 1,
                                        "all-reduce": 3}
        assert out["total_bytes"] == sum(out["bytes_by_kind"].values())
    w.all_gather(torch.zeros((4, 1)))
    assert TR.collective_bytes(tally)["count_by_kind"]["all-gather"] == 1


def test_roofline_terms_pick_dominant_on_h100_constants():
    t = TR.roofline_terms(flops=HW["peak_flops_bf16"], hbm_bytes=0,
                          coll_bytes=0)
    assert t["dominant"] == "compute_s" and abs(t["compute_s"] - 1) < 1e-12
    t = TR.roofline_terms(flops=0, hbm_bytes=HW["hbm_bw"], coll_bytes=0)
    assert t["dominant"] == "memory_s" and abs(t["memory_s"] - 1) < 1e-12
    t = TR.roofline_terms(flops=0, hbm_bytes=0, coll_bytes=HW["nvlink_bw"])
    assert t["dominant"] == "collective_s" \
        and abs(t["collective_s"] - 1) < 1e-12
    t = TR.roofline_terms(flops=0, hbm_bytes=1, coll_bytes=0,
                          fp32_flops=HW["peak_flops_fp32"])
    assert t["dominant"] == "compute_s" and abs(t["compute_s"] - 1) < 1e-12
    # The reference's keys, at fp32_flops=0.
    assert set(t) == set(JH.roofline_terms(1.0, 1.0, 1.0))
    assert TR.roofline_terms(2e12, 3e9, 4e9)["overlap_fraction"] == \
        pytest.approx(max(2e12 / 989e12, 3e9 / 3.35e12, 4e9 / 450e9)
                      / (2e12 / 989e12 + 3e9 / 3.35e12 + 4e9 / 450e9))


def test_summarize_cell_divides_by_the_chips():
    costs = {"flops": 30, "flops_bf16": 20, "flops_fp32": 10,
             "hbm_bytes_model": 40}
    w = LocalWorkers(2, "cpu")
    w.psum(torch.zeros((2, 4)))
    out = TR.summarize_cell(costs, {"argument_size_in_bytes": 1}, w,
                            n_chips=2)
    assert out["flops"] == 15 and out["hbm_bytes"] == 20
    assert out["collectives"]["total_bytes"] == 32
    assert out["roofline"] == TR.roofline_terms(10, 20, 16, fp32_flops=5)
    assert out["memory_analysis"] == {"argument_size_in_bytes": 1}


# ---------------------------------------------------------------------------
# The dry-run's arithmetic against the reference's
# ---------------------------------------------------------------------------

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES]


@pytest.mark.parametrize("arch, shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    for n in (256, 512):
        assert TD._model_flops(get_config(arch), SHAPES[shape], n) == \
            JD._model_flops(J_ARCHS[arch], JD.SHAPES[shape], n)


def test_parse_overrides_equals_the_reference():
    pairs = ["kv_cache_dtype=int8", "exact_causal_attn=true", "remat=False",
             "capacity_factor=1.5", "n_layers=4", "name=x=y"]
    assert TD._parse_overrides(pairs) == JD._parse_overrides(pairs)
    assert TD._parse_overrides(None) == JD._parse_overrides(None) == {}
    assert TD.GRAD_ACCUM == JD.GRAD_ACCUM


@pytest.mark.parametrize("arch, shape", [c for c in CELLS if not skip_reason(
    get_config(c[0]), SHAPES[c[1]])])
def test_analytic_memory_parts_equal_the_reference(arch, shape):
    for n, mesh in ((256, "16x16"), (512, "2x16x16")):
        got = TD._analytic_memory(get_config(arch), SHAPES[shape], n,
                                  TD.GRAD_ACCUM[mesh])
        want = JD._analytic_memory(J_ARCHS[arch], JD.SHAPES[shape], n,
                                   JD.GRAD_ACCUM[mesh])
        assert got["analytic_parts_gb"] == want["analytic_parts_gb"]
        assert got["analytic_hbm_gb"] == want["analytic_hbm_gb"]
        assert got["analytic_fits"] == (
            want["analytic_hbm_gb"] * 1e9 <= HW["hbm_bytes"] + 5e6)


def test_argument_bytes_divide_by_the_named_axes():
    mesh = make_production_mesh(multi_pod=True)
    tree = {"a": ShapeDtypeStruct((64, 32), torch.float32, (("pod", "data"),
                                                            "model")),
            "b": [ShapeDtypeStruct((8,), torch.bfloat16, (None,)),
                  ShapeDtypeStruct((), torch.int32)]}
    assert TD.argument_bytes(tree, mesh) == 64 * 32 * 4 // 512 + 16 + 4


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_cell_of_a_decode_cell(multi_pod):
    """A whole cell on meta: the reference's keys (``costs_global`` for
    ``jaxpr_costs_global``, no ``cost_analysis_raw``), per-chip costs the
    global ones over the chips, its counters emitted."""
    with ocnt.use_registry() as reg:
        info = TD.dryrun_cell("mamba2-370m", "decode_32k",
                              multi_pod=multi_pod)
    n = 512 if multi_pod else 256
    assert info["status"] == "ok" and info["n_chips"] == n
    assert info["flops_per_chip"] == info["costs_global"]["flops"] / n
    assert info["hbm_bytes_per_chip_model"] == \
        info["costs_global"]["hbm_bytes_model"] / n
    assert "cost_analysis_raw" not in info
    mem = info["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert info["peak_hbm_frac"] == (mem["argument_size_in_bytes"]
                                     + mem["temp_size_in_bytes"]) / 80e9
    assert info["collectives"]["total_bytes"] == 0     # no MoE layer
    labels = {"arch": "mamba2-370m", "shape": "decode_32k"}
    assert reg.get("dryrun.lower_s", **labels) > 0
    assert reg.get("dryrun.compile_s", **labels) > 0


def test_skipped_cell_is_the_references_record():
    got = TD.dryrun_cell("qwen3-32b", "long_500k")
    want = {"arch": "qwen3-32b", "shape": "long_500k", "mesh": "16x16",
            "status": "skipped",
            "reason": JD.skip_reason(J_ARCHS["qwen3-32b"],
                                     JD.SHAPES["long_500k"])}
    assert got == want


def test_moe_cell_counts_the_owner_dispatch_psum():
    """Under the production mesh the MoE takes the owner dispatch: its
    psum bytes are the collective term (a smoke-size MoE on a 2 x 2
    mesh)."""
    from repro_torch.launch.mesh import make_mesh
    cfg = smoke_config("qwen2-moe-a2.7b")
    mesh = make_mesh((2, 2), ("data", "model"))
    shape = dataclasses.replace(smoke_shape("prefill"), global_batch=4)
    rules = TS.rules_for(shape, cfg)
    fn, run, _ = TD.build_step(cfg, shape, mesh, rules)
    tally = LocalWorkers(1, "meta")
    with tally_into(tally):
        TF.step_costs(fn, *run)
    n_moe = sum("moe" in k for k in cfg.pattern) * cfg.n_repeats
    # Each of 2 token shards sums its 2 owners' (T/2, d) partials.
    t_local = 4 * shape.seq_len // 2
    want = n_moe * 2 * 2 * t_local * cfg.d_model * 2
    assert TR.collective_bytes(tally)["bytes_by_kind"] == {
        "all-reduce": want}


def test_cli_writes_the_cell_and_names_the_missing_save_hlo(tmp_path,
                                                            capsys):
    TD.main(["--arch", "mamba2-370m", "--shape", "long_500k",
             "--out", str(tmp_path)])
    assert "ok dom=" in capsys.readouterr().out
    assert (tmp_path / "mamba2-370m__long_500k__16x16.json").exists()
    with pytest.raises(SystemExit):
        TD.main(["--help"])
    assert "--save-hlo has no counterpart" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# FLOP parity with the reference, per (arch, step)
# ---------------------------------------------------------------------------

def _reference_costs(arch, kind):
    cfg, shape = j_smoke(arch), j_smoke_shape(kind)
    if kind == "train":
        opt = JO.make_optimizer(cfg.optimizer)
        return JF.step_costs(JS.make_train_step(cfg, opt),
                             JS.train_state_specs(cfg, opt),
                             JS.input_specs(cfg, shape))
    params = j_abstract(JM.model_specs(cfg))
    if kind == "prefill":
        return JF.step_costs(JS.make_prefill_step(cfg), params,
                             JS.input_specs(cfg, shape))
    sp = JS.input_specs(cfg, shape)
    return JF.step_costs(JS.make_decode_step(cfg), params, sp["cache"],
                         sp["token"], sp["pos"])


def _port_step(cfg, kind):
    shape = smoke_shape(kind)
    if kind == "train":
        opt = TO.make_optimizer(cfg.optimizer)
        return TS.make_train_step(cfg, opt), (
            TS.train_state_specs(cfg, opt), TS.input_specs(cfg, shape))
    params = abstract_params(TM.model_specs(cfg))
    if kind == "prefill":
        return TS.make_prefill_step(cfg), (params,
                                           TS.input_specs(cfg, shape))
    sp = TS.input_specs(cfg, shape)
    return TS.make_decode_step(cfg), (params, sp["cache"], sp["token"],
                                      shape.seq_len - 1)


@contextlib.contextmanager
def _recorded_sites():
    """The port's calls of the sites the formulas need, with their
    shapes: attention, the memory's K/V, the router, the SSD and mamba's
    prefill and decode."""
    calls = {k: [] for k in ("attn", "kv", "router", "ssd", "mamba_prefill",
                             "mamba_decode")}
    saved = {}

    def wrap(mod, name, key, take):
        orig = getattr(mod, name)
        saved[(mod, name)] = orig

        def f(*a, **kw):
            if key == "ssd" and calls.get("_in_ssd"):
                return orig(*a, **kw)         # its own padded call
            calls["_in_ssd"] = key == "ssd" or calls.get("_in_ssd")
            try:
                # A call inside a backward is a checkpoint's recompute.
                calls[key].append(dict(take(*a, **kw), recompute=(
                    torch._C._current_graph_task_id() != -1)))
                return orig(*a, **kw)
            finally:
                if key == "ssd":
                    calls["_in_ssd"] = False
        setattr(mod, name, f)

    wrap(TA, "flash_attention", "attn", lambda q, k, v, **kw: dict(
        q=tuple(q.shape), k=tuple(k.shape), isz=q.element_size(),
        q_chunk=kw.get("q_chunk", 1024), kv_chunk=kw.get("kv_chunk", 1024),
        exact=kw.get("exact_causal", False), mode=kw.get("mode", "causal")))
    wrap(TB, "_kv_only", "kv", lambda cfg, p, mem: dict(
        mem=tuple(mem.shape), isz=mem.element_size()))
    wrap(TMoE, "router_assign", "router", lambda xf, *a: dict(
        x=tuple(xf.shape), isz=xf.element_size()))
    wrap(TSSM, "_ssd", "ssd", lambda xdt, dA, B, C, chunk: dict(
        x=tuple(xdt.shape), n=B.shape[-1], chunk=chunk))
    wrap(TSSM, "mamba_prefill", "mamba_prefill", lambda p, x, cfg: dict(
        x=tuple(x.shape), isz=x.element_size()))
    wrap(TSSM, "mamba_decode", "mamba_decode", lambda p, x, c, cfg: dict(
        x=tuple(x.shape)))
    try:
        yield calls
    finally:
        for (mod, name), orig in saved.items():
            setattr(mod, name, orig)
        calls.pop("_in_ssd", None)


def _attention_gap(cfg, calls):
    """Train: the reference's attention recurrence is a ``lax.scan`` over
    KV chunks inside the checkpointed layer; its backward recomputes each
    chunk pair's score product ``q·kᵀ`` once more than the port's (which
    keeps the probabilities of its recompute), and it sums a GQA group's
    ``dK`` / ``dV`` inside the product, where the port's products write
    the group's ``g`` copies (fp32) and add them after. Per chunk pair of
    a layer (its first forward run, not a recompute)."""
    flops = nbytes = 0
    for c in calls:
        if c["recompute"]:
            continue
        b, lq, h, dh = c["q"]
        lk, kh = c["k"][1], c["k"][2]
        qc, kc = min(c["q_chunk"], lq), min(c["kv_chunk"], lk)
        nq, nk = -(-lq // qc), -(-lk // kc)
        pairs = nq * nk
        if c["exact"] and c["mode"] == "causal" and lq == lk and nq > 1:
            pairs = sum(TA._kv_blocks(qc, kc, i) for i in range(nq))
        flops += pairs * 2 * b * h * qc * kc * dh
        nbytes += pairs * ((b * h * qc * dh + b * kh * kc * dh) * c["isz"]
                           + b * h * qc * kc * 4
                           - 2 * (h // kh - 1) * b * kh * kc * dh * 4)
    return flops, nbytes


def _router_gap(cfg, calls, kind):
    """The reference widens the router's input (``xf.astype(f32)``) before
    its product and reads it at fp32; the port's counter reads the
    widening at the activations' bytes. Train reads it once more a layer
    than its forward runs: the weight gradient."""
    nbytes = sum(math.prod(c["x"]) * (4 - c["isz"])
                 * (1 + (kind == "train" and not c["recompute"]))
                 for c in calls)
    return nbytes


def _ssd_dims(cfg, x):
    b, l, h, p = x
    return b, l, h, p, cfg.d_state, cfg.ssm_groups, \
        torch_dtype(cfg.act_dtype).itemsize


def _ssd_gap(cfg, calls, kind):
    """The reference hands its SSD B and C repeated over the heads
    (``jnp.repeat``) and widened to fp32, and its products read them so;
    the port's counter reads the repeat and the widening, which fuse into
    the products, at the activations' unrepeated bytes (``δ_BC`` a read:
    the CB product's two, the states' and ``y_off``'s one each). The
    train backward reads them four times more, and reads ``y``'s
    cotangent, which reaches the SSD through ``y.to(act)``, at the
    activations' bytes where the reference reads fp32 (``δ_g``, twice)."""
    nbytes = 0
    for c in calls:
        b, l, h, p, n, g, isz = _ssd_dims(cfg, c["x"])
        d_bc = b * l * (h * n * 4 - g * n * isz)
        d_g = b * l * h * p * (4 - isz)
        nbytes += 4 * d_bc
        if kind == "train" and not c["recompute"]:     # the backward
            nbytes += 4 * d_bc + 2 * d_g
    return 0, nbytes


def _mamba_prefill_gap(cfg, calls):
    """The reference's prefill recomputes, for the cache, each mamba
    layer's input projection and its chunk states (``blocks.py:313-315``:
    the K=1 decay product and the state product); the port keeps both from
    its one pass."""
    flops = nbytes = 0
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.d_state
    h, p = cfg.ssm_heads, cfg.ssm_headdim
    dp = 2 * di + 2 * g * n + h
    for c in calls:
        b, l, d = c["x"]
        cl = min(cfg.ssm_chunk, l)
        nc = -(-l // cl)
        lp = nc * cl
        flops += 2 * b * l * d * dp + 2 * b * lp * h * p \
            + 2 * b * nc * h * p * n * cl
        nbytes += (b * l * d + d * dp + b * l * dp) * c["isz"] \
            + (b * h * lp + 2 * b * lp * h * p) * 4 \
            + (b * lp * h * p + b * lp * h * n + b * nc * h * p * n) * 4
    return flops, nbytes


def _mamba_decode_gap(cfg, calls):
    """The decode update's two products read B and C repeated over the
    heads in the reference, unrepeated in the port's count (fp32 in
    both)."""
    h, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.d_state
    return 0, sum(2 * c["x"][0] * (h - g) * n * 4 for c in calls)


def _kv_gap(cfg, calls):
    """The reference's prefill computes each cross-attention layer's
    memory K and V twice (for the attention, and again for the cache,
    ``blocks.py:246``); the port once."""
    flops = nbytes = 0
    for c in calls:
        b, lm, d = c["mem"]
        kvd = cfg.kv_dim
        flops += 2 * 2 * b * lm * d * kvd
        nbytes += 2 * (b * lm * d + d * kvd + b * lm * kvd) * c["isz"]
    return flops, nbytes


def _known_gaps(cfg, kind, calls):
    """The reference's count less the port's, site by site."""
    parts = [_ssd_gap(cfg, calls["ssd"], kind),
             (0, _router_gap(cfg, calls["router"], kind))]
    if kind == "train":
        parts.append(_attention_gap(cfg, calls["attn"]))
    if kind == "prefill":
        parts.append(_kv_gap(cfg, calls["kv"]))
        parts.append(_mamba_prefill_gap(cfg, calls["mamba_prefill"]))
    if kind == "decode":
        parts.append(_mamba_decode_gap(cfg, calls["mamba_decode"]))
    return (sum(f for f, _ in parts), sum(b for _, b in parts))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_flops_and_product_bytes_equal_the_reference(arch, kind):
    want = _reference_costs(arch, kind)
    cfg = smoke_config(arch)
    fn, args = _port_step(cfg, kind)
    with _recorded_sites() as calls:
        got = TF.step_costs(fn, *args)
    gap_flops, gap_bytes = _known_gaps(cfg, kind, calls)
    assert got["flops"] == got["flops_bf16"] + got["flops_fp32"]
    assert got["flops"] + gap_flops == want["flops"]
    assert got["dot_bytes"] + gap_bytes == want["dot_bytes"]
    assert got["hbm_bytes_model"] == got["dot_bytes"] + got["gather_bytes"]


# ---------------------------------------------------------------------------
# Counting does not depend on the device
# ---------------------------------------------------------------------------

def _real(tree, seed=0):
    """A ``ShapeDtypeStruct`` tree as real CPU tensors (seeded)."""
    gen = torch.Generator().manual_seed(seed)
    if isinstance(tree, dict):
        return {k: _real(v, seed) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_real(v, seed) for v in tree)
    if not isinstance(tree, ShapeDtypeStruct):
        return tree
    if tree.dtype in (torch.int32, torch.int64):
        return torch.randint(0, 200, tree.shape, generator=gen,
                             dtype=tree.dtype)
    return (0.02 * torch.randn(tree.shape, generator=gen)).to(tree.dtype)


@pytest.mark.parametrize("arch, kind", [
    ("qwen3-32b", "train"), ("phi3-mini-3.8b", "prefill"),
    ("qwen2-moe-a2.7b", "prefill"), ("mamba2-370m", "decode"),
    ("seamless-m4t-large-v2", "train")])
def test_a_cpu_run_and_a_meta_run_count_the_same(arch, kind):
    cfg = smoke_config(arch)
    fn, args = _port_step(cfg, kind)
    meta = TF.step_costs(fn, *args)
    fn, args = _port_step(cfg, kind)
    if kind == "train":
        state, batch = args
        params = init_params(TM.model_specs(cfg), seed=0, device="cpu")
        opt = TO.make_optimizer(cfg.optimizer)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        args = (state, _real(batch))
    else:
        params = init_params(TM.model_specs(cfg), seed=0, device="cpu")
        args = (params,) + tuple(_real(a) for a in args[1:])
    cpu = TF.analyze(fn, *args, device="cpu")
    assert cpu == meta


# ---------------------------------------------------------------------------
# Exact causal attention (tests/test_perf_levers.py)
# ---------------------------------------------------------------------------

def test_exact_causal_matches_and_saves_flops():
    rng = np.random.default_rng(1)
    b, lq, h, kh, dh = 2, 64, 8, 4, 16
    q = torch.from_numpy(rng.standard_normal((b, lq, h, dh)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((b, lq, kh, dh)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, lq, kh, dh)).astype(
        np.float32))
    pos = torch.arange(lq, dtype=torch.int32)[None].expand(b, lq)
    a = TA.flash_attention(q, k, v, pos_q=pos, pos_k=pos, mode="causal",
                           q_chunk=16, kv_chunk=16, exact_causal=False)
    bq = TA.flash_attention(q, k, v, pos_q=pos, pos_k=pos, mode="causal",
                            q_chunk=16, kv_chunk=16, exact_causal=True)
    np.testing.assert_allclose(a.numpy(), bq.numpy(), atol=1e-5)

    qs = _meta((1, 4096, 8, 64))
    ps = _meta((1, 4096), torch.int32)

    def attn(flag):
        return lambda q, k, v, p: TA.flash_attention(
            q, k, v, pos_q=p, pos_k=p, mode="causal", exact_causal=flag)

    f_full = TF.step_costs(attn(False), qs, qs, qs, ps)["flops"]
    f_skip = TF.step_costs(attn(True), qs, qs, qs, ps)["flops"]
    assert f_skip < 0.7 * f_full          # (nq+1)/2nq = 0.625 at nq=4
    want = jax.ShapeDtypeStruct((1, 4096, 8, 64), jnp.float32)
    from repro.models.attention import flash_attention as j_flash
    pj = jax.ShapeDtypeStruct((1, 4096), jnp.int32)
    assert f_full == JF.step_costs(
        lambda q, k, v, p: j_flash(q, k, v, pos_q=p, pos_k=p,
                                   mode="causal", exact_causal=False),
        want, want, want, pj)["flops"]
