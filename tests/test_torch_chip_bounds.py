"""The least-time bounds ``chip_smoke.py`` prints beside its LM phases,
from the shapes alone (no card): ``lm_forward_work``, ``serve_bound_ms``
and ``train_bound_ms`` keep the numbers they gave before they counted the
encoder and cross-attention (phi3-mini-3.8b's 109.267 ms prefill,
mamba2-370m's 29.854 ms prefill, PERF.md §5), give phi3's train step
474.257 ms, and count the memory families' extra work term by term; and
hold the hand count against what ``launch.flops`` counts a smoke forward
and a train step executing, up to per-site formulas."""
import dataclasses
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402

_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)


@pytest.mark.parametrize("arch, prefill_ms", [("phi3-mini-3.8b", 109.267),
                                              ("mamba2-370m", 29.854)])
def test_serve_bounds_of_the_earlier_phases_are_unchanged(arch, prefill_ms):
    got = C.serve_bound_ms(get_config(arch), 8, 1024, 1057)
    assert abs(got["prefill_bound_ms"] - prefill_ms) < 1e-3


def test_train_bound_of_phi3_is_unchanged():
    """[train]'s bound, 474.257 ms, counts the recompute the step runs:
    every product but the unembedding and each layer's down projection
    (``mm_recompute``)."""
    got = C.train_bound_ms(get_config("phi3-mini-3.8b"), 8192, 1024,
                           15_285_891_072)
    assert abs(got["step_bound_ms"] - 474.257) < 1e-3
    cfg = get_config("phi3-mini-3.8b")
    work = C.lm_forward_work(cfg, 8, 1024)
    tokens, d = 8192, cfg.d_model
    assert got["mm_flops"] == 3 * work["mm"] + work["mm_recompute"]
    assert work["mm_recompute"] == work["mm"] - 2 * tokens * d * (
        cfg.vocab_padded + cfg.n_layers * cfg.d_ff)
    assert got["fp32_flops"] == 4 * work["fp32"]


def test_cross_attention_and_encoder_are_counted():
    """seamless: the encoder's layers and frontend over the memory, the
    cross-attention's K/V over the memory and its scores; llama-3.2-vision:
    the image projection and 8 gated layers' scores over 1601 tokens."""
    cfg = get_config("seamless-m4t-large-v2")
    b, l, lm = 2, 64, 48
    d, f, kv, q = cfg.d_model, cfg.d_ff, cfg.kv_dim, cfg.q_dim
    w_attn = d * (q + 2 * kv) + q * d
    work = C.lm_forward_work(cfg, b, l, lm)
    dec = C.lm_forward_work(dataclasses.replace(cfg, family="dense",
                                                pattern=("attn+mlp",)), b, l)
    enc = cfg.n_enc_layers * (2 * b * lm * (w_attn + 3 * d * f))
    cross = cfg.n_layers * (2 * b * l * 2 * q * d + 2 * b * lm * 2 * d * kv)
    assert work["mm"] - dec["mm"] == enc + cross + 2 * b * lm * d * d
    heads, dh = cfg.n_heads, cfg.head_dim
    assert work["fp32"] - dec["fp32"] == (
        cfg.n_enc_layers * 4 * b * heads * lm * lm * dh
        + cfg.n_layers * 4 * b * heads * l * lm * dh)
    assert work["cross_bytes"] == cfg.n_layers * 2 * b * lm * kv * 2
    vlm = get_config("llama-3.2-vision-11b")
    work = C.lm_forward_work(vlm, b, l, vlm.n_img_tokens)
    assert work["enc_weights"] == vlm.d_frontend * vlm.d_model + 8 * 2 * (
        vlm.d_model * vlm.kv_dim)
    # Prefill reads the image projection and the memory's K/V weights
    # (fp32); a decode step reads the K/V cache and the cached memory K/V
    # instead.
    bound = C.serve_bound_ms(vlm, b, l, l + 1, mem_len=vlm.n_img_tokens)
    assert bound["prefill_bytes"] - bound["decode_step_bytes"] == \
        4 * work["enc_weights"] - work["kv_bytes"] * (l + 1) \
        - work["cross_bytes"]


# ---------------------------------------------------------------------------
# The hand count against the dry-run's counter (launch.flops)
# ---------------------------------------------------------------------------

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch import flops as TF  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.models.params import ShapeDtypeStruct, \
    abstract_params  # noqa: E402

B, L = 2, 32


def _mem_len(cfg, seq):
    return {"encdec": seq, "vlm": cfg.n_img_tokens}.get(cfg.family, 0)


def _counted_forward(cfg, b, seq):
    """A forward of ``b`` x ``seq`` tokens (no remat) counted on meta."""
    args = [abstract_params(TM.model_specs(cfg)),
            ShapeDtypeStruct((b, seq), torch.int32)]
    d_in = cfg.d_frontend or cfg.d_model
    names = []
    if cfg.family == "encdec":
        names, args = ["frames"], args + [
            ShapeDtypeStruct((b, seq, d_in), torch.float32)]
    if cfg.family == "vlm":
        names, args = ["img"], args + [
            ShapeDtypeStruct((b, cfg.n_img_tokens, d_in), torch.float32)]

    def fwd(params, tokens, *extra):
        return TM.forward(cfg, params, tokens, remat=False,
                          **dict(zip(names, extra)))

    return TF.step_costs(fwd, *args)


def _moe_slots(cfg, tokens):
    """The routed experts' products run over every padded (E_pad, cap)
    slot, the hand count over the top_k pairs: the bf16 FLOPs between,
    over the MoE layers."""
    n_moe = sum("+moe" in k for k in cfg.pattern) * cfg.n_repeats
    f = cfg.d_ff_expert or cfg.d_ff
    cap = capacity(tokens, cfg.top_k, cfg.capacity_factor,
                   cfg.n_experts_padded)
    return n_moe * 2 * 3 * cfg.d_model * f * (
        cfg.n_experts_padded * cap - tokens * cfg.top_k)


def _ssd_k1(cfg, b, seq):
    """The SSD's two K=1 einsum products a layer (the chunk states' decay
    factor, and ``y_off``'s), which the counter counts as the reference
    does (``launch.flops``) and the hand count leaves out (elementwise)."""
    n_mamba = sum(k.startswith("mamba") for k in cfg.pattern) \
        * cfg.n_repeats
    c = min(cfg.ssm_chunk, seq)
    lp = -(-seq // c) * c
    return n_mamba * 2 * 2 * b * lp * cfg.ssm_heads * cfg.ssm_headdim


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_work_is_the_counted_forward(arch):
    """``lm_forward_work``'s ``mm`` / ``fp32`` against a smoke forward
    counted by ``launch.flops``: equal for the dense and memory families;
    for the MoE the padded slots, for the SSD its K=1 products."""
    cfg = smoke_config(arch)
    got = _counted_forward(cfg, B, L)
    work = C.lm_forward_work(cfg, B, L, _mem_len(cfg, L))
    moe = _moe_slots(cfg, B * L) if cfg.n_experts else 0
    assert got["flops_bf16"] == work["mm"] + moe
    assert got["flops_fp32"] == work["fp32"] + _ssd_k1(cfg, B, L)


def _train_specs(cfg, b):
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.models import steps as S
    specs = S.input_specs(cfg, ShapeSpec("t", L, b, "train"))
    seq = specs["tokens"].shape[1]
    mem = specs["frames"].shape[1] if "frames" in specs else _mem_len(cfg, seq)
    return specs, seq, mem


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen3-32b"])
def test_train_step_work_is_train_bound_ms(arch):
    """A [train]-style step (2 microbatches, remat) counted on meta equals
    ``train_bound_ms``'s ``mm_flops`` / ``fp32_flops``: forward, two
    backward products, and the recompute the step runs, which leaves out
    the unembedding (outside the checkpoints) and each group's down
    projection (``lm_forward_work``'s ``mm_recompute``)."""
    from repro_torch import optim
    from repro_torch.models import steps as S
    cfg = smoke_config(arch)
    b = 4
    opt = optim.make_optimizer(cfg.optimizer)
    specs, seq, _ = _train_specs(cfg, b)
    got = TF.step_costs(S.make_train_step(cfg, opt, grad_accum=2),
                        S.train_state_specs(cfg, opt), specs)
    bound = C.train_bound_ms(cfg, b * seq, seq, 0)
    assert got["flops_bf16"] == bound["mm_flops"]
    assert got["flops_fp32"] == bound["fp32_flops"]


def _recomputes(cfg):
    """``(kind, whole, cut)`` of each decoder layer of the pattern: how
    often a remat backward reruns it whole and how often all but its last
    product, over the repeats. A group of more than two layers checkpoints
    each layer too: its recompute runs every layer but the last whole,
    and each layer's own recompute all but its last product."""
    k = len(cfg.pattern)
    for j, kind in enumerate(cfg.pattern):
        whole = int(j < k - 1)
        cut = int(j == k - 1 or k > 2)
        yield kind, whole * cfg.n_repeats, cut * cfg.n_repeats


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_recompute_is_the_counted_recompute(arch):
    """What a remat backward recomputes, counted on meta (the gradient
    with remat less the gradient without), against ``lm_forward_work``'s
    ``mm_recompute`` / ``fp32_recompute``. Per site: an MoE layer's routed
    products run over every padded (E_pad, cap) slot, the hand count over
    the top_k pairs, three products each time the layer reruns (its last
    product is the shared experts' down projection or, without them, none:
    the combine saves the routed output); each mamba layer rerun adds its
    two K=1 SSD products (``_ssd_k1``)."""
    from repro_torch.models import steps as S
    cfg = smoke_config(arch)
    b = 2
    specs, seq, mem = _train_specs(cfg, b)
    params = abstract_params(TM.model_specs(cfg))

    def counted(remat):
        def grads(params, batch):
            params = {k: _requiring_grad(v) for k, v in params.items()}
            S.loss_and_grads(cfg, params, batch, remat=remat)
        return TF.step_costs(grads, params, specs)

    on, off = counted(True), counted(False)
    work = C.lm_forward_work(cfg, b, seq, mem)
    tokens, d = b * seq, cfg.d_model
    f = cfg.d_ff_expert or cfg.d_ff
    slots = 0
    if cfg.n_experts:
        cap = capacity(tokens, cfg.top_k, cfg.capacity_factor,
                       cfg.n_experts_padded)
        slots = 2 * d * f * (cfg.n_experts_padded * cap - tokens * cfg.top_k)
    moe = sum(slots * 3 * (whole + cut)
              for kind, whole, cut in _recomputes(cfg) if "+moe" in kind)
    one_ssd = _ssd_k1(dataclasses.replace(
        cfg, pattern=("mamba",), n_layers=1), b, seq)
    ssd = sum(one_ssd * (whole + cut)
              for kind, whole, cut in _recomputes(cfg)
              if kind.startswith("mamba"))
    assert on["flops_bf16"] - off["flops_bf16"] == work["mm_recompute"] + moe
    assert on["flops_fp32"] - off["flops_fp32"] == \
        work["fp32_recompute"] + ssd


def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True) \
        if tree.is_floating_point() else tree


def test_dryrun_predict_is_the_dryruns_count():
    """``chip_smoke.dryrun_predict`` (the [dryrun] phase's predictions)
    is ``launch.dryrun.count_step`` on the host mesh, with the roofline of
    ``launch.roofline`` on ``launch.mesh.HW``, whose rates the script's own
    bounds read too."""
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import dryrun as TD
    from repro_torch.launch.mesh import HW, make_host_mesh
    cfg = smoke_config("phi3-mini-3.8b")
    shape = ShapeSpec("t", L, 4, "train")
    got = C.dryrun_predict(cfg, shape, grad_accum=2)
    counted = TD.count_step(cfg, shape, make_host_mesh(), grad_accum=2)
    for k, v in counted["costs"].items():
        assert got[k] == v, k
    assert got["predicted_peak_bytes"] == counted["argument_bytes"] \
        + counted["costs"]["peak_bytes"]
    compute = (got["flops_bf16"] / HW["peak_flops_bf16"]
               + got["flops_fp32"] / HW["peak_flops_fp32"])
    memory = got["hbm_bytes_model"] / HW["hbm_bw"]
    assert got["bound_ms"] == max(compute, memory) * 1e3
    assert got["dominant"] == ("compute_s" if compute >= memory
                               else "memory_s")
    assert [C.hw_peak(k) for k in ("hbm_bw", "peak_flops_bf16",
                                   "peak_flops_fp32")] == [
        3.35e12, 989e12, 67e12]
