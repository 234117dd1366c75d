"""The least-time bounds ``chip_smoke.py`` prints beside its LM phases,
from the shapes alone (no card): ``lm_forward_work``, ``serve_bound_ms``
and ``train_bound_ms`` keep the numbers they gave before they counted the
encoder and cross-attention (phi3-mini-3.8b's 109.267 ms prefill and
489.233 ms train-step bounds, mamba2-370m's 29.854 ms prefill, PERF.md
§5), and count the memory families' extra work term by term."""
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
    got = C.train_bound_ms(get_config("phi3-mini-3.8b"), 8192, 1024,
                           15_285_891_072)
    assert abs(got["step_bound_ms"] - 489.233) < 1e-3
    assert got["mm_flops"] == 4 * C.lm_forward_work(
        get_config("phi3-mini-3.8b"), 8, 1024)["mm"]


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
