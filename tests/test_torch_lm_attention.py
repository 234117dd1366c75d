"""The port's online-softmax attention against the JAX package's on the
same numpy inputs: ``flash_attention`` in every mode (causal, full, local)
with MHA and GQA heads, lengths that need chunk padding, ``exact_causal``'s
block skip, fully masked rows; ``decode_attention`` over a cache. 1e-5 in
float32; at bfloat16 both widen to float32 for the products and round the
probabilities to bf16 before PV, so they agree to bf16 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import attention as JA  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

TOL = 1e-5


def _t(a):
    return lm_params_from_reference({"x": a}, device="cpu")["x"]


def _close(got, want, tol=TOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _qkv(rng, b, lq, lk, h, kh, dh, dtype="float32"):
    q = jnp.asarray(rng.standard_normal((b, lq, h, dh)), dtype)
    k = jnp.asarray(rng.standard_normal((b, lk, kh, dh)), dtype)
    v = jnp.asarray(rng.standard_normal((b, lk, kh, dh)), dtype)
    return q, k, v


def _both(q, k, v, pos_q, pos_k, **kw):
    want = JA.flash_attention(q, k, v, pos_q=jnp.asarray(pos_q),
                              pos_k=jnp.asarray(pos_k), **kw)
    got = TA.flash_attention(_t(q), _t(k), _t(v),
                             pos_q=torch.from_numpy(pos_q),
                             pos_k=torch.from_numpy(pos_k), **kw)
    assert got.dtype == _t(q).dtype and got.shape == _t(q).shape
    return got, want


@pytest.mark.parametrize("l, qc, kc", [(37, 8, 16), (29, 16, 8),
                                       (13, 32, 32)])
@pytest.mark.parametrize("h, kh", [(4, 4), (8, 2)])
@pytest.mark.parametrize("mode, window, exact_causal", [
    ("causal", 0, False), ("causal", 0, True), ("full", 0, False),
    ("local", 8, False)])
def test_flash_matches_reference(mode, window, exact_causal, h, kh, l, qc,
                                 kc):
    rng = np.random.default_rng(l + h)
    b, dh = 2, 16
    q, k, v = _qkv(rng, b, l, l, h, kh, dh)
    pos = np.broadcast_to(np.arange(l, dtype=np.int32), (b, l)).copy()
    got, want = _both(q, k, v, pos, pos, mode=mode, window=window,
                      q_chunk=qc, kv_chunk=kc, exact_causal=exact_causal)
    _close(got, want)


@pytest.mark.parametrize("lq, lk, qc, kc", [(5, 23, 4, 8), (19, 40, 8, 16)])
def test_flash_cross_lengths_and_offsets(lq, lk, qc, kc):
    """Queries and keys of other lengths and position offsets (decode-like
    suffix queries), with padding on both sides."""
    rng = np.random.default_rng(lq * lk)
    q, k, v = _qkv(rng, 2, lq, lk, 8, 2, 16)
    pos_k = np.broadcast_to(np.arange(lk, dtype=np.int32), (2, lk)).copy()
    pos_q = pos_k[:, lk - lq:].copy()
    for mode in ("causal", "full"):
        got, want = _both(q, k, v, pos_q, pos_k, mode=mode, q_chunk=qc,
                          kv_chunk=kc)
        _close(got, want)


@pytest.mark.parametrize("exact_causal", [False, True])
def test_flash_bf16(exact_causal):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 40, 40, 8, 2, 16, "bfloat16")
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    got, want = _both(q, k, v, pos, pos, mode="causal", q_chunk=16,
                      kv_chunk=8, exact_causal=exact_causal)
    _close(got, want, 2 ** -7)


def test_flash_fully_masked_rows_are_finite_and_equal():
    """Every key after every query: all rows masked, the output finite (the
    probabilities are zeroed under the mask) and equal to the
    reference's."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 16, 16, 2, 2, 8)
    pos_q = np.zeros((1, 16), np.int32)
    pos_k = np.full((1, 16), 100, np.int32)
    got, want = _both(q, k, v, pos_q, pos_k, mode="causal", q_chunk=8,
                      kv_chunk=8)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_flash_chunk_invariance():
    rng = np.random.default_rng(1)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 64, 64, 4, 4, 8))
    pos = torch.arange(64, dtype=torch.int32)[None]
    outs = [TA.flash_attention(q, k, v, pos_q=pos, pos_k=pos, mode="causal",
                               q_chunk=qc, kv_chunk=kc)
            for qc, kc in [(8, 8), (16, 32), (64, 64)]]
    torch.testing.assert_close(outs[0], outs[1], rtol=TOL, atol=TOL)
    torch.testing.assert_close(outs[0], outs[2], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode, window, dtype", [
    ("causal", 0, "float32"), ("local", 8, "float32"),
    ("causal", 0, "bfloat16")])
@pytest.mark.parametrize("h, kh", [(4, 4), (8, 2)])
@pytest.mark.parametrize("cur", [0, 9, 23])
def test_decode_matches_reference(cur, h, kh, mode, window, dtype):
    rng = np.random.default_rng(cur + h)
    b, S, dh = 2, 24, 16
    q = jnp.asarray(rng.standard_normal((b, 1, h, dh)), dtype)
    kc = jnp.asarray(rng.standard_normal((b, S, kh, dh)), dtype)
    vc = jnp.asarray(rng.standard_normal((b, S, kh, dh)), dtype)
    want = JA.decode_attention(q, kc, vc, cur_pos=jnp.int32(cur), mode=mode,
                               window=window)
    got = TA.decode_attention(_t(q), _t(kc), _t(vc), cur_pos=cur, mode=mode,
                              window=window)
    assert got.dtype == _t(q).dtype and got.shape == (b, 1, h, dh)
    _close(got, want, TOL if dtype == "float32" else 2 ** -7)


def test_decode_matches_flash_last_position():
    rng = np.random.default_rng(2)
    q, k, v = (_t(a) for a in _qkv(rng, 2, 16, 16, 4, 2, 8))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    full = TA.flash_attention(q, k, v, pos_q=pos, pos_k=pos, mode="causal",
                              q_chunk=8, kv_chunk=8)
    dec = TA.decode_attention(q[:, -1:], k, v, cur_pos=15)
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=TOL, atol=TOL)
