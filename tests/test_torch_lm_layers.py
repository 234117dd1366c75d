"""The port's layer primitives (RMSNorm, RoPE, SwiGLU) against the JAX
package's on the same numpy inputs: 1e-5 in float32; at bfloat16 both
compute in float32 inside and round once, so they agree to one bf16 ulp
of the output."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import layers as JL  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

TOL = 1e-5
BF16_TOL = 2 ** -7          # one bf16 ulp, relative


def _t(a):
    return lm_params_from_reference({"x": a}, device="cpu")["x"]


def _np(t):
    return t.float().numpy()


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 7, 4, 16)])
def test_rms_norm(shape, dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(shape) * 3, dtype)
    w = jnp.asarray(1 + 0.1 * rng.standard_normal(shape[-1]), jnp.float32)
    want = JL.rms_norm(x, w)
    got = TL.rms_norm(_t(x), _t(w))
    assert got.dtype == TP.torch_dtype(dtype)
    _close(got, want, TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dh, theta", [(16, 1e4), (96, 1e4), (128, 1e6)])
def test_rope_freqs(dh, theta):
    _close(TL.rope_freqs(dh, theta), JL.rope_freqs(dh, theta), TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h, dh, theta", [(4, 16, 1e4), (2, 96, 1e4),
                                          (3, 128, 5e5)])
def test_apply_rope(h, dh, theta, dtype):
    rng = np.random.default_rng(1)
    b, l = 2, 9
    x = jnp.asarray(rng.standard_normal((b, l, h, dh)), dtype)
    pos = rng.integers(0, 2000, (b, l)).astype(np.int32)
    want = JL.apply_rope(x, jnp.asarray(pos), theta)
    got = TL.apply_rope(_t(x), torch.from_numpy(pos), theta)
    assert got.dtype == TP.torch_dtype(dtype)
    _close(got, want, TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_mlp(dtype):
    rng = np.random.default_rng(2)
    d, f = 64, 128
    x = jnp.asarray(rng.standard_normal((2, 7, d)), dtype)
    p = {k: jnp.asarray(rng.standard_normal(s) / np.sqrt(s[0]), jnp.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    want = JL.mlp_apply(p, x)
    tp = lm_params_from_reference(p, device="cpu")
    got = TL.mlp_apply(tp, _t(x))
    assert got.dtype == TP.torch_dtype(dtype)
    _close(got, want, TOL if dtype == "float32" else 2e-2)
    _close(TL.swiglu(_t(x), tp["w_gate"], tp["w_up"], tp["w_down"]), want,
           TOL if dtype == "float32" else 2e-2)


def test_specs_equal_the_reference():
    for t, j in ((TL.norm_spec(48), JL.norm_spec(48)),):
        assert (t.shape, t.axes, t.init) == (j.shape, j.axes, j.init)
    tm, jm = TL.mlp_specs(64, 128), JL.mlp_specs(64, 128)
    assert set(tm) == set(jm)
    for k in jm:
        assert (tm[k].shape, tm[k].axes, tm[k].init) == \
            (jm[k].shape, jm[k].axes, jm[k].init)
