"""The port's Mamba2 SSD mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the same weights and inputs, mirroring
``tests/test_ssm.py``: ``_ssd_chunked`` at chunks 4, 8 and 32 (a tail that
is not a whole chunk included) within 1e-5 of max|y|, the chunked form
against the literal recurrence, ``mamba_apply`` at float32 (1e-5) and
bfloat16 (2e-2) activations, the prefill cache and a decode step against
the reference's (``mamba_prefill`` against its ``blocks._mamba_prefill``),
decode after prefill against the full forward, the cache
shapes and dtypes, and the masked decay at a full-size chunk of 256
staying finite."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

# The reference's calls jitted: one compile per shape, not one per op.
j_ssd = jax.jit(JS._ssd_chunked, static_argnums=(4,))
j_apply = jax.jit(JS.mamba_apply, static_argnums=(2,))
j_prefill = jax.jit(JB._mamba_prefill, static_argnums=(0,))
j_decode = jax.jit(JS.mamba_decode, static_argnums=(3,))


def _close(got, want, tol, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _ssd_inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dA = -np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.5
    B = rng.standard_normal((b, l, h, n)).astype(np.float32)
    C = rng.standard_normal((b, l, h, n)).astype(np.float32)
    return xdt, dA, B, C


def naive_ssd(xdt, dA, B, C):
    """Literal recurrence h_t = exp(dA_t)·h_{t-1} + B_t xdt_t; y_t = C_t·h_t."""
    b, l, h, p = xdt.shape
    S = np.zeros((b, h, p, B.shape[-1]))
    ys = np.zeros((b, l, h, p))
    for t in range(l):
        S = np.exp(dA[:, t])[..., None, None] * S + np.einsum(
            "bhn,bhp->bhpn", B[:, t], xdt[:, t])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", C[:, t], S)
    return ys


@pytest.mark.parametrize("chunk, l", [(4, 16), (8, 16), (8, 21), (32, 40),
                                      (32, 16)])
def test_ssd_chunked_matches_reference(chunk, l):
    ins = _ssd_inputs(2, l, 3, 4, 5)
    want = j_ssd(*map(jnp.asarray, ins), chunk)
    got = TS._ssd_chunked(*map(torch.from_numpy, ins), chunk)
    assert got.shape == (2, l, 3, 4) and got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_ssd_matches_recurrence(chunk):
    ins = _ssd_inputs(2, 16, 3, 4, 5)
    got = TS._ssd_chunked(*map(torch.from_numpy, ins), chunk)
    np.testing.assert_allclose(got.numpy(), naive_ssd(*ins), rtol=2e-4,
                               atol=2e-4)


def test_masked_decay_stays_finite_at_a_full_chunk():
    """256 steps of dA = -1.9 in one chunk: exp(seg) above the diagonal
    overflows to inf and must be masked by ``where``, not multiplied."""
    xdt, _, B, C = _ssd_inputs(1, 256, 2, 4, 3, seed=1)
    dA = np.full((1, 256, 2), -1.9, np.float32)
    got = TS._ssd_chunked(*map(torch.from_numpy, (xdt, dA, B, C)), 256)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), naive_ssd(xdt, dA, B, C),
                               rtol=2e-4, atol=2e-4)


def _mamba(act="float32", seed=0):
    jcfg = dataclasses.replace(j_smoke("mamba2-370m"), act_dtype=act)
    tcfg = dataclasses.replace(t_smoke("mamba2-370m"), act_dtype=act)
    tp = TP.init_params({"m": TS.mamba_specs(tcfg)}, seed=seed,
                        device="cpu")["m"]
    with torch.no_grad():          # non-trivial decays and biases
        g = torch.Generator().manual_seed(seed)
        tp["A_log"].copy_(torch.rand(tp["A_log"].shape, generator=g) * 1.5)
        tp["dt_bias"].copy_(torch.randn(tp["dt_bias"].shape, generator=g))
        tp["conv_b"].copy_(0.1 * torch.randn(tp["conv_b"].shape,
                                             generator=g))
    return jcfg, tcfg, jax.tree.map(lambda t: t.numpy(), tp), tp


def _xs(cfg, b, l, act, seed=1):
    x = (np.random.default_rng(seed).standard_normal((b, l, cfg.d_model))
         * 0.5).astype(np.float32)
    return jnp.asarray(x, act), torch.from_numpy(x).to(TP.torch_dtype(act))


@pytest.mark.parametrize("act, tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("l", [16, 21])
def test_mamba_apply_matches_reference(act, tol, l):
    jcfg, tcfg, jp, tp = _mamba(act)
    jx, tx = _xs(tcfg, 2, l, act)
    want = j_apply(jp, jx, jcfg)
    got = TS.mamba_apply(tp, tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, tol)


@pytest.mark.parametrize("act, tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_prefill_cache_and_decode_match_reference(act, tol):
    jcfg, tcfg, jp, tp = _mamba(act, seed=2)
    jx, tx = _xs(tcfg, 2, 13, act, seed=2)
    jout, jcache = j_prefill(jcfg, jp, jx[:, :12])
    out, cache = TS.mamba_prefill(tp, tx[:, :12], tcfg)
    _close(out, jout, tol)
    for name in ("conv", "ssd"):
        assert cache[name].dtype == torch.float32
        assert tuple(cache[name].shape) == jcache[name].shape
        _close(cache[name], jcache[name], tol, name)
    jdec, jnew = j_decode(jp, jx[:, 12:], jcache, jcfg)
    dec, new = TS.mamba_decode(tp, tx[:, 12:], cache, tcfg)
    assert dec.dtype == tx.dtype
    _close(dec, jdec, tol if act == "float32" else 3e-2)
    for name in ("conv", "ssd"):
        assert new[name].dtype == torch.float32
        _close(new[name], jnew[name], tol if act == "float32" else 3e-2,
               name)


def test_mamba_decode_matches_full_forward():
    """Prefill state + decode step == the full-sequence forward's last
    output (the reference test's 3e-3)."""
    _, cfg, _, params = _mamba("float32", seed=3)
    _, x = _xs(cfg, 2, 17, "float32", seed=3)
    full = TS.mamba_apply(params, x, cfg)
    _, cache = TS.mamba_prefill(params, x[:, :16], cfg)
    dec, _ = TS.mamba_decode(params, x[:, 16:], cache, cfg)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, 16].numpy(),
                               rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("name", ["mamba2-370m", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
def test_cache_shapes_and_specs_equal_the_reference(name, smoke):
    from repro.configs import get_config as j_get
    from repro_torch.configs import get_config as t_get
    jcfg = j_smoke(name) if smoke else j_get(name)
    tcfg = t_smoke(name) if smoke else t_get(name)
    assert TS.mamba_cache_shape(tcfg, 3) == JS.mamba_cache_shape(jcfg, 3)
    di, g, n = tcfg.d_inner, tcfg.ssm_groups, tcfg.d_state
    shapes = TS.mamba_cache_shape(tcfg, batch=3)
    assert shapes["conv"] == (3, tcfg.d_conv - 1, di + 2 * g * n)
    assert shapes["ssd"] == (3, tcfg.ssm_heads, tcfg.ssm_headdim, n)
    kind = next(k for k in tcfg.pattern if k.startswith("mamba"))
    t = TB.block_cache_specs(tcfg, kind, 3, 32, 0)
    j = JB.block_cache_specs(jcfg, kind, 3, 32, 0)
    assert set(t) == set(j) == {"conv", "ssd"}
    for leaf, (shape, axes, dtype) in j.items():
        assert t[leaf][:2] == (shape, axes)
        assert t[leaf][2] == torch.float32 == TP.torch_dtype(
            np.dtype(dtype).name)
