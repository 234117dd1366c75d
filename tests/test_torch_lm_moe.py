"""The port's MoE (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the same weights and inputs, mirroring
``tests/test_moe.py``: the router's ids exactly, its probabilities and
aux loss to float32 rounding, ``moe_apply`` within 1e-5 of max|y| at
float32 activations (2e-2 at bfloat16) for top-k 1/2/4 with and without
a shared expert, the drop counts equal, the per-token dense reference,
padding experts never routed, and a combine that gives the same bits on
a rerun."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import moe as JMoE  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

D, F = 16, 32
# The reference's calls jitted: one compile per shape, not one per op.
j_router = jax.jit(JMoE.router_assign, static_argnums=(2, 3))
j_moe = jax.jit(JMoE.moe_apply, static_argnames=(
    "n_real", "top_k", "capacity_factor", "deterministic_cap", "impl"))


def _params(E, n_shared, n_real=None, seed=0):
    """The port's seeded draw, and the same values as numpy for the
    reference."""
    specs = {"m": TMoE.moe_specs(D, F, E, n_shared, n_real or E)}
    tp = TP.init_params(specs, seed=seed, device="cpu")["m"]
    return jax.tree.map(lambda t: t.numpy(), tp), tp


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(x).to(TP.torch_dtype(dtype))


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_router_assign_matches_reference(top_k):
    jp, tp = _params(8, 0, n_real=6, seed=1)
    jx, tx = _x((64, D), 1)
    jprobs, jids, jaux = j_router(jx, jp["router"], 6, top_k)
    probs, ids, aux = TMoE.router_assign(tx, tp["router"], 6, top_k)
    assert ids.dtype == torch.int32 and ids.shape == (64, top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k,n_shared", [(1, 0), (1, 1), (2, 0), (2, 1),
                                            (4, 0), (4, 1)])
def test_moe_apply_matches_reference(top_k, n_shared, dtype):
    """Default capacity (1.25): some pairs drop; the counts, the aux loss
    and the output agree."""
    jp, tp = _params(8, n_shared, n_real=6, seed=2)
    jx, tx = _x((2, 24, D), 2, dtype)
    jy, jm = j_moe(jp, jx, n_real=6, top_k=top_k)
    y, m = TMoE.moe_apply(tp, tx, n_real=6, top_k=top_k)
    assert y.shape == (2, 24, D) and y.dtype == tx.dtype
    assert int(m["moe_dropped"]) == int(jm["moe_dropped"])
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               rtol=1e-6)
    _close(y, jy, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("top_k,n_shared", [(1, 0), (2, 1), (4, 1)])
def test_moe_matches_dense_reference_with_ample_capacity(top_k, n_shared):
    """The reference test's per-token loop over each token's top-k
    experts (no capacity, no buckets), in numpy on the port's routing."""
    _, tp = _params(4, n_shared, seed=3)
    _, tx = _x((2, 8, D), 3)
    y, m = TMoE.moe_apply(tp, tx, n_real=4, top_k=top_k,
                          deterministic_cap=64)
    assert int(m["moe_dropped"]) == 0
    xf = tx.reshape(-1, D).numpy()
    probs, ids, _ = TMoE.router_assign(tx.reshape(-1, D), tp["router"], 4,
                                       top_k)
    wg, wu, wd = (tp[k].numpy() for k in ("w_gate", "w_up", "w_down"))
    silu = lambda g: g / (1 + np.exp(-g))  # noqa: E731
    want = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(top_k):
            e = int(ids[t, j])
            want[t] += float(probs[t, j]) * (
                (silu(xf[t] @ wg[e]) * (xf[t] @ wu[e])) @ wd[e])
    if n_shared:
        sh = {k: v.numpy() for k, v in tp["shared"].items()}
        want += (silu(xf @ sh["w_gate"]) * (xf @ sh["w_up"])) @ sh["w_down"]
    np.testing.assert_allclose(y.reshape(-1, D).numpy(), want, rtol=3e-4,
                               atol=3e-4)


def test_padding_experts_never_routed():
    _, tp = _params(4, 0, n_real=3, seed=1)
    _, tx = _x((64, D), 1)
    probs, ids, _ = TMoE.router_assign(tx, tp["router"], 3, 2)
    assert int(ids.max()) < 3
    # their softmax mass is exactly zero, so the renormalised pair sums to 1
    torch.testing.assert_close(probs.sum(-1), torch.ones(64))
    # zeroing the padding experts' weights changes nothing
    y_pad_zeroed, _ = TMoE.moe_apply(
        dict(tp, w_down=torch.cat([tp["w_down"][:3],
                                   torch.zeros_like(tp["w_down"][3:])])),
        tx[None], n_real=3, top_k=2)
    y, _ = TMoE.moe_apply(tp, tx[None], n_real=3, top_k=2)
    assert torch.equal(y, y_pad_zeroed)


def test_overflow_drops_are_counted_as_the_reference():
    jp, tp = _params(2, 0, seed=2)
    jx, tx = _x((1, 64, D), 2)
    jy, jm = j_moe(jp, jx, n_real=2, top_k=1, deterministic_cap=4)
    y, m = TMoE.moe_apply(tp, tx, n_real=2, top_k=1, deterministic_cap=4)
    # 64 tokens into 2 experts with cap 4 → at least 56 dropped
    assert int(m["moe_dropped"]) == int(jm["moe_dropped"]) >= 56
    assert torch.isfinite(y).all()
    _close(y, jy, 1e-5)
    # a dropped token's row is zero (no shared expert)
    assert int((y.reshape(64, D).abs().sum(-1) == 0).sum()) == \
        int(m["moe_dropped"])


@pytest.mark.parametrize("T, k, cf, E", [(8192, 4, 1.25, 64),
                                         (8200, 4, 1.25, 64),
                                         (8, 4, 1.25, 64), (48, 2, 16.0, 16),
                                         (7, 1, 1.25, 16)])
def test_capacity_is_the_reference_formula(T, k, cf, E):
    want = max(8, int(-(-T * k * cf // E)))
    assert TMoE.capacity(T, k, cf, E) == want
    assert TMoE.capacity(T, k, cf, E, deterministic_cap=5) == 5


def test_full_config_capacities():
    """qwen2-moe-a2.7b's prefill (8 × 1024 tokens) and teacher-forced
    forward (8 × 1025) over its 64 padded experts: 640 and 641 slots."""
    assert TMoE.capacity(8 * 1024, 4, 1.25, 64) == 640
    assert TMoE.capacity(8 * 1025, 4, 1.25, 64) == 641


def test_combine_gives_the_same_bits_on_a_rerun():
    _, tp = _params(8, 1, n_real=6, seed=4)
    _, tx = _x((2, 40, D), 4, "bfloat16")
    a, _ = TMoE.moe_apply(tp, tx, n_real=6, top_k=4)
    b, _ = TMoE.moe_apply(tp, tx, n_real=6, top_k=4)
    assert torch.equal(a, b)


def test_impls_without_a_mesh_all_gather_and_owner_raises():
    _, tp = _params(8, 0, n_real=6, seed=5)
    _, tx = _x((1, 16, D), 5)
    outs = [TMoE.moe_apply(tp, tx, n_real=6, top_k=2, impl=i)[0]
            for i in ("auto", "owner", "gather")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    with pytest.raises(NotImplementedError, match="A15"):
        TMoE.moe_apply_owner(tp, tx, n_real=6, top_k=2)
    with pytest.raises(ValueError, match="unknown moe impl"):
        TMoE.moe_apply(tp, tx, n_real=6, top_k=2, impl="scatter")


def test_specs_equal_the_reference():
    from repro.models import params as JP
    for n_shared in (0, 2):
        t = dict(TP.iter_leaves(TMoE.moe_specs(D, F, 64, n_shared, 60)))
        j = dict(JP._iter_leaves(JMoE.moe_specs(D, F, 64, n_shared, 60)))
        assert list(t) == list(j)
        for path, js in j.items():
            ts = t[path]
            assert (ts.shape, ts.axes, ts.init, ts.fan_in_dims) == \
                (js.shape, js.axes, js.init, js.fan_in_dims)
            assert str(ts.dtype).replace("torch.", "") == \
                np.dtype(js.dtype).name
