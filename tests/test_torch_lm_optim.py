"""The port's optimizers (``repro_torch.optim``) against ``repro.optim``.

On identical numpy parameters, gradients and state, over 5 steps, AdamW
and Adafactor (a stacked 3-D leaf and a 2-D leaf, factored; a 1-D leaf,
unfactored) give parameters and moments within 1e-6 of each leaf's
max|·|; once at the default slice size and once with slices of a few
elements, so the sliced passes over a leaf's leading axis are exercised.
Also the schedule, the global norm and its clip, the state specs, the
in-place contract and the reference's quadratic-decrease test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as JO  # noqa: E402
from repro.models.params import ParamSpec as JSpec  # noqa: E402
from repro.models.params import abstract_params  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.models.params import ParamSpec, init_params, \
    iter_leaves  # noqa: E402

SHAPES = {"blocks": {"w": (3, 6, 5)}, "e": (7, 4), "b": (5,)}


def _tree(fn, shapes=SHAPES, path=()):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v, path + (k,)) for k, v in shapes.items()}
    return fn(path, shapes)


def _rand(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return _tree(lambda _, s: (scale * rng.standard_normal(s)
                               ).astype(np.float32))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return _tree(lambda p, _: torch.from_numpy(
        np.array(_at(tree, p))), SHAPES)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close_tree(got, want, tol, what):
    for path, g in iter_leaves(got):
        w = np.asarray(_at(want, path), np.float32)
        g = g.numpy()
        assert g.shape == w.shape, (what, path)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("chunk", [None, 7], ids=["default", "sliced"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_over_five_steps(name, chunk,
                                                     monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(TO, "_CHUNK", chunk)
    jopt = JO.make_optimizer(name, JO.cosine_schedule(1e-2, 2, 10))
    topt = TO.make_optimizer(name, TO.cosine_schedule(1e-2, 2, 10))
    p0 = _rand(0)
    jp, tp = _j(p0), _t(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _rand(100 + step, scale=0.3 + step)
        jp, js = jopt.update(_j(g), js, jp)
        out_p, out_s = topt.update(_t(g), ts, tp)
        assert out_p is tp and out_s is ts           # in place
    _close_tree(tp, jp, 1e-6, f"{name} params")
    moments = ("m", "v") if name == "adamw" else ("v",)
    for key in moments:
        _close_tree(ts[key], js[key], 1e-6, f"{name} {key}")
    assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
    assert int(ts["count"]) == int(js["count"]) == 5


@pytest.mark.parametrize("peak,warmup,total,floor", [
    (3e-4, 100, 10_000, 0.1), (1e-3, 2, 10, 0.1), (1e-2, 5, 40, 0.0)])
def test_cosine_schedule_matches_reference(peak, warmup, total, floor):
    jlr = JO.cosine_schedule(peak, warmup, total, floor)
    tlr = TO.cosine_schedule(peak, warmup, total, floor)
    # Every step through warmup and past it, then strided to total + 5.
    steps = sorted(set(range(min(total + 6, warmup + 50)))
                   | set(range(0, total + 6, max(1, total // 50)))
                   | set(range(total - 5, total + 6)))
    for s in steps:
        want = float(jlr(jnp.int32(s)))
        got = tlr(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=f"step {s}")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = _rand(7, scale=0.2)
    jn = float(JO.global_norm(_j(tree)))
    tt = _t(tree)
    np.testing.assert_allclose(float(TO.global_norm(tt)), jn, rtol=1e-6)
    jc, jnorm = JO.clip_by_global_norm(_j(tree), max_norm)
    tc, tnorm = TO.clip_by_global_norm(tt, max_norm)
    assert tc is tt                                   # scaled in place
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    _close_tree(tc, jc, 1e-6, "clipped")


def test_clip_by_global_norm():
    tree = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = TO.clip_by_global_norm(tree, 1.0)
    assert np.isclose(float(norm), np.sqrt(10 * 9 + 10 * 16))
    assert float(TO.global_norm(clipped)) <= 1.0 + 1e-5


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_specs_match_init_and_reference(name):
    opt = TO.make_optimizer(name)
    pspecs = {"a": ParamSpec((6, 4), ("embed", "mlp")),
              "b": ParamSpec((5,), (None,)),
              "c": ParamSpec((3, 6, 4), ("layers", "embed", "mlp"))}
    params = init_params(pspecs, seed=0, device="cpu")
    state = opt.init(params)
    built = init_params(opt.state_specs(pspecs), seed=0, device="cpu")
    shapes = lambda t: {"/".join(p): (tuple(x.shape), x.dtype)
                        for p, x in iter_leaves(t)}
    assert shapes(state) == shapes(built)
    assert all(not x.any() for _, x in iter_leaves(built))
    jspecs = {k: JSpec(s.shape, s.axes) for k, s in pspecs.items()}
    jabs = abstract_params(JO.make_optimizer(name).state_specs(jspecs))
    jshapes = {"/".join(str(getattr(k, "key", k)) for k in path):
               tuple(x.shape)
               for path, x in jax.tree_util.tree_flatten_with_path(jabs)[0]}
    assert {k: v[0] for k, v in shapes(state).items()} == jshapes


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    opt = TO.make_optimizer(name, lambda s: torch.tensor(0.1))
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32))
    params = {"w": torch.zeros((4, 8))}
    state = opt.init(params)
    loss = lambda p: torch.sum((p["w"] - target) ** 2)
    l0 = float(loss(params))
    for _ in range(60):
        g = {"w": 2 * (params["w"] - target)}
        params, state = opt.update(g, state, params)
    assert float(loss(params)) < 0.05 * l0


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.make_optimizer("sgd")
