"""The LM configs, parameter specs and init of the port against the JAX
package: every config field for field, the analytic parameter counts, the
smoke reductions, the shape grid and its skip rules, ``model_specs`` and
``cache_specs`` leaf for leaf, and an init that is stable across
processes at the reference's scales."""
import dataclasses
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(jreg.ARCHS)
DENSE = sorted(n for n, c in jreg.ARCHS.items() if c.family == "dense")
NOT_DENSE = sorted(set(ARCHS) - set(DENSE))
# The families the port serves beyond the dense one.
SERVED = sorted(n for n, c in jreg.ARCHS.items()
                if c.family in ("moe", "ssm", "hybrid"))
DERIVED = ("q_dim", "kv_dim", "vocab_padded", "n_experts_padded",
           "n_repeats", "d_inner", "ssm_heads")


def test_the_registry_holds_the_same_archs():
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    assert len(DENSE) == 4 and "phi3-mini-3.8b" in DENSE


@pytest.mark.parametrize("name", ARCHS)
def test_published_config_field_for_field(name):
    t, j = treg.get_config(name), jreg.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in DERIVED:
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_param_count(name, active_only):
    assert treg.get_config(name).param_count(active_only) == \
        jreg.get_config(name).param_count(active_only)


@pytest.mark.parametrize("name", ARCHS)
def test_smoke_config(name):
    t, j = treg.smoke_config(name), jreg.smoke_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()


@pytest.mark.parametrize("name", ARCHS)
def test_shape_grid_and_skip_reasons(name):
    assert {k: dataclasses.asdict(v) for k, v in treg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jreg.SHAPES.items()}
    for shape in jreg.SHAPES:
        t = treg.skip_reason(treg.get_config(name), treg.SHAPES[shape])
        j = jreg.skip_reason(jreg.get_config(name), jreg.SHAPES[shape])
        assert t == j
        assert treg.applicable(treg.get_config(name), treg.SHAPES[shape]) \
            == (j is None)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_shape(kind):
    assert dataclasses.asdict(treg.smoke_shape(kind)) == \
        dataclasses.asdict(jreg.smoke_shape(kind))


def test_unknown_arch_raises_like_the_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("gpt-9")


def _dtype_name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _specs_equal(tspecs, jspecs):
    t = dict(TP.iter_leaves(tspecs))
    j = dict(JP._iter_leaves(jspecs))
    assert list(t) == list(j)
    for path in j:
        ts, js = t[path], j[path]
        assert (ts.shape, ts.axes, ts.init, ts.fan_in_dims) == \
            (js.shape, js.axes, js.init, js.fan_in_dims), path
        assert _dtype_name(ts.dtype) == _dtype_name(js.dtype), path


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("name", DENSE + SERVED)
def test_model_specs_leaf_for_leaf(name, smoke):
    get = "smoke_config" if smoke else "get_config"
    tcfg, jcfg = getattr(treg, get)(name), getattr(jreg, get)(name)
    tspecs, jspecs = TM.model_specs(tcfg), JM.model_specs(jcfg)
    _specs_equal(tspecs, jspecs)
    assert TP.spec_bytes(tspecs) == JP.spec_bytes(jspecs)


@pytest.mark.parametrize("name", DENSE + SERVED)
@pytest.mark.parametrize("batch, seq", [(2, 32), (8, 1057)])
def test_cache_specs_equal(name, batch, seq):
    t = TM.cache_specs(treg.smoke_config(name), batch, seq, 0)
    j = JM.cache_specs(jreg.smoke_config(name), batch, seq, 0)
    assert set(t) == set(j)
    for grp in j:
        assert set(t[grp]) == set(j[grp])
        for leaf, (shape, axes, dtype) in j[grp].items():
            tshape, taxes, tdtype = t[grp][leaf]
            assert (tshape, taxes) == (shape, axes)
            assert _dtype_name(tdtype) == _dtype_name(dtype)


def test_phi3_is_the_size_the_card_holds():
    cfg = treg.get_config("phi3-mini-3.8b")
    nbytes = TP.spec_bytes(TM.model_specs(cfg))
    # fp32; param_count leaves out the final norm (out_norm, d_model)
    assert nbytes == 4 * (cfg.param_count() + cfg.d_model)
    assert 15.2e9 < nbytes < 15.4e9


def test_the_served_moe_and_ssm_models_are_the_size_the_card_holds():
    """qwen2-moe-a2.7b (experts padded 60 → 64) and mamba2-370m at fp32:
    each fits one 80 GB card with room for its caches."""
    moe = TP.spec_bytes(TM.model_specs(treg.get_config("qwen2-moe-a2.7b")))
    assert moe == 60_585_025_536
    ssm = TP.spec_bytes(TM.model_specs(treg.get_config("mamba2-370m")))
    assert 1.4e9 < ssm < 1.5e9


@pytest.mark.parametrize("name", sorted(set(NOT_DENSE) - set(SERVED)))
def test_other_families_raise_naming_a15(name):
    """``encdec`` and ``vlm`` still raise naming A15."""
    with pytest.raises(NotImplementedError, match="A15"):
        TM.model_specs(treg.smoke_config(name))


@pytest.mark.parametrize("name", SERVED)
def test_moe_ssm_and_hybrid_specs_equal_the_reference(name):
    """The MoE, SSM and hybrid families give the reference's specs leaf
    for leaf."""
    _specs_equal(TM.model_specs(treg.smoke_config(name)),
                 JM.model_specs(jreg.smoke_config(name)))


def test_int8_kv_cache_raises_naming_a15():
    cfg = dataclasses.replace(treg.smoke_config("qwen3-32b"),
                              kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="A15"):
        TM.model_specs(cfg)


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------

_DIGEST = (
    "import hashlib, sys, torch\n"
    "from repro_torch.configs import smoke_config\n"
    "from repro_torch.models import model as M, params as P\n"
    "p = P.init_params(M.model_specs(smoke_config('qwen3-32b')), seed=3, "
    "device='cpu')\n"
    "h = hashlib.sha256()\n"
    "for path, t in P.iter_leaves(p):\n"
    "    h.update('/'.join(path).encode()); h.update(t.numpy().tobytes())\n"
    "print(h.hexdigest())\n")


def _digest(params):
    h = hashlib.sha256()
    for path, t in TP.iter_leaves(params):
        h.update("/".join(path).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def test_init_is_equal_across_processes_with_other_hash_seeds():
    """The reference keys each leaf by ``hash(part)``, salted per process;
    the port's init gives the same weights under any ``PYTHONHASHSEED``."""
    outs = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   PYTHONHASHSEED=hash_seed)
        proc = subprocess.run([sys.executable, "-c", _DIGEST], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout.strip())
    assert outs[0] == outs[1]
    here = TP.init_params(TM.model_specs(treg.smoke_config("qwen3-32b")),
                          seed=3, device="cpu")
    assert _digest(here) == outs[0]


def test_init_depends_on_seed_and_path():
    specs = TM.model_specs(treg.smoke_config("phi3-mini-3.8b"))
    a = TP.init_params(specs, seed=0, device="cpu")
    b = TP.init_params(specs, seed=1, device="cpu")
    blk = a["blocks"]["p0"]
    assert not torch.equal(blk["wq"], b["blocks"]["p0"]["wq"])
    assert not torch.equal(blk["wq"], blk["wk"])        # same shape, own leaf
    assert not torch.equal(a["embed"], a["lm_head"])
    assert TP.leaf_seed(0, ("a", "b")) != TP.leaf_seed(0, ("ab",))


@pytest.mark.parametrize("name", DENSE)
def test_init_scales_are_the_reference_formula(name):
    """Each leaf: zeros / ones exact; ``small`` at std 0.02; ``normal`` at
    std 1/sqrt(fan_in) (fan-in over the stacked spec's fan-in dims), each
    within 10%."""
    cfg = treg.smoke_config(name)
    specs = TM.model_specs(cfg)
    params = TP.init_params(specs, seed=0, device="cpu")
    leaves = dict(TP.iter_leaves(params))
    for path, spec in TP.iter_leaves(specs):
        t = leaves[path]
        assert tuple(t.shape) == spec.shape and t.dtype == spec.dtype
        if spec.init == "ones":
            assert torch.equal(t, torch.ones_like(t))
            continue
        if spec.init == "zeros":
            assert torch.equal(t, torch.zeros_like(t))
            continue
        fan = spec.fan_in_dims or tuple(range(max(1, len(spec.shape) - 1)))
        want = 0.02 if spec.init == "small" else \
            1 / np.sqrt(np.prod([spec.shape[d] for d in fan]))
        got = float(t.float().std())
        assert abs(got / want - 1) < 0.1, (path, got, want)
        assert abs(float(t.float().mean())) < 0.1 * want
