"""The port's dense LM (``forward``, ``prefill``, ``decode_step``) against
the JAX package's on the same weights, for the smoke configs of the four
dense archs (qwen3-32b: qk_norm and GQA 4:2; minitron-8b and
internlm2-20b: GQA; phi3-mini-3.8b: MHA).

The reference's weights come across with
``convert.lm_params_from_reference`` in this process (its init is salted
per process, and no package can draw the other's stream). Two settings:

* ``act_dtype="float32"``: logits within 1e-4 of max|logits|; the K/V
  caches are bf16 in both packages, so a cache leaf may differ by one bf16
  ulp where the float32 value it rounds differs in its last bits;
* the configs' default ``bfloat16``: the reference's own tolerances,
  2e-2 (prefill, forward) and 3e-2 (decode), ``tests/test_archs_smoke.py``.

Also the reference's self-consistency checks, on the port: prefill's
logits equal the last position of ``forward``, and prefill + one decode
step equals teacher-forced ``forward``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

DENSE = ["internlm2-20b", "minitron-8b", "phi3-mini-3.8b", "qwen3-32b"]
B, L, LP = 2, 32, 16          # batch, forward length, prefill length
TOL = {"float32": (1e-4, 1e-4, 2 ** -8),        # forward, decode, cache
       "bfloat16": (2e-2, 3e-2, 2e-2)}


def _cfgs(name, act, **kw):
    kw = dict(kw, act_dtype=act)
    return (dataclasses.replace(j_smoke(name), **kw),
            dataclasses.replace(t_smoke(name), **kw))


def _grow(c):
    """One more cache slot for the decoded token (the reference test's
    ``grow``)."""
    if c.ndim == 5 and c.shape[2] == LP:
        return jnp.pad(c, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
    return c


def _port(tree):
    return lm_params_from_reference(tree, device="cpu")


def _np(t):
    return t.float().numpy()


def _close(got, want, tol, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = _np(got) if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _cache_close(got, want, tol):
    for grp in want:
        assert set(got[grp]) == set(want[grp])
        for leaf, w in want[grp].items():
            g = got[grp][leaf]
            assert tuple(g.shape) == w.shape, (grp, leaf)
            assert str(g.dtype) == f"torch.{w.dtype.name}", (grp, leaf)
            _close(g, w, tol, f"cache {grp}/{leaf}")


@pytest.fixture(scope="module", params=[
    (n, a) for a in ("float32", "bfloat16") for n in DENSE],
    ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """The reference's forward / prefill / decode on one seeded input, and
    its weights and caches carried into the port."""
    name, act = request.param
    jcfg, tcfg = _cfgs(name, act)
    jparams = init_params_np(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, L)).astype(np.int32)
    full, _ = JM.forward(jcfg, jparams, jnp.asarray(toks), remat=False)
    last, cache = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :LP]))
    cache_in = jax.tree.map(_grow, cache)
    dec, cache_out = JM.decode_step(jcfg, jparams, cache_in,
                                    jnp.asarray(toks[:, LP:LP + 1]),
                                    jnp.int32(LP))
    return dict(
        act=act, tcfg=tcfg, params=_port(jparams), toks=toks,
        full=np.asarray(full, np.float32), last=np.asarray(last, np.float32),
        cache=jax.tree.map(np.asarray, cache),
        cache_in=jax.tree.map(np.asarray, cache_in),
        dec=np.asarray(dec, np.float32),
        cache_out=jax.tree.map(np.asarray, cache_out))


def init_params_np(cfg, seed=0):
    return jax.tree.map(np.asarray, j_init(JM.model_specs(cfg), seed=seed))


def test_forward_matches_reference(case):
    logits, aux = TM.forward(case["tcfg"], case["params"],
                             torch.from_numpy(case["toks"]))
    assert logits.shape == (B, L, case["tcfg"].vocab_padded)
    assert logits.dtype == TP.torch_dtype(case["act"])
    assert float(aux["moe_aux"]) == 0.0
    _close(logits, case["full"], TOL[case["act"]][0])


def test_prefill_matches_reference(case):
    last, cache = TM.prefill(case["tcfg"], case["params"],
                             torch.from_numpy(case["toks"][:, :LP]))
    assert last.shape == (B, 1, case["tcfg"].vocab_padded)
    _close(last, case["last"], TOL[case["act"]][0])
    _cache_close(cache, case["cache"], TOL[case["act"]][2])
    specs = TM.cache_specs(case["tcfg"], B, LP, 0)
    for grp, leaves in specs.items():
        for leaf, (shape, _, dtype) in leaves.items():
            assert tuple(cache[grp][leaf].shape) == shape
            assert cache[grp][leaf].dtype == dtype


def test_decode_step_matches_reference(case):
    """One decode step on the reference's own (grown) cache: logits, and
    the cache with the new K/V written at slot LP in place."""
    cache = _port(case["cache_in"])
    tok = torch.from_numpy(case["toks"][:, LP:LP + 1])
    logits, out = TM.decode_step(case["tcfg"], case["params"], cache, tok,
                                 LP)
    assert out is cache                        # written in place
    assert logits.shape == (B, 1, case["tcfg"].vocab_padded)
    _close(logits, case["dec"], TOL[case["act"]][1])
    _cache_close(out, case["cache_out"], TOL[case["act"]][2])


@pytest.mark.parametrize("name", DENSE)
def test_port_prefill_equals_forward_last_position(name):
    """The reference's ``test_prefill_logits_match_forward``, on the port
    (default bf16 activations, its 2e-2)."""
    cfg = t_smoke(name)
    params = TP.init_params(TM.model_specs(cfg), seed=1, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, L)).astype(
        np.int32))
    full, _ = TM.forward(cfg, params, toks, remat=False)
    last, _ = TM.prefill(cfg, params, toks)
    torch.testing.assert_close(last[:, 0].float(), full[:, -1].float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", DENSE)
def test_port_decode_equals_teacher_forcing(name):
    """The reference's ``test_decode_consistent_with_forward``, on the
    port: prefill(l) + one decode step == forward at position l (3e-2)."""
    cfg = t_smoke(name)
    params = TP.init_params(TM.model_specs(cfg), seed=2, device="cpu")
    rng = np.random.default_rng(2)
    l = 16
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, l + 1)).astype(
        np.int32))
    full, _ = TM.forward(cfg, params, toks, remat=False)
    _, cache = TM.prefill(cfg, params, toks[:, :l])
    cache = {g: {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))
                 for k, c in leaves.items()} for g, leaves in cache.items()}
    lg, _ = TM.decode_step(cfg, params, cache, toks[:, l:], l)
    torch.testing.assert_close(lg[:, 0].float(), full[:, -1].float(),
                               rtol=3e-2, atol=3e-2)


def test_exact_causal_forward_matches_reference(monkeypatch):
    """``exact_causal_attn`` (the block-skip lever) at fp32 activations,
    in both packages with 8-token attention chunks, so a 40-token prompt
    spans five query blocks."""
    import repro.models.attention as ja
    import repro_torch.models.attention as ta
    for mod in (ja, ta):
        monkeypatch.setattr(mod, "flash_attention", functools.partial(
            mod.flash_attention, q_chunk=8, kv_chunk=8))
    jcfg, tcfg = _cfgs("qwen3-32b", "float32", exact_causal_attn=True)
    jparams = init_params_np(jcfg, seed=4)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (1, 40)).astype(
        np.int32)
    want, _ = JM.forward(jcfg, jparams, jnp.asarray(toks), remat=False)
    got, _ = TM.forward(tcfg, _port(jparams), torch.from_numpy(toks))
    _close(got, want, 1e-4)


def test_int8_kv_cache_and_other_families_raise_naming_a15():
    cfg = dataclasses.replace(t_smoke("qwen3-32b"), kv_cache_dtype="int8")
    params = TP.init_params(TM.model_specs(t_smoke("qwen3-32b")), seed=0,
                            device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A15"):
        TM.prefill(cfg, params, toks)
    for name in ("seamless-m4t-large-v2", "llama-3.2-vision-11b"):
        with pytest.raises(NotImplementedError, match="A15"):
            TM.forward(t_smoke(name), params, toks)
