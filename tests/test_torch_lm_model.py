"""The port's LM (``forward``, ``prefill``, ``decode_step``) against the
JAX package's on the same weights, for the smoke configs of the four
dense archs (qwen3-32b: qk_norm and GQA 4:2; minitron-8b and
internlm2-20b: GQA; phi3-mini-3.8b: MHA) and of the MoE, SSM and hybrid
archs the port serves (qwen2-moe-a2.7b: top-2 with a shared expert;
llama4-scout-17b-a16e: ``attn_local`` over a smoke window of 16, which
the 32-token forward and the decode at slot 16 cross, and top-1 MoE;
mamba2-370m: the SSD mixer with tied embeddings; jamba-1.5-large-398b:
the 8-layer hybrid pattern with grouped SSD and MoE).

The reference's weights come across with
``convert.lm_params_from_reference`` in this process (its init is salted
per process, and no package can draw the other's stream). Two settings:

* ``act_dtype="float32"``: logits within 1e-4 of max|logits|, the MoE
  aux loss within 1e-5; the K/V caches are bf16 in both packages, so a
  cache leaf may differ by one bf16 ulp where the float32 value it rounds
  differs in its last bits (the float32 mamba state is held to 1e-4);
  at bfloat16 the aux loss is held to 2e-2, as the logits;
* the configs' default ``bfloat16``: the reference's own tolerances,
  2e-2 (prefill, forward) and 3e-2 (decode), ``tests/test_archs_smoke.py``.
  For the archs with a router (qwen2-moe, llama4-scout, jamba) the
  comparison at bf16 is block by block: the reference's layer scan is
  compiled, and XLA fuses a layer's bf16 operations and drops some of
  their roundings, so the scanned reference differs from its own op-by-op
  evaluation by a bf16 ulp here and there, and a top-k router that sees
  such an ulp picks another expert for that token in every later layer
  (jamba's smoke logits then move by 0.38 of max|logits| between the two
  evaluations of the reference). The port rounds as PyTorch does
  (``F.silu`` rounds once where XLA's lowering rounds after each of its
  operations), which moves a router's choice the same way. So each of
  the reference's blocks runs op by op on the reference's own hidden
  state, its router's choice is recorded and replayed into the port's
  router (the router alone is held exactly in ``test_torch_lm_moe.py``),
  and the port's block, given the same state, holds 2e-2 (apply, prefill
  and its cache) and 3e-2 (decode and its cache).

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
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402

DENSE = ["internlm2-20b", "minitron-8b", "phi3-mini-3.8b", "qwen3-32b"]
SERVED = ["jamba-1.5-large-398b", "llama4-scout-17b-a16e", "mamba2-370m",
          "qwen2-moe-a2.7b"]
ROUTED = ["jamba-1.5-large-398b", "llama4-scout-17b-a16e", "qwen2-moe-a2.7b"]
B, L, LP = 2, 32, 16          # batch, forward length, prefill length
TOL = {"float32": (1e-4, 1e-4, 2 ** -8),        # forward, decode, cache
       "bfloat16": (2e-2, 3e-2, 2e-2)}


def _cfgs(name, act, **kw):
    kw = dict(kw, act_dtype=act)
    return (dataclasses.replace(j_smoke(name), **kw),
            dataclasses.replace(t_smoke(name), **kw))


def _grow(cache):
    """One more K/V slot for the decoded token (the reference test's
    ``grow``); mamba's ``conv`` / ``ssd`` state stays as it is."""
    return {g: {k: jnp.pad(c, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
                if k in ("k", "v") else c for k, c in leaves.items()}
            for g, leaves in cache.items()}


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


def _cache_close(got, want, tol, act):
    for grp in want:
        assert set(got[grp]) == set(want[grp])
        for leaf, w in want[grp].items():
            g = got[grp][leaf]
            assert tuple(g.shape) == w.shape, (grp, leaf)
            assert str(g.dtype) == f"torch.{w.dtype.name}", (grp, leaf)
            exact = act == "float32" and leaf in ("conv", "ssd")
            _close(g, w, 1e-4 if exact else tol, f"cache {grp}/{leaf}")


@pytest.fixture(scope="module", params=[
    (n, a) for a in ("float32", "bfloat16") for n in DENSE + SERVED
    if not (a == "bfloat16" and n in ROUTED)],
    ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    """The reference's forward / prefill / decode on one seeded input, and
    its weights and caches carried into the port."""
    name, act = request.param
    jcfg, tcfg = _cfgs(name, act)
    jparams = init_params_np(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, L)).astype(np.int32)
    full, aux = JM.forward(jcfg, jparams, jnp.asarray(toks), remat=False)
    last, cache = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :LP]))
    cache_in = _grow(cache)
    dec, cache_out = JM.decode_step(jcfg, jparams, cache_in,
                                    jnp.asarray(toks[:, LP:LP + 1]),
                                    jnp.int32(LP))
    return dict(
        act=act, tcfg=tcfg, params=_port(jparams), toks=toks,
        full=np.asarray(full, np.float32), last=np.asarray(last, np.float32),
        aux=float(aux["moe_aux"]),
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
    if "moe" in "".join(case["tcfg"].pattern):
        assert case["aux"] > 0
        np.testing.assert_allclose(
            float(aux["moe_aux"]), case["aux"],
            rtol=1e-5 if case["act"] == "float32" else TOL["bfloat16"][0])
    else:
        assert float(aux["moe_aux"]) == case["aux"] == 0.0
    _close(logits, case["full"], TOL[case["act"]][0])


def test_prefill_matches_reference(case):
    last, cache = TM.prefill(case["tcfg"], case["params"],
                             torch.from_numpy(case["toks"][:, :LP]))
    assert last.shape == (B, 1, case["tcfg"].vocab_padded)
    _close(last, case["last"], TOL[case["act"]][0])
    _cache_close(cache, case["cache"], TOL[case["act"]][2], case["act"])
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
    _cache_close(out, case["cache_out"], TOL[case["act"]][2], case["act"])


def _replay_routes(monkeypatch):
    """Record each call of the reference's ``router_assign`` and give its
    ``(probs, ids)`` to the port's router calls that follow it (the
    port's own aux loss is kept)."""
    routes = []
    j_route, t_route = JMoE.router_assign, TMoE.router_assign

    def record(*args, **kw):
        probs, ids, aux = j_route(*args, **kw)
        routes.append((torch.from_numpy(np.array(probs)),
                       torch.from_numpy(np.array(ids))))
        return probs, ids, aux

    def replay(*args, **kw):
        probs, ids, aux = t_route(*args, **kw)
        want_p, want_i = routes[-1]
        assert want_p.shape == probs.shape and want_i.dtype == ids.dtype
        return want_p.to(probs.dtype), want_i, aux

    monkeypatch.setattr(JMoE, "router_assign", record)
    monkeypatch.setattr(TMoE, "router_assign", replay)
    return routes


@pytest.mark.parametrize("name", ROUTED)
def test_routed_blocks_at_bf16_match_reference_op_by_op(name, monkeypatch):
    """Each block of a routed arch at bf16 (module docstring): the
    reference's ``block_prefill`` and ``block_decode`` op by op on its
    own hidden state, layer after layer; the port's ``block_apply``,
    ``block_prefill`` and ``block_decode`` on the same state and the same
    (grown) cache, with the reference's routes."""
    routes = _replay_routes(monkeypatch)
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jparams = init_params_np(jcfg, seed=3)
    tparams = _port(jparams)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (B, L + 1))
    pos = np.broadcast_to(np.arange(L, dtype=np.int32)[None], (B, L))
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    emb = lambda t: JM._embed_tokens(jcfg, jparams, jnp.asarray(  # noqa
        t.astype(np.int32)))
    h, hd = emb(toks[:, :L]), emb(toks[:, L:])
    for r in range(jcfg.n_repeats):
        for j, kind in enumerate(jcfg.pattern):
            jp = jax.tree.map(lambda a: a[r], jparams["blocks"][f"p{j}"])
            tp = TM._layer(tparams["blocks"][f"p{j}"], r)
            th = _port({"h": h})["h"]
            want, jcache = JB.block_prefill(jcfg, kind, jp, h, pos=jpos)
            got, _ = TB.block_apply(tcfg, kind, tp, th, pos=tpos)
            _close(got, want, 2e-2, f"apply {r}/{kind}")
            got, tcache = TB.block_prefill(tcfg, kind, tp, th, pos=tpos)
            _close(got, want, 2e-2, f"prefill {r}/{kind}")
            for leaf, w in jcache.items():
                _close(tcache[leaf], w, 2e-2, f"cache {r}/{kind}/{leaf}")
            jcache = {k: jnp.pad(c, ((0, 0), (0, 1), (0, 0), (0, 0)))
                      if k in ("k", "v") else c for k, c in jcache.items()}
            tcache = _port(jax.tree.map(np.asarray, jcache))
            dwant, jnew = JB.block_decode(jcfg, kind, jp, hd, jcache,
                                          pos=jnp.int32(L))
            dgot, tnew = TB.block_decode(tcfg, kind, tp, _port({"h": hd})[
                "h"], tcache, pos=L)
            _close(dgot, dwant, 3e-2, f"decode {r}/{kind}")
            for leaf, w in jnew.items():
                _close(tnew[leaf], w, 3e-2, f"decode cache {r}/{kind}/{leaf}")
            h, hd = want, dwant
    n_moe = sum(k.endswith("moe") for k in jcfg.pattern) * jcfg.n_repeats
    assert len(routes) == 2 * n_moe          # prefill and decode, each layer


@pytest.mark.parametrize("name", DENSE + SERVED)
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


@pytest.mark.parametrize("name", DENSE + SERVED)
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
                 if k in ("k", "v") else c for k, c in leaves.items()}
             for g, leaves in cache.items()}
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
