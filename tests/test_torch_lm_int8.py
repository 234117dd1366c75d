"""The port's int8 KV cache (``kv_cache_dtype="int8"``) against the JAX
package's, mirroring ``tests/test_perf_levers.py``.

* The quantizers (``quantize_per_token`` for K, ``quantize_per_channel``
  for V) give the reference's codes and scales bit for bit, ties rounded
  half to even in both.
* ``decode_attention_int8`` matches the reference within 1e-5 of
  max|out| (the reference's two int8 × int8 → int32 contractions are
  exact; the port's are too, so what differs is the float32 rounding of
  the scales and the softmax), at S below and above 1040 slots, causal
  and local.
* ``attention.int8_contract``, the port's int32 product of int8 codes
  (float32 products of at most 1024 terms, added in int32), equals a
  numpy int64 einsum at S = 2048 with every term ±127·127, where a single
  float32 product cannot be right (its exact sum is odd and above 2^24).
* Prefill + decode of smoke configs with the int8 cache against the
  reference on the same weights (``convert.lm_params_from_reference``):
  at float32 activations the logits within 1e-4 of max|logits|, the
  scales within 1e-5 of each leaf's max, the codes equal but for at most
  0.1% of them one code apart (a K or V element whose float32 value
  differs in its last bits between the packages, next to a rounding
  boundary); at the configs' bfloat16 the reference's own 2e-2 / 3e-2 for
  the dense archs.
* The reference's int8 end-to-end bounds (≤ 0.12 of max|logits| against
  the bf16 cache's teacher-forced ``forward``, top-1 agreement ≥ 0.5) on
  the port's own process-stable draw; the serving session greedy against
  the reference session's; the cache re-padding (``v_scale`` left as it
  is, padded slots masked) and its specs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from torch_lm_common import frontend_inputs  # noqa: E402

B, L = 2, 24                    # batch, prefill length
INT8 = dict(kv_cache_dtype="int8")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def _ties():
    """(1, 4, 2, 8) values whose per-token and per-channel scales are 1
    (a 127 in each row and column), the rest at ±k.5: round half to
    even decides every one."""
    x = np.arange(64, dtype=np.float32).reshape(1, 4, 2, 8) % 9 - 4.5
    x[..., 0] = 127.0
    x[:, 0] = 127.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "ties", "zeros"])
def test_quantizers_are_bitwise_the_reference(dtype, case):
    if case == "normal":
        x = np.random.default_rng(0).standard_normal(
            (2, 16, 4, 32)).astype(np.float32) * 3
    elif case == "ties":
        x = _ties()
    else:                                  # a zero row: the 1e-8 floor
        x = np.zeros((1, 3, 2, 8), np.float32)
        x[0, 1] = 5.0
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(TP.torch_dtype(dtype))
    for jq, tq in ((JA.quantize_per_token, TA.quantize_per_token),
                   (JA.quantize_per_channel, TA.quantize_per_channel)):
        (jc, js), (tc, ts) = jq(jx), tq(tx)
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "ties":
        codes = TA.quantize_per_token(tx)[0][0, 1:, :, 1:].numpy()
        halves = x[0, 1:, :, 1:]
        np.testing.assert_array_equal(codes, np.round(halves))  # to even


# ---------------------------------------------------------------------------
# decode_attention_int8
# ---------------------------------------------------------------------------

def _qkv(seed, b, S, h, kh, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, dh)).astype(np.float32),
            rng.standard_normal((b, S, kh, dh)).astype(np.float32),
            rng.standard_normal((b, S, kh, dh)).astype(np.float32))


@pytest.mark.parametrize("S,cur,mode,window", [
    (64, 63, "causal", 0),                  # tests/test_perf_levers.py:19
    (64, 40, "local", 16),
    (1100, 1099, "causal", 0),              # PV over two chunks
    (1100, 700, "causal", 0),
])
def test_decode_attention_int8_matches_reference(S, cur, mode, window):
    q, k, v = _qkv(S, 2, S, 8, 4, 16)
    jk, jv = JA.quantize_per_token(jnp.asarray(k)), \
        JA.quantize_per_channel(jnp.asarray(v))
    want = JA.decode_attention_int8(jnp.asarray(q), *jk, *jv,
                                    cur_pos=jnp.int32(cur), mode=mode,
                                    window=window)
    tk = TA.quantize_per_token(torch.from_numpy(k))
    tv = TA.quantize_per_channel(torch.from_numpy(v))
    got = TA.decode_attention_int8(torch.from_numpy(q), *tk, *tv,
                                   cur_pos=cur, mode=mode, window=window)
    assert got.shape == (2, 1, 8, 16) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    if S == 64 and mode == "causal":        # the reference test's bound
        fp = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), cur_pos=cur)
        assert _rel(got, fp) < 0.05


def test_int8_contract_is_exact_past_two_to_the_24():
    """S = 2048 slots of 127 · 127 (one of 127 · 2): the exact sum,
    33,016,317, is odd and above 2^24, so no float32 result is it."""
    a = torch.full((2, 3, 1, 2048), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((2, 3, 2048, 5), 127, dtype=torch.int8)
    b[:, :, 0, :] = 2
    b[:, 1] = -b[:, 1]
    got = TA.int8_contract(a, b)
    want = np.einsum("xymk,xykn->xymn", a.numpy().astype(np.int64),
                     b.numpy().astype(np.int64))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs(int(want[0, 0, 0, 0])) == 33_016_317 > 2 ** 24
    one_pass = torch.matmul(a.float(), b.float()).double().numpy()
    assert not np.array_equal(one_pass, want)
    # float32 codes (the products' operands) give the same sums
    np.testing.assert_array_equal(
        TA.int8_contract(a.float(), b.float()).numpy(), want)


def test_int8_contract_random_codes_equal_int64_at_every_chunk_edge():
    rng = np.random.default_rng(3)
    for n in (1, 1023, 1024, 1025, 2049):
        a = rng.integers(-127, 128, (3, 2, n)).astype(np.int8)
        b = rng.integers(-127, 128, (3, n, 4)).astype(np.int8)
        got = TA.int8_contract(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(
            got.numpy(), np.einsum("xmk,xkn->xmn", a.astype(np.int64),
                                   b.astype(np.int64)))


# ---------------------------------------------------------------------------
# Prefill + decode through the model
# ---------------------------------------------------------------------------

def _cfgs(name, act):
    kw = dict(INT8, act_dtype=act)
    return (dataclasses.replace(j_smoke(name), **kw),
            dataclasses.replace(t_smoke(name), **kw))


def _grow(cache, l):
    """One more slot of K/V and ``k_scale`` (the reference test's
    ``grow``)."""
    def fix(c):
        if c.ndim >= 4 and c.shape[2] == l:
            pad = [(0, 0)] * c.ndim
            pad[2] = (0, 1)
            return jnp.pad(c, pad)
        return c
    return jax.tree.map(fix, cache)


def _run_both(name, act, seed=0):
    jcfg, tcfg = _cfgs(name, act)
    params = TP.init_params(TM.model_specs(tcfg), seed=seed, device="cpu")
    jparams = jax.tree.map(lambda t: t.numpy(), params)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (B, L + 1)).astype(np.int32)
    extras = frontend_inputs(jcfg, rng, B, 12)
    textras = {k: torch.from_numpy(v) for k, v in extras.items()}
    jl, jcache = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :L]),
                            **extras)
    tl, tcache = TM.prefill(tcfg, params, torch.from_numpy(toks[:, :L]),
                            **textras)
    jd, _ = JM.decode_step(jcfg, jparams, _grow(jcache, L),
                           jnp.asarray(toks[:, L:]), jnp.int32(L))
    td, _ = TM.decode_step(tcfg, params, tserve._pad_caches(tcache, L, L + 1),
                           torch.from_numpy(toks[:, L:]), L)
    return (jl, jcache, jd), (tl, tcache, td)


@pytest.mark.parametrize("name", ["qwen3-32b", "phi3-mini-3.8b",
                                  "llama4-scout-17b-a16e",
                                  "seamless-m4t-large-v2"])
def test_int8_prefill_and_decode_match_reference_at_fp32(name):
    (jl, jcache, jd), (tl, tcache, td) = _run_both(name, "float32")
    assert _rel(tl, jl) < 1e-4
    assert _rel(td, jd) < 1e-4
    assert set(tcache) == set(jcache)
    for g in jcache:
        assert set(tcache[g]) == set(jcache[g])
        for leaf, want in jcache[g].items():
            got = tcache[g][leaf]
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            if leaf in ("k", "v"):
                diff = np.abs(got.numpy().astype(int) - want.astype(int))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            elif leaf in ("k_scale", "v_scale"):
                assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("name", ["qwen3-32b", "phi3-mini-3.8b"])
def test_int8_prefill_and_decode_match_reference_at_bf16(name):
    (jl, _, jd), (tl, _, td) = _run_both(name, "bfloat16")
    for got, want, tol in ((tl, jl, 2e-2), (td, jd, 3e-2)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                   atol=tol * np.abs(_np(want)).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_cache_end_to_end_decode(seed):
    """``tests/test_perf_levers.py::test_int8_cache_end_to_end_decode``
    on the port's draw, stable across processes: the int8 decode step
    against teacher-forced ``forward`` of the bf16-cache config, within
    0.12 of max|logits| and top-1 agreement at least 0.5; and the int8
    prefill's logits bitwise the bf16 cache's (prefill attends over the
    unquantized K/V)."""
    cfg_fp = t_smoke("qwen3-32b")
    cfg = dataclasses.replace(cfg_fp, **INT8)
    params = TP.init_params(TM.model_specs(cfg), seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    l = 16
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, l + 1)).astype(
        np.int32))
    full, _ = TM.forward(cfg_fp, params, toks, remat=False)
    last, cache = TM.prefill(cfg, params, toks[:, :l])
    last_fp, _ = TM.prefill(cfg_fp, params, toks[:, :l])
    assert torch.equal(last, last_fp)
    lg, _ = TM.decode_step(cfg, params, tserve._pad_caches(cache, l, l + 1),
                           toks[:, l:], l)
    a, b_ = lg[:, 0].float().numpy(), full[:, -1].float().numpy()
    assert np.abs(a - b_).max() / (np.abs(b_).max() + 1e-9) < 0.12
    assert (a.argmax(-1) == b_.argmax(-1)).mean() >= 0.5


@pytest.mark.parametrize("name", ["qwen3-32b", "llama4-scout-17b-a16e"])
def test_int8_session_greedy_equals_the_reference_session(name):
    jcfg, tcfg = _cfgs(name, "float32")
    params = TP.init_params(TM.model_specs(tcfg), seed=0, device="cpu")
    jparams = jax.tree.map(lambda t: t.numpy(), params)
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab, (3, 12)).astype(np.int32)
    want = jserve.ServeSession(jcfg, jparams, max_len=24).generate(
        prompts, 10)
    sess = tserve.ServeSession(tcfg, params, max_len=24, device="cpu")
    got = sess.generate(prompts, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sess.generate(prompts, 10), got)


def test_pad_caches_grow_k_scale_and_leave_v_scale():
    """``_pad_caches`` grows the int8 K / V and ``k_scale`` with zeros and
    leaves ``v_scale`` as it is (the reference's, key for key); a padded
    slot is masked: codes written there change no decode output until
    decode writes the slot."""
    jcfg, tcfg = _cfgs("qwen3-32b", "float32")
    params = TP.init_params(TM.model_specs(tcfg), seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (B, L + 1)).astype(np.int32))
    _, cache = TM.prefill(tcfg, params, toks[:, :L])
    grown = tserve._pad_caches(cache, L, L + 6)
    want = jserve._pad_caches(jax.tree.map(lambda t: t.numpy(), cache), L,
                              L + 6)
    for g in cache:
        for leaf, c in grown[g].items():
            np.testing.assert_array_equal(c.numpy(), np.asarray(want[g][leaf]))
        assert grown[g]["v_scale"] is cache[g]["v_scale"]
        assert tuple(grown[g]["k_scale"].shape[2:]) == (L + 6,
                                                        tcfg.n_kv_heads)
    clean, _ = TM.decode_step(tcfg, params, {
        g: {k: c.clone() for k, c in leaves.items()}
        for g, leaves in grown.items()}, toks[:, L:], L)
    noisy = {g: {k: c.clone() for k, c in leaves.items()}
             for g, leaves in grown.items()}
    gen = torch.Generator().manual_seed(0)
    for leaves in noisy.values():
        for k in ("k", "v"):
            leaves[k][:, :, L + 1:] = torch.randint(
                -127, 128, leaves[k][:, :, L + 1:].shape, generator=gen,
                dtype=torch.int8)
        leaves["k_scale"][:, :, L + 1:] = 3.0
    got, _ = TM.decode_step(tcfg, params, noisy, toks[:, L:], L)
    assert torch.equal(got, clean)


@pytest.mark.parametrize("name", ["qwen3-32b", "seamless-m4t-large-v2",
                                  "jamba-1.5-large-398b"])
def test_int8_cache_specs_equal_the_reference(name):
    jcfg, tcfg = _cfgs(name, "bfloat16")
    want = JM.cache_specs(jcfg, 2, 64, 8)
    got = TM.cache_specs(tcfg, 2, 64, 8)
    assert set(got) == set(want)
    for g in want:
        assert set(got[g]) == set(want[g])
        for leaf, (shp, axes, dt) in want[g].items():
            t_shp, t_axes, t_dt = got[g][leaf]
            assert (t_shp, t_axes) == (shp, axes)
            assert str(t_dt).split(".")[-1] == np.dtype(dt).name
    kinds = {k for k in jcfg.pattern}
    for kind in kinds:
        if TB.parse_kind(kind)[0] in ("attn", "attn_local", "attn_cross"):
            assert "k_scale" in TB.block_cache_specs(tcfg, kind, 1, 4, 2)
            assert "k_scale" in JB.block_cache_specs(jcfg, kind, 1, 4, 2)
