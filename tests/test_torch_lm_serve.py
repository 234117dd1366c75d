"""The port's serving driver against the JAX package's: greedy tokens of
``ServeSession.generate`` equal the reference session's on the same
weights at float32 activations (each step's top-2 logit margin above the
two packages' agreement tolerance, so the equality means something) for
the dense archs and the MoE, SSM and hybrid ones the port serves, the
cache re-padding (mamba's ``conv`` / ``ssd`` state left as it is), the
``serve.*`` counters and spans, temperature draws from a seeded
generator, ``python -m repro_torch.launch.serve``, and what the port does
not run yet (the ``encdec`` / ``vlm`` families, the int8 KV cache)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.obs import counters as jcnt  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.obs import counters as tcnt  # noqa: E402
from repro_torch.obs import tracer as ttracer  # noqa: E402

B, LP, NTOK = 3, 12, 10
MAX_LEN = LP + NTOK + 1
TOL = 1e-4          # the fp32 logits' agreement, relative to max|logits|


def _cfgs(name):
    return (dataclasses.replace(j_smoke(name), act_dtype="float32"),
            dataclasses.replace(t_smoke(name), act_dtype="float32"))


def _prompts(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, LP)).astype(np.int32)


def _step_logits(cfg, params, prompts, tokens):
    """The logits each greedy step chose from: prefill, then one decode
    step per generated token but the last (teacher-forced on ``tokens``)."""
    logits, cache = TM.prefill(cfg, params, torch.from_numpy(prompts))
    cache = tserve._pad_caches(cache, LP, MAX_LEN)
    out = [logits[:, -1, :cfg.vocab]]
    for i in range(tokens.shape[1] - 1):
        logits, cache = TM.decode_step(
            cfg, params, cache, torch.from_numpy(tokens[:, i:i + 1]), LP + i)
        out.append(logits[:, -1, :cfg.vocab])
    return torch.stack(out, 1).float()            # (b, n, vocab)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "qwen3-32b",
                                  "qwen2-moe-a2.7b", "mamba2-370m",
                                  "llama4-scout-17b-a16e",
                                  "jamba-1.5-large-398b"])
def test_greedy_tokens_equal_the_reference_session(name):
    jcfg, tcfg = _cfgs(name)
    # The port's draw, handed to both: it is the same in every process,
    # where the reference's init keys its leaves by the salted ``hash``,
    # so the margin check below would see other weights in each run.
    params = TP.init_params(TM.model_specs(tcfg), seed=0, device="cpu")
    jparams = jax.tree.map(lambda t: t.numpy(), params)
    prompts = _prompts(jcfg)
    want = jserve.ServeSession(jcfg, jparams, max_len=MAX_LEN).generate(
        prompts, NTOK)
    got = tserve.ServeSession(tcfg, params, max_len=MAX_LEN,
                              device="cpu").generate(prompts, NTOK)
    assert got.dtype == np.int32 and got.shape == (B, NTOK)
    np.testing.assert_array_equal(got, want)
    # Each step's choice is clear of the packages' 1e-4 disagreement.
    logits = _step_logits(tcfg, params, prompts, got)
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / logits.abs().amax()
    assert float(margin.min()) > TOL, margin
    assert torch.equal(logits.argmax(-1).to(torch.int32),
                       torch.from_numpy(got))


def _pad_caches_check(name):
    """K/V grow to ``max_len`` slots; mamba's ``conv`` / ``ssd`` state
    passes through as the same tensor."""
    jcfg, tcfg = _cfgs(name)
    jparams = jax.tree.map(np.asarray, j_init(JM.model_specs(jcfg), seed=0))
    prompts = _prompts(jcfg)
    _, jcache = JM.prefill(jcfg, jparams, prompts)
    want = jserve._pad_caches(jcache, LP, MAX_LEN)
    _, tcache = TM.prefill(tcfg, lm_params_from_reference(jparams,
                                                          device="cpu"),
                           torch.from_numpy(prompts))
    got = tserve._pad_caches(tcache, LP, MAX_LEN)
    assert set(got) == set(want)
    for grp in want:
        assert set(got[grp]) == set(want[grp])
        for leaf, w in want[grp].items():
            g = got[grp][leaf]
            assert tuple(g.shape) == w.shape
            if leaf in ("conv", "ssd"):
                assert g is tcache[grp][leaf]
                assert g.dtype == torch.float32
                continue
            assert w.shape == (tcfg.n_repeats, B, MAX_LEN, tcfg.n_kv_heads,
                               tcfg.head_dim)
            assert g.dtype == torch.bfloat16
            assert torch.equal(g[:, :, :LP], tcache[grp][leaf])
            assert not g[:, :, LP:].any()


def test_pad_caches_shapes_equal_the_reference():
    _pad_caches_check("qwen3-32b")
    # Non-K/V entries and K/V of another length pass through untouched.
    other = {"p0": {"k": torch.ones(1, 2, 5, 1, 1),
                    "conv": torch.ones(1, 2, LP, 3)}}
    out = tserve._pad_caches(other, LP, MAX_LEN)
    assert out["p0"]["k"] is other["p0"]["k"]
    assert out["p0"]["conv"] is other["p0"]["conv"]


@pytest.mark.parametrize("name", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_pad_caches_leave_the_mamba_state_as_the_reference(name):
    _pad_caches_check(name)


def _session(name="qwen3-32b", tracer=None):
    cfg = t_smoke(name)
    params = TP.init_params(TM.model_specs(cfg), seed=0, device="cpu")
    return cfg, tserve.ServeSession(cfg, params, max_len=MAX_LEN,
                                    tracer=tracer, device="cpu")


def test_serve_counters_fire_once_per_generate_as_the_reference():
    jcfg = j_smoke("qwen3-32b")
    jparams = j_init(JM.model_specs(jcfg), seed=0)
    prompts = _prompts(jcfg)
    jreg = jcnt.CounterRegistry()
    with jcnt.use_registry(jreg):
        jserve.ServeSession(jcfg, jparams, max_len=MAX_LEN).generate(
            prompts, NTOK)
    cfg, sess = _session()
    with tcnt.use_registry() as reg:
        sess.generate(prompts, NTOK)
        assert reg.get("serve.tokens") == jreg.get("serve.tokens") \
            == B * NTOK
        assert {tcnt.split_key(k)[0] for k in reg.snapshot()} == \
            {tcnt.split_key(k)[0] for k in jreg.snapshot()} == \
            {"serve.tokens", "serve.prefill_s", "serve.decode_s"}
        first = reg.snapshot()
        sess.generate(prompts, 4)
        assert reg.get("serve.tokens") == B * (NTOK + 4)
        assert reg.get("serve.prefill_s") > first["serve.prefill_s"] > 0
        assert reg.get("serve.decode_s") > first["serve.decode_s"] > 0


def test_serve_spans_are_the_reference_names_and_valid():
    tracer = ttracer.Tracer()
    cfg, sess = _session(tracer=tracer)
    sess.generate(_prompts(cfg), NTOK)
    names = [(r.name, r.depth) for r in sorted(tracer.records,
                                               key=lambda r: r.t0)]
    assert names == [("generate", 0), ("prefill", 1), ("decode", 1)]
    gen = next(r for r in tracer.records if r.name == "generate")
    assert gen.args == {"batch": B, "prompt_len": LP, "tokens": NTOK}
    dec = next(r for r in tracer.records if r.name == "decode")
    assert dec.args == {"tokens": NTOK - 1}
    assert gen.counters["serve.tokens"] == B * NTOK
    trace = tracer.chrome_trace()
    assert ttracer.validate_chrome_trace(
        trace, expect_names=("generate", "prefill", "decode")) == []
    # The process tracer is read per generate() when none was given.
    _, sess2 = _session()
    with ttracer.use_tracer() as scoped:
        sess2.generate(_prompts(cfg), 2)
    assert {r.name for r in scoped.records} == {"generate", "prefill",
                                               "decode"}


def test_temperature_draws_are_seeded_and_in_range():
    cfg, sess = _session("phi3-mini-3.8b")
    prompts = _prompts(cfg)
    a = sess.generate(prompts, NTOK, temperature=0.8, seed=1)
    b = sess.generate(prompts, NTOK, temperature=0.8, seed=1)
    c = sess.generate(prompts, NTOK, temperature=0.8, seed=2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    for out in (a, c):
        assert out.shape == (B, NTOK) and out.dtype == np.int32
        assert (out >= 0).all() and (out < cfg.vocab).all()


def test_sample_cuts_the_padded_vocab():
    logits = torch.zeros(2, 16)
    logits[:, 12:] = 5.0               # only padding rows are large
    gen = torch.Generator().manual_seed(0)
    assert (tserve._sample(logits, 0.0, gen, 12) < 12).all()
    for _ in range(20):
        assert (tserve._sample(logits, 1.0, gen, 12) < 12).all()


def test_main_serves_a_smoke_config_on_the_cpu(capsys):
    assert tserve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--tokens",
                        "4", "--device", "cpu"]) is None
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated (2, 4) in")


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2"])
def test_main_refuses_a_non_dense_arch_naming_a15(name):
    """The ``encdec`` family still raises naming A15."""
    with pytest.raises(NotImplementedError, match="A15"):
        tserve.main(["--arch", name, "--smoke", "--tokens", "4", "--device",
                     "cpu"])


@pytest.mark.parametrize("name", ["mamba2-370m", "qwen2-moe-a2.7b"])
def test_main_serves_a_moe_or_ssm_smoke_config_on_the_cpu(name, capsys):
    assert tserve.main(["--arch", name, "--smoke", "--tokens", "4",
                        "--device", "cpu"]) is None
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated (2, 4) in")


def test_int8_kv_cache_raises_naming_a15():
    cfg = dataclasses.replace(t_smoke("qwen3-32b"), kv_cache_dtype="int8")
    params = TP.init_params(TM.model_specs(t_smoke("qwen3-32b")), seed=0,
                            device="cpu")
    sess = tserve.ServeSession(cfg, params, max_len=MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        sess.generate(_prompts(cfg), 2)


def test_session_runs_on_cuda_unless_asked_for_the_cpu():
    cfg = t_smoke("qwen3-32b")
    params = TP.init_params(TM.model_specs(cfg), seed=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.ServeSession(cfg, params)
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--arch", "qwen3-32b", "--smoke"])
    else:
        with pytest.raises(ValueError, match="session on cuda"):
            tserve.ServeSession(cfg, params)
