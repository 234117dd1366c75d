"""LM training in the port (``repro_torch.models.steps``,
``repro_torch.launch.train``) against the JAX package.

* ``loss_fn`` and its gradients, for the smoke configs of the four dense
  archs on the reference's weights (``convert.lm_params_from_reference``):
  with fp32 activations the total, ``ce`` and ``z_loss`` within 1e-5
  relative and every leaf's gradient within 1e-4 of that leaf's max|g|;
  at the default bf16 the loss within 1e-2 relative.
* Activation checkpointing: the gradients with ``remat=False``,
  ``"nothing"`` and ``"dots"`` are equal; ``"dots"`` recomputes no weight
  product.
* The train step against ``jax.jit(make_train_step(cfg, opt,
  grad_accum=k))`` on one starting state
  (``convert.lm_train_state_from_reference``), k in {1, 2}, AdamW and
  Adafactor: metrics within 1e-5 relative, ``step`` and ``count`` equal,
  new parameters within 2.5 lr_t elementwise (the bound where a near-zero
  gradient's sign differs under AdamW's first step) and all but 0.1% of
  their elements within 1e-5 of max|p|; ``grad_accum=2`` ≡ 1.
* The reference's own train tests, on the port, and the driver: resume
  after a preemption equals the uninterrupted run bitwise.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import set_checkpoint_early_stop  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import (lm_params_from_reference,  # noqa: E402
                                 lm_train_state_from_reference)
from repro_torch.data import make_batch_iterator  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.models.params import init_params, iter_leaves  # noqa: E402
from repro_torch.runtime.fault_tolerance import TrainLoopRunner  # noqa: E402

DENSE = ["internlm2-20b", "minitron-8b", "phi3-mini-3.8b", "qwen3-32b"]


def _cfgs(name, **kw):
    return (dataclasses.replace(j_smoke(name), **kw),
            dataclasses.replace(t_smoke(name), **kw))


def _batch(cfg, b, l, seed, mask=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, l)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, l)).astype(np.int32)}
    if mask:
        out["loss_mask"] = (rng.random((b, l)) < 0.8).astype(np.float32)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_loss_and_grads_match_reference(name):
    jcfg, tcfg = _cfgs(name, act_dtype="float32")
    jp = j_init(JM.model_specs(jcfg), seed=0)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    batch = _batch(tcfg, 2, 32, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(jcfg, p, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    (tl, tm), tg = TS.loss_and_grads(tcfg, tp, _tb(batch))
    assert _rel(tl, jl) < 1e-5
    for key in ("ce", "z_loss"):
        assert _rel(tm[key], jm[key]) < 1e-5, key
    assert float(tm["moe_aux"]) == float(jm["moe_aux"]) == 0.0
    n = 0
    for path, g in iter_leaves(tg):
        want = np.asarray(_at(jg, path), np.float32)
        assert g.shape == want.shape and g.dtype == torch.float32, path
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
            err_msg=str(path))
        n += 1
    assert n == len(jax.tree.leaves(jg))

    # The configs' default bf16 activations: the loss within 1e-2.
    jcfg, tcfg = _cfgs(name)
    jl, _ = jax.jit(lambda p, b: JS.loss_fn(jcfg, p, b))(
        jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        tl, _ = TS.loss_fn(tcfg, tp, _tb(batch))
    assert _rel(tl, jl) < 1e-2


def test_loss_mask_and_vocab_padding():
    """A fully masked batch has loss 0 (the denominator is clamped to 1);
    padding columns never take probability."""
    cfg = dataclasses.replace(t_smoke("phi3-mini-3.8b"), vocab=250)
    assert cfg.vocab_padded == 256
    p = init_params(TM.model_specs(cfg), seed=0, device="cpu")
    batch = _tb(_batch(cfg, 2, 8, seed=0, mask=False))
    batch["loss_mask"] = torch.zeros(2, 8)
    with torch.no_grad():
        total, m = TS.loss_fn(cfg, p, batch)
    assert float(total) == float(m["ce"]) == float(m["z_loss"]) == 0.0
    batch["loss_mask"] = torch.ones(2, 8)
    with torch.no_grad():
        total, m = TS.loss_fn(cfg, p, batch)
        logits, _ = TM.forward(cfg, p, batch["tokens"])
        lse = torch.logsumexp(logits.float()[..., :250], -1)
        ll = torch.gather(logits.float(), -1,
                          batch["labels"].long()[..., None])[..., 0]
    torch.testing.assert_close(m["ce"], (lse - ll).mean())


# ---------------------------------------------------------------------------
# Activation checkpointing
# ---------------------------------------------------------------------------

def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("pattern", [1, 3], ids=["group", "per-layer"])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_remat_policies_give_equal_grads(act, pattern):
    """``len(pattern) > 2`` adds the per-layer checkpoints inside each
    group."""
    cfg = dataclasses.replace(t_smoke("qwen3-32b"), act_dtype=act,
                              pattern=("attn+mlp",) * pattern,
                              n_layers=2 * pattern)
    p = init_params(TM.model_specs(cfg), seed=0, device="cpu")
    batch = _tb(_batch(cfg, 2, 16, seed=2))
    runs = {}
    for key, remat, policy in (("off", False, "nothing"),
                               ("nothing", True, "nothing"),
                               ("dots", True, "dots")):
        c = dataclasses.replace(cfg, remat_policy=policy)
        runs[key] = TS.loss_and_grads(c, p, batch, remat=remat)
    for key in ("nothing", "dots"):
        (l, _), g = runs[key]
        assert torch.equal(l, runs["off"][0][0])
        for (path, a), (_, b) in zip(iter_leaves(g),
                                     iter_leaves(runs["off"][1])):
            assert torch.equal(a, b), (key, path)


def test_dots_policy_keeps_the_weight_products():
    """Under ``"dots"`` the backward runs fewer ``aten.mm`` than under
    ``"nothing"`` by the forward's weight products (early stop of the
    recompute off, so ``"nothing"`` recomputes each whole group)."""
    cfg = t_smoke("qwen3-32b")
    p = init_params(TM.model_specs(cfg), seed=0, device="cpu")
    batch = _tb(_batch(cfg, 2, 16, seed=3))
    with torch.no_grad(), _CountMM() as fwd:
        TM.forward(cfg, p, batch["tokens"], remat=False)
    weight_products = fwd.mm - 1                    # all but the unembed
    assert weight_products == 7 * cfg.n_layers
    backward = {}
    for policy in ("nothing", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        leaves = _requiring_grad(p)
        with set_checkpoint_early_stop(False):
            total, _ = TS.loss_fn(c, leaves, batch)
            with _CountMM() as bwd:
                total.backward()
        backward[policy] = bwd.mm
    assert backward["nothing"] - backward["dots"] == weight_products


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_train_step_matches_reference(opt_name, k):
    jcfg, tcfg = _cfgs("qwen3-32b", act_dtype="float32")
    peak = 1e-2
    jopt = JO.make_optimizer(opt_name, JO.cosine_schedule(peak, 2, 10))
    topt = TO.make_optimizer(opt_name, TO.cosine_schedule(peak, 2, 10))
    jp = j_init(JM.model_specs(jcfg), seed=0)
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = lm_train_state_from_reference(
        jax.tree.map(np.asarray, jstate), device="cpu")
    step_fn = TS.make_train_step(tcfg, topt, grad_accum=k)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, grad_accum=k))
    for i in range(2):
        batch = _batch(tcfg, 4, 16, seed=10 + i, mask=False)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        out, tm = step_fn(tstate, batch)
        assert out is tstate
        for key in ("loss", "ce", "z_loss", "grad_norm"):
            assert _rel(tm[key], jm[key]) < 1e-5, (i, key)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"])
        lr_t = float(TO.cosine_schedule(peak, 2, 10)(i + 1))
        outliers = total = 0
        for path, p in iter_leaves(tstate["params"]):
            want = np.asarray(_at(jstate["params"], path), np.float32)
            err = np.abs(p.numpy() - want)
            assert float(err.max()) <= 2.5 * lr_t, (i, path)
            outliers += int((err > 1e-5 * np.abs(want).max()).sum())
            total += err.size
        assert outliers <= 1e-3 * total, (i, outliers, total)
        # Carry on from the reference's state, so the next step compares
        # one step's arithmetic again.
        tstate = lm_train_state_from_reference(
            jax.tree.map(np.asarray, jstate), device="cpu")


def test_grad_accum_two_equals_one():
    cfg = dataclasses.replace(t_smoke("phi3-mini-3.8b"), act_dtype="float32")
    p = init_params(TM.model_specs(cfg), seed=0, device="cpu")
    batch = _tb(_batch(cfg, 4, 16, seed=4, mask=False))
    (l1, m1), g1 = TS.accumulate_grads(cfg, p, batch, 1)
    (l2, m2), g2 = TS.accumulate_grads(cfg, p, batch, 2)
    assert _rel(l2, l1) < 1e-5 and _rel(m2["ce"], m1["ce"]) < 1e-5
    for (path, a), (_, b) in zip(iter_leaves(g2), iter_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=str(path))


def test_grad_accum_in_a_wider_accumulator():
    """bf16 parameters with the default fp32 ``grad_accum_dtype``: the
    microbatches' bf16 gradients add into an fp32 accumulator."""
    cfg = dataclasses.replace(t_smoke("phi3-mini-3.8b"),
                              param_dtype="bfloat16")
    p = init_params(TM.model_specs(cfg), seed=0, device="cpu")
    batch = _tb(_batch(cfg, 4, 8, seed=5, mask=False))
    _, g = TS.accumulate_grads(cfg, p, batch, 2)
    _, g1 = TS.loss_and_grads(cfg, p, {k: v[:2] for k, v in batch.items()})
    _, g2 = TS.loss_and_grads(cfg, p, {k: v[2:] for k, v in batch.items()})
    for (path, a), (_, x), (_, y) in zip(iter_leaves(g), iter_leaves(g1),
                                         iter_leaves(g2)):
        assert a.dtype == torch.float32 and x.dtype == torch.bfloat16
        assert torch.equal(a, (x.float() + y.float()) / 2), path


def test_train_step_fits_one_batch():
    """Twenty steps on one repeated batch: the loss falls (the train path
    learns what it is shown)."""
    cfg = t_smoke("qwen3-32b")
    opt = TO.make_optimizer(cfg.optimizer, TO.cosine_schedule(1e-3, 2, 20))
    params = init_params(TM.model_specs(cfg), seed=0, device="cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step_fn = TS.make_train_step(cfg, opt)
    batch = _batch(cfg, 2, 64, seed=6, mask=False)
    losses = [float(step_fn(state, batch)[1]["loss"]) for _ in range(20)]
    assert losses[-1] < losses[0] - 0.5, losses


def test_make_train_step_refuses_a_mesh():
    cfg = t_smoke("qwen3-32b")
    opt = TO.make_optimizer("adamw")
    for kw in ({"mesh": object()}, {"rules": {}},
               {"param_shardings": {}}):
        with pytest.raises(NotImplementedError, match="A15"):
            TS.make_train_step(cfg, opt, **kw)


def test_lm_train_state_from_reference_keeps_shapes_and_dtypes():
    jcfg, tcfg = _cfgs("phi3-mini-3.8b")
    jp = j_init(JM.model_specs(jcfg), seed=0)
    for name in ("adamw", "adafactor"):
        jopt = JO.make_optimizer(name)
        jstate = jax.tree.map(np.asarray, {
            "params": jp, "opt": jopt.init(jp),
            "step": jnp.asarray(7, jnp.int32)})
        t = lm_train_state_from_reference(jstate, device="cpu")
        flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
        assert len(flat) == sum(1 for _ in iter_leaves(t))
        for path, want in flat:
            got = _at(t, [getattr(k, "key", k) for k in path])
            assert tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(got.numpy(), want)
        assert int(t["step"]) == 7
    with pytest.raises(ValueError, match="params, opt and step"):
        lm_train_state_from_reference({"params": {}}, device="cpu")


# ---------------------------------------------------------------------------
# The reference's own train tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_arch_smoke_train(name):
    """``tests/test_archs_smoke.py::test_arch_smoke_train_and_serve``'s
    train half."""
    cfg = t_smoke(name)
    params = init_params(TM.model_specs(cfg), seed=0, device="cpu")
    batch = _batch(cfg, 2, 32, seed=0, mask=False)
    logits, _ = TM.forward(cfg, params, torch.from_numpy(batch["tokens"]))
    assert logits.shape == (2, 32, cfg.vocab_padded)
    assert not torch.isnan(logits.float()).any()
    opt = TO.make_optimizer(cfg.optimizer, TO.cosine_schedule(1e-3, 2, 10))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state2, metrics = TS.make_train_step(cfg, opt)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2["step"]) == 1


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_policy_both_train(policy):
    """``tests/test_perf_levers.py::test_remat_policy_both_train``."""
    cfg = dataclasses.replace(t_smoke("qwen3-32b"), remat_policy=policy)
    params = _requiring_grad(init_params(TM.model_specs(cfg), seed=0,
                                         device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    lg, _ = TM.forward(cfg, params, toks)
    torch.mean(lg.float() ** 2).backward()
    assert np.isfinite(float(params["embed"].grad.sum()))


def test_runner_trains_resumes_and_monitors(tmp_path):
    """``tests/test_substrate.py::test_runner_trains_resumes_and_monitors``
    on the port's runner and data."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        return {"x": state["x"] + 1}, {"loss": 1.0 / (state["x"] + 1)}

    mgr = CheckpointManager(str(tmp_path))
    runner = TrainLoopRunner(step_fn, mgr, ckpt_every=4, log_every=100,
                             log_fn=lambda *a: None)
    state = {"x": torch.zeros((), dtype=torch.int32)}
    state, hist = runner.run(state, make_batch_iterator(10, 4, 2, seed=0),
                             num_steps=10)
    assert int(state["x"]) == 10
    assert len(hist) == 10
    runner2 = TrainLoopRunner(step_fn, mgr, ckpt_every=4, log_every=100,
                              log_fn=lambda *a: None)
    resumed, start = runner2.resume_or(
        {"x": torch.zeros((), dtype=torch.int32)})
    assert start == 8
    assert int(resumed["x"]) == 9   # state after step 8 ran


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def _quiet(*_):
    pass


def test_train_runs_twenty_steps_on_the_cpu():
    state, history = T.train("qwen3-32b", smoke=True, device="cpu",
                             log_fn=_quiet)
    assert [h["step"] for h in history] == list(range(20))
    losses = np.array([h["loss"] for h in history])
    assert np.isfinite(losses).all()
    # A near-uniform stream over 256 tokens: the loss stays near ln 256.
    assert np.abs(losses - np.log(256)).max() < 0.1
    assert int(state["step"]) == int(state["opt"]["count"]) == 20


def test_train_resume_after_preemption_equals_uninterrupted(tmp_path):
    """Preempted (SIGTERM) at step 10 and resumed, a checkpointed run
    equals the uninterrupted one bitwise on the CPU."""
    kw = dict(smoke=True, steps=20, ckpt_every=5, device="cpu")
    whole, hist = T.train("qwen3-32b", ckpt_dir=str(tmp_path / "a"),
                          log_fn=_quiet, **kw)

    def preempt_at_10(msg):
        if msg.startswith("[runner] step 10 "):
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    try:
        _, first = T.train("qwen3-32b", ckpt_dir=str(tmp_path / "b"),
                           log_fn=preempt_at_10, **kw)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert [h["step"] for h in first] == list(range(11))
    resumed, second = T.train("qwen3-32b", ckpt_dir=str(tmp_path / "b"),
                              log_fn=_quiet, **kw)
    assert [h["step"] for h in second] == list(range(11, 20))
    assert [h["loss"] for h in first + second] == [h["loss"] for h in hist]
    for (path, a), (_, b) in zip(iter_leaves(resumed), iter_leaves(whole)):
        assert torch.equal(a, b), path


@pytest.fixture(scope="module")
def uninterrupted_run(tmp_path_factory):
    return T.train("qwen3-32b", smoke=True, steps=20, ckpt_every=5,
                   device="cpu", log_fn=_quiet,
                   ckpt_dir=str(tmp_path_factory.mktemp("whole")))


@pytest.mark.parametrize("fail_at", [3, 12])
def test_train_retry_after_a_failed_step_equals_uninterrupted(
        tmp_path, monkeypatch, uninterrupted_run, fail_at):
    """A step that raises once after its in-place update began (before the
    first checkpoint, and after the one of step 10): the runner rolls back
    and replays, and the run equals the uninterrupted one bitwise."""
    make = TS.make_train_step

    def failing_once(cfg, opt, **kw):
        step_fn, failed = make(cfg, opt, **kw), []

        def step(state, batch):
            at = int(state["step"])
            state, metrics = step_fn(state, batch)
            if at == fail_at and not failed:
                failed.append(at)
                raise RuntimeError("device lost mid-update")
            return state, metrics
        return step

    monkeypatch.setattr(T.steps_lib, "make_train_step", failing_once)
    logs = []
    state, hist = T.train("qwen3-32b", smoke=True, steps=20, ckpt_every=5,
                          device="cpu", log_fn=logs.append,
                          ckpt_dir=str(tmp_path))
    assert any(f"step {fail_at} failed" in m for m in logs)
    whole, want = uninterrupted_run
    assert [h["step"] for h in hist] == list(range(20))
    assert [h["loss"] for h in hist] == [h["loss"] for h in want]
    for (path, a), (_, b) in zip(iter_leaves(state), iter_leaves(whole)):
        assert torch.equal(a, b), path


def test_train_main_smoke_on_the_cpu(capsys):
    assert T.main(["--arch", "qwen3-32b", "--smoke", "--steps", "3",
                   "--device", "cpu"]) is None
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "final loss ")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_train_refuses_what_is_not_ported(arch):
    with pytest.raises(NotImplementedError, match="A15"):
        T.train(arch, smoke=True, steps=1, device="cpu", log_fn=_quiet)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-370m",
                                  "llama4-scout-17b-a16e",
                                  "jamba-1.5-large-398b"])
def test_train_steps_refuse_moe_and_ssm_configs(arch):
    """The MoE / SSM / hybrid configs serve but do not train yet: the
    train step factory and the gradient entry point raise naming A15."""
    cfg = t_smoke(arch)
    params = init_params(TM.model_specs(cfg), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        TS.make_train_step(cfg, TO.make_optimizer("adamw"))
    batch = _tb(_batch(cfg, 2, 8, seed=0, mask=False))
    with pytest.raises(NotImplementedError, match="A15"):
        TS.loss_and_grads(cfg, params, batch)
    # the forward it would differentiate runs
    logits, _ = TM.forward(cfg, params, batch["tokens"])
    assert torch.isfinite(logits.float()).all()


def test_train_refuses_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train("qwen3-32b", smoke=True, steps=1, log_fn=_quiet)
