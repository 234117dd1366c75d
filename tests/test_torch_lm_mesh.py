"""The port's meshes, logical sharding rules and owner-computes MoE
dispatch against the JAX package's.

* ``params.logical_to_spec`` / ``LOGICAL_RULES``, ``sharding.
  default_rules`` / ``long_context_rules`` and ``steps.rules_for`` equal
  the reference's for every logical axis, rule set and mesh.
* For every runnable (arch, shape) of the ten configs on both production
  meshes, ``(16, 16)`` and ``(2, 16, 16)`` with ``"pod"``:
  ``steps.input_specs`` (the decode cache of ``abstract_cache``
  included), ``steps.train_state_specs``, ``params.abstract_params`` and
  ``params.tree_shardings`` give the reference's shapes, dtypes and
  partition specs, leaf for leaf. The reference's meshes need 512
  devices, so its side runs once per module in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=512`` set before
  JAX starts (``tests/conftest.py`` sets no such flag in this process);
  the subprocess also runs the reference's ``moe_apply_owner`` under
  ``shard_map`` on ``(1, 4)`` and ``(2, 2)`` meshes of four of those
  devices, on weights and inputs this process wrote. Partition specs
  are compared as JAX compares them: a one-name tuple is that name, and
  trailing ``None`` entries are dropped.
* ``moe.moe_apply_owner`` against the reference's at ``(1, 1)`` (in this
  process), ``(1, 4)`` and ``(2, 2)``: the router's ids on each token
  shard and the drop counts exactly, the output within 1e-5 of max|y|
  and the aux loss within 1e-6 relative, float32.
* The owner path against the port's own gather path at ``(1, n)``: the
  drops equal, the output bitwise at top-k <= 2 with no shared expert
  (a token's k rows are then added in the gather path's order), within
  1e-6 of max|y| otherwise; a rerun gives the same bits; gradients flow.
* ``make_train_step(mesh=, rules=, param_shardings=)``: a step under a
  ``(1, 4)`` mesh against the step without one, and the check of
  ``param_shardings``.

Torch runs one thread: the suite runs six files at a time.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import Mesh as JMesh  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import sharding as JSh  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, applicable  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import mesh as TMesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import sharding as TSh  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, F = 16, 32                     # the MoE tests' widths (test_torch_lm_moe)
MOE_CASES = [(1, 1), (2, 0), (4, 0), (4, 1)]       # (top_k, n_shared)
MESHES = {"pod1": False, "pod2": True}             # multi_pod


def _norm(spec):
    """A partition spec as JAX compares them: one-name tuples as the name,
    trailing ``None`` entries dropped; JSON-friendly (lists)."""
    if spec is None:
        return None
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return out


def _flat(tree, path=()):
    """``{"a/b": leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


def _port_entry(x):
    dt = str(x.dtype).split(".")[-1]
    return [list(x.shape), dt, _norm(x.spec)]


# ---------------------------------------------------------------------------
# The reference, in a subprocess on 512 forced host devices
# ---------------------------------------------------------------------------

_SCRIPT = r"""
import functools, json, os, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import ARCHS, SHAPES, applicable
from repro.launch.mesh import make_production_mesh
from repro.models import model as M, moe as MoE, params as P, steps as S
from repro.models.sharding import use_mesh_rules
from repro import optim as O

def norm(spec):
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return out

def entry(x):
    spec = None if x.sharding is None else norm(x.sharding.spec)
    return [list(x.shape), np.dtype(x.dtype).name, spec]

def flat(tree, fn):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): fn(x)
            for path, x in leaves}

out = {"meshes": {}, "specs": {}, "moe": {}}
for name, multi in (("pod1", False), ("pod2", True)):
    mesh = make_production_mesh(multi_pod=multi)
    out["meshes"][name] = [list(mesh.axis_names), list(mesh.devices.shape)]
    for arch, cfg in sorted(ARCHS.items()):
        pspecs = M.model_specs(cfg)
        for sname, shape in SHAPES.items():
            if not applicable(cfg, shape):
                continue
            rules = S.rules_for(shape, cfg)
            cell = {
                "inputs": flat(S.input_specs(cfg, shape, mesh, rules),
                               entry),
                "params": flat(P.abstract_params(pspecs, mesh, rules),
                               entry),
                "shardings": flat(P.tree_shardings(pspecs, mesh, rules),
                                  lambda s: norm(s.spec)),
            }
            if shape.kind == "train":
                opt = O.make_optimizer(cfg.optimizer)
                cell["state"] = flat(
                    S.train_state_specs(cfg, opt, mesh, rules), entry)
            out["specs"][f"{arch}|{sname}|{name}"] = cell

data = np.load(sys.argv[1])
devs = jax.devices()
for shape in ((1, 4), (2, 2)):
    mesh = Mesh(np.array(devs[:4]).reshape(shape), ("data", "model"))
    for top_k, n_shared in %(cases)s:
        params = {k[len(f"p{n_shared}/"):]: data[k] for k in data.files
                  if k.startswith(f"p{n_shared}/")}
        params = {k: v for k, v in params.items() if "/" not in k}
        if n_shared:
            params["shared"] = {k.split("/")[-1]: data[f"p{n_shared}/{k}"]
                                for k in ("shared/w_gate", "shared/w_up",
                                          "shared/w_down")}
        with use_mesh_rules(mesh):
            fn = jax.jit(functools.partial(MoE.moe_apply, n_real=6,
                                           top_k=top_k))
            y, m = fn(params, data["x"])
        out["moe"][f"{shape}|{top_k}|{n_shared}"] = {
            "y": np.asarray(y).tolist(), "aux": float(m["moe_aux"]),
            "dropped": int(m["moe_dropped"])}
print(json.dumps(out))
""" % {"cases": MOE_CASES}


def _moe_inputs():
    """The port's seeded draws for the MoE cases: weights without and
    with one shared expert (8 experts, 6 real), and ``x``."""
    ps = {n: TP.init_params({"m": TMoE.moe_specs(D, F, 8, n, 6)}, seed=7,
                            device="cpu")["m"] for n in (0, 1)}
    x = np.random.default_rng(7).standard_normal((2, 24, D)).astype(
        np.float32)
    return ps, x


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ps, x = _moe_inputs()
    arrays = {"x": x}
    for n, p in ps.items():
        for path, t in TP.iter_leaves(p):
            arrays[f"p{n}/" + "/".join(path)] = t.numpy()
    npz = tmp_path_factory.mktemp("mesh") / "moe.npz"
    np.savez(npz, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", _SCRIPT, str(npz)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.splitlines()[-1])


# ---------------------------------------------------------------------------
# Meshes and rules
# ---------------------------------------------------------------------------

def test_production_and_host_meshes(reference):
    for name, multi in MESHES.items():
        mesh = TMesh.make_production_mesh(multi_pod=multi)
        axes, sizes = reference["meshes"][name]
        assert list(mesh.axis_names) == axes and list(mesh.axis_sizes) == \
            sizes
        assert mesh.shape == dict(zip(axes, sizes))
        assert mesh.size == int(np.prod(sizes))
    host = TMesh.make_host_mesh()
    assert host.axis_names == ("data", "model") and host.size == 1
    with pytest.raises(ValueError, match="differ in length"):
        TMesh.Mesh(("data",), (1, 2))


def test_hw_holds_the_cards_constants_not_a_tpus():
    assert TMesh.HW["card"] == "NVIDIA H100 80GB HBM3"
    assert TMesh.HW["power_limit_w"] == 700.0
    assert TMesh.HW["hbm_bw"] == 3.35e12
    assert TMesh.HW["peak_flops_bf16"] == 989e12
    # The data sheet's 80 GB, not the TPU's 16 GiB; a card's own figure
    # comes from device_hw.
    assert TMesh.HW["hbm_bytes"] == 80e9


def _rule_sets():
    return {"default": (JSh.default_rules(), TSh.default_rules()),
            "long": (JSh.long_context_rules(), TSh.long_context_rules())}


def test_rules_equal_the_reference():
    assert TP.LOGICAL_RULES == JP.LOGICAL_RULES
    for jr, tr in _rule_sets().values():
        assert tr == jr


@pytest.mark.parametrize("rules", ["default", "long", "serving"])
@pytest.mark.parametrize("mesh", ["none", "host", "pod1", "pod2"])
def test_logical_to_spec_equals_the_reference(rules, mesh):
    """Every logical axis name (and ``None`` and an unknown name) alone
    and in tuples, resolved on the port's mesh descriptors: the
    reference's ``logical_to_spec`` reads only the mesh's axis names."""
    if rules == "serving":
        jr = JS.rules_for(J_SHAPES["decode_32k"], j_config("qwen3-32b"))
        tr = TS.rules_for(SHAPES["decode_32k"], get_config("qwen3-32b"))
        assert tr == jr and tr["embed"] is None
    else:
        jr, tr = _rule_sets()[rules]
    m = {"none": None, "host": TMesh.make_host_mesh(),
         "pod1": TMesh.make_production_mesh(),
         "pod2": TMesh.make_production_mesh(multi_pod=True)}[mesh]
    names = sorted(TP.LOGICAL_RULES) + [None, "unknown"]
    for i, a in enumerate(names):
        axes = (a, names[(i + 3) % len(names)], None)
        want = JP.logical_to_spec(axes, jr, m)
        got = TP.logical_to_spec(axes, tr, m)
        assert isinstance(got, tuple) and len(got) == 3
        assert _norm(got) == _norm(want)
    assert TP.logical_to_spec(("batch",)) == (("pod", "data"),)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_for_equals_the_reference(arch):
    for sname, shape in SHAPES.items():
        assert TS.rules_for(shape, get_config(arch)) == JS.rules_for(
            J_SHAPES[sname], j_config(arch))
        assert TS.rules_for(shape) == JS.rules_for(J_SHAPES[sname])
    big = TS.rules_for(SHAPES["decode_32k"],
                       get_config("jamba-1.5-large-398b"))
    assert big["embed"] == ("pod", "data")          # keeps FSDP
    assert TS.rules_for(SHAPES["long_500k"])["batch"] is None


# ---------------------------------------------------------------------------
# Abstract specs on the production meshes
# ---------------------------------------------------------------------------

def _cells():
    return [(arch, sname, mesh) for arch, cfg in sorted(ARCHS.items())
            for sname, shape in SHAPES.items() if applicable(cfg, shape)
            for mesh in MESHES]


@pytest.mark.parametrize("arch,sname,mesh", _cells())
def test_specs_equal_the_reference_on_production_meshes(reference, arch,
                                                        sname, mesh):
    cfg, shape = get_config(arch), SHAPES[sname]
    m = TMesh.make_production_mesh(multi_pod=MESHES[mesh])
    rules = TS.rules_for(shape, cfg)
    want = reference["specs"][f"{arch}|{sname}|{mesh}"]
    pspecs = TM.model_specs(cfg)
    got = {
        "inputs": {k: _port_entry(v) for k, v in
                   _flat(TS.input_specs(cfg, shape, m, rules)).items()},
        "params": {k: _port_entry(v) for k, v in
                   _flat(TP.abstract_params(pspecs, m, rules)).items()},
        "shardings": {k: _norm(v) for k, v in
                      _flat(TP.tree_shardings(pspecs, m, rules)).items()},
    }
    if shape.kind == "train":
        opt = TO.make_optimizer(cfg.optimizer)
        got["state"] = {k: _port_entry(v) for k, v in _flat(
            TS.train_state_specs(cfg, opt, m, rules)).items()}
    assert set(got) == set(want)
    for part in want:
        assert got[part] == want[part], part
    if shape.kind == "decode":
        assert any("/" in k for k in got["inputs"])      # the cache


@pytest.mark.parametrize("arch", ["qwen3-32b", "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_specs_without_a_mesh_have_no_partition_specs(arch):
    cfg = get_config(arch)
    for sname, shape in SHAPES.items():
        if not applicable(cfg, shape):
            continue
        got = _flat(TS.input_specs(cfg, shape))
        want = jax.tree_util.tree_flatten_with_path(JS.input_specs(
            j_config(arch), J_SHAPES[sname]))[0]
        assert len(got) == len(want)
        for path, w in want:
            g = got["/".join(str(k.key) for k in path)]
            assert g.spec is None and w.sharding is None
            assert g.shape == w.shape
    st = TS.train_state_specs(cfg, TO.make_optimizer(cfg.optimizer))
    assert st["step"].shape == () and st["step"].dtype == torch.int32
    leaf = st["params"]["embed"].meta()
    assert leaf.device.type == "meta" and leaf.dtype == torch.float32
    assert tuple(leaf.shape) == (cfg.vocab_padded, cfg.d_model)


def test_shard_resolves_under_a_mesh_and_is_the_identity():
    x = torch.zeros(2, 3, 4)
    assert TSh.shard(x, "batch", "seq", "bogus", "too", "many") is x
    mesh = TMesh.make_production_mesh()
    with TSh.use_mesh_rules(mesh):
        assert TSh.active_mesh_rules()[0] is mesh
        assert TSh.shard(x, "batch", "seq", "act_embed") is x
        with pytest.raises(ValueError, match="3 dimensions"):
            TSh.shard(x, "batch", "seq", None, None)
        with pytest.raises(ValueError, match="twice"):
            TSh.shard(x, "heads", "mlp")
        with TSh.use_mesh_rules(None):
            assert TSh.active_mesh_rules() is None
    assert TSh.active_mesh_rules() is None


# ---------------------------------------------------------------------------
# moe_apply_owner
# ---------------------------------------------------------------------------

def _owner(p, x, shape, top_k, **kw):
    with TSh.use_mesh_rules(TMesh.make_mesh(shape, ("data", "model"))):
        return TMoE.moe_apply(p, x, n_real=6, top_k=top_k, **kw)


def _check_against(y, m, want_y, want_aux, want_dropped):
    want_y = np.asarray(want_y, np.float32)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5,
                               atol=1e-5 * np.abs(want_y).max())
    assert int(m["moe_dropped"]) == want_dropped
    np.testing.assert_allclose(float(m["moe_aux"]), want_aux, rtol=1e-6)


def _routes_equal(tp, x, n_tok, top_k):
    """The router's ids on each of ``n_tok`` token shards, both
    packages."""
    xf = x.reshape(-1, D)
    for xs in np.split(xf, n_tok):
        _, jids, _ = JMoE.router_assign(jnp.asarray(xs),
                                        jnp.asarray(tp["router"].numpy()),
                                        6, top_k)
        _, tids, _ = TMoE.router_assign(torch.from_numpy(xs), tp["router"],
                                        6, top_k)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("top_k,n_shared", MOE_CASES)
def test_moe_owner_matches_reference_at_1x1(top_k, n_shared):
    ps, x = _moe_inputs()
    tp = ps[n_shared]
    jp = jax.tree.map(lambda t: t.numpy(), tp)
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    with JSh.use_mesh_rules(mesh):
        jy, jm = JMoE.moe_apply_owner(jp, jnp.asarray(x), n_real=6,
                                      top_k=top_k)
    y, m = _owner(tp, torch.from_numpy(x), (1, 1), top_k)
    _check_against(y, m, jy, float(jm["moe_aux"]), int(jm["moe_dropped"]))
    _routes_equal(tp, x, 1, top_k)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("top_k,n_shared", MOE_CASES)
def test_moe_owner_matches_reference_on_meshes(reference, shape, top_k,
                                               n_shared):
    ps, x = _moe_inputs()
    want = reference["moe"][f"{shape}|{top_k}|{n_shared}"]
    y, m = _owner(ps[n_shared], torch.from_numpy(x), shape, top_k)
    _check_against(y, m, want["y"], want["aux"], want["dropped"])
    _routes_equal(ps[n_shared], x, shape[0], top_k)
    assert m["moe_sent_bytes"] == shape[0] * shape[1] * x.size // shape[0] \
        * 4


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("top_k,n_shared", MOE_CASES)
def test_owner_path_against_the_gather_path(n, top_k, n_shared):
    ps, x = _moe_inputs()
    tx = torch.from_numpy(x)
    yg, mg = TMoE.moe_apply(ps[n_shared], tx, n_real=6, top_k=top_k)
    yo, mo = _owner(ps[n_shared], tx, (1, n), top_k)
    assert int(mo["moe_dropped"]) == int(mg["moe_dropped"]) > 0
    assert torch.equal(mo["moe_aux"], mg["moe_aux"])
    if top_k <= 2 and not n_shared or n == 1:
        assert torch.equal(yo, yg)
    else:
        scale = float(yg.abs().max())
        assert float((yo - yg).abs().max()) <= 1e-6 * scale
    again, _ = _owner(ps[n_shared], tx, (1, n), top_k)
    assert torch.equal(again, yo)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [2, 4])
def test_owner_path_differs_only_where_the_owners_group_rows(n):
    """With no shared expert, the owner path's output is bitwise the
    gather path's on every token but those whose kept rows the owners
    group otherwise (``chip_smoke.owner_order_tokens``, the predicate
    ``[moe-owner]`` checks on the card), and those tokens exist."""
    cs = _chip_smoke()
    p = TP.init_params({"m": TMoE.moe_specs(D, F, 16, 0, 14)}, seed=9,
                       device="cpu")["m"]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 64, D)).astype(np.float32))
    yg, _ = TMoE.moe_apply(p, x, n_real=14, top_k=4)
    with TSh.use_mesh_rules(TMesh.make_mesh((1, n), ("data", "model"))):
        yo, _ = TMoE.moe_apply(p, x, n_real=14, top_k=4)
    _, ids, _ = TMoE.router_assign(x.reshape(-1, D), p["router"], 14, 4)
    cap = TMoE.capacity(x.shape[0] * x.shape[1], 4, 1.25, 16)
    may = cs.owner_order_tokens(ids, cs._dropped_pairs(ids, cap), n, 16 // n)
    differ = (yo != yg).reshape(-1, D).any(1)
    assert not (differ & ~may).any()
    assert int(may.sum()) > 0 and int(differ.sum()) > 0


def test_owner_impls_and_gradients():
    ps, x = _moe_inputs()
    tp = {k: v.clone().requires_grad_(True) if k != "shared" else v
          for k, v in ps[0].items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, m = _owner(tp, tx, (1, 4), 2)
    yg, _ = TMoE.moe_apply(tp, tx, n_real=6, top_k=2, impl="gather")
    with TSh.use_mesh_rules(TMesh.make_mesh((1, 4), ("data", "model"))):
        yg2, mg = TMoE.moe_apply(tp, tx, n_real=6, top_k=2, impl="gather")
    assert "moe_sent_bytes" in m and "moe_sent_bytes" not in mg
    assert torch.equal(yg2, yg)
    (y.square().sum()).backward()
    go = {k: v.grad.clone() for k, v in tp.items()} | {"x": tx.grad.clone()}
    for t in list(tp.values()) + [tx]:
        t.grad = None
    (yg.square().sum()).backward()
    for k, v in list(tp.items()) + [("x", tx)]:
        np.testing.assert_allclose(go[k].numpy(), v.grad.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(v.grad.abs().max()))
    no_experts = dict(TSh.default_rules(), experts=None)
    with TSh.use_mesh_rules(TMesh.make_mesh((1, 4), ("data", "model")),
                            no_experts):
        y3, m3 = TMoE.moe_apply_owner(tp, tx, n_real=6, top_k=2)
    assert torch.equal(y3, yg) and "moe_sent_bytes" not in m3
    with pytest.raises(ValueError, match="mesh context"):
        TMoE.moe_apply_owner(tp, tx, n_real=6, top_k=2)
    with pytest.raises(ValueError, match="do not split"):
        _owner(tp, tx, (1, 3), 2)


# ---------------------------------------------------------------------------
# make_train_step under a mesh
# ---------------------------------------------------------------------------

def _state(cfg, opt, seed=0):
    params = TP.init_params(TM.model_specs(cfg), seed=seed, device="cpu")
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "qwen3-32b"])
def test_train_step_under_a_mesh_against_no_mesh(name):
    cfg = dataclasses.replace(smoke_config(name), act_dtype="float32")
    opt = TO.make_optimizer("adamw")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mesh = TMesh.make_mesh((1, 4), ("data", "model"))
    rules = TS.rules_for(SHAPES["train_4k"])
    shardings = TP.tree_shardings(TM.model_specs(cfg), mesh, rules)
    a, b = _state(cfg, opt), _state(cfg, opt)
    _, ma = TS.make_train_step(cfg, opt, grad_accum=2)(a, batch)
    _, mb = TS.make_train_step(cfg, opt, mesh, rules, grad_accum=2,
                               param_shardings=shardings)(b, batch)
    for k in ("loss", "grad_norm", "ce", "moe_aux"):
        np.testing.assert_allclose(float(mb[k]), float(ma[k]), rtol=1e-5)
    for (path, pa), (_, pb) in zip(TP.iter_leaves(a["params"]),
                                   TP.iter_leaves(b["params"])):
        np.testing.assert_allclose(pb.numpy(), pa.numpy(), rtol=0,
                                   atol=1e-5 * float(pa.abs().max()),
                                   err_msg="/".join(path))
    assert int(b["step"]) == 1


def test_train_step_checks_param_shardings():
    cfg = smoke_config("qwen3-32b")
    opt = TO.make_optimizer("adamw")
    mesh = TMesh.make_production_mesh()
    good = TP.tree_shardings(TM.model_specs(cfg), mesh)
    TS.make_train_step(cfg, opt, mesh, param_shardings=good)
    bad = dict(good, embed=(None, None))
    with pytest.raises(ValueError, match="embed"):
        TS.make_train_step(cfg, opt, mesh, param_shardings=bad)
    with pytest.raises(ValueError, match="keys"):
        TS.make_train_step(cfg, opt, mesh, param_shardings={"embed": ()})
