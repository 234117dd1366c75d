"""Port parity: ``repro_torch.checkpoint`` and
``repro_torch.resilience.checkpoint`` against the reference.

* one on-disk format: for the same state the port writes the reference's
  file names and ``tree.json`` manifest; a checkpoint written by either
  package restores bitwise in the other;
* the atomic protocol: stale ``tmp.*`` dirs are swept, ``keep`` holds the
  newest steps, a save killed mid-write (SIGKILL) never corrupts the
  newest complete checkpoint, and a run killed mid-way resumes warm;
* validated restore: a fingerprint or shape mismatch raises, and the
  port's ``cp_als`` (backend ``"torch"``) refuses a checkpoint of the
  reference's (``"jax"``);
* resumes are exact: ``cp_als`` and the stepped ``cp_als_distributed``
  (D=1 and D=4) stopped and resumed equal a straight run bitwise.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.core import cpals as jcpals  # noqa: E402
from repro.resilience import checkpoint as jckpt  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten_with_paths  # noqa: E402
from repro_torch.core import cpals as tcpals  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import tensors as ttens  # noqa: E402
from repro_torch.core.workers import LocalWorkers  # noqa: E402
from repro_torch.obs import counters as tcnt  # noqa: E402
from repro_torch.resilience import RetryPolicy  # noqa: E402
from repro_torch.resilience import checkpoint as tckpt  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _arrays(seed=0, rank=4):
    rng = np.random.default_rng(seed)
    factors = [rng.standard_normal((d, rank)).astype(np.float32)
               for d in (6, 5, 3)]
    stream = (rng.integers(0, 5, (1, 11, 3)).astype(np.int32),
              rng.standard_normal((1, 11)).astype(np.float32),
              rng.random((1, 11)) < 0.7)
    return factors, np.linspace(1, 2, rank).astype(np.float32), stream


def _state(mod, seed=0, sweep=2, **kw):
    factors, lam, stream = _arrays(seed)
    kw.setdefault("backend", "auto")
    return mod.make_state(factors, lam, [0.25, 0.5], sweep=sweep, rank=4,
                          ordering="none", stream=stream, **kw)


def _dir_listing(path):
    return sorted(os.listdir(path))


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "factors":
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(_host(x), _host(y))
        else:
            x, y = _host(a[k]), _host(b[k])
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_manifest_and_file_names_equal_reference(tmp_path):
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tckpt.save_state(tckpt.make_manager(tdir), _state(tckpt))
    jckpt.save_state(jckpt.make_manager(jdir), _state(jckpt))
    step = "step_0000000002"
    assert _dir_listing(tdir) == _dir_listing(jdir) == [step]
    assert _dir_listing(os.path.join(tdir, step)) == \
        _dir_listing(os.path.join(jdir, step))
    assert "factors__0.npy" in _dir_listing(os.path.join(tdir, step))
    with open(os.path.join(tdir, step, "tree.json")) as f:
        tman = json.load(f)
    with open(os.path.join(jdir, step, "tree.json")) as f:
        jman = json.load(f)
    assert tman == jman
    assert list(tman) == list(jman)   # same (sorted) order


def test_reference_checkpoint_restores_bitwise_in_port(tmp_path):
    jckpt.save_state(jckpt.make_manager(str(tmp_path)), _state(jckpt))
    with tcnt.use_registry() as reg:
        got, sweep = tckpt.restore_state(
            tckpt.make_manager(str(tmp_path)), _state(tckpt, seed=1, sweep=0),
            device="cpu")
        assert reg.get("resilience.checkpoint.restores") == 1
    assert sweep == 2
    assert isinstance(got["factors"][0], torch.Tensor)
    assert isinstance(got["stream_mask"], torch.Tensor)
    assert got["stream_mask"].dtype == torch.bool
    assert isinstance(got["backend"], np.ndarray)   # strings stay numpy
    _assert_state_equal(got, _state(tckpt))


def test_port_checkpoint_restores_bitwise_in_reference(tmp_path):
    state = _state(tckpt)
    state["factors"] = [torch.from_numpy(f) for f in state["factors"]]
    state["lam"] = torch.from_numpy(state["lam"])
    tckpt.save_state(tckpt.make_manager(str(tmp_path / "t")), state)
    jckpt.save_state(jckpt.make_manager(str(tmp_path / "j")), _state(jckpt))
    template = _state(jckpt, seed=1, sweep=0)
    got, sweep = jckpt.restore_state(jckpt.make_manager(str(tmp_path / "t")),
                                     template)
    own, _ = jckpt.restore_state(jckpt.make_manager(str(tmp_path / "j")),
                                 template)
    assert sweep == 2
    # Bitwise what the reference restores from its own checkpoint (JAX
    # without x64 gives the float64 fit trace back as float32 either way).
    _assert_state_equal(got, own)
    np.testing.assert_array_equal(np.asarray(got["stream_idx"]),
                                  _state(jckpt)["stream_idx"])


@pytest.mark.parametrize("tree", [
    0, np.float32(2.5), [np.arange(3)], (np.ones(2), {"b": np.zeros(1)}),
    {"z": np.arange(4), "a": [np.ones((2, 2)), None, np.int64(7)]},
])
def test_tree_layout_equal_reference(tmp_path, tree):
    CheckpointManager(str(tmp_path / "t")).save(1, tree)
    JManager(str(tmp_path / "j")).save(1, tree)
    step = "step_0000000001"
    for name in _dir_listing(tmp_path / "j" / step):
        a = tmp_path / "t" / step / name
        b = tmp_path / "j" / step / name
        assert a.read_bytes() == b.read_bytes(), name
    # Each restores the other's files, leaf for leaf.
    import jax
    restored, _ = CheckpointManager(str(tmp_path / "j")).restore(tree)
    restored_j, _ = JManager(str(tmp_path / "t")).restore(tree)
    leaves = [leaf for _, leaf in _flatten_with_paths(restored)]
    assert len(leaves) == len(jax.tree.leaves(restored_j))
    for x, y in zip(jax.tree.leaves(restored_j), leaves):
        np.testing.assert_array_equal(np.asarray(x), _host(y))


@pytest.mark.parametrize("mutate, match", [
    (dict(rank=5), "rank"), (dict(backend="pallas"), "backend"),
    (dict(ordering="morton"), "ordering")])
def test_restore_rejects_config_mismatch(tmp_path, mutate, match):
    mgr = tckpt.make_manager(str(tmp_path))
    factors, lam, _ = _arrays()
    base = dict(sweep=0, rank=4, backend="auto", ordering="none")
    tckpt.save_state(mgr, tckpt.make_state(factors, lam, [0.5], **base))
    with pytest.raises(ValueError, match=match):
        tckpt.restore_state(mgr, tckpt.make_state(factors, lam, [],
                                                  **{**base, **mutate}))


def test_restore_rejects_shape_mismatch_and_empty_dir(tmp_path):
    mgr = tckpt.make_manager(str(tmp_path))
    assert tckpt.restore_state(mgr, _state(tckpt)) == (None, None)
    assert tckpt.make_manager(None) is None
    tckpt.save_state(mgr, _state(tckpt))
    template = _state(tckpt)
    template["factors"][0] = template["factors"][0][:-1]
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_state(mgr, template)


def test_manager_sweeps_stale_tmp_and_keeps_newest(tmp_path):
    stale = tmp_path / "tmp.7"
    stale.mkdir()
    (stale / "half_written.npy").write_bytes(b"\x00" * 16)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert not stale.exists()
    for step in (1, 2, 3):
        mgr.save(step, {"x": np.full(3, step)})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    got, step = mgr.restore({"x": np.zeros(3)}, step=2, device="cpu")
    assert step == 2 and torch.equal(got["x"], torch.full((3,), 2))


def test_cp_als_resume_matches_uninterrupted(tmp_path):
    t = ttens.random_sparse_tensor((12, 10, 8), 120, seed=0)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    with tcnt.use_registry() as reg:
        tcpals.cp_als(t, 4, device="cpu", iters=2, tol=0.0,
                      checkpoint_dir=d1)
        resumed = tcpals.cp_als(t, 4, device="cpu", iters=4, tol=0.0,
                                checkpoint_dir=d1)
        full = tcpals.cp_als(t, 4, device="cpu", iters=4, tol=0.0,
                             checkpoint_dir=d2)
        assert reg.get("resilience.checkpoint.restores") == 1
        assert reg.get("cpals.sweeps", driver="single") == 2 + 2 + 4
    assert resumed.fits == full.fits and len(full.fits) == 4
    for a, b in zip(resumed.factors, full.factors):
        np.testing.assert_array_equal(a, b)


def test_cp_als_refuses_a_reference_checkpoint(tmp_path):
    from repro.core import tensors as jten
    jcpals.cp_als(jten.random_sparse_tensor((12, 10, 8), 120, seed=0), 4,
                  iters=1, checkpoint_dir=str(tmp_path))
    t = ttens.random_sparse_tensor((12, 10, 8), 120, seed=0)
    with pytest.raises(ValueError, match="backend=jax"):
        tcpals.cp_als(t, 4, device="cpu", iters=2,
                      checkpoint_dir=str(tmp_path))


@pytest.mark.parametrize("D", [1, 4])
def test_stepped_resume_is_exact(tmp_path, D):
    t = ttens.random_sparse_tensor((30, 20, 10), 500, seed=3)
    ft = tfly.build_flycoo(t, D, m_bounds=(2, 8), g_bounds=(8, 64),
                           cache_bytes=1 << 20)
    kw = dict(workers=LocalWorkers(D, "cpu"), tol=0.0, backend="auto")
    d1 = str(tmp_path / "a")
    with tcnt.use_registry() as reg:
        tcpals.cp_als_distributed(ft, 8, iters=2, checkpoint_dir=d1,
                                  checkpoint_keep=1, **kw)
        assert CheckpointManager(d1).all_steps() == [1]
        resumed = tcpals.cp_als_distributed(ft, 8, iters=4,
                                            checkpoint_dir=d1, **kw)
        assert reg.get("resilience.checkpoint.restores") == 1
        assert reg.get("resilience.checkpoint.saves") == 4
    full = tcpals.cp_als_distributed(ft, 8, iters=4,
                                     resilience=RetryPolicy(), **kw)
    assert resumed.fits == full.fits
    for a, b in zip(resumed.factors, full.factors):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(resumed.lam, full.lam)
    state, _ = CheckpointManager(d1).restore(
        {"stream_idx": 0, "stream_val": 0, "stream_mask": 0})
    assert state["stream_idx"].shape[0] == D   # the worker axis


GROUP_CHILD = textwrap.dedent("""
    import datetime, json, sys
    import torch
    torch.set_num_threads(1)
    import torch.distributed as tdist
    rank, rdv, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    tdist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                             world_size=2,
                             timeout=datetime.timedelta(seconds=60))
    from repro_torch.core import cpals, flycoo, tensors
    from repro_torch.core.workers import GroupWorkers
    ft = flycoo.build_flycoo(tensors.random_sparse_tensor((30, 20, 10),
                                                          500, seed=3), 2)
    res = cpals.cp_als_distributed(ft, 8, workers=GroupWorkers(device="cpu"),
                                   iters=3, tol=0.0, checkpoint_dir=d,
                                   checkpoint_keep=1)
    tdist.destroy_process_group()
    print("FITS", json.dumps(res.fits))
""")


def test_checkpoint_across_processes_is_a10b(tmp_path):
    """ROADMAP A10b: ``checkpoint_dir`` with workers spread over processes
    (``GroupWorkers`` over gloo, 2 ranks) checkpoints: rank 0 keeps only
    the newest step (``checkpoint_keep=1``), whose stream holds both
    workers, and the ranks end with the same fits."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    d = str(tmp_path / "ck")
    procs = [subprocess.Popen(
        [sys.executable, "-c", GROUP_CHILD, str(r), str(tmp_path / "rdv"),
         d], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    fits = []
    for p, (so, se) in zip(procs, logs):
        assert p.returncode == 0, so + se
        fits.append(json.loads(so.split("FITS", 1)[1]))
    assert fits[0] == fits[1] and len(fits[0]) == 3
    mgr = CheckpointManager(d)
    assert mgr.all_steps() == [2]
    state, _ = mgr.restore({"stream_idx": 0, "fits": 0})
    assert state["stream_idx"].shape[0] == 2   # both workers' streams
    np.testing.assert_array_equal(state["fits"].numpy(), fits[0])


def _run_child(code):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)


def test_sigkill_mid_save_never_corrupts_newest(tmp_path):
    d = str(tmp_path / "ck")
    proc = _run_child(textwrap.dedent(f"""
        import os, signal
        import numpy as np
        import repro_torch.checkpoint.manager as m
        mgr = m.CheckpointManager({d!r})
        mgr.save(1, dict(x=np.arange(64, dtype=np.float32),
                         y=np.ones((8, 8), np.float32)))
        orig = m._fsync_file
        def dying(path, _n=[0]):
            _n[0] += 1
            if _n[0] >= 2:                      # mid-way through save #2
                os.kill(os.getpid(), signal.SIGKILL)
            orig(path)
        m._fsync_file = dying
        mgr.save(2, dict(x=np.full(64, 9.0, np.float32),
                         y=np.zeros((8, 8), np.float32)))
        raise SystemExit("unreachable: SIGKILL expected")
    """))
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert [n for n in os.listdir(d) if n.startswith("tmp.")] == ["tmp.2"]
    mgr = CheckpointManager(d)
    assert [n for n in os.listdir(d) if n.startswith("tmp.")] == []
    assert mgr.all_steps() == [1]
    restored, step = mgr.restore(dict(x=np.zeros(64, np.float32),
                                      y=np.zeros((8, 8), np.float32)))
    assert step == 1
    np.testing.assert_array_equal(restored["x"].numpy(),
                                  np.arange(64, dtype=np.float32))


def test_sigkill_mid_run_resumes_warm(tmp_path):
    d = str(tmp_path / "ck")
    proc = _run_child(textwrap.dedent(f"""
        import os, signal
        import repro_torch.resilience.checkpoint as rc
        orig = rc.save_state
        def dying(mgr, state, _n=[0]):
            path = orig(mgr, state)
            _n[0] += 1
            if _n[0] >= 2:
                os.kill(os.getpid(), signal.SIGKILL)   # die after sweep 1
            return path
        rc.save_state = dying
        from repro_torch.core import cpals, tensors
        t = tensors.random_sparse_tensor((12, 10, 8), 120, seed=0)
        cpals.cp_als(t, 4, device="cpu", iters=5, tol=0.0,
                     checkpoint_dir={d!r})
        raise SystemExit("unreachable: SIGKILL expected")
    """))
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert CheckpointManager(d).latest_step() == 1
    t = ttens.random_sparse_tensor((12, 10, 8), 120, seed=0)
    with tcnt.use_registry() as reg:
        resumed = tcpals.cp_als(t, 4, device="cpu", iters=5, tol=0.0,
                                checkpoint_dir=d)
        assert reg.get("resilience.checkpoint.restores") == 1
    full = tcpals.cp_als(t, 4, device="cpu", iters=5, tol=0.0)
    assert resumed.fits == full.fits and len(full.fits) == 5
