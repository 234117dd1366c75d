"""Checkpoints with workers spread over processes: ``GroupWorkers`` over
gloo at 2 and 4 ranks against ``LocalWorkers`` at the same D.

* the checkpoint rank 0 writes has ``LocalWorkers``' manifest and stream
  arrays exactly, and its factors, λ and fits within the tolerance the
  gloo tests of ``tests/test_torch_distributed.py`` hold the two to
  (gloo's ``all_reduce`` may add in another order than
  ``LocalWorkers.psum``); rank 0's ``resilience.*`` counters and spans
  equal ``LocalWorkers``';
* a ``GroupWorkers`` checkpoint resumes under ``LocalWorkers`` and the
  reverse;
* a run stopped after a sweep and resumed is bitwise the straight run;
* a save killed before its rename leaves the previous step newest on
  every rank.

Each world spawns its ranks once for the first three (a module fixture)
and twice for the killed save, with a ``file://`` rendezvous.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import cpals as tcpals  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import tensors as ttens  # noqa: E402
from repro_torch.core.workers import LocalWorkers  # noqa: E402
from repro_torch.obs import counters as tcnt  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402
from repro_torch.resilience import RetryPolicy  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK = 8
# The tolerances of test_group_workers_over_gloo_equal_local_workers.
FAC_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_TOL = 1e-5

PRELUDE = r"""
import datetime, json, os, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
rank, world, rdv, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
tdist.init_process_group("gloo", init_method="file://" + rdv, rank=rank,
                         world_size=world,
                         timeout=datetime.timedelta(seconds=60))
from repro_torch.core import cpals, flycoo, tensors
from repro_torch.core.workers import GroupWorkers
from repro_torch.obs import counters as cnt
from repro_torch.obs.tracer import Tracer
from repro_torch.resilience import RetryPolicy
from repro_torch.resilience import checkpoint as rc
ft = flycoo.build_flycoo(tensors.random_sparse_tensor((30, 20, 10), 500,
                                                      seed=3), world,
                         m_bounds=(2, 8), g_bounds=(8, 64),
                         cache_bytes=1 << 20)
wk = GroupWorkers(device="cpu")
kw = dict(workers=wk, tol=0.0, backend="auto")
def d(name):
    return os.path.join(out_dir, name)
def save(tag, res, **extra):
    np.savez(d(f"{tag}.rank{rank}.npz"), fits=np.asarray(res.fits),
             lam=res.lam, **{f"f{n}": f for n, f in enumerate(res.factors)},
             **extra)
"""

# Straight checkpointed run, stop-and-resume, and a resume of a
# LocalWorkers checkpoint.
MAIN = PRELUDE + r"""
with cnt.use_registry() as reg:
    tr = Tracer()
    res = cpals.cp_als_distributed(ft, 8, iters=2, tracer=tr,
                                   checkpoint_dir=d("group"),
                                   checkpoint_keep=5, **kw)
    spans = [[r.name, r.depth, sorted(map(str, r.args.items()))]
             for r in tr.records]
    counters = {k: v for k, v in reg.snapshot().items()
                if k.startswith("resilience.")}
save("group", res, spans=np.array(json.dumps(spans)),
     counters=np.array(json.dumps(counters)))
cpals.cp_als_distributed(ft, 8, iters=2, checkpoint_dir=d("stop"), **kw)
with cnt.use_registry() as reg:
    res = cpals.cp_als_distributed(ft, 8, iters=4, checkpoint_dir=d("stop"),
                                   **kw)
    restores = reg.get("resilience.checkpoint.restores")
save("resumed", res, restores=restores)
save("straight", cpals.cp_als_distributed(ft, 8, iters=4,
                                          resilience=RetryPolicy(), **kw))
save("from_local", cpals.cp_als_distributed(
    ft, 8, iters=4, checkpoint_dir=d("local_resume"), **kw))
tdist.destroy_process_group()
print("RANK-OK", rank)
"""

# Rank 0 dies in the save of sweep 2, after its files and before the
# rename; the other ranks wait at the barrier until the test kills them.
KILL = PRELUDE + r"""
cpals.cp_als_distributed(ft, 8, iters=2, checkpoint_dir=d("kill"), **kw)
if rank == 0:
    import repro_torch.checkpoint.manager as m
    def dying(path):
        os.kill(os.getpid(), signal.SIGKILL)
    m._fsync_dir = dying
cpals.cp_als_distributed(ft, 8, iters=3, checkpoint_dir=d("kill"), **kw)
raise SystemExit("unreachable: rank 0 is killed in the save")
"""

# Every rank resumes from the killed run's directory.
PROBE = PRELUDE + r"""
steps = []
orig = rc.restore_state
def recording(*a, **k):
    state, step = orig(*a, **k)
    steps.append(-1 if step is None else step)
    return state, step
rc.restore_state = recording
res = cpals.cp_als_distributed(ft, 8, iters=3, checkpoint_dir=d("kill"),
                               **kw)
save("probe", res, steps=np.asarray(steps))
tdist.destroy_process_group()
print("RANK-OK", rank)
"""


def _spawn(script, world, out_dir, tag):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    rdv = os.path.join(out_dir, f"rendezvous-{tag}")
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), rdv, out_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def _finish(procs, timeout=240):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def _run(script, world, out_dir, tag):
    procs = _spawn(script, world, out_dir, tag)
    logs = _finish(procs)
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK-OK {r}" in so, so + se


def _load(out_dir, tag, rank):
    with np.load(os.path.join(out_dir, f"{tag}.rank{rank}.npz")) as z:
        return dict(z)


def _ft(world):
    t = ttens.random_sparse_tensor((30, 20, 10), 500, seed=3)
    return tfly.build_flycoo(t, world, m_bounds=(2, 8), g_bounds=(8, 64),
                             cache_bytes=1 << 20)


def _local_kw(world):
    return dict(workers=LocalWorkers(world, "cpu"), tol=0.0, backend="auto")


def _as_dict(res):
    return dict(fits=np.asarray(res.fits), lam=res.lam,
                **{f"f{n}": f for n, f in enumerate(res.factors)})


def _assert_close(got, want):
    """Two runs' fits, λ and factors (saved rank results or ``CPResult``s)
    at the gloo tolerance."""
    got = got if isinstance(got, dict) else _as_dict(got)
    want = want if isinstance(want, dict) else _as_dict(want)
    np.testing.assert_allclose(got["fits"], want["fits"], rtol=0,
                               atol=FIT_TOL)
    for key in want:
        if key != "fits":
            np.testing.assert_allclose(got[key], want[key], **FAC_TOL,
                                       err_msg=key)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def group_run(request, tmp_path_factory):
    """The ranks' results of MAIN at one world size, beside the
    ``LocalWorkers`` checkpoint and runs at the same D."""
    world = request.param
    out = str(tmp_path_factory.mktemp(f"group{world}"))
    ft, kw = _ft(world), _local_kw(world)
    with tcnt.use_registry() as reg:
        tr = Tracer()
        local = tcpals.cp_als_distributed(ft, RANK, iters=2, tracer=tr,
                                          checkpoint_dir=os.path.join(
                                              out, "local"),
                                          checkpoint_keep=5, **kw)
        counters = {k: v for k, v in reg.snapshot().items()
                    if k.startswith("resilience.")}
    spans = [[r.name, r.depth, sorted(map(str, r.args.items()))]
             for r in tr.records]
    shutil.copytree(os.path.join(out, "local"),
                    os.path.join(out, "local_resume"))
    _run(MAIN, world, out, "main")
    by_tag = {t: [_load(out, t, r) for r in range(world)]
              for t in ("group", "resumed", "straight", "from_local")}
    straight = tcpals.cp_als_distributed(ft, RANK, iters=4,
                                         resilience=RetryPolicy(), **kw)
    return dict(world=world, out=out, ft=ft, local=local, spans=spans,
                counters=counters, local_straight=straight, **by_tag)


def test_group_checkpoint_equals_local_workers(group_run):
    out = group_run["out"]
    g, lo = (CheckpointManager(os.path.join(out, n), keep=5)
             for n in ("group", "local"))
    assert g.all_steps() == lo.all_steps() == [0, 1]
    for step in (0, 1):
        gd, ld = g._step_dir(step), lo._step_dir(step)
        assert sorted(os.listdir(gd)) == sorted(os.listdir(ld))
        with open(os.path.join(gd, "tree.json")) as f:
            gm = json.load(f)
        with open(os.path.join(ld, "tree.json")) as f:
            lm = json.load(f)
        assert gm == lm
        for key, entry in lm.items():
            a = np.load(os.path.join(gd, entry["file"]))
            b = np.load(os.path.join(ld, entry["file"]))
            if key.startswith("stream_") or a.dtype.kind not in "f":
                np.testing.assert_array_equal(a, b, err_msg=key)
            elif key == "fits":
                np.testing.assert_allclose(a, b, rtol=0, atol=FIT_TOL)
            else:
                np.testing.assert_allclose(a, b, **FAC_TOL, err_msg=key)
        assert int(np.load(os.path.join(gd, lm["stream_idx"]["file"]))
                   .shape[0]) == group_run["world"]
    for got in group_run["group"]:
        _assert_close(got, group_run["local"])
    # Rank 0's resilience counters are LocalWorkers', the checkpoint
    # saves included (rank 0 alone saves), except the sites that fire
    # once per worker's mode step: LocalWorkers runs its D workers in one
    # process, so there the ranks' counts add up to its count.
    counters = [json.loads(str(got["counters"]))
                for got in group_run["group"]]
    per_worker = {f"resilience.site_calls{{site={s}}}"
                  for s in ("ops.kernel", "execution.resolve")}
    local = group_run["counters"]
    assert local["resilience.checkpoint.saves"] == 2
    assert {k: v for k, v in counters[0].items() if k not in per_worker} \
        == {k: v for k, v in local.items() if k not in per_worker}
    for k in per_worker:
        assert sum(c[k] for c in counters) == local[k]
    for c in counters[1:]:
        assert not [k for k in c if k.startswith("resilience.checkpoint")]
    for got in group_run["group"]:
        assert json.loads(str(got["spans"])) == json.loads(
            json.dumps(group_run["spans"]))


def test_group_checkpoint_resumes_under_local_workers_and_back(group_run):
    world, out, ft = group_run["world"], group_run["out"], group_run["ft"]
    resumed = tcpals.cp_als_distributed(
        ft, RANK, iters=4, checkpoint_dir=os.path.join(out, "group"),
        **_local_kw(world))
    _assert_close(resumed, group_run["local_straight"])
    _assert_close(resumed, group_run["straight"][0])
    for got in group_run["from_local"]:
        _assert_close(got, group_run["local_straight"])


def test_group_stop_and_resume_is_bitwise_the_straight_run(group_run):
    for resumed, straight in zip(group_run["resumed"],
                                 group_run["straight"]):
        assert int(resumed["restores"]) == 1
        for key in straight:
            np.testing.assert_array_equal(resumed[key], straight[key],
                                          err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_group_killed_save_keeps_previous_step_on_every_rank(tmp_path,
                                                             world):
    out = str(tmp_path)
    procs = _spawn(KILL, world, out, "kill")
    try:
        so, se = procs[0].communicate(timeout=240)
        assert procs[0].returncode == -9, so + se
    finally:
        for p in procs[1:]:
            p.kill()
            p.communicate()
    names = os.listdir(os.path.join(out, "kill"))
    assert "tmp.2" in names and "step_0000000002" not in names
    assert CheckpointManager(os.path.join(out, "kill"),
                             owner=False).latest_step() == 1
    _run(PROBE, world, out, "probe")
    ft = _ft(world)
    full = tcpals.cp_als_distributed(ft, RANK, iters=3, **_local_kw(world))
    for r in range(world):
        got = _load(out, "probe", r)
        assert list(got["steps"]) == [1]
        _assert_close(got, full)
    assert not [n for n in os.listdir(os.path.join(out, "kill"))
                if n.startswith("tmp.")]
