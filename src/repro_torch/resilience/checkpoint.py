"""Checkpointed, resumable CP-ALS: the sweep state and its validation.

Port of ``repro/resilience/checkpoint.py``. One sweep's complete
algorithm state as a flat tree the manager
(:class:`repro_torch.checkpoint.CheckpointManager`) persists, plus
validated restore. A sweep checkpoint (``cp_als`` /
``cp_als_distributed`` ``checkpoint_dir=``) holds:

* the factor matrices (permuted row space for the distributed driver,
  the space the algorithm iterates in),
* ``lam`` (column weights) and the fit trace so far,
* the sweep index,
* for the distributed driver, the nonzero stream ``(idx, val, mask)``
  with its worker axis: the remapped layout as of the end of the sweep,
  so a resumed job continues with the *exact* stream,
* config fingerprints (``rank``, ``ordering``, ``backend``) that
  :func:`restore_state` validates: resuming under a different
  configuration is a hard ``ValueError``.

With workers spread over processes (a ``GroupWorkers`` of more than one
rank) a checkpoint is the same files as with all the workers in one
process: every rank's stream is gathered to every rank in rank order
(:func:`gather_stream`, through the workers' own ``all_gather``), rank 0
alone writes it (and alone deletes old steps), and on restore rank 0's
newest complete step is broadcast, so ranks cannot disagree after a kill
during a save; each rank then reads only its own slice of the stream.

The keys, file names and ``tree.json`` manifest are the reference's, so
the two packages read each other's checkpoints; the fingerprints keep
one from resuming a run of the other by mistake (the port's ``cp_als``
writes backend ``"torch"``, the reference's ``"jax"``). Every save and
restore is counted (``resilience.checkpoint.saves`` /
``resilience.checkpoint.restores``).
"""
from __future__ import annotations

import numpy as np

from ..checkpoint import CheckpointManager
from ..checkpoint.manager import _host
from ..obs import counters as _obs

__all__ = [
    "STATE_VERSION",
    "gather_stream",
    "make_manager",
    "make_state",
    "restore_state",
    "save_state",
]

STATE_VERSION = 1


_STREAM_KEYS = ("stream_idx", "stream_val", "stream_mask")


def make_manager(directory: str | None, *, keep: int = 3,
                 owner: bool = True) -> CheckpointManager | None:
    """A manager for ``directory`` (``None``: checkpointing disabled);
    ``owner=False`` for the ranks other than 0, which only read."""
    return None if directory is None else CheckpointManager(
        directory, keep=keep, owner=owner)


def gather_stream(stream, workers):
    """Every worker's ``(idx, val, mask)``, stacked ``(D, cap, ...)`` in
    rank order: the stream as given when this process holds every worker,
    else gathered through ``workers.all_gather``."""
    if not workers.spread:
        return tuple(stream)
    d = workers.num_workers
    return tuple(workers.all_gather(x).reshape((d,) + tuple(x.shape[1:]))
                 for x in stream)


def make_state(factors, lam, fits, *, sweep: int, rank: int,
               ordering: str = "none", backend: str = "",
               stream=None) -> dict:
    """Assemble the flat tree one sweep checkpoint persists.

    Tensors stay where they are (the manager reads them to the host when
    it saves); ``stream`` is the distributed driver's ``(idx, val, mask)``
    (``None`` for the single-device driver). Strings ride as 0-d numpy
    unicode arrays, which ``np.save`` round-trips losslessly.
    """
    state = {
        "version": np.int64(STATE_VERSION),
        "sweep": np.int64(sweep),
        "rank": np.int64(rank),
        "ordering": np.asarray(ordering),
        "backend": np.asarray(backend),
        "lam": lam,
        "fits": np.asarray(fits, dtype=np.float64),
        "factors": list(factors),
    }
    if stream is not None:
        state["stream_idx"], state["stream_val"], state["stream_mask"] = \
            stream
    return state


def save_state(mgr: CheckpointManager, state: dict) -> str:
    """Atomically persist one sweep's state; returns the step dir."""
    path = mgr.save(int(state["sweep"]), state)
    _obs.add("resilience.checkpoint.saves")
    return path


def restore_state(mgr: CheckpointManager, template: dict, device=None,
                  workers=None) -> tuple[dict | None, int | None]:
    """Restore the newest complete checkpoint, validated against
    ``template``, numeric leaves as tensors on ``device``.

    With ``workers`` spread over processes, the step is rank 0's newest
    (broadcast), and the stream leaves hold this process's workers only.

    Returns ``(state, sweep)`` or ``(None, None)`` when the directory
    holds no complete checkpoint (a fresh start). A checkpoint whose
    config fingerprint (version / rank / ordering / backend) or factor
    shapes disagree with the template raises ``ValueError`` with the
    mismatch spelled out: a resume continues the *same* decomposition or
    refuses.
    """
    step = slices = None
    if workers is not None and workers.spread:
        newest = mgr.latest_step()
        step = workers.broadcast_int(-1 if newest is None else newest)
        if step < 0:
            return None, None
        rows = slice(workers.ranks[0], workers.ranks[-1] + 1)
        slices = {k: rows for k in _STREAM_KEYS if k in template}
    restored, step = mgr.restore(template, step=step, device=device,
                                 slices=slices)
    if restored is None:
        return None, None
    for key in ("version", "rank", "ordering", "backend"):
        want, got = _host(template[key]), _host(restored[key])
        if want.shape == () and got.shape == () and str(want) != str(got):
            raise ValueError(
                f"checkpoint at {mgr.dir!r} step {step} was written with "
                f"{key}={got} but this run is configured with {key}={want} "
                "— resume with the original configuration or point "
                "checkpoint_dir at a fresh directory")
    for n, (t, r) in enumerate(zip(template["factors"],
                                   restored["factors"])):
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(
                f"checkpoint factor {n} has shape {tuple(r.shape)}, "
                f"this run expects {tuple(t.shape)} — tensor/worker "
                "configuration changed; use a fresh checkpoint_dir")
    _obs.add("resilience.checkpoint.restores")
    return restored, int(step)
