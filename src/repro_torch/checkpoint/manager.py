"""Atomic checkpointing of nested dicts, lists and tuples of arrays.

Port of ``repro/checkpoint/manager.py``, with the same on-disk format:

* **Atomicity.** A step directory is written under ``<dir>/tmp.<step>``:
  every leaf file fsynced, then the ``_DONE`` marker, then the directory
  itself, then ``os.replace`` to ``step_<step:010d>``, then the parent is
  fsynced so the rename survives power loss. A crash mid-write never
  corrupts the newest complete checkpoint; stale ``tmp.*`` directories
  are swept when a manager opens the directory.
* **Auto-resume.** :meth:`CheckpointManager.latest_step` finds the newest
  complete step (marker file ``_DONE``).
* **The reference's layout.** Leaves are flattened by path as
  ``jax.tree_util`` does (dict keys sorted, list and tuple entries by
  index; ``None`` holds no leaf), the path ``factors/0`` is stored as
  ``factors__0.npy``, and ``tree.json`` maps each path to its file, shape
  and dtype. A checkpoint written by either package restores in the
  other.

Tensors are read to the host with ``.cpu().numpy()`` when saved; on
restore, numeric leaves come back as tensors on the device asked for,
and non-numeric ones (the fingerprint strings) stay numpy arrays.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]


def _flatten_with_paths(tree, prefix=()):
    """``[(path, leaf)]`` in ``jax.tree_util`` order; ``path`` is the
    ``/``-joined keys and indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten_with_paths(x, prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # Directory fsync is what makes a rename durable on POSIX; platforms
    # that refuse O_RDONLY on directories simply skip it.
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - non-POSIX
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_pytree(tree, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    manifest = {}
    for key, leaf in _flatten_with_paths(tree):
        arr = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        fpath = os.path.join(path, fname)
        np.save(fpath, arr)
        _fsync_file(fpath)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": str(arr.dtype)}
    mpath = os.path.join(path, "tree.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())


def restore_pytree(template, path: str, device=None, slices=None):
    """Restore into the structure of ``template``: numeric leaves as
    tensors on ``device`` (``None``: the CPU), others as numpy arrays.
    ``slices`` maps a leaf's path to the slice of its leading axis to
    read (the rest of the file is not read)."""
    with open(os.path.join(path, "tree.json")) as f:
        manifest = json.load(f)
    slices = slices or {}
    leaves = []
    for key, _ in _flatten_with_paths(template):
        fpath = os.path.join(path, manifest[key]["file"])
        if key in slices:
            arr = np.ascontiguousarray(np.load(fpath, mmap_mode="r")
                                       [slices[key]])
        else:
            arr = np.load(fpath)
        if arr.dtype.kind not in "biufc":
            # Non-numeric leaves (config-fingerprint strings) have no
            # tensor dtype: they stay host numpy for the caller to check.
            leaves.append(arr)
        else:
            leaves.append(torch.from_numpy(arr).to(device))
    return _unflatten(template, iter(leaves))


class CheckpointManager:
    """Steps of one checkpoint directory. ``owner=False`` opens it to read
    only: stale ``tmp.*`` directories are left to the owner (with workers
    spread over processes, rank 0 saves, sweeps and deletes)."""

    def __init__(self, directory: str, *, keep: int = 3, owner: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # A crash mid-save leaves a tmp.<step> behind; it can never be
        # restored from (no rename happened), so sweep it at startup.
        for name in (os.listdir(directory) if owner else ()):
            if name.startswith("tmp."):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def save(self, step: int, tree) -> str:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_pytree(tree, tmp)
        with open(os.path.join(tmp, "_DONE"), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        # fsync order is the atomicity: every file in tmp is durable,
        # then the tmp dir entry list, then the rename, then the parent
        # so the rename itself survives power loss.
        _fsync_dir(tmp)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.dir)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "_DONE")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, device=None,
                slices=None):
        """``(tree, step)`` of ``step`` (``None``: the newest complete
        one), or ``(None, None)`` when there is none. ``slices``: as
        :func:`restore_pytree`'s."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return restore_pytree(template, self._step_dir(step), device,
                              slices), step
