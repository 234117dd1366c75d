"""The workers of a Dynasor run and the collectives between them.

The port's counterpart of the reference's mesh axis ``AXIS`` and of the
``jax.lax`` collectives its ``shard_map`` bodies call (``all_to_all`` in
the remap, ``all_gather`` of the owned factor rows, ``psum`` and ``pmax``
of column norms and of the fit's inner term). Two implementations share
one interface; per-worker tensors carry a leading axis over the workers
*this process* holds, in the order of :attr:`ranks`:

* :class:`LocalWorkers` — all D workers in one process, each per-worker
  tensor stacked on a leading ``(D, ...)`` axis as the reference's
  ``prepare_runtime`` returns them. The collectives are tensor operations
  on one device. This is how D>1 runs on one GPU: NCCL refuses two ranks
  on the same device, so one process per worker is not a route there.
* :class:`GroupWorkers` — this process is one worker of a
  ``torch.distributed`` process group (the counterpart of a real mesh):
  the leading axis has length 1, and the collectives are
  ``all_to_all_single``, ``all_gather_into_tensor`` and ``all_reduce``.

Both count the bytes handed to each collective (:attr:`sent_bytes`; an
all_to_all's self-buckets included, a psum's inputs) and the calls
(:attr:`sent_counts`), the traffic the paper's comparison (Fig. 9) is
about. Within :func:`tally_into` every collective of any workers object
is also counted into one more: the dry-run's tally of a whole step, whose
MoE layers make their own workers (``models.moe.moe_apply_owner``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as tdist

from ..runtime.device import resolve_device

__all__ = ["LocalWorkers", "GroupWorkers", "tally_into"]

# torch 2.13 renamed all_gather_into_tensor (same arguments) and warns on
# the old name; earlier releases have only the old one.
_all_gather = getattr(tdist, "all_gather_single", None) \
    or tdist.all_gather_into_tensor


class _Workers:
    """What both implementations share: the byte counts."""

    num_workers: int
    device: torch.device
    ranks: tuple[int, ...]

    def __init__(self):
        self.sent_bytes: dict[str, int] = {}
        self.sent_counts: dict[str, int] = {}

    def _count(self, op: str, *xs) -> None:
        n = sum(x.numel() * x.element_size() for x in xs)
        for w in [self] + [t for t in _TALLIES if t is not self]:
            w.sent_bytes[op] = w.sent_bytes.get(op, 0) + n
            w.sent_counts[op] = w.sent_counts.get(op, 0) + 1

    def reset_bytes(self) -> None:
        self.sent_bytes = {}
        self.sent_counts = {}

    @property
    def spread(self) -> bool:
        """Are the workers spread over processes (this one holds some)?"""
        return len(self.ranks) != self.num_workers

    def barrier(self) -> None:
        """Wait for every process of the workers (one process: nothing)."""

    def broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every process (one process: ``value``)."""
        return value


_TALLIES: list = []


@contextlib.contextmanager
def tally_into(workers):
    """Within the block, every collective any workers object runs is also
    counted in ``workers``' ``sent_bytes`` / ``sent_counts`` (from any
    thread: a checkpoint's recompute may run in autograd's)."""
    _TALLIES.append(workers)
    try:
        yield workers
    finally:
        _TALLIES.remove(workers)


class LocalWorkers(_Workers):
    """``num_workers`` workers in this process, on one ``device``.

    ``device`` is resolved as every entry point does: ``None`` is CUDA
    (raising when there is none), ``"cpu"`` runs the plain versions.
    """

    def __init__(self, num_workers: int, device=None):
        super().__init__()
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers}: need at least 1")
        self.num_workers = int(num_workers)
        self.device = resolve_device(device)
        self.ranks = tuple(range(self.num_workers))

    def _check(self, x, what: str) -> None:
        if x.shape[0] != self.num_workers:
            raise ValueError(f"{what}: leading axis {x.shape[0]} is not the "
                             f"{self.num_workers} workers")

    def all_to_all(self, x):
        """``(D_src, D_dst, B, ...)`` → ``(D_dst, D_src, B, ...)``: entry
        ``[d, s]`` of the result is what source ``s`` sent to ``d`` (the
        reference's ``all_to_all(..., tiled=True)``)."""
        self._check(x, "all_to_all")
        if x.shape[1] != self.num_workers:
            raise ValueError(f"all_to_all: {x.shape[1]} destinations for "
                             f"{self.num_workers} workers")
        self._count("all_to_all", x)
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x):
        """``(D, rows, ...)`` → ``(D·rows, ...)``, in worker order."""
        self._check(x, "all_gather")
        self._count("all_gather", x)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def psum(self, x):
        """Sum over the worker axis, added in worker order."""
        self._check(x, "psum")
        self._count("psum", x)
        out = x[0]
        for d in range(1, self.num_workers):
            out = out + x[d]
        return out

    def pmax(self, x):
        """Maximum over the worker axis."""
        self._check(x, "pmax")
        self._count("pmax", x)
        out = x[0]
        for d in range(1, self.num_workers):
            out = torch.maximum(out, x[d])
        return out


class GroupWorkers(_Workers):
    """This process as one worker of a ``torch.distributed`` group.

    ``group`` is a process group (``None``: the default group, which the
    caller has initialised, giving it its address, world size and rank).
    On a CUDA ``device`` the group must use NCCL: there is no switch to
    gloo. On the CPU any backend with the four collectives (gloo) serves.
    Boolean tensors travel as ``uint8``, which every backend takes.
    """

    def __init__(self, group=None, device=None):
        super().__init__()
        if not tdist.is_initialized():
            raise RuntimeError("GroupWorkers needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.device = resolve_device(device)
        backend = tdist.get_backend(group)
        if self.device.type == "cuda" and backend != "nccl":
            raise ValueError(f"a CUDA worker needs an NCCL group, got "
                             f"{backend!r}")
        self.num_workers = tdist.get_world_size(group)
        self.rank = tdist.get_rank(group)
        self.ranks = (self.rank,)

    def _local(self, x, what: str):
        if x.shape[0] != 1:
            raise ValueError(f"{what}: leading axis {x.shape[0]}, expected "
                             "this rank's 1")
        x = x[0]
        return (x.to(torch.uint8) if x.dtype == torch.bool else x), x.dtype

    def all_to_all(self, x):
        """``(1, D, B, ...)`` buckets → ``(1, D, B, ...)`` received, entry
        ``[0, s]`` from source ``s``."""
        send, dtype = self._local(x, "all_to_all")
        if send.shape[0] != self.num_workers:
            raise ValueError(f"all_to_all: {send.shape[0]} destinations for "
                             f"{self.num_workers} workers")
        send = send.reshape((-1,) + tuple(send.shape[2:])).contiguous()
        self._count("all_to_all", send)
        recv = torch.empty_like(send)
        tdist.all_to_all_single(recv, send, group=self.group)
        return recv.to(dtype).reshape(x.shape)

    def all_gather(self, x):
        """``(1, rows, ...)`` → ``(D·rows, ...)``, in rank order."""
        part, dtype = self._local(x, "all_gather")
        part = part.contiguous()
        self._count("all_gather", part)
        out = torch.empty((self.num_workers * part.shape[0],)
                          + tuple(part.shape[1:]), dtype=part.dtype,
                          device=part.device)
        _all_gather(out, part, group=self.group)
        return out.to(dtype)

    def _all_reduce(self, x, op, what: str):
        part, _ = self._local(x, what)
        self._count(what, part)
        out = part.clone()
        tdist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x):
        """Sum over the workers (``all_reduce``, in the backend's order)."""
        return self._all_reduce(x, tdist.ReduceOp.SUM, "psum")

    def barrier(self) -> None:
        tdist.barrier(group=self.group)

    def broadcast_int(self, value: int) -> int:
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        src = 0 if self.group is None else tdist.get_global_rank(self.group,
                                                                0)
        tdist.broadcast(t, src=src, group=self.group)
        return int(t.item())

    def pmax(self, x):
        """Maximum over the workers."""
        return self._all_reduce(x, tdist.ReduceOp.MAX, "pmax")
