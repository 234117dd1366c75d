"""Calibration table: the versioned on-disk artifact of ``repro_torch.tune``.

Port of ``repro/tune/table.py``. A table is a list of grid entries, one
per measured configuration ``(nmodes, rank, blk, tile_rows, density)``,
each carrying the median wall seconds of every MTTKRP backend on that
configuration. Tables are saved as JSON under ``bench_torch/tune/`` and
loaded through a small registry (:func:`find_table`) that returns the
newest valid table, or ``None``: every consumer then keeps the static
residency ladder, bit-identical to the untuned dispatch.

**The port's own schema.** :data:`SCHEMA_VERSION` is a string
(``"torch-1"``) where the reference's are the integers 1–4, and the port
keeps no compatibility window: :meth:`CalibrationTable.from_json` refuses
the reference's tables, and the reference refuses the port's. Timings of
interpret-mode Pallas kernels on a CPU say nothing about hand-written
CUDA kernels on a card, and the reverse. The entry fields are the
reference's v4 fields; ``stream_window_tiles`` is counted in the port's
``FACTOR_ROW_TILE``-row factor tiles.

**The host is the card.** :func:`host_meta` records the machine and, on
CUDA, the card's name, count and power limit (``obs.prof.harness
.env_fingerprint``): a card held below its power limit runs slower under
load, so :func:`find_table` serves a table only to the same machine,
device type, card and power limit.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import platform
from typing import Sequence

from ..kernels.mttkrp import ops as _kops
from ..obs import counters as _obs
from ..resilience import faults as _faults

__all__ = [
    "SCHEMA_VERSION",
    "COMPAT_SCHEMA_VERSIONS",
    "OPS_BACKENDS",
    "AUTO_BACKENDS",
    "DEFAULT_TABLE_DIR",
    "SchemaVersionError",
    "CalibrationEntry",
    "CalibrationTable",
    "aggregate_timings",
    "key_factor_rows",
    "measured_best",
    "host_meta",
    "default_table_path",
    "find_table",
    "load_table",
]

SCHEMA_VERSION = "torch-1"

# Older schema versions from_json still understands: none (the
# reference's v1-v4 timed another machine's kernels).
COMPAT_SCHEMA_VERSIONS: tuple = ()

# Backends ``ops.mttkrp_device_step`` runs itself; ``segsum`` dispatches
# one layer up (core.distributed.device_mttkrp).
OPS_BACKENDS = _kops.BACKENDS

# The numerics-preserving subset ``auto`` may resolve to.
AUTO_BACKENDS = _kops.AUTO_BACKENDS

# Where `python -m repro_torch.tune calibrate` writes and `find_table`
# searches (never the reference's experiments/tune/).
DEFAULT_TABLE_DIR = os.path.join("bench_torch", "tune")

# Host keys a table must match to steer this host (absent keys pass).
_HOST_KEYS = ("machine", "device_type", "device_name", "power_limit")


class SchemaVersionError(ValueError):
    """Raised when a table file's schema_version is not the port's."""


@dataclasses.dataclass(frozen=True)
class CalibrationEntry:
    """One measured grid point: per-backend median seconds."""

    nmodes: int
    rank: int
    blk: int
    tile_rows: int
    density: float               # mean nonzeros per (blk x row-tile) block
    timings_s: dict              # backend name -> median wall seconds
    # Total input-factor rows (sum of I over non-output modes) of the
    # measured case: what the gather and stream rungs' fit needs.
    factor_rows: int | None = None
    # Per-input-mode stream-window width of the measured case, in
    # FACTOR_ROW_TILE-row tiles (oocore.planner.stream_window_tiles).
    stream_window_tiles: int | None = None

    @property
    def best(self) -> str:
        """Measured-argmin backend (deterministic tie-break by name)."""
        return min(sorted(self.timings_s), key=lambda b: self.timings_s[b])

    @property
    def shape_key(self) -> tuple[int, int, int, int]:
        """The dispatch-relevant key (density aggregated out by the model)."""
        return (self.nmodes, self.rank, self.blk, self.tile_rows)

    def to_json(self) -> dict:
        return dict(
            nmodes=self.nmodes, rank=self.rank, blk=self.blk,
            tile_rows=self.tile_rows, density=self.density,
            timings_s={k: float(v) for k, v in self.timings_s.items()},
            factor_rows=self.factor_rows,
            stream_window_tiles=self.stream_window_tiles,
        )

    @classmethod
    def from_json(cls, obj: dict) -> "CalibrationEntry":
        factor_rows = obj.get("factor_rows")
        window = obj.get("stream_window_tiles")
        return cls(
            nmodes=int(obj["nmodes"]), rank=int(obj["rank"]),
            blk=int(obj["blk"]), tile_rows=int(obj["tile_rows"]),
            density=float(obj["density"]),
            timings_s={str(k): float(v)
                       for k, v in obj["timings_s"].items()},
            factor_rows=None if factor_rows is None else int(factor_rows),
            stream_window_tiles=None if window is None else int(window),
        )


@dataclasses.dataclass
class CalibrationTable:
    """A set of calibration entries + host metadata, JSON round-trippable."""

    entries: list
    meta: dict = dataclasses.field(default_factory=dict)
    schema_version: str = SCHEMA_VERSION

    def __post_init__(self):
        # Lazily built CostModel, keyed on a snapshot of the entries so
        # that changing them after a query rebuilds it.
        self._model = None
        self._model_entries = None

    # -- queries ----------------------------------------------------------

    @property
    def model(self):
        """The interpolating :class:`repro_torch.tune.model.CostModel`
        (cached)."""
        if self._model is None or self._model_entries != self.entries:
            from . import model as _model  # deferred: model imports table
            self._model = _model.CostModel(self)
            self._model_entries = list(self.entries)
        return self._model

    def best_backend(self, *, nmodes: int, rank: int, blk: int,
                     tile_rows: int, allowed: Sequence[str] | None = None,
                     density: float | None = None) -> str | None:
        """Interpolated-argmin backend, or ``None`` if the table can't say.

        The duck-typed hook ``ops.select_backend`` calls on its ``table=``
        argument; ops never imports this package.
        """
        return self.model.best_backend(
            nmodes=nmodes, rank=rank, blk=blk, tile_rows=tile_rows,
            allowed=allowed, density=density,
        )

    def covers(self, *, nmodes: int, rank: int, blk: int,
               tile_rows: int) -> bool:
        """See :meth:`repro_torch.tune.model.CostModel.covers`."""
        return self.model.covers(nmodes=nmodes, rank=rank, blk=blk,
                                 tile_rows=tile_rows)

    def shape_keys(self) -> list[tuple[int, int, int, int]]:
        """Unique dispatch keys, sorted (densities collapsed)."""
        return sorted({e.shape_key for e in self.entries})

    # -- (de)serialization -------------------------------------------------

    def to_json(self) -> dict:
        return dict(
            schema_version=self.schema_version,
            meta=dict(self.meta),
            grid=[e.to_json() for e in self.entries],
        )

    @classmethod
    def from_json(cls, obj: dict) -> "CalibrationTable":
        version = obj.get("schema_version")
        if version != SCHEMA_VERSION and version not in \
                COMPAT_SCHEMA_VERSIONS:
            raise SchemaVersionError(
                f"calibration table schema_version={version!r} is not the "
                f"port's {SCHEMA_VERSION!r} (a table of the JAX package, "
                "or of another version, timed other kernels); re-run "
                "`python -m repro_torch.tune calibrate`")
        entries = [CalibrationEntry.from_json(e) for e in obj.get("grid", [])]
        return cls(entries=entries, meta=dict(obj.get("meta", {})),
                   schema_version=SCHEMA_VERSION)

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        # Registered failure boundary (repro_torch.resilience): a table on
        # disk can be truncated or garbled; the injected CorruptionFault
        # stands in for what from_json's parse errors signal on real bad
        # bytes.
        _faults.fault_site("tune.table_load")
        with open(path) as f:
            return cls.from_json(json.load(f))


def aggregate_timings(table: CalibrationTable, key) -> dict:
    """Median-over-density seconds per backend at one dispatch key."""
    import numpy as np

    entries = [e for e in table.entries if e.shape_key == key]
    backends = sorted({b for e in entries for b in e.timings_s})
    return {b: float(np.median([e.timings_s[b] for e in entries
                                if b in e.timings_s]))
            for b in backends}


def key_factor_rows(table: CalibrationTable, key) -> int | None:
    """``factor_rows`` recorded at one dispatch key (``None`` when the key
    was never measured): the context the gather and stream rungs' fit
    needs beyond the shape key."""
    for e in table.entries:
        if e.shape_key == key and e.factor_rows is not None:
            return int(e.factor_rows)
    return None


def measured_best(agg: dict, allowed=None) -> str | None:
    """Argmin backend among measured ones; ``None`` if none are eligible."""
    pool = sorted(agg if allowed is None else
                  [b for b in agg if b in allowed])
    if not pool:
        return None
    return min(pool, key=lambda b: (agg[b], b))


def _device_type(device) -> str:
    """``cuda`` or ``cpu``: ``device`` as given, else ``cuda`` when this
    host has a card."""
    import torch

    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def host_meta(extra: dict | None = None, *, device=None) -> dict:
    """Host fingerprint stored in ``meta``: where the timings ran.

    ``device`` is where they ran (``None``: CUDA when this host has a
    card). The machine, Python, torch and CUDA versions, the device type,
    and on CUDA the card's name, count and power limit
    (``obs.prof.harness.env_fingerprint``), in place of the reference's
    ``jax_backend`` and execution policy.
    """
    from ..obs.prof import harness as _harness

    dtype = _device_type(device)
    fp = _harness.env_fingerprint("cuda" if dtype == "cuda" else "cpu")
    meta = dict(platform=platform.platform(), machine=fp["machine"],
                python=fp["python"], torch=fp["torch"], cuda=fp["cuda"],
                device_type=dtype)
    for k in ("device_name", "device_count", "power_limit"):
        if k in fp:
            meta[k] = fp[k]
    if extra:
        meta.update(extra)
    return meta


def default_table_path(table_dir: str = DEFAULT_TABLE_DIR, *,
                       device=None) -> str:
    return os.path.join(
        table_dir, f"calibration_{SCHEMA_VERSION}_{platform.machine()}_"
                   f"{_device_type(device)}.json")


def load_table(path: str) -> CalibrationTable:
    """Load one table file (raises on missing file / wrong schema)."""
    return CalibrationTable.load(path)


def _matches_host(meta: dict, device=None) -> bool:
    """Does a table's host fingerprint match this host?

    Compares the machine, the device type, the card's name and its power
    limit. Keys absent from ``meta`` are not checked (permissive for
    hand-built tables); explicit mismatches reject the table.
    """
    if not any(meta.get(k) is not None for k in _HOST_KEYS):
        return True
    current = host_meta(device=device)
    return all(meta.get(k) in (None, current.get(k)) for k in _HOST_KEYS)


def find_table(table_dir: str = DEFAULT_TABLE_DIR, *,
               match_host: bool = True,
               device=None) -> CalibrationTable | None:
    """Registry lookup: newest valid ``*.json`` table in ``table_dir``.

    Tables whose stored host fingerprint (machine, device type, card,
    power limit) contradicts this host (``device``: ``None`` means CUDA
    when the host has a card) are skipped unless ``match_host=False``.
    Tables stamped ``meta.stub`` (``calibrate --stub`` pseudo-timings)
    are *always* skipped; load them by explicit path. A corrupt table
    counts ``resilience.table_fallbacks{reason=corrupt}``, an unloadable
    one ``{reason=unloadable}``. Returns ``None`` when the directory is
    missing or holds no loadable matching table: the signal for consumers
    to keep the static residency ladder.
    """
    paths = sorted(glob.glob(os.path.join(table_dir, "*.json")),
                   key=lambda p: (os.path.getmtime(p), p), reverse=True)
    for path in paths:
        try:
            table = CalibrationTable.load(path)
        except _faults.CorruptionFault:
            # Injected bad bytes: skipped like a real parse failure.
            _obs.add("resilience.table_fallbacks", reason="corrupt")
            continue
        except (SchemaVersionError, json.JSONDecodeError, KeyError,
                ValueError, OSError):
            _obs.add("resilience.table_fallbacks", reason="unloadable")
            continue
        if table.meta.get("stub"):
            continue
        if match_host and not _matches_host(table.meta, device):
            continue
        return table
    return None
