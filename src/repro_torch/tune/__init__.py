"""repro_torch.tune — measured autotuning of the port's MTTKRP runtime.

Port of ``repro.tune``. ``auto`` resolves on the static residency ladder
(``oocore.planner.plan_residency``: the first rung that fits shared
memory and L2). This package times the backends instead:

  * :mod:`.microbench` — times every backend (``ops.BACKENDS``: the
    hand-written kernels B1-B6 on CUDA tensors, ``ref``, plus
    ``segsum``) over a grid of ``(nmodes, rank, blk, tile_rows,
    density)`` on this host;
  * :mod:`.table` — the versioned JSON calibration table the timings are
    saved into (``bench_torch/tune/``; the port's own schema), with a
    registry that gives ``None``, the static ladder, when no table fits
    this host;
  * :mod:`.model` — a cost model that interpolates the table to unseen
    configurations and plans per-mode ``(backend, blk, tile_rows)`` for
    ``DynasorRuntime``;
  * :mod:`.cli` — ``python -m repro_torch.tune calibrate|show|check``.

Tuning workflow::

    python -m repro_torch.tune calibrate            # on the card
    python -m repro_torch.tune check                # dispatch == argmin

    from repro_torch.core.cpals import cp_als_distributed
    from repro_torch.tune import find_table

    table = find_table()                            # None: static ladder
    res = cp_als_distributed(ft, 16, backend="auto", table=table)

With ``table=None`` every decision is bit-identical to the static
ladder. A table answers only where the residency planner accepts its
answer.
"""
from .microbench import (BACKENDS, GridPoint, calibrate, default_grid,
                         stub_measure)
from .model import CostModel, compare_dispatch, plan_modes
from .table import (AUTO_BACKENDS, COMPAT_SCHEMA_VERSIONS, OPS_BACKENDS,
                    SCHEMA_VERSION, CalibrationEntry, CalibrationTable,
                    SchemaVersionError, aggregate_timings,
                    default_table_path, find_table, key_factor_rows,
                    load_table, measured_best)

__all__ = [
    "BACKENDS",
    "OPS_BACKENDS",
    "AUTO_BACKENDS",
    "COMPAT_SCHEMA_VERSIONS",
    "GridPoint",
    "calibrate",
    "default_grid",
    "stub_measure",
    "key_factor_rows",
    "CostModel",
    "compare_dispatch",
    "plan_modes",
    "SCHEMA_VERSION",
    "CalibrationEntry",
    "CalibrationTable",
    "SchemaVersionError",
    "aggregate_timings",
    "measured_best",
    "default_table_path",
    "find_table",
    "load_table",
]
