"""Dynasor core in PyTorch: FLYCOO, scheduling, remap, CP-ALS.

flycoo      — FLYCOO format build (numpy, equal to the reference)
schedule    — Alg. 3 LPT greedy scheduling (+ block-cyclic baseline)
tensors     — sparse tensor container and seeded generators
mttkrp      — index_add_ spMTTKRP oracles
remap       — dynamic tensor remapping (bucket, exchange, compact)
workers     — the D workers and their collectives (one process, or a
              torch.distributed group)
distributed — owner-computes mode step and remap on D workers, and the
              paper's comparison paths
cpals       — Alg. 1 CP-ALS drivers
"""
from . import (cpals, distributed, flycoo, mttkrp, remap, schedule, tensors,
               workers)

__all__ = ["cpals", "distributed", "flycoo", "mttkrp", "remap", "schedule",
           "tensors", "workers"]
