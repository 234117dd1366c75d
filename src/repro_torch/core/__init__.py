"""Dynasor core in PyTorch: FLYCOO, scheduling, remap, CP-ALS.

flycoo      — FLYCOO format build (numpy, equal to the reference)
schedule    — Alg. 3 LPT greedy scheduling (+ block-cyclic baseline)
tensors     — sparse tensor container and seeded generators
mttkrp      — index_add_ spMTTKRP oracles
remap       — dynamic tensor remapping (one worker)
distributed — owner-computes mode step and remap on one device
cpals       — Alg. 1 CP-ALS drivers
"""
from . import cpals, distributed, flycoo, mttkrp, remap, schedule, tensors

__all__ = ["cpals", "distributed", "flycoo", "mttkrp", "remap", "schedule",
           "tensors"]
