"""Dynasor sparse MTTKRP and CP-ALS in PyTorch, with CUDA kernels for Hopper.

The port of the JAX/Pallas package ``repro`` (which stays the reference):
the same subpackage layout, PyTorch inside. Entry points run on CUDA
unless the caller passes ``device="cpu"``; on a CPU tensor each kernel
wrapper runs its plain PyTorch version. Importing the package needs no
CUDA, ``nvcc`` or ``triton``: the kernels are built at first launch.

checkpoint   atomic checkpoints in the reference's on-disk format
core         FLYCOO preprocessing, remap, Dynasor CP-ALS on D workers
kernels      the six MTTKRP kernels (CUDA) + block layout + dispatch +
             oracles
obs          span tracer and counter registry
oocore       chunked out-of-core MTTKRP, stream windows and traffic
reorder      locality-aware nonzero orderings
resilience   fault sites, degradation policy, resumable sweeps, guarded
             normal-equations solve
runtime      device policy, fault-tolerant loop runner
convert      JAX-package state → port tensors
"""
from . import (checkpoint, convert, core, kernels, obs,  # noqa: F401
               oocore, reorder, resilience, runtime)

__all__ = ["checkpoint", "convert", "core", "kernels", "obs", "oocore",
           "reorder", "resilience", "runtime"]
