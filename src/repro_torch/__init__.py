"""Dynasor sparse MTTKRP and CP-ALS in PyTorch, with CUDA kernels for Hopper.

The port of the JAX/Pallas package ``repro`` (which stays the reference):
the same subpackage layout, PyTorch inside. Entry points run on CUDA
unless the caller passes ``device="cpu"``; on a CPU tensor each kernel
wrapper runs its plain PyTorch version. Importing the package needs no
CUDA, ``nvcc`` or ``triton``: the kernels are built at first launch.

checkpoint   atomic checkpoints in the reference's on-disk format
configs      the LM architecture configs (a copy of the reference's)
core         FLYCOO preprocessing, remap, Dynasor CP-ALS on D workers
kernels      the six MTTKRP kernels (CUDA) + block layout + dispatch +
             oracles
launch       the LM serving driver (``python -m repro_torch.launch.serve``)
models       the LM substrate: params, layers, attention, blocks, model,
             the serving steps (dense family)
obs          span tracer and counter registry
oocore       chunked out-of-core MTTKRP, stream windows and traffic
reorder      locality-aware nonzero orderings
resilience   fault sites, degradation policy, resumable sweeps, guarded
             normal-equations solve
runtime      device policy, fault-tolerant loop runner
convert      JAX-package state and LM parameters → port tensors
"""
from . import (checkpoint, configs, convert, core, kernels,  # noqa: F401
               launch, models, obs, oocore, reorder, resilience, runtime)

__all__ = ["checkpoint", "configs", "convert", "core", "kernels", "launch",
           "models", "obs", "oocore", "reorder", "resilience", "runtime"]
