"""Dynasor sparse MTTKRP and CP-ALS in PyTorch, with CUDA kernels for Hopper.

The port of the JAX/Pallas package ``repro`` (which stays the reference):
the same subpackage layout, PyTorch inside. Entry points run on CUDA
unless the caller passes ``device="cpu"``; on a CPU tensor each kernel
wrapper runs its plain PyTorch version. Importing the package needs no
CUDA, ``nvcc`` or ``triton``: the kernels are built at first launch.

checkpoint   atomic checkpoints in the reference's on-disk format
configs      the LM architecture configs (a copy of the reference's)
core         FLYCOO preprocessing, remap, Dynasor CP-ALS on D workers
data         the synthetic LM data pipeline (a copy of the reference's)
kernels      the six MTTKRP kernels (CUDA) + block layout + dispatch +
             oracles
launch       the LM serving and training drivers (``python -m
             repro_torch.launch.serve`` / ``.train``)
models       the LM substrate: params, layers, attention, blocks, model,
             the loss, train and serving steps (dense family)
obs          span tracer and counter registry
optim        AdamW, Adafactor, the cosine schedule, global-norm clipping
oocore       chunked out-of-core MTTKRP, stream windows and traffic
reorder      locality-aware nonzero orderings
resilience   fault sites, degradation policy, resumable sweeps, guarded
             normal-equations solve
runtime      device policy, fault-tolerant loop runner
convert      JAX-package state, LM parameters and LM train states → port
             tensors
"""
from . import (checkpoint, configs, convert, core, data,  # noqa: F401
               kernels, launch, models, obs, oocore, optim, reorder,
               resilience, runtime)

__all__ = ["checkpoint", "configs", "convert", "core", "data", "kernels",
           "launch", "models", "obs", "oocore", "optim", "reorder",
           "resilience", "runtime"]
