"""Dynasor sparse MTTKRP and CP-ALS in PyTorch, with CUDA kernels for Hopper.

The port of the JAX/Pallas package ``repro`` (which stays the reference):
the same subpackage layout, PyTorch inside. Entry points run on CUDA
unless the caller passes ``device="cpu"``; on a CPU tensor each kernel
wrapper runs its plain PyTorch version. Importing the package needs no
CUDA, ``nvcc`` or ``triton``: the kernels are built at first launch.

core         FLYCOO preprocessing, remap, one-GPU Dynasor CP-ALS
kernels      in-kernel-gather MTTKRP (CUDA) + block layout + oracles
resilience   guarded normal-equations solve
runtime      device policy
convert      JAX-package state → port tensors
"""
from . import convert, core, kernels, resilience, runtime  # noqa: F401

__all__ = ["convert", "core", "kernels", "resilience", "runtime"]
