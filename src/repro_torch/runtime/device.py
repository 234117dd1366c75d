"""Device policy of the port: the counterpart of ``repro/runtime/execution.py``.

The JAX package chooses between Pallas interpretation and Mosaic
compilation. The port has no interpreter: a CUDA tensor runs the
hand-written kernels, a CPU tensor runs their plain PyTorch versions,
and nothing falls back from one to the other. This module decides which
device an entry point runs on:

* :func:`resolve_device` — ``None`` means CUDA; with no CUDA device it
  raises instead of quietly running on the CPU. The tests pass
  ``device="cpu"`` explicitly. ``"meta"`` (shapes, no data) is taken as
  given: the dry-run (``launch.dryrun``) runs the LM steps on it to count
  their work.
* :func:`require_sm90` — the kernels are built for ``sm_90a`` (Hopper)
  and refuse any other card.

Importing this module sets ``torch.backends.cuda.matmul.allow_tf32 =
False`` and ``torch.backends.cudnn.allow_tf32 = False``: the grams, the
solve and the fit are float32 math, and TF32 keeps only about three
decimal digits, which would break agreement with the float32 reference.
It also sets ``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction = False``: by default cuBLAS may
add split-K partial sums of a bf16 product in bf16, where the
reference's bf16 products (the LM's weights and activations) sum in
float32 and round once. The Dynasor path has no bf16 ``matmul`` (its bf16
gathers are hand-written kernels with float32 sums), so only the LM
path feels it.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "require_sm90"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked for the CPU.

    ``None`` resolves to the current CUDA device and raises
    ``RuntimeError`` when CUDA is not available; a string or
    ``torch.device`` is taken as given (a CUDA one must exist).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on CUDA by "
                "default — pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: expected 'cuda', "
                         "'cpu' or 'meta'")
    return dev


def require_sm90(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA card of compute capability 9.x."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got "
                         f"device {device}")
    major, minor = torch.cuda.get_device_capability(device)
    if major != 9:
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{major}.{minor}")
