"""Atomic checkpoints in the reference's on-disk format (``manager``)."""
from .manager import CheckpointManager, restore_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]
