"""Locality-aware nonzero ordering, in PyTorch (port of ``repro.reorder``).

Permutes each mode's FLYCOO nonzero stream so consecutive blocks reuse
the same ``FACTOR_ROW_TILE``-row factor tiles, which shrinks the stream
kernel's per-block tile windows. Policies and machinery live in
:mod:`repro_torch.reorder.ordering`; the consumers are
``core.flycoo.pack_mode``, ``kernels.mttkrp.ops.build_block_layout``
(``order_keys``) and ``oocore.executor.mttkrp_out_of_core``.
"""
from .ordering import (
    MORTON_BITS,
    ORDERINGS,
    locality_keys,
    locality_lexsort,
    morton_bits_for,
    morton_key_words,
    reorder_stream,
    validate_ordering,
)

__all__ = [
    "MORTON_BITS",
    "ORDERINGS",
    "locality_keys",
    "locality_lexsort",
    "morton_bits_for",
    "morton_key_words",
    "reorder_stream",
    "validate_ordering",
]
