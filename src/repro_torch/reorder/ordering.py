"""Locality-aware nonzero ordering, on the device.

Port of ``repro/reorder/ordering.py``. The FLYCOO stream contract only
fixes the output-row-tile grouping (``ops.build_block_layout`` needs
each tile's run contiguous), which leaves the order of nonzeros within
a run free. These policies spend that freedom so the nonzeros of one
block touch few ``frow_tile``-row factor tiles, which is what the stream
kernel's per-block window holds:

* ``"tile"`` — within each output-tile run, sort by the tuple of
  factor-tile ids of the gathered (input) modes, first mode major;
* ``"morton"`` — sort by the Morton (Z-order) interleave of those tile
  ids, trading locality evenly between the modes.

Everything is a true permutation of the stream. The keys and the
permutations equal the JAX package's exactly for the same inputs and
``frow_tile``. The functions take tensors and run where they lie: torch
has no ``lexsort``, so :func:`lexsort` chains stable sorts, least
significant key first, which on the card takes milliseconds where a
host ``np.lexsort`` of a 76.9 M-nonzero stream takes tens of seconds.
"""
from __future__ import annotations

import torch

from ..kernels.mttkrp import kernel as _kernel

__all__ = [
    "FACTOR_ROW_TILE",
    "MORTON_BITS",
    "ORDERINGS",
    "lexsort",
    "locality_keys",
    "locality_lexsort",
    "morton_bits_for",
    "morton_key_words",
    "reorder_stream",
    "validate_ordering",
]

FACTOR_ROW_TILE = _kernel.FACTOR_ROW_TILE

ORDERINGS = ("none", "tile", "morton")

# Bits of tile id each mode contributes to the Morton code; widened by
# morton_bits_for when the caller passes the mode sizes.
MORTON_BITS = 16

# Interleaved codes are packed into words of at most this many bits, as
# in the reference (int32-safe words).
_WORD_BITS = 30


def validate_ordering(ordering: str) -> str:
    if ordering not in ORDERINGS:
        raise ValueError(
            f"unknown ordering {ordering!r}: expected one of {ORDERINGS}")
    return ordering


def morton_bits_for(max_tiles: int, bits: int = MORTON_BITS) -> int:
    """Bits per mode covering tile ids ``[0, max_tiles)``, never below
    ``bits``: widening only prepends zero bit planes, so it keeps the
    order of ids that fit anyway."""
    if max_tiles <= 1:
        return bits
    return max(bits, int(max_tiles - 1).bit_length())


def morton_key_words(tiles: torch.Tensor, bits: int = MORTON_BITS, *,
                     max_tiles: int | None = None) -> tuple:
    """Morton code of ``(n, K)`` per-mode tile ids as int64 words of at
    most 30 bits, most significant first.

    Bit ``b`` of mode 0, then bit ``b`` of mode 1, … from the top bit
    down. ``max_tiles`` widens ``bits`` (:func:`morton_bits_for`);
    without it a tile id beyond the budget raises instead of merging
    distinct tiles into one clamped key.
    """
    tiles = tiles.long()
    k = tiles.shape[1]
    if max_tiles is not None:
        bits = morton_bits_for(int(max_tiles), bits)
    elif tiles.numel():
        top = int(tiles.max())
        if top >= (1 << bits):
            raise ValueError(
                f"tile id {top} needs {top.bit_length()} bits, over the "
                f"{bits}-bit Morton budget — pass max_tiles= (or "
                "max_rows= one level up) so the word count widens "
                "instead of silently clamping distinct tiles together")
    tiles = tiles.clamp(0, (1 << bits) - 1)
    planes = [(tiles[:, i] >> b) & 1
              for b in reversed(range(bits)) for i in range(k)]
    words = []
    for start in range(0, len(planes), _WORD_BITS):
        word = planes[start]
        for plane in planes[start + 1:start + _WORD_BITS]:
            word = (word << 1) | plane
        words.append(word)
    return tuple(words)


def lexsort(keys, n: int | None = None, device=None) -> torch.Tensor:
    """Stable lexicographic order of equal-length ``keys`` (most
    significant first), position breaking the remaining ties.

    ``np.lexsort`` with the key order reversed, from stable sorts: each
    pass sorts the current order by one key, least significant first.
    With no keys it returns ``arange(n)``.
    """
    keys = tuple(keys)
    if keys:
        n, device = keys[0].shape[0], keys[0].device
    order = torch.arange(n, device=device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def locality_keys(idx_in: torch.Tensor, ordering: str,
                  frow_tile: int = FACTOR_ROW_TILE,
                  max_rows: int | None = None) -> tuple:
    """Sort keys realizing ``ordering`` over ``(n, K)`` gathered-mode
    indices, most significant first (``()`` for ``"none"``).

    ``max_rows`` (the largest gathered mode's factor row count) sizes
    the Morton bit budget, as in the reference.
    """
    validate_ordering(ordering)
    if ordering == "none":
        return ()
    tiles = torch.div(idx_in.long(), frow_tile, rounding_mode="floor")
    if ordering == "tile":
        return tuple(tiles[:, i] for i in range(tiles.shape[1]))
    max_tiles = (None if max_rows is None
                 else -(-int(max_rows) // frow_tile))
    return morton_key_words(tiles, max_tiles=max_tiles)


def locality_lexsort(idx_in: torch.Tensor, ordering: str, *, primaries=(),
                     frow_tile: int = FACTOR_ROW_TILE,
                     max_rows: int | None = None) -> torch.Tensor:
    """Stable permutation: ``primaries`` (most significant first), then
    the locality keys, then position — ``"none"`` is a stable sort by
    the primaries alone."""
    keys = locality_keys(idx_in, ordering, frow_tile=frow_tile,
                         max_rows=max_rows)
    return lexsort(tuple(p.long() for p in primaries) + keys,
                   n=idx_in.shape[0], device=idx_in.device)


def reorder_stream(idx, val, valid, *, mode: int, ordering: str,
                   tile_rows: int, row_offset: int = 0,
                   frow_tile: int = FACTOR_ROW_TILE,
                   max_rows: int | None = None):
    """Permute one mode's stream for factor-tile locality.

    Input: ``idx (cap, N)`` sorted by output row with trailing invalid
    elements (the executor's contract). The result keeps valid elements
    first and output-tile runs contiguous and ascending, each run in the
    policy's order. Returns ``(idx', val', valid', perm)`` with
    ``x'[i] = x[perm[i]]``.
    """
    nmodes = idx.shape[1]
    in_modes = [w for w in range(nmodes) if w != mode]
    local_row = idx[:, mode].long() - row_offset
    # Invalid elements sort after every real output tile.
    out_tile = torch.where(
        valid, torch.div(local_row, tile_rows, rounding_mode="floor"),
        2 ** 62)
    idx_in = torch.where(valid[:, None], idx[:, in_modes].long(), 0)
    perm = locality_lexsort(idx_in, ordering, primaries=(out_tile,),
                            frow_tile=frow_tile, max_rows=max_rows)
    return idx[perm], val[perm], valid[perm], perm
