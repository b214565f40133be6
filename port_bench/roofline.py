"""The yardstick's constants and shared byte counts.

Peaks are NVIDIA's published figures for one H100 SXM at its 700 W
power limit (dense, outside the tensor cores for float32).
"""
from __future__ import annotations

from collections.abc import Mapping

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INDEX_BYTES = 4        # a CSF coordinate or fiber pointer, at int32
VALUE_BYTES = 4        # float32


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    its memory bandwidth and the operations over its float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def csf_bytes(levels: Mapping[int, int]) -> int:
    """Bytes of a CSF read once: every level's coordinates, the fiber
    pointers of every level above the leaves (one more than its fibers),
    and the leaf values.  ``levels[p]`` is the number of distinct
    ``p``-prefixes (``p = 1 .. order``; the last is the nonzero count)."""
    order = max(levels)
    coords = sum(levels[p] for p in range(1, order + 1))
    pointers = sum(levels[p] + 1 for p in range(1, order))
    return INDEX_BYTES * (coords + pointers) + VALUE_BYTES * levels[order]
