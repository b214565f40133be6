"""Exhaustive loop-nest enumeration (paper §4.1) — the autotuning space.

The size is O((n!)^2/(n·2^n) · prod |I_i|!/k_i!); use only for small kernels
(every paper kernel is small: n <= 6, m <= 10) or for property tests.
"""
from __future__ import annotations

from collections.abc import Iterator, Mapping, Sequence

from repro_torch.core.cost import TreeCost
from repro_torch.core.loopnest import LoopOrder, enumerate_orders
from repro_torch.core.paths import ContractionPath, min_depth_paths
from repro_torch.core.spec import SpTTNSpec

__all__ = ["SpTTNSpec", "brute_force_optimal", "enumerate_loop_nests"]


def enumerate_loop_nests(spec: SpTTNSpec,
                         max_paths: int | None = None,
                         depth_slack: int = 0
                         ) -> Iterator[tuple[ContractionPath, LoopOrder]]:
    """Yield (contraction path, loop order) pairs spanning the search space."""
    for path in min_depth_paths(spec, max_paths=max_paths, slack=depth_slack):
        for order in enumerate_orders(path, spec.sparse_indices):
            yield path, order


def brute_force_optimal(path: ContractionPath, cost: TreeCost,
                        dims: Mapping[str, int],
                        sparse_storage: Sequence[str] = ()
                        ) -> tuple[LoopOrder, float]:
    """Ground-truth optimum by evaluating every valid loop order.

    Used by property tests to validate Algorithm 1 (Theorem 4.9).
    """
    best: tuple[LoopOrder, float] | None = None
    for order in enumerate_orders(path, sparse_storage):
        c = cost.evaluate(path, order, dims, sparse_storage)
        if best is None or c < best[1]:
            best = (order, c)
    if best is None:
        raise ValueError("no valid order")
    return best
