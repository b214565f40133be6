"""Partially-fused loop nests — the paper's §8 future-work direction.

The paper restricts search to FULLY-fused forests ("no vertex has two
consecutive children with the same index") and notes that partial fusion
"would be particularly useful for cost metrics like number of BLAS kernels
or the degree of parallelism".  We extend the search space with *fusion
barriers*: a barrier between consecutive terms t and t+1 forbids merging
their loops even where prefixes match, trading buffer size for

  * larger independent dense loop nests (higher BLAS/MXU offload degree) —
    an unfused producer keeps ALL its trailing dense loops contiguous;
  * independent (parallelizable) subtrees.

Enumeration-level feature: costs are evaluated on the barrier-respecting
forest; Algorithm 1 remains the engine for the fully-fused optimum (its
optimal-substructure argument does not carry over once barriers decouple
subproblem roots, so partial fusion is searched by enumeration — exactly
the autotuning mode the paper prescribes for such metrics).
"""
from __future__ import annotations

import itertools
import math
from collections.abc import Iterator, Sequence

from repro_torch.core.loopnest import (Forest, LoopNode, LoopOrder, TermLeaf,
                                 common_ancestor_indices, leaf_vertex_paths)
from repro_torch.core.paths import ContractionPath, consumer_map

Barriers = tuple[bool, ...]  # barriers[t] splits terms t and t+1


def build_forest_with_barriers(order: LoopOrder,
                               barriers: Barriers | None = None) -> Forest:
    """Fused forest construction honoring fusion barriers."""
    n = len(order)
    barriers = barriers or (False,) * max(n - 1, 0)

    def rec(seq) -> Forest:
        forest: Forest = []
        i = 0
        while i < len(seq):
            tid, rem = seq[i]
            if not rem:
                forest.append(TermLeaf(term_id=tid))
                i += 1
                continue
            q = rem[0]
            group = [(tid, rem[1:])]
            j = i + 1
            while (j < len(seq) and seq[j][1] and seq[j][1][0] == q
                   and not barriers[seq[j][0] - 1]):
                group.append((seq[j][0], seq[j][1][1:]))
                j += 1
            forest.append(LoopNode(index=q, children=rec(group)))
            i = j
        return forest

    return rec([(i, a) for i, a in enumerate(order)])


def partial_fusion_metrics(path: ContractionPath, order: LoopOrder,
                           barriers: Barriers,
                           dims, sparse: Sequence[str]) -> dict:
    """(max buffer dim/size, total BLAS-able dense loops, #parallel roots)
    for a barrier choice."""
    forest = build_forest_with_barriers(order, barriers)
    paths_ = leaf_vertex_paths(forest)
    cons = consumer_map(path)
    sp = set(sparse)
    max_dim, max_size = 0, 0
    for u, v in cons.items():
        anc = common_ancestor_indices(paths_[u], paths_[v])
        rem = [i for i in path[u].out.indices if i not in anc]
        max_dim = max(max_dim, len(rem))
        max_size = max(max_size, math.prod(dims[i] for i in rem) if rem
                       else 1)
    # BLAS degree: per leaf, contiguous dense loops directly above it that
    # enclose only this leaf (single-child chain)
    blas = 0
    for tid, vpath in paths_.items():
        # walk from the leaf upward while the loop is dense
        n = 0
        for _, idx in reversed(vpath):
            if idx in sp:
                break
            n += 1
        blas += n
    return {"max_buffer_dim": max_dim, "max_buffer_size": max_size,
            "blas_loops": blas, "n_roots": len(forest)}


def enumerate_barrier_choices(n_terms: int) -> Iterator[Barriers]:
    for combo in itertools.product([False, True], repeat=max(n_terms - 1, 0)):
        yield combo


def best_partial_fusion(path: ContractionPath, order: LoopOrder,
                        dims, sparse: Sequence[str],
                        buffer_dim_bound: int | None = None
                        ) -> tuple[Barriers, dict]:
    """Maximize BLAS-able loops subject to an optional buffer-dim bound —
    the cost the paper names as the one partial fusion serves."""
    best = None
    for b in enumerate_barrier_choices(len(path)):
        m = partial_fusion_metrics(path, order, b, dims, sparse)
        if buffer_dim_bound is not None and \
                m["max_buffer_dim"] > buffer_dim_bound:
            continue
        key = (m["blas_loops"], -m["max_buffer_size"])
        if best is None or key > best[2]:
            best = (b, m, key)
    if best is None:
        raise ValueError("no barrier choice satisfies the buffer bound")
    return best[0], best[1]
