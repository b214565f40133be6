"""Algorithm 1 (paper §4.2.5): cost-optimal index order for a contraction
path, for any tree-separable cost function.

Subproblems are identified by a contiguous term subsequence ``[lo, hi)`` and
the set of already-iterated (removed) indices; with memoization the
complexity is ``O(N^3 * 2^m * m)`` versus ``O((m!)^N)`` exhaustive
(Theorem 4.9).  Returns both the best order A and the best order B whose
loop-nest forest has a different root — B is required by line 17 of the
pseudocode to preserve full fusion across peels.

The DP scores any tree-separable cost (docs/cost-models.md); on the
MTTKRP running example under :class:`~repro_torch.core.cost.MaxBufferSize` it
finds the fully fused nest whose crossing buffer is a single scalar, and
its alternative-root order (line 17's ``B``) starts at a different loop:

>>> from repro_torch.core import spec as S
>>> from repro_torch.core.cost import MaxBufferSize
>>> from repro_torch.core.planner import plan
>>> spec = S.mttkrp(8, 6, 5, 4)
>>> path = plan(spec).path
>>> res = OrderDP(path, MaxBufferSize(), spec.dims,
...               spec.sparse_indices).solve()
>>> res.order, res.cost
((('i', 'j', 'a', 'k'), ('i', 'j', 'a')), 1)
>>> res.alt_order[0][0] != res.order[0][0]
True

The sparse-order restriction (paper §5) is honored: within any term,
CSF-stored indices may only be peeled in storage order, so no valid
order ever iterates ``j`` before ``i`` inside the sparse leaf term:

>>> all(a[0] == "i" for a, *_ in [res.order])   # root loop is storage-major
True
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

from repro_torch.core.cost import INF, PhiCtx, TreeCost
from repro_torch.core.loopnest import LoopOrder
from repro_torch.core.paths import ContractionPath, consumer_map


@dataclasses.dataclass
class DPResult:
    order: LoopOrder | None
    cost: float
    alt_order: LoopOrder | None  # best with a different root (B of Alg. 1)
    alt_cost: float


def _first_index(order: LoopOrder) -> str | None:
    """Root index of the first tree of the forest for ``order`` (None if the
    leading terms are exhausted leaves)."""
    for a in order:
        if a:
            return a[0]
        # a leading leaf breaks root-adjacency; no fusion conflict possible
        return None
    return None


class OrderDP:
    """Algorithm 1 with memoization over (lo, hi, removed)."""

    def __init__(self, path: ContractionPath, cost: TreeCost,
                 dims: Mapping[str, int],
                 sparse_storage: Sequence[str] = ()):
        self.path = path
        self.cost = cost
        self.dims = dims
        self.sparse_storage = tuple(sparse_storage)
        self.sparse = frozenset(sparse_storage)
        self.spos = {s: i for i, s in enumerate(sparse_storage)}
        self.consumer = consumer_map(path)
        self.term_inds = [t.indices for t in path]
        self._memo: dict[tuple, DPResult] = {}

    # ------------------------------------------------------------------ #
    def solve(self) -> DPResult:
        return self._order(0, len(self.path), frozenset())

    # ------------------------------------------------------------------ #
    def _remaining(self, tid: int, removed: frozenset[str]) -> tuple[str, ...]:
        return tuple(i for i in self.term_inds[tid] if i not in removed)

    def _valid_root(self, q: str, tid: int, removed: frozenset[str]) -> bool:
        """Sparse-order restriction (paper §5): within any term, sparse
        indices must be iterated in CSF storage order.  Choosing sparse ``q``
        as the next loop of term ``tid`` is valid only if ``q`` is the
        earliest remaining sparse index of that term."""
        if q not in self.sparse:
            return True
        rem_sp = sorted((i for i in self.term_inds[tid]
                         if i in self.sparse and i not in removed),
                        key=self.spos.get)
        return bool(rem_sp) and rem_sp[0] == q

    def _crossing(self, lo: int, mid: int, hi: int,
                  removed: frozenset[str]) -> tuple[tuple[str, ...], ...]:
        """Buffer edges separated by this peel: producer in [lo, mid),
        consumer in [mid, hi).  Each edge is separated by exactly one peel
        along the recursion, so costs never double count."""
        out = []
        for u in range(lo, mid):
            v = self.consumer.get(u)
            if v is not None and mid <= v < hi:
                out.append(tuple(i for i in self.path[u].out.indices
                                 if i not in removed))
        return tuple(out)

    # ------------------------------------------------------------------ #
    def _order(self, lo: int, hi: int, removed: frozenset[str]) -> DPResult:
        key = (lo, hi, removed)
        hit = self._memo.get(key)
        if hit is not None:
            return hit

        # L = ∅  (line 3)
        if lo == hi:
            res = DPResult((), self.cost.zero, None, INF)
            self._memo[key] = res
            return res

        # L[1] = ∅ — first term exhausted: it is a leaf here (line 5).
        # Its buffer edge, if the consumer is also in this subproblem, was
        # never separated by any peel: it is a fully-fused scalar — charge
        # the cost's scalar_buffer term exactly once here.
        first_rem = self._remaining(lo, removed)
        if not first_rem:
            sub = self._order(lo + 1, hi, removed)
            extra = self.cost.zero
            v = self.consumer.get(lo)
            if v is not None and lo < v < hi:
                extra = self.cost.scalar_buffer()
            res = DPResult(
                ((),) + sub.order if sub.order is not None else None,
                self.cost.combine(extra, sub.cost),
                ((),) + sub.alt_order if sub.alt_order is not None else None,
                self.cost.combine(extra, sub.alt_cost)
                if sub.alt_order is not None else sub.alt_cost)
            self._memo[key] = res
            return res

        best_cost, best_order, best_root = INF, None, None
        alt_cost, alt_order = INF, None

        for q in first_rem:  # line 8: roots are indices of the first term
            dc_cost, dc_order = INF, None
            # line 10: longest prefix of terms that all (validly) contain q
            k = 0
            while lo + k < hi:
                rem = self._remaining(lo + k, removed)
                if q not in rem or not self._valid_root(q, lo + k, removed):
                    break
                k += 1
            for s in range(1, k + 1):  # line 11
                x = self._order(lo, lo + s, removed | {q})
                if x.order is None or x.cost >= INF:
                    continue
                y = self._order(lo + s, hi, removed)
                y_order, y_cost = y.order, y.cost
                # line 17: Y must not root at q, else the forest would fuse
                if y_order is not None and _first_index(y_order) == q:
                    y_order, y_cost = y.alt_order, y.alt_cost
                if y_order is None or y_cost >= INF:
                    continue
                ctx = PhiCtx(
                    q=q, removed=removed,
                    terms_x=tuple((lo + t, self.path[lo + t])
                                  for t in range(s)),
                    crossing_out=self._crossing(lo, lo + s, hi, removed),
                    dims=self.dims, sparse=self.sparse)
                delta = self.cost.combine(self.cost.phi(ctx, x.cost), y_cost)
                if delta < dc_cost:  # line 24
                    dc_cost = delta
                    dc_order = tuple((q,) + a for a in x.order) + y_order
            if dc_order is None:
                continue
            # lines 27-31 (one candidate per distinct root q, so the demoted
            # previous best always has a different root than the new best)
            if dc_cost < best_cost:
                alt_cost, alt_order = best_cost, best_order
                best_cost, best_order, best_root = dc_cost, dc_order, q
            elif dc_cost < alt_cost:
                alt_cost, alt_order = dc_cost, dc_order

        res = DPResult(best_order, best_cost, alt_order, alt_cost)
        self._memo[key] = res
        return res


def optimal_order(path: ContractionPath, cost: TreeCost,
                  dims: Mapping[str, int],
                  sparse_storage: Sequence[str] = ()) -> tuple[LoopOrder, float]:
    """Convenience wrapper: best loop order and its cost for one path."""
    res = OrderDP(path, cost, dims, sparse_storage).solve()
    if res.order is None:
        raise ValueError("no valid loop order (check sparse-order constraints)")
    return res.order, res.cost
