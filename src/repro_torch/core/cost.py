"""Tree-separable cost functions (paper §4.2.2-4.2.4, Defs 4.6-4.8).

Each cost provides:
  * the DP interface used by Algorithm 1 — an identity element ``zero``, an
    associative nondecreasing ``combine`` (the paper's ``⊕``), and ``phi``
    (the paper's ``φ_{T,L,r}``) evaluated at a peel of root ``q`` splitting
    the current term subsequence;
  * ``evaluate`` — an *independent* ground-truth evaluation on the fused
    forest, used to property-test the DP against exhaustive enumeration.

Cost instances implemented:
  * :class:`MaxBufferDim` / :class:`MaxBufferSize` (Def 4.7),
  * :class:`CacheMisses`  (Def 4.8),
  * :class:`ConstrainedBlas` — the metric used in the paper's experiments
    (§5/§7): maximize the number of innermost independent dense (BLAS-able)
    loops subject to a bound on intermediate buffer dimension.

Every cost scores the same object — a contraction path plus a loop
order — on the MTTKRP running example (docs/cost-models.md walks
through these numbers):

>>> from repro_torch.core import spec as S
>>> from repro_torch.core.cost import (CacheMisses, ConstrainedBlas,
...                              MaxBufferDim, MaxBufferSize)
>>> from repro_torch.core.order_dp import optimal_order
>>> from repro_torch.core.planner import plan
>>> spec = S.mttkrp(8, 6, 5, 4)   # A(i,a) = sum_jk T(i,j,k) B(j,a) C(k,a)
>>> path = plan(spec).path        # leaf term T.C, then root term B.(T.C)
>>> [str(t) for t in path]
['T*(i,j,k) . C(k,a) -> (T.C)*(i,j,a)', 'B(j,a) . (T.C)*(i,j,a) -> OUT(i,a)']

The fully fused nest keeps the crossing buffer scalar (one element), so
the Def-4.7 optima are tiny:

>>> order, best = optimal_order(path, MaxBufferSize(), spec.dims,
...                             spec.sparse_indices)
>>> order
(('i', 'j', 'a', 'k'), ('i', 'j', 'a'))
>>> best
1
>>> MaxBufferDim().evaluate(path, order, spec.dims, spec.sparse_indices)
0

The paper's experiment metric trades that for MXU-offloadable loops: the
best order ends both terms in the dense index ``a`` (two BLAS-able
loops, hence cost −2 under minimization), at a buffer dimension still
within the bound:

>>> order, best = optimal_order(path, ConstrainedBlas(bound=2), spec.dims,
...                             spec.sparse_indices)
>>> (order, best)
((('i', 'j', 'k', 'a'), ('i', 'j', 'a')), -2.0)
>>> optimal_order(path, CacheMisses(), spec.dims, spec.sparse_indices)[1]
272.0
"""
from __future__ import annotations

import abc
import dataclasses
import math
from collections.abc import Mapping, Sequence

from repro_torch.core.loopnest import (Forest, LoopOrder, TermLeaf,
                                 build_forest)
from repro_torch.core.paths import ContractionPath, Term, consumer_map

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class PhiCtx:
    """Context for one φ application: peel of root ``q`` over terms X.

    ``crossing_out``: for every buffer edge whose producer lies in X and
    whose consumer lies in the Y side of this peel, the producer's remaining
    output indices (``K_3`` of Def 4.7, with already-iterated indices
    removed; ``q`` itself NOT removed — the buffer carries the ``q`` dim).
    ``terms_x``: the (global_id, Term) pairs placed under loop ``q``.
    ``removed``: indices iterated above this peel (excludes ``q``).
    """

    q: str
    removed: frozenset[str]
    terms_x: tuple[tuple[int, Term], ...]
    crossing_out: tuple[tuple[str, ...], ...]
    dims: Mapping[str, int]
    sparse: frozenset[str]


class TreeCost(abc.ABC):
    """A tree-separable cost function (Def 4.6)."""

    zero: float = 0.0

    def scalar_buffer(self) -> float:
        """Contribution of a fully-fused scalar intermediate (a buffer whose
        producer exhausts inside the consumer's loop group, so no peel ever
        separates the edge).  Size-type costs count 1 element; dim/cache
        costs count 0."""
        return 0.0

    @abc.abstractmethod
    def combine(self, a: float, b: float) -> float:
        """The associative, nondecreasing ``⊕``."""

    @abc.abstractmethod
    def phi(self, ctx: PhiCtx, inner: float) -> float:
        """``φ_{T,L,q}`` applied to the combined cost of the children."""

    @abc.abstractmethod
    def evaluate(self, path: ContractionPath, order: LoopOrder,
                 dims: Mapping[str, int],
                 sparse: Sequence[str]) -> float:
        """Independent ground-truth evaluation on the fused forest."""


# --------------------------------------------------------------------------- #
# helpers shared by ground-truth evaluators
# --------------------------------------------------------------------------- #
def _forest_edges(path: ContractionPath, order: LoopOrder):
    """(forest, per-edge (producer, consumer, buffer-remaining-inds)).
    Ancestors are vertex-identity LCAs (same-label loops separated by a
    sibling are distinct vertices — their iterations are not shared)."""
    from repro_torch.core.loopnest import (common_ancestor_indices,
                                     leaf_vertex_paths)
    forest = build_forest(order)
    paths_ = leaf_vertex_paths(forest)
    cons = consumer_map(path)
    edges = []
    for u, v in cons.items():
        anc = common_ancestor_indices(paths_[u], paths_[v])
        rem = tuple(i for i in path[u].out.indices if i not in anc)
        edges.append((u, v, rem))
    return forest, edges


# --------------------------------------------------------------------------- #
# Def 4.7 — maximum buffer dimension / size
# --------------------------------------------------------------------------- #
class MaxBufferDim(TreeCost):
    """φ(x) = max(ρ, x) with ρ = max |K_3| over edges crossing the peel."""

    def combine(self, a, b):
        return max(a, b)

    def phi(self, ctx: PhiCtx, inner):
        rho = max((len(k3) for k3 in ctx.crossing_out), default=0)
        return max(rho, inner)

    def evaluate(self, path, order, dims, sparse):
        _, edges = _forest_edges(path, order)
        return max((len(rem) for _, _, rem in edges), default=0)


class MaxBufferSize(TreeCost):
    """Same as MaxBufferDim with ρ = product of K_3 dims (paper §4.2.3)."""

    def scalar_buffer(self) -> float:
        return 1.0  # a scalar intermediate still occupies one element

    def combine(self, a, b):
        return max(a, b)

    def phi(self, ctx: PhiCtx, inner):
        rho = max((math.prod(ctx.dims[i] for i in k3)
                   for k3 in ctx.crossing_out), default=0)
        return max(rho, inner)

    def evaluate(self, path, order, dims, sparse):
        _, edges = _forest_edges(path, order)
        return max((math.prod(dims[i] for i in rem)
                    for _, _, rem in edges), default=0)


# --------------------------------------------------------------------------- #
# Def 4.8 — cache-miss model
# --------------------------------------------------------------------------- #
class CacheMisses(TreeCost):
    """φ(x) = I(q)·(τ + x); τ counts distinct tensors under the loop that are
    indexed by q and still have more than D indices left to iterate."""

    def __init__(self, D: int = 1):
        self.D = D

    def combine(self, a, b):
        return a + b

    def _tau(self, q: str, removed: frozenset[str],
             terms: Sequence[tuple[int, Term]]) -> int:
        seen: set[str] = set()
        for _, t in terms:
            for op in (t.lhs, t.rhs, t.out):
                rem = [i for i in op.indices if i not in removed]
                if q in rem and len(rem) > self.D and op.name not in seen:
                    seen.add(op.name)
        return len(seen)

    def phi(self, ctx: PhiCtx, inner):
        tau = self._tau(ctx.q, ctx.removed, ctx.terms_x)
        return ctx.dims[ctx.q] * (tau + inner)

    def evaluate(self, path, order, dims, sparse):
        forest = build_forest(order)

        def terms_under(f: Forest) -> list[int]:
            out = []
            for n in f:
                if isinstance(n, TermLeaf):
                    out.append(n.term_id)
                else:
                    out.extend(terms_under(n.children))
            return out

        def rec(f: Forest, removed: frozenset[str]) -> float:
            total = 0.0
            for n in f:
                if isinstance(n, TermLeaf):
                    continue
                tids = terms_under(n.children)
                tau = self._tau(n.index, removed,
                                [(t, path[t]) for t in tids])
                inner = rec(n.children, removed | {n.index})
                total += dims[n.index] * (tau + inner)
            return total

        return rec(forest, frozenset())


# --------------------------------------------------------------------------- #
# Paper §5/§7 experiment metric — max BLAS-able dense loops, bounded buffers
# --------------------------------------------------------------------------- #
class ConstrainedBlas(TreeCost):
    """Minimize ``-(number of innermost independent dense loops)`` subject to
    every intermediate buffer having dimension <= ``bound`` (INF otherwise).

    A term's BLAS-able loops are the *trailing dense* indices of its loop
    order (the contiguous dense suffix offloadable to xAXPY/xGER/GEMM — on
    TPU, a single MXU ``dot_general``).  For a term containing sparse
    indices, the suffix contribution is committed by φ at the peel where the
    term's LAST sparse index is iterated; terms with no sparse indices at
    all contribute |indices| regardless of order and are handled by a
    constant offset (see :meth:`order_independent_offset`).
    """

    zero = 0.0

    def __init__(self, bound: int = 2):
        self.bound = bound

    def combine(self, a, b):
        return a + b

    def phi(self, ctx: PhiCtx, inner):
        if any(len(k3) > self.bound for k3 in ctx.crossing_out):
            return INF
        credit = 0
        if ctx.q in ctx.sparse:
            for _, t in ctx.terms_x:
                rem = [i for i in t.indices if i not in ctx.removed]
                sp_rem = [i for i in rem if i in ctx.sparse]
                if sp_rem == [ctx.q]:  # q is the term's last sparse index
                    credit += sum(1 for i in rem if i not in ctx.sparse)
        return inner - credit

    def order_independent_offset(self, path: ContractionPath,
                                 sparse: Sequence[str]) -> float:
        sp = set(sparse)
        off = 0
        for t in path:
            if not any(i in sp for i in t.indices):
                off -= len(t.indices)
        return float(off)

    def evaluate(self, path, order, dims, sparse):
        sp = set(sparse)
        _, edges = _forest_edges(path, order)
        if any(len(rem) > self.bound for _, _, rem in edges):
            return INF
        total = 0
        for a in order:
            n = 0
            for i in reversed(a):
                if i in sp:
                    break
                n += 1
            total -= n
        return float(total)


# --------------------------------------------------------------------------- #
# FLOP model (order-independent; used by the planner across paths)
# --------------------------------------------------------------------------- #
def path_flops(path: ContractionPath, dims: Mapping[str, int],
               sparse_storage: Sequence[str],
               nnz_levels: Mapping[int, int]) -> float:
    """2 * (#loop-iterations) per term, sparse-aware.

    A term whose sparse indices reach CSF level p iterates nnz^(I1..Ip)
    fibers times the product of its dense dims (paper §2.4's operation
    counts, e.g. pairwise MTTKRP = 2·nnz(T)·A + 2·nnz^(IJ)·A).
    """
    pos = {s: i + 1 for i, s in enumerate(sparse_storage)}
    total = 0.0
    for t in path:
        sp_lvl = max((pos[i] for i in t.indices if i in pos), default=0)
        dense = math.prod(dims[i] for i in t.indices if i not in pos)
        if sp_lvl:
            total += 2.0 * nnz_levels.get(sp_lvl, 0) * dense
        else:
            total += 2.0 * dense
    return total


def buffer_bytes(path: ContractionPath, order: LoopOrder,
                 dims: Mapping[str, int],
                 sparse_storage: Sequence[str],
                 nnz_levels: Mapping[int, int],
                 itemsize: int = 4) -> int:
    """Total bytes of vectorized intermediates (fiber-level materialization).

    This is the TPU-adapted memory model: a buffer fused at sparse depth p
    with dense indices Dset occupies nnz^(I1..Ip) * prod(Dset) elements.
    The memory-budgeted slicing pass (:mod:`repro_torch.core.slicing`,
    DESIGN.md §10) prices chunk candidates by re-evaluating this under
    chunk-restricted ``dims`` — keep it a pure function of its arguments.
    """
    from repro_torch.core.loopnest import buffer_indices, fused_sparse_depth
    pos = {s: i for i, s in enumerate(sparse_storage)}
    binds = buffer_indices(path, order)
    bdepth = fused_sparse_depth(path, order, sparse_storage)
    total = 0
    for u, inds in binds.items():
        dense = math.prod(dims[i] for i in inds if i not in pos)
        sp_in_buf = [i for i in inds if i in pos]
        if sp_in_buf:
            lvl = max(pos[i] for i in sp_in_buf) + 1
            rows = nnz_levels.get(lvl, 0)
        else:
            rows = max(1, nnz_levels.get(bdepth[u], 1)) if bdepth[u] else 1
        total += rows * dense * itemsize
    return total
