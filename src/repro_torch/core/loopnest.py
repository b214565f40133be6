"""Loop orders, peeling, and fully-fused loop-nest forests (Defs 4.2-4.5).

A *loop order* ``A = (A_1, ..., A_N)`` assigns each contraction term a
permutation of its indices.  The corresponding fully-fused loop-nest forest
is built by iterative *peeling*: consecutive terms sharing the same leading
index fuse under a single loop vertex (Def 4.4).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Iterator, Sequence

from repro_torch.core.paths import ContractionPath, Term, consumer_map

LoopOrder = tuple[tuple[str, ...], ...]  # one index tuple per term


# --------------------------------------------------------------------------- #
# Forest construction (Def 4.4)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class LoopNode:
    """A loop vertex; children are nested loops or term leaves."""

    index: str
    children: list["LoopNode | TermLeaf"] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class TermLeaf:
    """A contraction-term leaf of the loop-nest forest."""

    term_id: int


Forest = list["LoopNode | TermLeaf"]


def build_forest(order: LoopOrder) -> Forest:
    """Construct the fully-fused loop nest forest from a loop order.

    Implements Def 4.4 via iterative peeling: group consecutive terms whose
    remaining order starts with the same index.
    """

    def rec(seq: list[tuple[int, tuple[str, ...]]]) -> Forest:
        forest: Forest = []
        i = 0
        while i < len(seq):
            tid, rem = seq[i]
            if not rem:
                forest.append(TermLeaf(term_id=tid))
                i += 1
                continue
            q = rem[0]
            group: list[tuple[int, tuple[str, ...]]] = []
            j = i
            while j < len(seq) and seq[j][1] and seq[j][1][0] == q:
                group.append((seq[j][0], seq[j][1][1:]))
                j += 1
            forest.append(LoopNode(index=q, children=rec(group)))
            i = j
        return forest

    return rec([(i, a) for i, a in enumerate(order)])


def leaf_paths(forest: Forest) -> dict[int, tuple[str, ...]]:
    """Root-to-leaf loop-index path for every term leaf."""
    out: dict[int, tuple[str, ...]] = {}

    def rec(f: Forest, prefix: tuple[str, ...]) -> None:
        for node in f:
            if isinstance(node, TermLeaf):
                out[node.term_id] = prefix
            else:
                rec(node.children, prefix + (node.index,))

    rec(forest, ())
    return out


def leaf_vertex_paths(forest: Forest) -> dict[int, tuple[tuple[int, str], ...]]:
    """Root-to-leaf path as (vertex_id, index) pairs.  Vertex identity
    matters: two same-labelled loops separated by a sibling are DIFFERENT
    vertices and share no iterations (they are not common ancestors)."""
    out: dict[int, tuple[tuple[int, str], ...]] = {}
    counter = [0]

    def rec(f: Forest, prefix) -> None:
        for node in f:
            if isinstance(node, TermLeaf):
                out[node.term_id] = prefix
            else:
                vid = counter[0]
                counter[0] += 1
                rec(node.children, prefix + ((vid, node.index),))

    rec(forest, ())
    return out


def common_ancestor_indices(path_u, path_v) -> set[str]:
    """Loop indices of the true common ancestors (vertex-id LCA prefix)."""
    anc = set()
    for (ida, ia), (idb, _) in zip(path_u, path_v):
        if ida != idb:
            break
        anc.add(ia)
    return anc


# --------------------------------------------------------------------------- #
# Validity and enumeration of loop orders
# --------------------------------------------------------------------------- #
def is_valid_order(path: ContractionPath, order: LoopOrder,
                   sparse_storage: Sequence[str] = ()) -> bool:
    """An order is valid iff each A_i is a permutation of term i's indices
    and (framework restriction, paper §5) every term iterates its sparse
    indices in CSF storage order."""
    if len(order) != len(path):
        return False
    pos = {s: i for i, s in enumerate(sparse_storage)}
    for term, a in zip(path, order):
        if sorted(a) != sorted(term.indices):
            return False
        sp = [i for i in a if i in pos]
        if any(pos[x] > pos[y] for x, y in zip(sp, sp[1:])):
            return False
    return True


def enumerate_orders(path: ContractionPath,
                     sparse_storage: Sequence[str] = ()
                     ) -> Iterator[LoopOrder]:
    """Exhaustively enumerate valid loop orders (paper §4.1.2).

    Cardinality is prod_i |I_i|! / k_i! once the sparse-order restriction is
    applied (k_i = number of sparse indices in term i).
    """
    pos = {s: i for i, s in enumerate(sparse_storage)}

    def term_orders(term: Term) -> Iterator[tuple[str, ...]]:
        for perm in itertools.permutations(term.indices):
            sp = [i for i in perm if i in pos]
            if all(pos[x] <= pos[y] for x, y in zip(sp, sp[1:])):
                yield perm

    for combo in itertools.product(*[list(term_orders(t)) for t in path]):
        yield tuple(combo)


# --------------------------------------------------------------------------- #
# Intermediate buffers (Eq. 7)
# --------------------------------------------------------------------------- #
def buffer_indices(path: ContractionPath, order: LoopOrder
                   ) -> dict[int, tuple[str, ...]]:
    """Indices of each intermediate buffer under the fused forest.

    Buffer between producer term u and its consumer v:
      inds = out(u) \\ common_ancestors(u, v)           (Eq. 7)
    where common ancestors are determined by vertex identity (LCA), not by
    loop labels.  The final term's output is the kernel output, not a
    buffer.
    """
    forest = build_forest(order)
    paths_ = leaf_vertex_paths(forest)
    cons = consumer_map(path)
    out: dict[int, tuple[str, ...]] = {}
    for u, v in cons.items():
        anc = common_ancestor_indices(paths_[u], paths_[v])
        out[u] = tuple(i for i in path[u].out.indices if i not in anc)
    return out


def fused_sparse_depth(path: ContractionPath, order: LoopOrder,
                       sparse_storage: Sequence[str]) -> dict[int, int]:
    """For each buffer, the number of sparse loops among the true common
    ancestors (= the CSF level at which the vectorized executor
    materializes it)."""
    forest = build_forest(order)
    paths_ = leaf_vertex_paths(forest)
    cons = consumer_map(path)
    sp = set(sparse_storage)
    depth: dict[int, int] = {}
    for u, v in cons.items():
        anc = common_ancestor_indices(paths_[u], paths_[v])
        depth[u] = sum(1 for i in anc if i in sp)
    return depth
