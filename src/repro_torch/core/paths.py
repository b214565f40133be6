"""Contraction-path enumeration (paper §4.1.1, Def 4.1).

A contraction path for N+1 tensors is a depth-first post-ordering of a binary
contraction tree: a sequence of N *terms*, each contracting two operands
(inputs or intermediates) into an output operand.  The recurrence
``T(n) = C(n,2) * T(n-1)`` with ``T(2) = 1`` counts ordered paths, i.e.
``T(n) = (n!)^2 / (n * 2^(n-1))`` (paper reports the same up to O-constants).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Iterator, Sequence

from repro_torch.core.spec import SpTTNSpec, TensorRef


@dataclasses.dataclass(frozen=True)
class Operand:
    """An operand of a contraction term (input tensor or intermediate)."""

    name: str
    indices: tuple[str, ...]
    is_sparse: bool = False

    def __str__(self) -> str:  # pragma: no cover
        star = "*" if self.is_sparse else ""
        return f"{self.name}{star}({','.join(self.indices)})"


@dataclasses.dataclass(frozen=True)
class Term:
    """One pairwise contraction ``lhs * rhs -> out`` (a leaf of a loop nest)."""

    lhs: Operand
    rhs: Operand
    out: Operand

    @property
    def indices(self) -> tuple[str, ...]:
        """All indices of the term, sparse (storage order) before dense."""
        seen: list[str] = []
        for op in (self.lhs, self.rhs, self.out):
            for i in op.indices:
                if i not in seen:
                    seen.append(i)
        return tuple(seen)

    @property
    def index_set(self) -> frozenset[str]:
        return frozenset(self.indices)

    @property
    def is_sparse(self) -> bool:
        return self.lhs.is_sparse or self.rhs.is_sparse

    @property
    def contracted(self) -> tuple[str, ...]:
        out = set(self.out.indices)
        return tuple(i for i in self.indices if i not in out)

    def __str__(self) -> str:  # pragma: no cover
        return f"{self.lhs} . {self.rhs} -> {self.out}"


ContractionPath = tuple[Term, ...]


def _operand_of(t: TensorRef) -> Operand:
    return Operand(name=t.name, indices=t.indices, is_sparse=t.is_sparse)


def _intermediate(spec: SpTTNSpec, a: Operand, b: Operand,
                  remaining: Sequence[Operand]) -> Operand:
    """Build the output operand of contracting ``a . b``.

    Kept indices = indices needed by any remaining operand or the final
    output.  Index order: sparse indices in CSF storage order first, then
    dense indices in spec order (canonical; executor relies on it).
    """
    needed: set[str] = set(spec.output.indices)
    for op in remaining:
        needed |= set(op.indices)
    mine = set(a.indices) | set(b.indices)
    kept = mine & needed
    sparse_order = [i for i in spec.sparse_indices if i in kept]
    sp = set(spec.sparse_indices)
    dense_order = [i for i in spec.all_indices if i in kept and i not in sp]
    is_sparse = (a.is_sparse or b.is_sparse) and bool(sparse_order)
    name = f"({a.name}.{b.name})"
    return Operand(name=name, indices=tuple(sparse_order + dense_order),
                   is_sparse=is_sparse)


def enumerate_paths(spec: SpTTNSpec) -> Iterator[ContractionPath]:
    """Yield every ordered contraction path (paper §4.1.1)."""

    def rec(ops: tuple[Operand, ...],
            acc: tuple[Term, ...]) -> Iterator[ContractionPath]:
        if len(ops) == 1:
            yield acc
            return
        if len(ops) == 2:
            a, b = ops
            out = Operand(name="OUT", indices=spec.output.indices,
                          is_sparse=spec.output_is_sparse)
            yield acc + (Term(lhs=a, rhs=b, out=out),)
            return
        for ia, ib in itertools.combinations(range(len(ops)), 2):
            a, b = ops[ia], ops[ib]
            rest = tuple(o for j, o in enumerate(ops) if j not in (ia, ib))
            out = _intermediate(spec, a, b, rest)
            term = Term(lhs=a, rhs=b, out=out)
            yield from rec(rest + (out,), acc + (term,))

    yield from rec(tuple(_operand_of(t) for t in spec.inputs), ())


def path_depth(path: ContractionPath) -> int:
    """Max loop-nest depth over terms (= paper's asymptotic-complexity proxy)."""
    return max(len(t.indices) for t in path)


def count_paths(n: int) -> int:
    """Closed form of the recurrence T(n) = C(n,2) T(n-1), T(2) = 1."""
    c = 1
    for k in range(3, n + 1):
        c *= k * (k - 1) // 2
    return c


def consumer_map(path: ContractionPath) -> dict[int, int]:
    """Map producer term index -> consumer term index (binary-tree edges).

    The final term's output is the kernel output and has no consumer.
    """
    out: dict[int, int] = {}
    for i, t in enumerate(path):
        for j in range(i + 1, len(path)):
            if path[j].lhs.name == t.out.name or path[j].rhs.name == t.out.name:
                out[i] = j
                break
    return out


def min_depth_paths(spec: SpTTNSpec,
                    max_paths: int | None = None,
                    slack: int = 0) -> list[ContractionPath]:
    """All paths whose depth is within ``slack`` of the minimum (paper §5:
    'considers all contraction paths with optimal asymptotic complexity')."""
    best: int | None = None
    kept: list[tuple[int, ContractionPath]] = []
    for p in enumerate_paths(spec):
        d = path_depth(p)
        if best is None or d < best:
            best = d
            kept = [(dd, pp) for dd, pp in kept if dd <= best + slack]
        if d <= best + slack:
            kept.append((d, p))
            if max_paths is not None and len(kept) > 4 * max_paths:
                kept.sort(key=lambda x: x[0])
                kept = kept[:2 * max_paths]
    kept = [pp for dd, pp in kept if dd <= best + slack]
    # dedupe identical term sequences (paths can coincide after reordering)
    seen: set[str] = set()
    uniq: list[ContractionPath] = []
    for p in kept:
        key = "|".join(str(t) for t in p)
        if key not in seen:
            seen.add(key)
            uniq.append(p)
    if max_paths is not None:
        uniq = uniq[:max_paths]
    return uniq
