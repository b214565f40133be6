"""SpTTN kernel specification.

An SpTTN kernel (paper §3) is a contraction of a single sparse tensor with a
network of dense tensors, whose output is dense or shares the sparse tensor's
sparsity pattern exactly.  We describe kernels with an einsum-like string,
e.g. MTTKRP is ``"ijk,ja,ka->ia"`` with input 0 sparse.

Indices are single characters.  Dimension sizes are supplied separately.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """A tensor operand: a name and an ordered index tuple."""

    name: str
    indices: tuple[str, ...]
    is_sparse: bool = False

    def __post_init__(self):
        if len(set(self.indices)) != len(self.indices):
            raise ValueError(
                f"repeated index within one tensor is unsupported: {self}")

    @property
    def order(self) -> int:
        return len(self.indices)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        star = "*" if self.is_sparse else ""
        return f"{self.name}{star}({','.join(self.indices)})"


@dataclasses.dataclass(frozen=True)
class SpTTNSpec:
    """A full SpTTN kernel: inputs, output, and index dimensions.

    ``inputs[sparse_input]`` is the sparse tensor (or None for an all-dense
    network, which we also support for completeness).  The output either has
    no sparse-only indices (dense output) or exactly the sparse tensor's
    index set (same-sparsity output, e.g. TTTP).

    Build one with :func:`parse` or the named constructors below:

    >>> spec = mttkrp(8, 6, 5, 4)         # "ijk,ja,ka->ia", input 0 sparse
    >>> spec.sparse_indices               # CSF storage order
    ('i', 'j', 'k')
    >>> spec.contracted_indices
    ('j', 'k')
    >>> spec.output_is_sparse
    False
    >>> spec.size("a")
    4
    """

    inputs: tuple[TensorRef, ...]
    output: TensorRef
    dims: Mapping[str, int]

    def __post_init__(self):
        n_sparse = sum(t.is_sparse for t in self.inputs)
        if n_sparse > 1:
            raise ValueError("SpTTN allows at most one sparse input")
        all_inds = set()
        for t in self.inputs:
            all_inds |= set(t.indices)
        missing = set(self.output.indices) - all_inds
        if missing:
            raise ValueError(f"output indices {missing} not found in inputs")
        undimmed = (all_inds | set(self.output.indices)) - set(self.dims)
        if undimmed:
            raise ValueError(f"no dimension given for indices {undimmed}")

    # ------------------------------------------------------------------ #
    @property
    def sparse_input(self) -> TensorRef | None:
        for t in self.inputs:
            if t.is_sparse:
                return t
        return None

    @property
    def sparse_indices(self) -> tuple[str, ...]:
        """Sparse indices in CSF storage order (= sparse tensor index order)."""
        sp = self.sparse_input
        return sp.indices if sp is not None else ()

    @property
    def all_indices(self) -> tuple[str, ...]:
        seen: list[str] = []
        for t in (*self.inputs, self.output):
            for i in t.indices:
                if i not in seen:
                    seen.append(i)
        return tuple(seen)

    @property
    def contracted_indices(self) -> tuple[str, ...]:
        out = set(self.output.indices)
        return tuple(i for i in self.all_indices if i not in out)

    @property
    def output_is_sparse(self) -> bool:
        """True when output has same sparsity as the sparse input (TTTP-like)."""
        sp = self.sparse_input
        return (sp is not None
                and set(self.output.indices) == set(sp.indices))

    def size(self, index: str) -> int:
        return self.dims[index]

    def __str__(self) -> str:  # pragma: no cover
        ins = ",".join(str(t) for t in self.inputs)
        return f"{ins}->{self.output}"


def parse(expr: str,
          dims: Mapping[str, int],
          sparse: int | None = 0,
          names: Sequence[str] | None = None) -> SpTTNSpec:
    """Parse ``"ijk,ja,ka->ia"`` into an :class:`SpTTNSpec`.

    ``sparse`` is the position of the sparse input (None = all dense).

    >>> spec = parse("ijk,ja,ka->ia",
    ...              dims={"i": 8, "j": 6, "k": 5, "a": 4},
    ...              names=["T", "B", "C"])
    >>> str(spec)
    'T*(i,j,k),B(j,a),C(k,a)->OUT(i,a)'
    >>> spec.sparse_input.name
    'T'
    """
    if "->" not in expr:
        raise ValueError("explicit output required, e.g. 'ijk,ja->ia'")
    lhs, rhs = expr.split("->")
    in_specs = lhs.split(",")
    if names is None:
        names = [f"T{i}" for i in range(len(in_specs))]
    inputs = tuple(
        TensorRef(name=names[i], indices=tuple(s), is_sparse=(i == sparse))
        for i, s in enumerate(in_specs))
    output = TensorRef(name="OUT", indices=tuple(rhs))
    return SpTTNSpec(inputs=inputs, output=output, dims=dict(dims))


# Convenience constructors for the paper's kernels (§2.3). ------------------ #

def mttkrp(I: int, J: int, K: int, R: int) -> SpTTNSpec:
    """Eq. 1: A(i,a) = sum_jk T(i,j,k) B(j,a) C(k,a)."""
    return parse("ijk,ja,ka->ia", dims={"i": I, "j": J, "k": K, "a": R},
                 names=["T", "B", "C"])


def ttmc3(I: int, J: int, K: int, R: int, S: int) -> SpTTNSpec:
    """Eq. 2: S(i,r,s) = sum_jk T(i,j,k) U(j,r) V(k,s)."""
    return parse("ijk,jr,ks->irs", dims={"i": I, "j": J, "k": K,
                                         "r": R, "s": S},
                 names=["T", "U", "V"])


def ttmc4(I: int, J: int, K: int, L: int, R: int, S: int, U: int) -> SpTTNSpec:
    """§5.3: S(i,r,s,t) = sum_jkl T(i,j,k,l) U(j,r) V(k,s) W(l,t)."""
    return parse("ijkl,jr,ks,lt->irst",
                 dims={"i": I, "j": J, "k": K, "l": L,
                       "r": R, "s": S, "t": U},
                 names=["T", "U", "V", "W"])


def tttp3(I: int, J: int, K: int, R: int) -> SpTTNSpec:
    """Eq. 3: S(i,j,k) = sum_r T(i,j,k) U(i,r) V(j,r) W(k,r) (SDDMM-like)."""
    return parse("ijk,ir,jr,kr->ijk",
                 dims={"i": I, "j": J, "k": K, "r": R},
                 names=["T", "U", "V", "W"])


def sddmm(I: int, J: int, R: int) -> SpTTNSpec:
    """Order-2 TTTP = SDDMM: S(i,j) = T(i,j) * sum_r U(i,r) V(j,r)."""
    return parse("ij,ir,jr->ij", dims={"i": I, "j": J, "r": R},
                 names=["T", "U", "V"])


def tttc6(N: int, R: int, E: int | None = None) -> SpTTNSpec:
    """Eq. 4 (TTTc): order-6 tensor-train contraction producing Z(e,n).

    Z(e,n) = sum T(i,j,k,l,m,n) A(i,a) B(a,j,b) C(b,k,c) D(c,l,d) E(d,m,e)
    """
    E = E or R
    dims = {c: N for c in "ijklmn"}
    dims.update({c: R for c in "abcd"})
    dims["e"] = E
    return parse("ijklmn,ia,ajb,bkc,cld,dme->en", dims=dims,
                 names=["T", "A", "B", "C", "D", "E"])
