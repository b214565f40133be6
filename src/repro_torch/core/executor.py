"""SpTTN loop-nest execution (paper §5.1, Algorithm 2) — the engines.

1. :func:`reference_execute` — a *literal* implementation of Algorithm 2:
   recursive loop-nest generation over the CSF tree with buffer reset
   rules.  Pure numpy, exponentially slow, used as the semantic oracle.

2. :class:`VectorizedExecutor` — the eager PyTorch engine
   (``backend="torch"``, the JAX package's ``"xla"`` engine).  The fused
   loop-nest plan runs as tensor operations over the CSF arrays:
     * sparse loops          -> flattened fiber arrays (gather / sorted
                                segment sum)
     * innermost dense loops -> one ``torch.einsum`` per term
     * loop fusion depth     -> the CSF level at which each intermediate
                                is materialized (nnz^(I1..Ip) x dense)
   Its sorted segment sums are :func:`repro_torch.kernels.segment.
   segment_combine`: the combine kernel on CUDA (deterministic, no
   atomics), its plain version on the CPU.

3. ``backend="cuda"`` / ``"cuda-splitk"`` —
   :class:`repro_torch.kernels.codegen.StagePlanExecutor`, the code
   generator that emits the target-neutral stage IR and lowers it to the
   hand-written Hopper kernels (segment loop or split-K + combine).

Select an engine with :func:`make_executor`; all share one semantics.
Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``): :meth:`CSFArrays.from_csf` with no device raises
where CUDA is missing, never falling back to the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import string
from collections.abc import Mapping, Sequence
from typing import ClassVar

import numpy as np
import torch

from repro_torch.analysis.diagnostics import (BACKENDS, CODEGEN_BACKENDS,
                                              CODEGEN_TARGETS,
                                              REFERENCE_BACKENDS)
from repro_torch.core.loopnest import LoopOrder, buffer_indices
from repro_torch.core.paths import ContractionPath, Term, consumer_map
from repro_torch.core.spec import SpTTNSpec
from repro_torch.kernels.segment import segment_combine, segment_ptr
from repro_torch.sparse.csf import CSFTensor, level_segments

# =========================================================================== #
# Plan serialization — plan JSON v6, the JAX package's format.  Documents
# written there load here: their backend names map through
# REFERENCE_BACKENDS ("xla" -> "torch", "pallas" -> "cuda", "pallas-gpu"
# -> "cuda-splitk").  Any other version is rejected — "re-plan, never
# guess".
# =========================================================================== #
PLAN_JSON_VERSION = 6


def _operand_to_dict(op) -> dict:
    return {"name": op.name, "indices": list(op.indices),
            "sparse": bool(op.is_sparse)}


def _operand_from_dict(d):
    from repro_torch.core.paths import Operand
    return Operand(name=d["name"], indices=tuple(d["indices"]),
                   is_sparse=bool(d["sparse"]))


def plan_to_dict(plan) -> dict:
    """Serialize an :class:`~repro_torch.core.planner.SpTTNPlan` to plain
    JSON types.  Everything a plan holds is structural (names, index
    tuples, dims) plus float diagnostics, so the round trip is exact."""
    spec = plan.spec
    return {
        "version": PLAN_JSON_VERSION,
        "spec": {
            "inputs": [_operand_to_dict(t) for t in spec.inputs],
            "output": _operand_to_dict(spec.output),
            "dims": {k: int(v) for k, v in spec.dims.items()},
        },
        "path": [{"lhs": _operand_to_dict(t.lhs),
                  "rhs": _operand_to_dict(t.rhs),
                  "out": _operand_to_dict(t.out)} for t in plan.path],
        "order": [list(a) for a in plan.order],
        "cost": plan.cost,
        "flops": plan.flops,
        "depth": plan.depth,
        "backend": plan.backend,
        "mesh": None if plan.mesh is None else dict(plan.mesh),
        "fused": bool(plan.fused),
        "block": None if plan.block is None else int(plan.block),
        "slice_mode": plan.slice_mode,
        "slice_chunks": int(plan.slice_chunks),
    }


def plan_from_dict(doc: dict):
    # lazy: the verifier imports core submodules
    from repro_torch.analysis.invariants import (check_block, check_mesh,
                                                 check_slice)
    from repro_torch.core.paths import Term
    from repro_torch.core.planner import SpTTNPlan
    if doc.get("version") != PLAN_JSON_VERSION:
        raise ValueError(
            f"unsupported plan version {doc.get('version')!r}: plan JSON "
            f"v{doc.get('version')}, expected v{PLAN_JSON_VERSION}; "
            "re-plan, never guess [SPTTN-E060]")
    sd = doc["spec"]
    spec = SpTTNSpec(
        inputs=tuple(_tensor_ref(t) for t in sd["inputs"]),
        output=_tensor_ref(sd["output"]),
        dims=dict(sd["dims"]))
    path = tuple(Term(lhs=_operand_from_dict(t["lhs"]),
                      rhs=_operand_from_dict(t["rhs"]),
                      out=_operand_from_dict(t["out"]))
                 for t in doc["path"])
    order = tuple(tuple(a) for a in doc["order"])
    backend = doc.get("backend", "xla")
    backend = REFERENCE_BACKENDS.get(backend, backend)
    if backend not in BACKENDS:
        raise ValueError(f"unknown plan backend {backend!r}; expected one "
                         f"of {BACKENDS} [SPTTN-E040]")
    mesh = doc.get("mesh")
    for d in check_mesh(mesh):
        raise ValueError(f"{d.message} [{d.code}]")
    fused = doc.get("fused", False)
    if not isinstance(fused, bool):
        raise ValueError(f"plan fused must be a boolean, got {fused!r}")
    block = doc.get("block")
    if block is not None and (not isinstance(block, int)
                              or isinstance(block, bool)):
        raise ValueError("plan block must be a positive multiple of 8 "
                         f"or null, got {block!r}")
    for d in check_block(block):
        raise ValueError("plan block must be a positive multiple of 8 "
                         f"or null, got {block!r} [{d.code}]")
    smode = doc.get("slice_mode")
    schunks = doc.get("slice_chunks", 1)
    if smode is not None and not isinstance(smode, str):
        raise ValueError(f"plan slice_mode must be a string or null, "
                         f"got {smode!r}")
    if (not isinstance(schunks, int) or isinstance(schunks, bool)
            or schunks < 1):
        raise ValueError(f"plan slice_chunks must be a positive int, "
                         f"got {schunks!r}")
    for d in check_slice(spec, smode, schunks):
        raise ValueError(f"plan {d.message} [{d.code}]")
    return SpTTNPlan(spec=spec, path=path, order=order, cost=doc["cost"],
                     flops=doc["flops"], depth=doc["depth"], backend=backend,
                     mesh=mesh, fused=fused, block=block,
                     slice_mode=smode, slice_chunks=schunks)


def _tensor_ref(d):
    from repro_torch.core.spec import TensorRef
    return TensorRef(name=d["name"], indices=tuple(d["indices"]),
                     is_sparse=bool(d["sparse"]))


def plan_to_json(plan) -> str:
    return json.dumps(plan_to_dict(plan), sort_keys=True)


def plan_from_json(s: str):
    return plan_from_dict(json.loads(s))


# =========================================================================== #
# Reference engine — Algorithm 2, literally
# =========================================================================== #
def _children_ptr(csf: CSFTensor, p: int) -> np.ndarray:
    """Start offsets of each level-(p-1) fiber's children among level-p
    fibers (contiguous because coordinates are lexicographically sorted)."""
    nparent = csf.nfib[p - 1] if p > 1 else 1
    if csf.nfib.get(p, 0) == 0:
        return np.zeros(nparent + 1, dtype=np.int64)
    parents = csf.parent[p] if p > 1 else np.zeros(csf.nfib[p], dtype=np.int32)
    return np.searchsorted(parents, np.arange(nparent + 1))


def reference_execute(spec: SpTTNSpec, path: ContractionPath,
                      order: LoopOrder, csf: CSFTensor,
                      factors: Mapping[str, np.ndarray]) -> np.ndarray:
    """Execute a fused loop nest exactly as Algorithm 2 would (numpy loops).

    Returns the DENSE output (sparse-pattern outputs are densified so tests
    can compare against einsum oracles directly).
    """
    spos = {s: i for i, s in enumerate(spec.sparse_indices)}
    cons = consumer_map(path)
    binds = buffer_indices(path, order)
    dims = spec.dims

    # dense buffer allocation (reference keeps buffers at full declared size)
    bufs: dict[str, np.ndarray] = {}
    for u, inds in binds.items():
        bufs[path[u].out.name] = np.zeros([dims[i] for i in inds],
                                          dtype=np.float64)
    buf_inds = {path[u].out.name: inds for u, inds in binds.items()}
    out_arr = np.zeros([dims[i] for i in spec.output.indices],
                       dtype=np.float64)

    ptr = {p: _children_ptr(csf, p) for p in range(1, csf.order + 1)}

    def term_value(op, env, fibers):
        if op.name in factors:
            return factors[op.name][tuple(env[i] for i in op.indices)]
        if op.is_sparse and op.name == spec.sparse_input.name:
            # the sparse tensor's term always has a full fiber chain: its
            # sparse loops appear in storage order on the leaf's root path
            assert len(fibers) == csf.order, "broken CSF chain at sparse leaf"
            return csf.values[fibers[-1]]
        b = bufs[op.name]
        return b[tuple(env[i] for i in buf_inds[op.name])]

    def exec_term(tid: int, env, fibers):
        t = path[tid]
        val = term_value(t.lhs, env, fibers) * term_value(t.rhs, env, fibers)
        if t.out.name == "OUT":
            out_arr[tuple(env[i] for i in spec.output.indices)] += val
        else:
            bufs[t.out.name][tuple(env[i] for i in buf_inds[t.out.name])] += val

    def loop_nest(seq, env, fibers):
        """seq: (term_id, remaining_order) pairs; ``fibers`` is the chain of
        CSF fiber ids bound so far (levels 1..len(fibers) consecutively).

        Buffer reset per Algorithm 2: a producer/consumer pair whose fused
        loops diverge at this level has a buffer private to one iteration of
        the enclosing loops, so it is zeroed here (they never rejoin deeper,
        hence the reset fires exactly once per enclosing iteration)."""
        pos_in = {tid: n for n, (tid, _) in enumerate(seq)}
        for u, v in cons.items():
            if u in pos_in and v in pos_in:
                if not _same_group(seq, pos_in[u], pos_in[v]):
                    bufs[path[u].out.name][...] = 0.0

        i = 0
        while i < len(seq):
            tid, rem = seq[i]
            if not rem:
                exec_term(tid, env, fibers)
                i += 1
                continue
            q = rem[0]
            group = []
            j = i
            while j < len(seq) and seq[j][1] and seq[j][1][0] == q:
                group.append((seq[j][0], seq[j][1][1:]))
                j += 1
            lvl = spos[q] + 1 if q in spos else None
            if lvl is not None and len(fibers) == lvl - 1:
                # sparse loop with intact chain: iterate CSF children
                parent = fibers[-1] if fibers else 0
                for fib in range(ptr[lvl][parent], ptr[lvl][parent + 1]):
                    env2 = dict(env)
                    env2[q] = int(csf.coord[lvl][fib])
                    loop_nest(group, env2, fibers + (fib,))
            else:
                # dense loop (also the correct semantics for a sparse index
                # whose CSF chain is broken — all reads are then from dense
                # buffers/factors, e.g. a non-prefix intermediate)
                for v in range(dims[q]):
                    env2 = dict(env)
                    env2[q] = v
                    loop_nest(group, env2, fibers)
            i = j
        return

    def _same_group(seq, iu, iv):
        """True if positions iu..iv all share the same leading index."""
        ru = seq[iu][1]
        if not ru:
            return False
        q = ru[0]
        for t in range(iu, iv + 1):
            r = seq[t][1]
            if not r or r[0] != q:
                return False
        return True

    loop_nest([(i, a) for i, a in enumerate(order)], {}, ())
    return out_arr


def dense_oracle(spec: SpTTNSpec, csf: CSFTensor,
                 factors: Mapping[str, np.ndarray]) -> np.ndarray:
    """np.einsum over densified operands — the ultimate ground truth."""
    letters = {}
    for i in spec.all_indices:
        letters[i] = string.ascii_lowercase[len(letters)]
    operands, subs = [], []
    for t in spec.inputs:
        if t.is_sparse:
            operands.append(csf.coo.to_dense().astype(np.float64))
        else:
            operands.append(np.asarray(factors[t.name], dtype=np.float64))
        subs.append("".join(letters[i] for i in t.indices))
    out_sub = "".join(letters[i] for i in spec.output.indices)
    return np.einsum(",".join(subs) + "->" + out_sub, *operands)


# =========================================================================== #
# Devices and operands
# =========================================================================== #
def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; it raises where CUDA is missing
    (the CPU runs only when asked for by name, as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def factors_to_torch(factors: Mapping, device) -> dict[str, torch.Tensor]:
    """Turn a mapping of factor matrices (numpy arrays, as the JAX
    package's callers hold them, or tensors) into tensors on ``device``,
    keeping each one's dtype."""
    dev = torch.device(device)
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(dev) for k, v in factors.items()}


@dataclasses.dataclass
class FiberVal:
    """A tensor carried on the level-p fibers of the sparse tensor:
    array shape = (nfib_p, *dense_dims)."""
    array: torch.Tensor
    level: int
    dense: tuple[str, ...]


@dataclasses.dataclass
class DenseVal:
    array: torch.Tensor
    indices: tuple[str, ...]


@dataclasses.dataclass
class CSFArrays:
    """The CSF operand on one device (one-time upload; the pattern is
    fixed).  It keeps the host :class:`CSFTensor` too, so every layout is
    computed once from numpy — never from a device-to-host copy."""
    values: torch.Tensor
    fiber_coord: dict[int, dict[int, torch.Tensor]]  # level -> mode -> coords
    seg: dict[tuple[int, int], torch.Tensor]         # (child, parent) -> map
    nfib: dict[int, int]
    order: int
    shape: tuple[int, ...]
    host: CSFTensor
    # pattern-static device data derived from ``host`` on first use
    # (segment offsets here, stage layouts and index tables in
    # kernels/codegen/executor.py), keyed by what it was derived for
    cache: dict = dataclasses.field(default_factory=dict, repr=False)
    #: every fiber's coordinates differ, so densifying fiber rows is a
    #: plain put; a padded distributed shard
    #: (:class:`repro_torch.distributed.spttn_dist.ShardArrays`) repeats
    #: coordinate 0 on its zero pad fibers and densifies by adding
    distinct_fibers: ClassVar[bool] = True

    @property
    def device(self) -> torch.device:
        return self.values.device

    @classmethod
    def from_csf(cls, csf: CSFTensor, device=None) -> "CSFArrays":
        """Upload ``csf`` to ``device`` (``None``: the CUDA card, raising
        where there is none)."""
        dev = resolve_device(device)

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        fiber_coord: dict[int, dict[int, torch.Tensor]] = {}
        for p in range(1, csf.order + 1):
            fc = csf.fiber_coords(p).astype(np.int64)
            fiber_coord[p] = {m: up(fc[:, m]) for m in range(p)}
        seg = {}
        for child in range(1, csf.order + 1):
            for par in range(0, child):
                seg[(child, par)] = up(
                    level_segments(csf, child, par).astype(np.int64))
        return cls(values=up(csf.values), fiber_coord=fiber_coord, seg=seg,
                   nfib=dict(csf.nfib), order=csf.order, shape=csf.shape,
                   host=csf)

    def host_segments(self, child: int, par: int) -> np.ndarray:
        """The sorted (child -> par) segment map, from the host CSF
        (``par == 0`` maps every child fiber to the one root row)."""
        if par == 0:
            return np.zeros(self.nfib[child], np.int64)
        return level_segments(self.host, child, par)

    def segment_ptr(self, child: int, par: int) -> torch.Tensor:
        """Row offsets of the (child -> par) segment map on the device
        (computed once from the host CSF, then cached)."""
        key = ("segment_ptr", child, par)
        if key not in self.cache:
            nseg = self.nfib[par] if par > 0 else 1
            self.cache[key] = torch.from_numpy(segment_ptr(
                self.host_segments(child, par), nseg)).to(self.device)
        return self.cache[key]


def as_arrays(csf, device=None) -> CSFArrays:
    """``csf`` as a :class:`CSFArrays`: a host CSF tensor is uploaded to
    ``device`` (``None``: the CUDA card); an operand already on a device
    is kept, and refused when ``device`` names another one."""
    if not isinstance(csf, CSFArrays):
        return CSFArrays.from_csf(csf, device)
    want = None if device is None else torch.device(device)
    if want is not None and (csf.device.type != want.type or (
            want.index is not None and csf.device.index != want.index)):
        raise ValueError(f"operand lives on {csf.device}, but "
                         f"device={device!r} was asked for")
    return csf


def segment_sum(csf: CSFArrays, arr: torch.Tensor, lvl: int,
                out_lvl: int) -> torch.Tensor:
    """Sorted segment sum of level-``lvl`` rows onto level ``out_lvl``
    (``out_lvl == 0`` sums every row into the single root row)."""
    nseg = csf.nfib[out_lvl] if out_lvl > 0 else 1
    rest = tuple(arr.shape[1:])
    width = int(np.prod(rest, dtype=np.int64))     # -1 is ambiguous at 0 rows
    out = segment_combine(arr.reshape(arr.shape[0], width).contiguous(),
                          csf.segment_ptr(lvl, out_lvl), nseg)
    return out.reshape((nseg,) + rest)


# =========================================================================== #
# Eager PyTorch engine
# =========================================================================== #
class VectorizedExecutor:
    """Run a (path, order) plan as eager PyTorch over CSF arrays.

    The plan's fused sparse depth per intermediate decides the CSF level at
    which it is materialized; trailing dense loops become one einsum.
    """

    def __init__(self, spec: SpTTNSpec, path: ContractionPath,
                 order: LoopOrder):
        self.spec = spec
        self.path = path
        self.order = order
        self.spos = {s: i for i, s in enumerate(spec.sparse_indices)}
        from repro_torch.core.loopnest import fused_sparse_depth
        self.fuse_depth = fused_sparse_depth(path, order, spec.sparse_indices)
        self._letter = {}
        for i in spec.all_indices:
            self._letter[i] = string.ascii_lowercase[len(self._letter)]

    # -- helpers -------------------------------------------------------- #
    def _sparse_level(self, inds: Sequence[str]) -> int:
        return max((self.spos[i] + 1 for i in inds if i in self.spos),
                   default=0)

    def _is_prefix(self, inds: Sequence[str]) -> bool:
        """True if the sparse indices of ``inds`` form a CSF storage prefix."""
        sp = sorted(self.spos[i] for i in inds if i in self.spos)
        return sp == list(range(len(sp)))

    def _lift_dense_factor(self, csf: CSFArrays, arr: torch.Tensor,
                           inds: tuple[str, ...], level: int
                           ) -> tuple[torch.Tensor, tuple[str, ...]]:
        """Gather a dense operand's rows onto level-``level`` fibers, one
        gather per sparse index it carries."""
        if not any(i in self.spos for i in inds):
            return arr, inds
        dense_inds = tuple(i for i in inds if i not in self.spos)
        index_tuple = tuple(
            csf.fiber_coord[level][self.spos[i]] if i in self.spos
            else slice(None) for i in inds)
        # numpy-style mixed advanced indexing: all advanced indices are 1-D
        # fiber-length vectors -> one fiber axis, placed first when the
        # advanced indices are non-adjacent and in place otherwise
        out = arr[index_tuple]
        adv_pos = [ax for ax, i in enumerate(inds) if i in self.spos]
        contiguous = adv_pos == list(range(adv_pos[0],
                                           adv_pos[0] + len(adv_pos)))
        if contiguous and adv_pos[0] != 0:
            out = torch.movedim(out, adv_pos[0], 0)
        return out, dense_inds

    def _einsum(self, a: torch.Tensor, ai: Sequence[str],
                b: torch.Tensor, bi: Sequence[str],
                oi: Sequence[str], fiber: bool) -> torch.Tensor:
        L = self._letter
        batch = "Z" if fiber else ""
        sa = batch + "".join(L[i] for i in ai)
        sb = batch + "".join(L[i] for i in bi)
        so = batch + "".join(L[i] for i in oi)
        dtype = torch.promote_types(a.dtype, b.dtype)
        return torch.einsum(f"{sa},{sb}->{so}", a.to(dtype), b.to(dtype))

    # -- main ----------------------------------------------------------- #
    def _get_operand(self, csf: CSFArrays, factors: Mapping, env: dict,
                     op) -> "FiberVal | DenseVal":
        if op.is_sparse and op.name == self.spec.sparse_input.name:
            return FiberVal(csf.values, csf.order, ())
        if op.name in factors:
            return DenseVal(factors[op.name], op.indices)
        return env[op.name]

    def _to_dense(self, csf: CSFArrays, v: "FiberVal | DenseVal",
                  want: tuple[str, ...]) -> torch.Tensor:
        """Materialize onto a dense array with index order ``want``."""
        spec = self.spec
        if isinstance(v, DenseVal):
            perm = [v.indices.index(i) for i in want]
            return v.array.permute(perm)
        # scatter fiber rows into a dense array over its sparse prefix;
        # fibers are distinct, so a plain (non-accumulating) put is exact
        # (a padded shard's zero pad fibers repeat coordinate 0: added)
        sp_inds = tuple(spec.sparse_indices[:v.level])
        full = sp_inds + v.dense
        shape = [spec.dims[i] for i in full]
        coords = tuple(csf.fiber_coord[v.level][m] for m in range(v.level))
        out = torch.zeros(shape, dtype=v.array.dtype, device=v.array.device)
        out.index_put_(coords, v.array, accumulate=not csf.distinct_fibers)
        perm = [full.index(i) for i in want]
        return out.permute(perm)

    def _exec_term(self, csf: CSFArrays, factors: Mapping, env: dict,
                   term: Term) -> "FiberVal | DenseVal":
        """Execute one contraction term, returning its intermediate value
        (a final term's value is materialized by ``_materialize_output``)."""
        a = self._get_operand(csf, factors, env, term.lhs)
        b = self._get_operand(csf, factors, env, term.rhs)
        out_inds = term.out.indices
        term_sp = [i for i in term.indices if i in self.spos]
        prefix_ok = (self._is_prefix(term.indices)
                     and self._is_prefix(out_inds))
        is_final = term.out.name == "OUT"

        if term_sp and prefix_ok and (isinstance(a, FiberVal)
                                      or isinstance(b, FiberVal)):
            return self._exec_fiber_term(csf, term, a, b)
        if (term_sp and is_final and self._is_prefix(term.indices)
                and (isinstance(a, FiberVal) or isinstance(b, FiberVal))):
            # final term keeping a non-prefix sparse subset (e.g. TTTc's
            # OUT(e,n)): einsum at the term level, then scatter-add by
            # the kept coordinate columns (implicitly summing the rest)
            arr = self._exec_final_scatter(csf, term, a, b)
            return DenseVal(arr, self.spec.output.indices)
        # dense fallback (covers dense x dense and non-prefix cases)
        ai = tuple(term.lhs.indices)
        bi = tuple(term.rhs.indices)
        da = self._to_dense(csf, a, ai)
        db = self._to_dense(csf, b, bi)
        arr = self._einsum(da, ai, db, bi, out_inds, fiber=False)
        return DenseVal(arr, out_inds)

    def _materialize_output(self, csf: CSFArrays,
                            val: "FiberVal | DenseVal") -> torch.Tensor:
        spec = self.spec
        if isinstance(val, DenseVal):
            perm = [val.indices.index(i) for i in spec.output.indices]
            return val.array.permute(perm)
        if spec.output_is_sparse:
            # same-sparsity output: return leaf values (level = order)
            assert val.level == csf.order and not val.dense
            return val.array
        return self._to_dense(csf, val, spec.output.indices)

    def _chain_len(self, tid: int) -> int:
        """Number of consecutive terms starting at ``tid`` this engine
        executes as one unit.  The eager engine runs one term at a time;
        the code generator overrides this with its fused chains."""
        return 1

    def _exec_chain(self, csf: CSFArrays, factors: Mapping, env: dict,
                    tid: int, length: int):
        raise NotImplementedError   # pragma: no cover - chain engines only

    def __call__(self, csf: CSFArrays, factors: Mapping) -> torch.Tensor:
        factors = factors_to_torch(factors, csf.device)
        env: dict[str, FiberVal | DenseVal] = {}
        tid, n = 0, len(self.path)
        while tid < n:
            length = self._chain_len(tid)
            if length > 1:
                val = self._exec_chain(csf, factors, env, tid, length)
                term = self.path[tid + length - 1]
            else:
                term = self.path[tid]
                val = self._exec_term(csf, factors, env, term)
            tid += length
            if term.out.name == "OUT":
                return self._materialize_output(csf, val)
            env[term.out.name] = val
        raise AssertionError("path had no final term")

    # ------------------------------------------------------------------ #
    def _lift(self, csf: CSFArrays, v, ref, lvl: int):
        """Bring an operand onto level-``lvl`` fibers."""
        if isinstance(v, FiberVal):
            arr = v.array
            if v.level < lvl:
                arr = arr[csf.seg[(lvl, v.level)]]
            return arr, v.dense
        return self._lift_dense_factor(csf, v.array, ref.indices, lvl)

    def _exec_final_scatter(self, csf: CSFArrays, term: Term, a, b):
        """Final term whose kept sparse indices are not a storage prefix:
        scatter-add fiber rows by the kept coordinate columns.  Distinct
        fibers may share those columns, so this accumulates
        (``index_put_(accumulate=True)``: atomics on CUDA, so the sum
        order — and the last bits of a float32 result — vary by run;
        the tests hold it to ``1e-5 * max(1, max|ref|)`` in float32)."""
        spec = self.spec
        lvl = self._sparse_level(term.indices)
        fa, da = self._lift(csf, a, term.lhs, lvl)
        fb, db = self._lift(csf, b, term.rhs, lvl)
        out_inds = spec.output.indices
        out_sp = [i for i in out_inds if i in self.spos]
        out_dense = tuple(i for i in out_inds if i not in self.spos)
        arr = self._fiber_contract(csf, fa, da, fb, db, out_dense, lvl, lvl)
        coords = tuple(csf.fiber_coord[lvl][self.spos[i]] for i in out_sp)
        shape = [spec.dims[i] for i in out_sp] + \
            [spec.dims[i] for i in out_dense]
        full = tuple(out_sp) + out_dense
        out = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
        out.index_put_(coords, arr, accumulate=True)
        perm = [full.index(i) for i in out_inds]
        return out.permute(perm)

    def _exec_fiber_term(self, csf: CSFArrays, term: Term,
                         a: "FiberVal | DenseVal",
                         b: "FiberVal | DenseVal") -> "FiberVal | DenseVal":
        """sparse-structured term: lift to the term's CSF level, contract the
        dense dims, segment-reduce to the output's level."""
        lvl = self._sparse_level(term.indices)
        out_lvl = self._sparse_level(term.out.indices)

        fa, da = self._lift(csf, a, term.lhs, lvl)
        fb, db = self._lift(csf, b, term.rhs, lvl)
        sp = set(self.spos)
        out_dense = tuple(i for i in term.out.indices if i not in sp)
        arr = self._fiber_contract(csf, fa, da, fb, db, out_dense, lvl,
                                   out_lvl)
        if out_lvl == 0:
            return DenseVal(arr, out_dense)      # fully contracted prefix
        return FiberVal(arr, out_lvl, out_dense)

    def _fiber_contract(self, csf: CSFArrays, fa, da, fb, db,
                        out_dense: tuple[str, ...], lvl: int,
                        out_lvl: int) -> torch.Tensor:
        """Contract two level-``lvl`` operands and reduce to ``out_lvl``.

        The overridable lowering unit shared by the eager and code
        generator engines: dense-contracted indices collapse into one
        einsum and the sparse reduction becomes a sorted segment sum.
        ``out_lvl == lvl`` means no sparse reduction (per-fiber output);
        ``out_lvl == 0`` returns the dense array of shape ``out_dense``.
        """
        arr = self._einsum(fa, da, fb, db, out_dense, fiber=True)
        if out_lvl < lvl:
            arr = segment_sum(csf, arr, lvl, out_lvl)
            if out_lvl == 0:
                arr = arr[0]
        return arr


def execute_unfactorized(spec: SpTTNSpec, csf, factors: Mapping,
                         device=None) -> torch.Tensor:
    """The 'unfactorized' schedule (paper §2.4.1): all factors gathered to
    the leaves and multiplied in one pass (TACO/COMET default).  Kept as a
    baseline for the benchmarks.  ``csf`` is a :class:`CSFArrays` or a
    host CSF tensor, uploaded to ``device`` (``None``: the CUDA card)."""
    csf = as_arrays(csf, device)
    factors = factors_to_torch(factors, csf.device)
    spos = {s: i for i, s in enumerate(spec.sparse_indices)}
    letters = {i: string.ascii_lowercase[n]
               for n, i in enumerate(spec.all_indices)}
    lvl = csf.order
    operands = [csf.values]
    subs = ["Z"]
    for t in spec.inputs:
        if t.is_sparse:
            continue
        idx = tuple(csf.fiber_coord[lvl][spos[i]] if i in spos
                    else slice(None) for i in t.indices)
        g = factors[t.name][idx]
        adv = [ax for ax, i in enumerate(t.indices) if i in spos]
        # advanced indices side by side land where the first one was (so
        # the fiber axis moves to the front); split by a slice, they
        # already lead (numpy's rule)
        if adv and adv[0] != 0 and adv == list(range(adv[0],
                                                     adv[0] + len(adv))):
            g = torch.movedim(g, adv[0], 0)
        operands.append(g)
        subs.append("Z" + "".join(letters[i] for i in t.indices
                                  if i not in spos))
    out_sp = [i for i in spec.output.indices if i in spos]
    out_dn = [i for i in spec.output.indices if i not in spos]
    expr = ",".join(subs) + "->Z" + "".join(letters[i] for i in out_dn)
    per_leaf = torch.einsum(expr, *operands)
    if spec.output_is_sparse:
        return per_leaf
    p_out = len(out_sp)
    if p_out < lvl:
        per_leaf = segment_sum(csf, per_leaf, lvl, p_out)
    # put the rows onto the dense output over the sparse output indices
    full = tuple(out_sp) + tuple(out_dn)
    if p_out == 0:
        out = per_leaf[0]
    else:
        out = per_leaf.new_zeros([spec.dims[i] for i in full])
        out[tuple(csf.fiber_coord[p_out][m] for m in range(p_out))] = \
            per_leaf                              # each fiber once
    perm = [full.index(i) for i in spec.output.indices]
    return out.permute(perm) if perm != list(range(len(perm))) else out


# =========================================================================== #
# Engine registry
# =========================================================================== #
class ReferenceExecutor:
    """Algorithm-2 interpreter behind the common executor signature.

    Accepts a host :class:`CSFTensor` or a :class:`CSFArrays` (which
    retains the host tensor).  Output is always the dense numpy array;
    sparse-pattern outputs are densified.
    """

    def __init__(self, spec: SpTTNSpec, path: ContractionPath,
                 order: LoopOrder):
        self.spec = spec
        self.path = path
        self.order = order

    def __call__(self, csf, factors: Mapping) -> np.ndarray:
        if isinstance(csf, CSFArrays):
            csf = csf.host
        np_factors = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v) for k, v in factors.items()}
        return reference_execute(self.spec, self.path, self.order, csf,
                                 np_factors)


# The full extra-kwarg vocabulary of the engines: all three are code
# generator options.  Anything else is a typo and is rejected.
ENGINE_KWARGS = ("block", "strategy", "tile_align")


def _check_engine_kwargs(kwargs: Mapping, backend: str, who: str) -> None:
    unknown = sorted(k for k in kwargs if k not in ENGINE_KWARGS)
    if unknown:
        import difflib
        hints = []
        for k in unknown:
            close = difflib.get_close_matches(k, ENGINE_KWARGS, n=1)
            if close:
                hints.append(f"{k!r} -> did you mean {close[0]!r}?")
        hint = ("; " + "; ".join(hints)) if hints else ""
        raise ValueError(
            f"{who}() got unknown argument(s) {unknown}; valid engine "
            f"options are {sorted(ENGINE_KWARGS)} (plus 'backend' and "
            f"'device'){hint}")
    if kwargs and backend not in CODEGEN_BACKENDS:
        raise ValueError(
            f"{who}() argument(s) {sorted(kwargs)} apply only to the "
            f"code-generator backends {CODEGEN_BACKENDS}, got "
            f"backend={backend!r}")


def make_executor(spec: SpTTNSpec, path: ContractionPath, order: LoopOrder,
                  backend: str = "torch", **kwargs):
    """Instantiate an execution engine for a (path, order) schedule.

    All engines share the call signature ``ex(csf_arrays, factors)``.
    ``backend`` is one of :data:`BACKENDS`.  Extra kwargs reach the code
    generator (:data:`ENGINE_KWARGS`: ``block``, ``strategy``,
    ``tile_align``); unknown kwargs — or generator options on another
    backend — raise ``ValueError`` instead of being silently dropped.

    >>> import numpy as np
    >>> from repro_torch.core import spec as S
    >>> from repro_torch.core.planner import plan
    >>> from repro_torch.sparse import build_csf, random_sparse
    >>> spec = S.mttkrp(8, 6, 5, 4)
    >>> csf = build_csf(random_sparse((8, 6, 5), 0.2, seed=0))
    >>> rng = np.random.default_rng(0)
    >>> factors = {"B": rng.standard_normal((6, 4)).astype(np.float32),
    ...            "C": rng.standard_normal((5, 4)).astype(np.float32)}
    >>> p = plan(spec, nnz_levels=csf.nnz_levels())
    >>> ex = make_executor(spec, p.path, p.order, backend="cuda", block=8)
    >>> out = ex(CSFArrays.from_csf(csf, device="cpu"), factors)
    >>> tuple(out.shape)
    (8, 4)
    >>> make_executor(spec, p.path, p.order, blocks=128)
    Traceback (most recent call last):
        ...
    ValueError: make_executor() got unknown argument(s) ['blocks']; ...
    """
    _check_engine_kwargs(kwargs, backend, "make_executor")
    if backend == "torch":
        return VectorizedExecutor(spec, path, order)
    if backend in CODEGEN_BACKENDS:
        from repro_torch.kernels.codegen import StagePlanExecutor
        return StagePlanExecutor(spec, path, order,
                                 target=CODEGEN_TARGETS[backend], **kwargs)
    if backend == "reference":
        return ReferenceExecutor(spec, path, order)
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def execute_plan(plan, csf, factors: Mapping, backend: str | None = None,
                 memory_budget: int | None = None, device=None, **kwargs):
    """Run an :class:`~repro_torch.core.planner.SpTTNPlan` end to end,
    honoring the plan's backend unless overridden.

    ``csf`` is a :class:`CSFArrays`, a host
    :class:`~repro_torch.sparse.csf.CSFTensor` (uploaded to ``device``:
    ``None`` is the CUDA card, ``"cpu"`` the CPU), or a *sharded*
    operand: a list of per-shard CSF tensors in global coordinates, whose
    dense partial outputs are summed.  ``factors`` are numpy arrays or
    tensors (one mapping, or one per shard).

    ``memory_budget`` (bytes) prices the plan's working set against the
    operand's actual nnz profile and, when over budget, replays the same
    schedule per chunk of one dense mode
    (:func:`repro_torch.core.slicing.sliced_execute`, DESIGN.md §10).
    With no explicit budget, a plan stamped ``slice_chunks > 1`` at
    planning time replays sliced as stamped.  Both compose with sharded
    operands: the budget applies within each shard.

    >>> import numpy as np
    >>> from repro_torch.core import spec as S
    >>> from repro_torch.core.planner import plan
    >>> from repro_torch.sparse import build_csf, random_sparse
    >>> spec = S.mttkrp(8, 6, 5, 4)
    >>> csf = build_csf(random_sparse((8, 6, 5), 0.2, seed=0))
    >>> rng = np.random.default_rng(0)
    >>> factors = {"B": rng.standard_normal((6, 4)).astype(np.float32),
    ...            "C": rng.standard_normal((5, 4)).astype(np.float32)}
    >>> p = plan(spec, nnz_levels=csf.nnz_levels())
    >>> out = execute_plan(p, csf, factors, device="cpu")
    >>> tuple(out.shape)
    (8, 4)
    """
    resolved = backend or plan.backend
    _check_engine_kwargs(kwargs, resolved, "execute_plan")
    # static pre-flight: every invariant an engine would trip over deep
    # inside a lowering is rejected here with a structured diagnostic
    from repro_torch.analysis import verify_plan
    verify_plan(plan, backend=resolved).raise_if_error("execute_plan")
    if isinstance(csf, (list, tuple)):
        if plan.spec.output_is_sparse:
            raise ValueError(
                "sharded operands with a same-sparsity output need the "
                "distributed engine; per-shard leaf values cannot be "
                "summed")
        if not csf:
            raise ValueError("empty shard list")
        per_shard = (list(factors) if isinstance(factors, (list, tuple))
                     else [factors] * len(csf))
        if len(per_shard) != len(csf):
            raise ValueError(
                f"{len(csf)} shards but {len(per_shard)} factor mappings")
        total = None
        for shard, f in zip(csf, per_shard):
            part = torch.as_tensor(execute_plan(
                plan, shard, f, backend=backend,
                memory_budget=memory_budget, device=device, **kwargs))
            total = part if total is None else total + part
        return total
    if memory_budget is not None:
        # price against the operand's true profile; slice only if needed
        from repro_torch.core import slicing
        plan = slicing.stamp_plan_slicing(plan, slicing.nnz_levels_of(csf),
                                          memory_budget)
    if getattr(plan, "slice_chunks", 1) > 1:
        from repro_torch.core.slicing import sliced_execute
        return sliced_execute(plan, csf, factors, backend=backend,
                              device=device, **kwargs)
    if isinstance(csf, CSFArrays) or resolved != "reference":
        csf = as_arrays(csf, device)
    ex = make_executor(plan.spec, plan.path, plan.order, backend=resolved,
                       **plan_engine_kwargs(plan, resolved, kwargs))
    return ex(csf, factors)


def plan_engine_kwargs(plan, backend: str, kwargs: Mapping = ()) -> dict:
    """``kwargs`` plus the code-generator options ``plan`` won with on
    ``backend``: a fused winner replays through the chain lowering it was
    tuned with, and with the block size that won."""
    kwargs = dict(kwargs)
    if backend in CODEGEN_BACKENDS:
        if getattr(plan, "fused", False):
            kwargs.setdefault("strategy", "fused")
        if getattr(plan, "block", None):
            kwargs.setdefault("block", plan.block)
    return kwargs
