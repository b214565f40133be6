"""The paper's loop-nest invariants, re-derived symbolically.

This module is the **single source of truth** for every legality fact
the engines enforce.  Each invariant is a pure function of the spec, the
contraction path, and the plan axes — no CSF operand, no torch — so
the verifier can run before any kernel is built, and the engines' own
guards (`fusible_chains` in kernels/codegen, the block-grid check of the
stage lowerings, the plan-document validators in core) are thin
wrappers over the functions here.

Checker functions return ``list[Diagnostic]`` (empty = invariant holds);
:func:`check_block_grid` returns ``Diagnostic | None`` for its single
fact.  :mod:`repro_torch.analysis.verify` orchestrates them into one report.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

from repro_torch.analysis.diagnostics import (BACKEND_DEVICE_KINDS,
                                              BACKENDS, CODEGEN_TARGETS,
                                              Diagnostic, diag)
from repro_torch.core.paths import ContractionPath, consumer_map
from repro_torch.core.spec import SpTTNSpec

# Tuned block sizes stay multiples of the TPU sublane (8): the plan
# documents are shared with the JAX package, whose compiled lowering
# needs it, so the rule (SPTTN-E021) is kept here as well.
_SUBLANE = 8


# --------------------------------------------------------------------------- #
# Shared CSF-structure helpers (the storage-prefix vocabulary)
# --------------------------------------------------------------------------- #
def _spos(spec: SpTTNSpec) -> dict[str, int]:
    return {s: i for i, s in enumerate(spec.sparse_indices)}


def _slv(spos: Mapping[str, int], inds: Sequence[str]) -> int:
    """Deepest CSF level touched by ``inds`` (0 = fully dense)."""
    return max((spos[i] + 1 for i in inds if i in spos), default=0)


def _is_prefix(spos: Mapping[str, int], inds: Sequence[str]) -> bool:
    """True when the sparse indices in ``inds`` form a storage-order
    prefix of the CSF path (the paper's storage-prefix rule)."""
    sp = sorted(spos[i] for i in inds if i in spos)
    return sp == list(range(len(sp)))


def _reducing(spec: SpTTNSpec, spos: Mapping[str, int], term) -> bool:
    """A term the fused-chain lowering can host: touches the sparse
    operand, keeps storage-prefix on both sides, and strictly descends
    the CSF level from operand to output."""
    return (any(i in spos for i in term.indices)
            and _is_prefix(spos, term.indices)
            and _is_prefix(spos, term.out.indices)
            and _slv(spos, term.out.indices) < _slv(spos, term.indices))


# --------------------------------------------------------------------------- #
# Fused-chain legality (DESIGN.md §6)
# --------------------------------------------------------------------------- #
def fusible_chains(spec: SpTTNSpec,
                   path: ContractionPath) -> dict[int, tuple[int, ...]]:
    """Detect chains of reducing terms the fused-chain lowering can prove
    safe (DESIGN.md §6): maximal runs of *consecutive* path terms where
    each term's output is consumed by exactly the next term, every term
    reduces along the sparse operand's CSF path (storage-prefix indices,
    strictly decreasing output level, the consumer contracting at exactly
    the intermediate's level), and each non-first term's other operand is
    an original dense input (liftable onto that level's fibers without
    further recursion).  Returns ``{start_tid: (tid, ...)}`` for chains of
    length >= 2; everything else stays on the staged per-term path.

    Structural only — no CSF needed — so the autotuner can use it to
    decide whether ``fused`` is a meaningful candidate axis for a
    schedule before any operand exists.
    """
    spos = _spos(spec)
    dense_inputs = {t.name for t in spec.inputs if not t.is_sparse}

    cons = consumer_map(path)
    chains: dict[int, tuple[int, ...]] = {}
    used: set[int] = set()
    for t in range(len(path)):
        if t in used or not _reducing(spec, spos, path[t]):
            continue
        tids = [t]
        k = t
        while k + 1 < len(path) and cons.get(k) == k + 1:
            nxt = path[k + 1]
            inter = path[k].out.name
            other = (nxt.rhs if nxt.lhs.name == inter
                     else nxt.lhs if nxt.rhs.name == inter else None)
            if (other is None or other.name not in dense_inputs
                    or not _reducing(spec, spos, nxt)
                    or _slv(spos, nxt.indices)
                    != _slv(spos, path[k].out.indices)):
                break
            tids.append(k + 1)
            k += 1
        if len(tids) > 1:
            chains[t] = tuple(tids)
            used.update(tids)
    return chains


def chain_diagnostics(spec: SpTTNSpec,
                      path: ContractionPath) -> list[Diagnostic]:
    """Explain a ``fused=True`` request: empty when at least one provably
    safe chain exists, otherwise E010 plus per-term detail on *why* every
    candidate chain broke (the inverse of :func:`fusible_chains`)."""
    if fusible_chains(spec, path):
        return []
    spos = _spos(spec)
    dense_inputs = {t.name for t in spec.inputs if not t.is_sparse}
    diags = [diag(
        "SPTTN-E010", "plan.fused",
        "fused requested but the path has no provably safe reducing "
        "chain (fusible_chains found none)",
        "drop fused, or re-plan — the tuner only offers fused when a "
        "chain exists")]
    cons = consumer_map(path)
    for t in range(len(path) - 1):
        if not _reducing(spec, spos, path[t]):
            continue
        if cons.get(t) != t + 1:
            diags.append(diag(
                "SPTTN-E013", f"term[{t}]",
                f"term {t}'s output is consumed by term {cons.get(t)!r}, "
                "not the next path term — chains must be consecutive"))
            continue
        nxt = path[t + 1]
        inter = path[t].out.name
        other = (nxt.rhs if nxt.lhs.name == inter
                 else nxt.lhs if nxt.rhs.name == inter else None)
        if other is None or other.name not in dense_inputs:
            diags.append(diag(
                "SPTTN-E012", f"term[{t + 1}]",
                f"chain link at term {t + 1} multiplies the intermediate "
                f"by {other.name if other is not None else '<missing>'!r}, "
                "which is not an original dense input"))
        elif (not _reducing(spec, spos, nxt)
              or _slv(spos, nxt.indices) != _slv(spos, path[t].out.indices)):
            diags.append(diag(
                "SPTTN-E011", f"term[{t + 1}]",
                f"chain levels not strictly descending: term {t + 1} "
                f"contracts at level {_slv(spos, nxt.indices)}, expected "
                f"exactly the intermediate's level "
                f"{_slv(spos, path[t].out.indices)}"))
    return diags


# --------------------------------------------------------------------------- #
# Loop-order legality (paper §4.1.2 / §5)
# --------------------------------------------------------------------------- #
def check_order(spec: SpTTNSpec, path: ContractionPath,
                order) -> list[Diagnostic]:
    """Per-term loop-order legality: one permutation per term, sparse
    indices in CSF storage order (the same facts as
    :func:`repro_torch.core.loopnest.is_valid_order`, localized per term)."""
    if len(order) != len(path):
        return [diag(
            "SPTTN-E003", "plan.order",
            f"loop order has {len(order)} entries for {len(path)} path "
            "terms — found vs expected lengths must match")]
    spos = _spos(spec)
    diags: list[Diagnostic] = []
    for i, (term, a) in enumerate(zip(path, order)):
        if sorted(a) != sorted(term.indices):
            diags.append(diag(
                "SPTTN-E002", f"order[{i}]",
                f"order {tuple(a)!r} is not a permutation of term {i}'s "
                f"indices {tuple(term.indices)!r}"))
            continue
        sp = [x for x in a if x in spos]
        if any(spos[x] > spos[y] for x, y in zip(sp, sp[1:])):
            diags.append(diag(
                "SPTTN-E001", f"order[{i}]",
                f"sparse indices {tuple(sp)!r} in term {i}'s order "
                f"violate CSF storage order {spec.sparse_indices!r} "
                "(storage-prefix rule, paper §5)",
                "iterate the term's sparse indices in storage order"))
    return diags


def check_path_output(spec: SpTTNSpec,
                      path: ContractionPath) -> list[Diagnostic]:
    """The final term must produce exactly the spec output."""
    if not path or tuple(path[-1].out.indices) != tuple(spec.output.indices):
        found = tuple(path[-1].out.indices) if path else ()
        return [diag(
            "SPTTN-E004", f"term[{max(len(path) - 1, 0)}]",
            f"path's final term produces {found!r}, expected the spec "
            f"output {tuple(spec.output.indices)!r}")]
    return []


# --------------------------------------------------------------------------- #
# Plan-axis legality: backend / block / slice / mesh
# --------------------------------------------------------------------------- #
def check_backend(backend) -> list[Diagnostic]:
    if backend not in BACKENDS:
        return [diag(
            "SPTTN-E040", "plan.backend",
            f"unknown backend {backend!r}; expected one of {BACKENDS}")]
    return []


def check_lowering(backend) -> list[Diagnostic]:
    """A code-generator backend is executable only where its stage
    lowering target (:data:`CODEGEN_TARGETS`) is registered in the
    kernels/codegen registry — a plan replayed on a build that lacks the
    target must be rejected *before* the engine is constructed.  The
    registry import is lazy: this module is imported by the codegen
    executor itself, so a top-level import would cycle."""
    target = CODEGEN_TARGETS.get(backend)
    if target is None:
        return []
    import repro_torch.kernels.codegen  # registers the built-in lowerings
    from repro_torch.kernels.codegen.ir import lowering_targets
    if target not in lowering_targets():
        return [diag(
            "SPTTN-E041", "plan.backend",
            f"backend {backend!r} needs stage lowering target "
            f"{target!r}, but this host registers only "
            f"{lowering_targets()}",
            "re-plan on this host instead of replaying the foreign plan "
            "JSON")]
    return []


def check_device_kind(backend, device_kind) -> list[Diagnostic]:
    """The CUDA engines launch their kernels only on a ``"gpu"`` device
    (:data:`BACKEND_DEVICE_KINDS`); on CPU tensors they run the kernels'
    plain PyTorch versions.  That is legal — it is how the tests run —
    but a deployment replaying a ``cuda`` plan on a CPU host is almost
    certainly a routing mistake, so the mismatch is a warning
    (SPTTN-W005), surfaced only when the caller states the host device
    kind explicitly."""
    want = BACKEND_DEVICE_KINDS.get(backend)
    if want is None or device_kind is None or device_kind == want:
        return []
    return [diag(
        "SPTTN-W005", "plan.backend",
        f"backend {backend!r} launches its kernels on device kind "
        f"{want!r} but the host is {device_kind!r}; execution runs the "
        "kernels' plain PyTorch versions",
        "route the plan to a matching device")]


def check_block(block) -> list[Diagnostic]:
    """Tuned Pallas fiber block sizes are positive sublane multiples
    (DESIGN.md §8); ``None`` means engine default and is always legal."""
    if block is None:
        return []
    if not isinstance(block, int) or isinstance(block, bool) or block < 1:
        return [diag(
            "SPTTN-E020", "plan.block",
            f"block must be positive, got {block!r} — block sizes are "
            "positive multiples of 8")]
    if block % _SUBLANE:
        return [diag(
            "SPTTN-E021", "plan.block",
            f"block {block!r} is not a multiple of the TPU sublane "
            f"({_SUBLANE}) — tuned block sizes must be positive "
            "multiples of 8")]
    return []


def check_block_grid(padded_len: int, block: int) -> Diagnostic | None:
    """The sequential grid covers ``padded_len // block`` blocks; a
    non-multiple length would silently drop the tail slots."""
    if padded_len % block:
        return diag(
            "SPTTN-E022", "stage.grid",
            f"padded operand length {padded_len} is not a multiple of "
            f"the stage block {block}",
            "layout producers must pad to block multiples "
            "(padded_segment_layout / pad_segment_layout)")
    return None


def check_slice(spec: SpTTNSpec, mode, chunks) -> list[Diagnostic]:
    """Slice-mode kind legality (DESIGN.md §10): only a dense mode may be
    chunked — output-kind modes assemble disjoint slabs, contracted-kind
    modes accumulate in float64, sparse modes are *sharding*, never
    slicing."""
    if mode is None:
        if chunks is not None and chunks > 1:
            return [diag(
                "SPTTN-E033", "plan.slice_chunks",
                f"slice_chunks must be 1 when slice_mode is null, "
                f"got {chunks!r}")]
        return []
    if mode not in spec.dims:
        return [diag(
            "SPTTN-E030", "plan.slice_mode",
            f"slice mode {mode!r} not in spec dims "
            f"{tuple(spec.dims)!r}")]
    if mode in spec.sparse_indices:
        return [diag(
            "SPTTN-E031", "plan.slice_mode",
            f"slice mode {mode!r} is a sparse index; slicing sparse "
            "modes is nonzero sharding — only dense modes are sliceable",
            "pass a shard list to execute_plan instead")]
    if chunks is not None and (chunks < 2 or chunks > spec.dims[mode]):
        return [diag(
            "SPTTN-E032", "plan.slice_chunks",
            f"slice_chunks must be in [2, dims[{mode}]="
            f"{spec.dims[mode]}] when slice_mode is set, got {chunks!r}")]
    return []


def check_mesh(mesh) -> list[Diagnostic]:
    """Shard-context shape (``shard_mesh_key``): a mapping with
    ``mesh_shape``/``mode_axis`` sub-mappings and an integer ``shard``."""
    if mesh is None:
        return []
    if not isinstance(mesh, dict):
        return [diag(
            "SPTTN-E050", "plan.mesh",
            f"plan mesh must be an object or null, got {mesh!r}")]
    diags: list[Diagnostic] = []
    for key in ("mesh_shape", "mode_axis"):
        if key in mesh and not isinstance(mesh[key], dict):
            diags.append(diag(
                "SPTTN-E050", f"plan.mesh.{key}",
                f"plan mesh {key} must be an object, got {mesh[key]!r}"))
    if "shard" in mesh and (not isinstance(mesh["shard"], int)
                            or isinstance(mesh["shard"], bool)):
        diags.append(diag(
            "SPTTN-E050", "plan.mesh.shard",
            f"plan mesh shard must be an integer, got {mesh['shard']!r}"))
    return diags


# --------------------------------------------------------------------------- #
# Advisory analyses (warnings — never block execution)
# --------------------------------------------------------------------------- #
_DTYPE_RANK = {"bool": 0, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
               "int32": 3, "uint32": 3, "int64": 4, "uint64": 4,
               "float16": 5, "bfloat16": 5, "float32": 6, "float64": 7}


def dtype_diagnostics(spec: SpTTNSpec, path: ContractionPath,
                      dtypes: Mapping[str, str] | None) -> list[Diagnostic]:
    """W004: trace numpy-style promotion through the crossing buffers.
    A widened buffer (e.g. a float64 factor meeting float32 leaf values)
    is legal — every engine accumulates at the promoted dtype — but the
    caller should know the whole downstream chain pays for the width."""
    if not dtypes:
        return []
    env = {t.name: str(dtypes.get(t.name, "float32")) for t in spec.inputs}
    diags: list[Diagnostic] = []
    for i, term in enumerate(path):
        lt = env.get(term.lhs.name, "float32")
        rt = env.get(term.rhs.name, "float32")
        out_dt = lt if _DTYPE_RANK.get(lt, 6) >= _DTYPE_RANK.get(rt, 6) else rt
        env[term.out.name] = out_dt
        if i < len(path) - 1 and (out_dt != lt or out_dt != rt):
            diags.append(diag(
                "SPTTN-W004", f"term[{i}]",
                f"crossing buffer {term.out.name!r} promotes {lt} * {rt} "
                f"-> {out_dt}; downstream stages accumulate at the "
                "widened dtype"))
    return diags
