"""Distributed SpTTN execution on ``torch.distributed`` — the paper's
§5.2 (the JAX package's ``distributed/spttn_dist.py``, in SPMD form).

CTF layout, as in the reference:
  * the sparse tensor is partitioned by tensor modes onto mesh axes and
    never moves (cyclic load balance = host-side row permutation + block
    partition, which is the same layout up to relabeling);
  * each dense factor is sharded along the modes it shares with a
    partitioned sparse mode and *partially replicated* along every other
    mesh axis (the paper's replication scheme);
  * each rank runs the same fused loop-nest plan on its local CSF (the
    local problem is an SpTTN of identical structure — paper §1);
  * the output is reduced only over mesh axes that own contracted sparse
    modes, and is sharded over output modes.

**The SPMD translation.**  The reference is single-controller: one
``shard_map`` runs one traced function on every device of a
``jax.sharding.Mesh``.  Here every rank calls the same entry point with
the same global inputs, and the entry point returns on every rank what
the reference's call returns.

* The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` the
  caller builds (``init_process_group`` + ``init_device_mesh``, the
  counterpart of ``jax.make_mesh``) and that spans the default group.
  Host-only functions also take a plain ``{axis: size}`` mapping.
* A rank's shard is the mixed-radix index of its coordinates along the
  partition axes, in ``mode_axis`` order (the owner enumeration of
  :func:`partition_mesh`).  Ranks that differ only along another axis are
  replicas: they compute the same shard.
* ``psum`` over an axis is ``all_reduce`` on that axis's group.  The
  output's sharding becomes an ``all_gather`` along each axis that
  shards an output mode, shards concatenated in part order, so every
  rank returns the reference's ``[part, local]`` global layout and
  :func:`undo_cyclic` and the ``[:I]`` trim apply unchanged.
* Each rank runs the plan on its shard's **padded** arrays
  (:func:`_pad_local_csf`): the zero-nnz pad fibers the stackability
  walk reasons about are there exactly as in the reference, and the
  engines route every stage as the reference does.  Nothing is traced,
  so the reference's mesh-wide padding of block-layout tables
  (``_stacked_layout_tables``, ``_install_stacked_layouts``: one
  ``pallas_call`` trace for every shard) has no counterpart: each rank's
  code-generator executor cuts its layouts from its own padded segment
  maps (:class:`ShardArrays`) through the operand's layout cache
  (``kernels/codegen/executor.py``'s ``layout_cache``).

Three execution modes:

* :func:`make_distributed` — the collective engine on the eager
  ``torch`` engine, ``all_reduce`` over contracted partitioned modes.
* :func:`make_distributed_cuda` — the collective engine on the code
  generator's ``cuda`` engine (the stage kernels K1, K2 and the combine,
  the fused chain K3 when the plan is fused), behind the
  :func:`stackable_plan` gate.
* :func:`make_distributed_tuned` — per-shard tuned plans: homogeneous
  ``torch`` winners route to the first, homogeneous ``cuda`` winners
  that pass :func:`stackable_plan` to the second, anything else replays
  each shard's plan on its owner and sums the partials in shard order.

Collectives move what the process group's backend moves: NCCL across
cards; gloo also takes CUDA tensors (through host memory), which is how
several ranks share one card (NCCL refuses two ranks on one GPU).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.diagnostics import CODEGEN_BACKENDS
from repro_torch.analysis.invariants import plan_layout_walk
from repro_torch.core.executor import (CSFArrays, VectorizedExecutor,
                                       factors_to_torch, make_executor,
                                       plan_engine_kwargs, resolve_device)
from repro_torch.core.planner import SpTTNPlan
from repro_torch.core.spec import SpTTNSpec
from repro_torch.kernels.segment import segment_ptr
from repro_torch.sparse.coo import COOTensor
from repro_torch.sparse.csf import build_csf, level_segments


# =========================================================================== #
# Meshes and shards
# =========================================================================== #
def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, of a plain mapping, or of
    anything whose ``shape`` is such a mapping (a JAX ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {ax: int(n) for ax, n in zip(names, mesh.shape)}
    shape = mesh if isinstance(mesh, Mapping) else mesh.shape
    return {ax: int(n) for ax, n in shape.items()}


def rank_shard(mesh, part_axes) -> tuple[int, bool]:
    """This rank's shard (its coordinates along ``part_axes``, mixed
    radix in that order) and whether it is the shard's first replica
    (coordinate 0 along every other axis of ``mesh``)."""
    sizes = axis_sizes(mesh)
    shard = 0
    for ax in part_axes:
        shard = shard * sizes[ax] + mesh.get_local_rank(ax)
    first = all(mesh.get_local_rank(ax) == 0 for ax in sizes
                if ax not in part_axes)
    return shard, first


def shard_owners(mesh, part_axes) -> list[int]:
    """Global rank of each shard's first replica, in shard order."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    parts = [sizes[ax] for ax in part_axes]
    owners = []
    for s in range(int(np.prod(parts))):
        coord = [0] * len(names)
        for ax, d in zip(part_axes, np.unravel_index(s, parts)):
            coord[names.index(ax)] = int(d)
        owners.append(int(mesh.mesh[tuple(coord)]))
    return owners


# =========================================================================== #
# Padded shard layout
# =========================================================================== #
def _pad_local_csf(csf, max_nnz: int, max_nfib: dict[int, int]):
    """Flattened per-level arrays padded with zero-contribution entries.

    Values pad with zeros and fiber coordinates with 0 (a real local
    coordinate — harmless because the padded values are zero, and the
    engines add pad rows where they densify).  Segment tails pad with
    the LAST segment id (``max_nfib[par] - 1``), not 0: every CSF
    segment map is sorted ascending, and the block layouts
    (:func:`repro_torch.kernels.util.padded_segment_layout`) and the
    sorted segment sums rely on that — a zero tail after a nonzero id
    would silently break it.  The padded rows still contribute nothing
    (their values are zero), they just accumulate into the final row
    instead of row 0.
    """
    order = csf.order
    out = {"values": np.zeros(max_nnz, csf.values.dtype)}
    out["values"][: csf.nnz] = csf.values
    for p in range(1, order + 1):
        fc = csf.fiber_coords(p)
        for m in range(p):
            a = np.zeros(max_nfib[p], np.int32)
            a[: csf.nfib[p]] = fc[:, m]
            out[f"coord_{p}_{m}"] = a
    for child in range(1, order + 1):
        for par in range(0, child):
            seg = level_segments(csf, child, par)
            padval = (max_nfib[par] - 1) if par > 0 else 0
            a = np.full(max_nfib[child], padval, np.int32)
            a[: len(seg)] = seg
            out[f"seg_{child}_{par}"] = a
    return out


def unpad_local_csf(packed: Mapping[str, np.ndarray], order: int,
                    nnz: int, nfib: Mapping[int, int]) -> dict:
    """Invert :func:`_pad_local_csf`: slice one shard's padded arrays
    back to its real ``nnz`` / per-level ``nfib`` counts.  Padding never
    mixes into real slots (it is strictly appended), so the round trip
    is bit-exact — the property the collective engines rest on."""
    out = {"values": np.asarray(packed["values"])[:nnz]}
    for p in range(1, order + 1):
        for m in range(p):
            out[f"coord_{p}_{m}"] = \
                np.asarray(packed[f"coord_{p}_{m}"])[: nfib[p]]
    for child in range(1, order + 1):
        for par in range(0, child):
            out[f"seg_{child}_{par}"] = \
                np.asarray(packed[f"seg_{child}_{par}"])[: nfib[child]]
    return out


@dataclasses.dataclass
class ShardArrays(CSFArrays):
    """One shard's padded CSF operand on its rank's device.  Its host
    segment maps are the padded ones, so every layout the code generator
    cuts covers the pad tail (the reference's ``shard_views``); its pad
    fibers repeat coordinate 0, so the engines densify by adding.

    ``real_nfib`` is the shard's own fiber count per level: the rows past
    it at each level are the pad fibers, which hold zeros."""

    segments: dict = dataclasses.field(default_factory=dict, repr=False)
    real_nfib: dict = dataclasses.field(default_factory=dict, repr=False)
    distinct_fibers = False

    def host_segments(self, child: int, par: int) -> np.ndarray:
        return self.segments[(child, par)]

    def segment_ptr(self, child: int, par: int) -> torch.Tensor:
        """Row offsets of the segment map with the pad rows in none: the
        sorted segment sums then add the real rows only (pad rows are
        zero, so the sums are the same), and the combine never walks a
        shard's whole pad tail in its last segment, one row at a time."""
        key = ("segment_ptr", child, par)
        if key not in self.cache:
            nseg = self.nfib[par] if par > 0 else 1
            ptr = np.minimum(segment_ptr(self.host_segments(child, par),
                                         nseg), self.real_nfib[child])
            self.cache[key] = torch.from_numpy(ptr).to(self.device)
        return self.cache[key]


def _unpack_csf(stacked_local: Mapping, order: int, nfib: Mapping[int, int],
                shape, device, real_nfib: Mapping[int, int]) -> ShardArrays:
    """A shard's padded arrays (:func:`_pad_local_csf`) as a
    :class:`ShardArrays` on ``device`` (indices as int64, as
    ``CSFArrays.from_csf`` holds them); ``real_nfib`` the shard's own
    fiber counts."""
    dev = torch.device(device)

    def up(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(dev)

    fiber_coord = {p: {m: up(np.asarray(stacked_local[f"coord_{p}_{m}"],
                                        np.int64))
                       for m in range(p)} for p in range(1, order + 1)}
    segments = {(c, par): np.asarray(stacked_local[f"seg_{c}_{par}"],
                                     np.int64)
                for c in range(1, order + 1) for par in range(0, c)}
    return ShardArrays(values=up(stacked_local["values"]),
                       fiber_coord=fiber_coord,
                       seg={k: up(v) for k, v in segments.items()},
                       nfib=dict(nfib), order=order, shape=tuple(shape),
                       host=None, segments=segments,
                       real_nfib=dict(real_nfib))


@dataclasses.dataclass
class MeshPartition:
    """Host-side result of partitioning a COO over the mesh — everything
    the collective engines share: per-shard padded CSF arrays (numpy
    ``packed``, and ``stacked``, the same arrays as CPU tensors, one
    mapping per shard), factor/output shardings (a mesh axis or ``None``
    per dimension), and the ``all_reduce`` axes.  Built by
    :func:`partition_mesh`; every rank builds the same one."""

    order: int
    nshards: int
    csfs: list                          # per-shard local CSFTensors
    packed: list                        # per-shard padded numpy arrays
    stacked: list                       # per-shard padded CPU tensors
    perm: np.ndarray                    # nnz permutation (global -> stacked)
    local_shape: tuple
    local_spec: SpTTNSpec
    max_nnz: int
    max_nfib: dict
    part_axes: tuple
    factor_specs: dict
    factor_perm: dict
    out_spec: tuple
    reduce_axes: list


def factor_take(nparts: int, local_dim: int, dim: int,
                cyclic: bool) -> np.ndarray:
    """Rows of a zero-row-padded factor in ``[part, local]`` stacked
    order: part ``p``'s local row ``l`` is global row ``l * nparts + p``
    (cyclic) or ``p * local_dim + l`` (blocks); rows past ``dim`` take
    the pad row ``dim``."""
    part = np.arange(nparts)[:, None]
    local = np.arange(local_dim)[None, :]
    g = local * nparts + part if cyclic else part * local_dim + local
    return np.where(g < dim, g, dim).astype(np.int64).ravel()


def partition_mesh(spec: SpTTNSpec, coo: COOTensor, mesh,
                   mode_axis: dict[int, str],
                   cyclic: bool = True) -> MeshPartition:
    """Partition ``coo`` per ``mode_axis`` into the padded shard layout
    (the reference's ``partition_mesh``, array for array).  Only the
    mesh's axis sizes are read."""
    sp_inds = spec.sparse_indices
    shape = coo.shape
    coords = coo.coords.copy()
    values = coo.values.copy()
    sizes = axis_sizes(mesh)

    # cyclic load balance == row permutation + block partition
    nparts = {m: sizes[ax] for m, ax in mode_axis.items()}
    local_dim = {m: -(-shape[m] // nparts[m]) for m in mode_axis}
    owner = np.zeros(len(values), np.int64)
    nshards = 1
    for m in mode_axis:
        if cyclic:
            part = coords[:, m] % nparts[m]
            local = coords[:, m] // nparts[m]
        else:
            part = coords[:, m] // local_dim[m]
            local = coords[:, m] % local_dim[m]
        coords[:, m] = local
        owner = owner * nparts[m] + part
        nshards *= nparts[m]

    # bucket nonzeros per shard, build local CSFs, pad to common sizes
    order = coo.order
    buckets = [np.flatnonzero(owner == s) for s in range(nshards)]
    local_shape = tuple(local_dim.get(m, shape[m]) for m in range(order))
    csfs = []
    sorted_ids = []                 # global nnz id per (shard, local slot)
    for idx in buckets:
        key = np.lexsort(coords[idx].T[::-1])
        lc = COOTensor(coords=np.ascontiguousarray(coords[idx][key]),
                       values=np.ascontiguousarray(values[idx][key]),
                       shape=local_shape)
        csfs.append(build_csf(lc))
        sorted_ids.append(idx[key])
    max_nnz = max(max(c.nnz for c in csfs), 1)
    max_nfib = {p: max(max(c.nfib.get(p, 0) for c in csfs), 1)
                for p in range(1, order + 1)}
    packed = [_pad_local_csf(c, max_nnz, max_nfib) for c in csfs]
    stacked = [{k: torch.from_numpy(v) for k, v in pk.items()}
               for pk in packed]

    part_axes = tuple(mode_axis[m] for m in mode_axis)
    dims_local = dict(spec.dims)
    for m, ind in enumerate(sp_inds):
        if m in mode_axis:
            dims_local[ind] = local_shape[m]
    local_spec = dataclasses.replace(spec, dims=dims_local)

    # factor shardings: shard along partitioned shared modes, replicate
    # the rest (paper §5.2 partial replication).  Each rank keeps one
    # block of rows, so rows are pre-permuted into [part, local] stacked
    # order to match the (cyclic) relabeling of the sparse coordinates.
    factor_specs = {}
    factor_perm: dict[str, tuple[int, np.ndarray] | None] = {}
    for t in spec.inputs:
        if t.is_sparse:
            continue
        parts = []
        factor_perm[t.name] = None
        for axpos, ind in enumerate(t.indices):
            ax = None
            for m, a in mode_axis.items():
                if sp_inds[m] == ind:
                    ax = a
                    factor_perm[t.name] = (axpos, factor_take(
                        nparts[m], local_dim[m], shape[m], cyclic))
            parts.append(ax)
        factor_specs[t.name] = tuple(parts)

    # output sharding: partitioned output sparse modes stay sharded;
    # contracted partitioned modes need an all_reduce
    out_parts = []
    for ind in spec.output.indices:
        ax = None
        for m, a in mode_axis.items():
            if sp_inds[m] == ind:
                ax = a
        out_parts.append(ax)
    reduce_axes = [a for m, a in mode_axis.items()
                   if sp_inds[m] not in spec.output.indices]
    out_spec = tuple(out_parts) if not spec.output_is_sparse \
        else (part_axes,)

    return MeshPartition(
        order=order, nshards=nshards, csfs=csfs, packed=packed,
        stacked=stacked, perm=np.concatenate(sorted_ids),
        local_shape=local_shape, local_spec=local_spec, max_nnz=max_nnz,
        max_nfib=max_nfib, part_axes=part_axes, factor_specs=factor_specs,
        factor_perm=factor_perm, out_spec=out_spec,
        reduce_axes=reduce_axes)


# =========================================================================== #
# The collective engines
# =========================================================================== #
def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in
    group-rank order (the mesh coordinate along the group's axis)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


@dataclasses.dataclass
class DistributedSpTTN:
    """A collective distributed kernel: call with the global factors on
    every rank; every rank returns the global ``[part, local]`` output."""

    spec: SpTTNSpec
    plan: SpTTNPlan
    mesh: object                        # DeviceMesh
    mode_axis: dict[int, str]
    arrays: ShardArrays                 # this rank's padded shard
    executor: VectorizedExecutor
    shard: int
    perm: np.ndarray                    # nnz permutation (global -> stacked)
    factor_perm: dict
    factor_specs: dict
    out_spec: tuple
    reduce_axes: list
    nnz_per_shard: list
    max_nnz: int
    _take: dict = dataclasses.field(default_factory=dict, repr=False)

    def _prepare(self, factors: Mapping) -> dict[str, torch.Tensor]:
        """Each factor padded by a zero row, permuted into stacked order
        and cut to this rank's block along each sharded axis (what
        ``shard_map``'s blockwise split hands each device)."""
        dev = self.arrays.device
        prepared = {}
        for name, arr in factors_to_torch(factors, dev).items():
            perm = self.factor_perm.get(name)
            if perm is not None:
                axis, take = perm
                if name not in self._take:
                    self._take[name] = torch.from_numpy(take).to(dev)
                pad = list(arr.shape)
                pad[axis] = 1
                arr = torch.cat([arr, arr.new_zeros(pad)], axis)
                arr = arr.index_select(axis, self._take[name])
            for dim, ax in enumerate(self.factor_specs.get(name, ())):
                if ax is not None:
                    n = arr.shape[dim] // axis_sizes(self.mesh)[ax]
                    arr = arr.narrow(dim, self.mesh.get_local_rank(ax) * n,
                                     n)
            prepared[name] = arr.contiguous()
        return prepared

    def __call__(self, factors: Mapping) -> torch.Tensor:
        out = self.executor(self.arrays, self._prepare(factors)).contiguous()
        for ax in self.reduce_axes:
            dist.all_reduce(out, group=self.mesh.get_group(ax))
        for dim, axes in enumerate(self.out_spec):
            # a sparse output's one dim is sharded over every partition
            # axis, the first the outermost: gather the innermost first
            for ax in reversed(axes if isinstance(axes, tuple) else (axes,)):
                if ax is not None:
                    out = _all_gather(out, self.mesh.get_group(ax), dim)
        return out


def _collective(spec, plan, mesh, mode_axis, part: MeshPartition,
                arrays: ShardArrays, executor, shard: int):
    return DistributedSpTTN(
        spec=spec, plan=plan, mesh=mesh, mode_axis=dict(mode_axis),
        arrays=arrays, executor=executor, shard=shard, perm=part.perm,
        factor_perm=part.factor_perm, factor_specs=part.factor_specs,
        out_spec=part.out_spec, reduce_axes=list(part.reduce_axes),
        nnz_per_shard=[c.nnz for c in part.csfs], max_nnz=part.max_nnz)


def _shard_operand(spec, coo, mesh, mode_axis, cyclic, device):
    dev = resolve_device(device)
    part = partition_mesh(spec, coo, mesh, mode_axis, cyclic=cyclic)
    shard, _ = rank_shard(mesh, part.part_axes)
    arrays = _unpack_csf(part.stacked[shard], part.order, part.max_nfib,
                         part.local_shape, dev, part.csfs[shard].nfib)
    return part, shard, arrays


def make_distributed(spec: SpTTNSpec, plan: SpTTNPlan, coo: COOTensor,
                     mesh, mode_axis: dict[int, str], cyclic: bool = True,
                     device=None) -> DistributedSpTTN:
    """Partition ``coo`` per ``mode_axis`` and build this rank's
    collective kernel on the eager ``torch`` engine (see
    :func:`make_distributed_cuda` for the code-generator sibling).
    ``device`` is where this rank computes (``None``: its current CUDA
    device, raising where there is none)."""
    part, shard, arrays = _shard_operand(spec, coo, mesh, mode_axis, cyclic,
                                         device)
    executor = VectorizedExecutor(part.local_spec, plan.path, plan.order)
    return _collective(spec, plan, mesh, mode_axis, part, arrays, executor,
                       shard)


def stackable_plan(spec: SpTTNSpec, path, fused: bool = False) -> bool:
    """True when a plan can run on padded shards through
    :func:`make_distributed_cuda`: every sparse-structured stage consumes
    at least one operand that is zero on padded fibers at the stage's own
    CSF level, so the zero-nnz tails contribute nothing on any shard —
    including an entirely empty one.  Dense outputs only;
    :func:`make_distributed_tuned` falls back to replay when this is
    False.  A thin wrapper over
    :func:`repro_torch.analysis.invariants.stackable_diagnostics`, so
    engine routing and static verification cannot disagree."""
    from repro_torch.analysis.invariants import stackable_diagnostics
    return not stackable_diagnostics(spec, path, fused=fused)


def make_distributed_cuda(spec: SpTTNSpec, plan: SpTTNPlan, coo: COOTensor,
                          mesh, mode_axis: dict[int, str],
                          cyclic: bool = True, device=None,
                          **executor_kwargs) -> DistributedSpTTN:
    """The collective engine on the code generator's ``cuda`` engine (the
    reference's ``make_distributed_pallas``): each rank runs the plan's
    stage kernels on its padded shard, contracted-mode partials reduce
    with ``all_reduce``.

    ``plan`` must be homogeneous across shards (one schedule for all) and
    pass :func:`stackable_plan` (else ``ValueError``, SPTTN-E051); extra
    kwargs reach the code generator (``block``, ``strategy``,
    ``tile_align``), and ``plan.fused`` and ``plan.block`` are applied as
    plan replay applies them.  Each rank cuts its block layouts from its
    own padded segment maps.
    """
    if spec.output_is_sparse:
        raise ValueError(
            "make_distributed_cuda requires a dense output; same-"
            "sparsity (TTTP-like) outputs go through make_distributed")
    part, shard, arrays = _shard_operand(spec, coo, mesh, mode_axis, cyclic,
                                         device)
    ex = make_executor(part.local_spec, plan.path, plan.order,
                       backend="cuda",
                       **plan_engine_kwargs(plan, "cuda", executor_kwargs))
    ok, requests = plan_layout_walk(
        spec, plan.path, ex._chains,
        lambda lvl, out_lvl: ex.strategy_for(arrays, lvl, out_lvl) == "row")
    if not ok:
        raise ValueError(
            "plan is not stackable: some sparse-structured stage has no "
            "operand that is zero on padded fibers at its own CSF level, "
            "so the zero-nnz tails of the padded shards would pollute the "
            "result — check stackable_plan() first and fall back to "
            "replay [SPTTN-E051]")
    dist_ = _collective(spec, plan, mesh, mode_axis, part, arrays, ex, shard)
    dist_.layout_requests = requests     # inspection: the walk's requests
    return dist_


# =========================================================================== #
# Distributed plan replay (DESIGN.md §7): per-shard tuned backends
# =========================================================================== #
def shard_mesh_key(mesh, mode_axis: Mapping[int, str],
                   shard: int) -> dict:
    """JSON-able shard context for the plan cache key (DESIGN.md §7).

    Names everything that distinguishes one shard-local tuning problem
    from the single-device one and from other mesh layouts: the sizes of
    the partitioned mesh axes, the mode→axis assignment, and the shard
    index.  Feed it to ``TunerConfig.mesh`` /
    :func:`repro_torch.autotune.cache_key`; it is also stamped onto the
    tuned plan and persisted in plan JSON.

    ``mesh`` is a ``DeviceMesh`` or a plain ``{axis: size}`` mapping
    (handy for key computations without process groups).

    >>> shard_mesh_key({"data": 4}, {0: "data"}, shard=2)
    {'mesh_shape': {'data': 4}, 'mode_axis': {'0': 'data'}, 'shard': 2}
    """
    shape = axis_sizes(mesh)
    return {
        "mesh_shape": {ax: int(shape[ax])
                       for ax in sorted(set(mode_axis.values()))},
        "mode_axis": {str(m): ax for m, ax in sorted(mode_axis.items())},
        "shard": int(shard),
    }


def partition_nonzeros(coo: COOTensor, nparts: Mapping[int, int],
                       cyclic: bool = True) -> list[COOTensor]:
    """Partition ``coo``'s nonzeros by (cyclic) ownership over the
    partitioned modes, **keeping global coordinates** — each shard is a
    same-shape COO holding a disjoint nonzero subset, so per-shard dense
    partial outputs sum exactly to the global output (the replay-mode
    reduction; contrast :func:`partition_mesh`, which relabels
    coordinates for the equal-block layout).

    ``nparts`` maps mode → number of parts; ownership composes over modes
    in sorted order (mixed radix, the shard enumeration of
    :func:`partition_mesh` for one-mode grids).
    """
    owner = np.zeros(coo.nnz, np.int64)
    nshards = 1
    for m in sorted(nparts):
        P_m = int(nparts[m])
        if cyclic:
            part = coo.coords[:, m] % P_m
        else:
            local_dim = -(-coo.shape[m] // P_m)
            part = coo.coords[:, m] // local_dim
        owner = owner * P_m + part
        nshards *= P_m
    out = []
    for s in range(nshards):
        idx = np.flatnonzero(owner == s)
        # a subset of lexicographically sorted rows stays sorted
        out.append(COOTensor(coords=np.ascontiguousarray(coo.coords[idx]),
                             values=np.ascontiguousarray(coo.values[idx]),
                             shape=coo.shape))
    return out


@dataclasses.dataclass
class TunedShard:
    """One shard of a :class:`DistributedPlanReplay`: the shard-locally
    tuned plan and the search stats (cache hit/miss accounting), shared
    with every rank; on the shard's owner in replay mode also its operand
    (``csf`` for the ``reference`` engine, ``arrays`` otherwise) and the
    executor closure."""

    index: int
    nnz: int
    plan: SpTTNPlan | None       # None for an empty shard
    stats: object | None         # autotune SearchStats
    csf: object | None = None
    arrays: CSFArrays | None = None
    fn: object | None = None     # factors -> partial output


#: the three distributed execution modes a tuned replay can land on (the
#: reference's "collective-pallas" is "collective-cuda")
DIST_MODES = ("collective", "collective-cuda", "replay")


def undo_cyclic_plan(spec: SpTTNSpec, mode_axis, mesh, shape,
                     cyclic: bool = True) -> list[tuple[int, np.ndarray]]:
    """Pattern-static (axis, take) gathers inverting the cyclic row
    relabeling on partitioned output modes — compute once, apply per
    call (the gathered layout is [part, local]; global = local*nparts +
    part)."""
    sp_inds = spec.sparse_indices
    sizes = axis_sizes(mesh)
    plan = []
    for m, ax in mode_axis.items():
        ind = sp_inds[m]
        if ind not in spec.output.indices:
            continue
        axis = spec.output.indices.index(ind)
        nparts, I = sizes[ax], shape[m]
        local = -(-I // nparts)
        if not cyclic:
            plan.append((axis, np.arange(I)))
            continue
        g = np.arange(I)
        plan.append((axis, ((g % nparts) * local + g // nparts)
                     .astype(np.int64)))
    return plan


def _take(out, axis: int, take: np.ndarray):
    if isinstance(out, torch.Tensor):
        return out.index_select(axis, torch.from_numpy(
            np.asarray(take, np.int64)).to(out.device))
    return np.take(out, take, axis=axis)


def undo_cyclic(out, spec: SpTTNSpec, mode_axis, mesh, shape,
                cyclic: bool = True):
    """Invert the cyclic row relabeling on output modes (a numpy array or
    a tensor, returned as such)."""
    for axis, take in undo_cyclic_plan(spec, mode_axis, mesh, shape,
                                       cyclic=cyclic):
        out = _take(out, axis, take)
    return out


@dataclasses.dataclass
class DistributedPlanReplay:
    """Distributed SpTTN execution with per-shard tuned plans.

    ``mode`` is one of :data:`DIST_MODES`: ``"collective"`` when every
    shard's winner agreed on one ``torch`` schedule — execution then goes
    through :func:`make_distributed`, ``all_reduce`` included;
    ``"collective-cuda"`` when they agreed on one ``cuda`` schedule whose
    plan passes :func:`stackable_plan` (the fused axis is harmonized to
    the majority winner — a lowering detail timing noise may split
    across shards, never a routing forfeit) — :func:`make_distributed_cuda`;
    otherwise ``"replay"``: each shard's owner executes its own tuned
    plan on its engine, the dense partials are all-gathered and summed in
    shard order (exact, because shards keep global coordinates).
    Calling the object returns the **global** dense output on every rank,
    directly comparable against ``reference_execute``/``dense_oracle``.
    """

    spec: SpTTNSpec
    mesh: object
    mode_axis: dict[int, str]
    shape: tuple[int, ...]       # global sparse-tensor shape
    shards: list[TunedShard]
    mode: str
    cyclic: bool = True
    collective: DistributedSpTTN | None = None
    device: torch.device | None = None
    owners: list[int] = dataclasses.field(default_factory=list)
    # pattern-static undo-relabeling gathers
    _undo: list | None = dataclasses.field(default=None, repr=False,
                                           compare=False)

    @property
    def plans(self) -> list[SpTTNPlan | None]:
        return [sh.plan for sh in self.shards]

    @property
    def backends(self) -> list[str | None]:
        return [None if sh.plan is None else sh.plan.backend
                for sh in self.shards]

    @property
    def nnz_per_shard(self) -> list[int]:
        return [sh.nnz for sh in self.shards]

    def __call__(self, factors: Mapping) -> torch.Tensor:
        if self.mode in ("collective", "collective-cuda"):
            out = self.collective(factors)
            if self._undo is None:
                self._undo = undo_cyclic_plan(self.spec, self.mode_axis,
                                              self.mesh, self.shape,
                                              cyclic=self.cyclic)
            for axis, take in self._undo:
                out = _take(out, axis, take)
            return out
        dims = self.spec.dims
        factors = factors_to_torch(factors, self.device)
        dtype = torch.float32
        for f in factors.values():
            dtype = torch.promote_types(dtype, f.dtype)
        mine = next((sh for sh in self.shards if sh.fn is not None), None)
        part = (torch.as_tensor(mine.fn(factors)).to(self.device, dtype)
                if mine is not None else torch.zeros(
                    [dims[i] for i in self.spec.output.indices],
                    dtype=dtype, device=self.device))
        parts = [torch.empty_like(part)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, part.contiguous())
        total = None
        for sh in self.shards:           # the reference's shard order
            if sh.plan is None:
                continue
            p = parts[self.owners[sh.index]]
            total = p if total is None else total + p
        return part.zero_() if total is None else total


def _annotate_dist_mode(cache_dir, shards, mode: str) -> None:
    """Record the distributed mode the tuned plans were routed through
    into each given shard's plan-cache entry meta."""
    if cache_dir is None:
        return
    from repro_torch.autotune.cache import PlanCache
    cache = PlanCache(cache_dir)
    for sh in shards:
        key = getattr(sh.stats, "cache_key", "") if sh.stats else ""
        if key:
            cache.annotate(key, dist_mode=mode)


def make_distributed_tuned(spec: SpTTNSpec, coo: COOTensor, mesh,
                           mode_axis: Mapping[int, str],
                           cache_dir: str | None = None,
                           tuner=None, cyclic: bool = True,
                           prefer_collective: bool = True, device=None,
                           **executor_kwargs) -> DistributedPlanReplay:
    """Partition ``coo`` over the mesh and replay a tuned plan per shard.

    The pipeline of DESIGN.md §7: partition the nonzeros over the
    partitioned mesh axes → each shard's first replica runs (or
    cache-hits) the autotuner on the *shard's local nnz profile* under a
    mesh-extended cache key (:func:`shard_mesh_key` via
    ``TunerConfig.mesh``) → the winners are shared with
    ``all_gather_object``, so every rank routes identically and no two
    ranks write one cache key → every live shard's winner passes the
    verifier's pre-flight → execute.  When all shards agree on one
    schedule and ``prefer_collective`` is set, ``torch`` winners go
    through :func:`make_distributed` and ``cuda`` winners whose plan
    passes :func:`stackable_plan` through :func:`make_distributed_cuda`;
    heterogeneous, non-stackable or ``cuda-splitk`` winners replay
    shard by shard.  The chosen mode is recorded into each live shard's
    plan-cache entry meta (``dist_mode``) by the shard's owner when
    ``cache_dir`` is given.

    ``tuner`` is a :class:`repro_torch.autotune.TunerConfig` template
    (its ``mesh`` field is overwritten per shard); extra kwargs reach the
    code generator for code-generator shards (``block``, ``strategy``).
    Same-sparsity (TTTP-like) outputs are rejected — use
    :func:`make_distributed`.
    """
    if spec.output_is_sparse:
        raise ValueError(
            "make_distributed_tuned requires a dense output; same-sparsity "
            "outputs (TTTP-like) reassemble leaf values through "
            "make_distributed's padded layout instead")
    from repro_torch.analysis import verify_plan
    from repro_torch.autotune import TunerConfig, tune

    dev = resolve_device(device)
    base = tuner if tuner is not None else TunerConfig()
    sizes = axis_sizes(mesh)
    part_axes = tuple(mode_axis[m] for m in mode_axis)
    nparts = {m: sizes[ax] for m, ax in mode_axis.items()}
    locals_ = partition_nonzeros(coo, nparts, cyclic=cyclic)
    shard, owner = rank_shard(mesh, part_axes)
    mine, arrays = None, None
    if owner:
        mine = (shard, None, None)
        if locals_[shard].nnz:
            arrays = CSFArrays.from_csf(build_csf(locals_[shard]), dev)
            cfg = dataclasses.replace(
                base, mesh=shard_mesh_key(mesh, mode_axis, shard))
            mine = (shard, *tune(spec, csf=arrays, cache_dir=cache_dir,
                                 tuner=cfg))
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, mine)
    won = {g[0]: g[1:] for g in gathered if g is not None}
    shards = [TunedShard(s, locals_[s].nnz, *won[s])
              for s in range(len(locals_))]
    live = [sh for sh in shards if sh.plan is not None]
    mine_live = [sh for sh in live if owner and sh.index == shard]
    replay = DistributedPlanReplay(
        spec=spec, mesh=mesh, mode_axis=dict(mode_axis), shape=coo.shape,
        shards=shards, mode="replay", cyclic=cyclic, device=dev,
        owners=shard_owners(mesh, part_axes))
    if not live:
        return replay            # degenerate: empty tensor, zero output

    # static pre-flight on every live shard's winner: a corrupt cache
    # entry (doctored mesh context, illegal axes) fails here with a
    # structured diagnostic instead of deep inside a shard's lowering
    for sh in live:
        verify_plan(sh.plan).raise_if_error(
            f"make_distributed_tuned[shard {sh.index}]")

    first = live[0].plan
    # homogeneity on the schedule (path/order/backend).  The fused axis
    # is not part of it: fused-vs-staged is a lowering detail of the same
    # plan whose per-shard winner timing noise may split; fusibility
    # depends only on (spec, path), so harmonizing to the majority
    # winner is always legal (the reference's rule)
    homogeneous = all(
        (sh.plan.path, sh.plan.order, sh.plan.backend)
        == (first.path, first.order, first.backend) for sh in live)
    fused = homogeneous and sum(sh.plan.fused for sh in live) * 2 > len(live)
    if first.fused != fused:
        first = dataclasses.replace(first, fused=fused)
    if prefer_collective and homogeneous and first.backend == "torch":
        replay.mode = "collective"
        replay.collective = make_distributed(
            spec, first, coo, mesh, dict(mode_axis), cyclic=cyclic,
            device=dev)
    elif (prefer_collective and homogeneous and first.backend == "cuda"
            and stackable_plan(spec, first.path, fused=first.fused)):
        # "cuda" only, as the reference routes "pallas" only: split-K
        # winners replay per shard (they need no padding to be parallel)
        replay.mode = "collective-cuda"
        replay.collective = make_distributed_cuda(
            spec, first, coo, mesh, dict(mode_axis), cyclic=cyclic,
            device=dev, **executor_kwargs)
    _annotate_dist_mode(cache_dir, mine_live, replay.mode)
    if replay.mode != "replay":
        return replay

    for sh in mine_live:
        backend = sh.plan.backend
        kw = (plan_engine_kwargs(sh.plan, backend, executor_kwargs)
              if backend in CODEGEN_BACKENDS else {})
        ex = make_executor(spec, sh.plan.path, sh.plan.order,
                           backend=backend, **kw)
        if backend == "reference":
            sh.csf = arrays.host
            sh.fn = (lambda f, ex=ex, csf=sh.csf: ex(csf, f))
        else:
            sh.arrays = arrays
            sh.fn = (lambda f, ex=ex, a=arrays: ex(a, f))
    return replay


def gather_sparse_values(dist_: DistributedSpTTN, out_stacked) -> np.ndarray:
    """Reassemble a same-sparsity (TTTP-like) output into the original COO
    nonzero order from the gathered per-shard value layout."""
    if isinstance(out_stacked, torch.Tensor):
        out_stacked = out_stacked.cpu().numpy()
    vals = np.asarray(out_stacked).reshape(len(dist_.nnz_per_shard),
                                           dist_.max_nnz)
    total = int(sum(dist_.nnz_per_shard))
    out = np.zeros(total, vals.dtype)
    start = 0
    for s, n in enumerate(dist_.nnz_per_shard):
        out[dist_.perm[start:start + n]] = vals[s, :n]
        start += n
    return out
