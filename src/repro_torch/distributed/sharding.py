"""Logical-axis sharding rules (MaxText-style) and activation constraints
(the JAX package's ``distributed/sharding.py``), on ``DeviceMesh`` and
DTensor placements.

Parameters carry *logical* axis names (see ``models/layers.py``); a rules
table maps them to mesh axes per mesh layout.  Defaults implement:

  FSDP   — weights sharded over the data axes on their 'embed'/'ffn' dim
  TP     — heads / ffn-hidden / experts / vocab sharded over 'model'
  DP     — batch over ('pod','data'); long-context decode shards the KV/seq
           axis over 'data' instead

``tree_sharding`` gives each leaf a :class:`NamedSharding` (the
reference's per-dim spec, and the DTensor placements it means);
``distribute_params`` keeps each rank's shard of a tree of full tensors
as DTensors (what ``jax.device_put(params, shardings)`` does).
``mesh_context`` installs a mesh + rules; ``replicate`` and
``shard_activation`` redistribute a DTensor inside one and are the
identity outside one (and on a plain tensor), so models stay pure.

GSPMD partitions the reference's step; the port's sharded step computes
on gathered weights instead (:func:`gather_params`, FSDP style): each rank
all-gathers the full weights, runs the model on its rows of the batch
(:func:`batch_split`), and the gather's backward sums the weight
gradients over the batch axes and keeps the rank's shard.  The batch
axes' ranks hold different rows, so their gradients add; the other
axes' ranks (``model``) compute the same rows again, so theirs are
sliced, not added.  The collectives are ``torch.distributed``'s own, on
any backend (gloo takes CUDA tensors for all three).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Mapping, Sequence
from typing import Any

import torch
import torch.distributed as dist

_ctx = threading.local()


# --------------------------------------------------------------------------- #
# rules
# --------------------------------------------------------------------------- #
def default_rules(multi_pod: bool, shape_kind: str = "train",
                  seq_shard: bool = False,
                  preset: str = "2d") -> dict[str, object]:
    """Sharding presets.

    '2d' (default)    — DP/FSDP over data axes, TP/EP over 'model'.
    'seq_parallel'    — sequence sharded over 'model', weights replicated
                        across it (vocab stays model-sharded): for models
                        too narrow for 16-way TP (heads or ffn not
                        divisible).
    """
    data_axes = ("pod", "data") if multi_pod else ("data",)
    seqp = preset == "seq_parallel"
    tp = None if seqp else "model"
    rules: dict[str, object] = {
        # parameter logical axes
        "vocab": "model",
        "embed": data_axes,          # FSDP shard on the embed dim
        "ffn": tp,
        "q_heads": tp,
        "kv_heads": tp,
        "experts": "model",          # EP stays even under seq_parallel
        "lora": None,
        "heads": tp,
        "head_dim": None,
        "conv": None,
        "layers": None,
        # activation logical axes
        "act_batch": data_axes,
        "act_seq": "model" if seqp else ("data" if seq_shard else None),
        "act_embed": None,
    }
    return rules


def _canon(m):
    """A spec entry as ``PartitionSpec`` keeps it: one axis in a tuple is
    that axis."""
    if isinstance(m, (tuple, list)):
        return m[0] if len(m) == 1 else tuple(m)
    return m


def spec_for(logical: Sequence[str] | None,
             rules: Mapping[str, object]) -> tuple:
    """The per-dim mesh axes of ``logical`` (the reference's
    ``PartitionSpec``, as a tuple)."""
    if logical is None:
        return ()
    return tuple(_canon(rules.get(ax, None)) for ax in logical)


def _axes(m) -> tuple[str, ...]:
    return (m,) if isinstance(m, str) else tuple(m)


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement over ``mesh``: ``spec`` gives, per tensor dim,
    the mesh axis (a name), axes (a tuple of names, the major one first)
    or ``None`` (the reference's ``NamedSharding(mesh, P(*spec))``; as
    ``P`` does, one axis in a tuple is kept as the name)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(d)`` where the
        spec puts that mesh axis on tensor dim ``d``, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, m in enumerate(self.spec)
                    if m is not None and name in _axes(m)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def sharded_dims(self) -> list[tuple[int, int]]:
        """``(mesh dim, tensor dim)`` for each mesh dim that shards,
        in mesh order (the order shards nest in)."""
        names = list(self.mesh.mesh_dim_names)
        out = []
        for d, m in enumerate(self.spec):
            if m is None:
                continue
            idx = [names.index(a) for a in _axes(m)]
            if idx != sorted(idx):
                raise ValueError(f"spec {self.spec}: axes {m} out of the "
                                 f"mesh's order {names}")
            out += [(i, d) for i in idx]
        return sorted(out)


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in s)


def _map_specs(fn, spec_tree, tree):
    """``fn(spec, leaf)`` over a specs tree (spec tuples are its leaves)
    and the params tree beside it."""
    if _is_spec(spec_tree):
        return fn(spec_tree, tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v, tree[k]) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map_specs(fn, s, t)
                               for s, t in zip(spec_tree, tree))
    raise TypeError(f"not a specs tree node: {spec_tree!r}")


def _leaf_spec(shape, spec, rules, mesh) -> tuple:
    """The reference's choice for one leaf: a mesh axis at most once per
    leaf (earlier logical dims win, e.g. experts over ffn); a dim its
    axes' extent does not divide, or smaller than it, replicated."""
    sizes = _mesh_sizes(mesh)
    parts: list = []
    used: set[str] = set()
    for dim, ax in zip(shape, spec):
        m = rules.get(ax, None)
        if m is None:
            parts.append(None)
            continue
        axes = _axes(m)
        if used & set(axes):
            parts.append(None)
            continue
        extent = 1
        for a in axes:
            extent *= sizes[a]
        if extent > 0 and dim % extent == 0 and dim >= extent:
            parts.append(_canon(m))
            used |= set(axes)
        else:
            parts.append(None)
    return tuple(parts)


def tree_sharding(params_or_shapes, spec_tree, rules, mesh):
    """A :class:`NamedSharding` per leaf of a params tree (tensors, fake
    or ``meta`` tensors: only shapes are read)."""
    return _map_specs(
        lambda spec, arr: NamedSharding(
            mesh, _leaf_spec(tuple(arr.shape), spec, rules, mesh)),
        spec_tree, params_or_shapes)


# --------------------------------------------------------------------------- #
# shards of full tensors, and full tensors of shards
# --------------------------------------------------------------------------- #
def _coordinate(mesh) -> list[int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return list(coord)


def local_shard(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` (a copy, so ``t`` can
    be freed)."""
    coord = _coordinate(sharding.mesh)
    out = t
    for i, d in sharding.sharded_dims():
        out = out.chunk(sharding.mesh.shape[i], dim=d)[coord[i]]
    return out.clone(memory_format=torch.contiguous_format)


def as_dtensor(local: torch.Tensor, sharding: NamedSharding):
    """``local`` (this rank's shard) as a DTensor; no communication."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def distribute_params(params, shardings):
    """A tree of full tensors (every rank holding the same values) as
    DTensors holding only this rank's shards: the counterpart of
    ``jax.device_put(params, shardings)``.  A params tree carried across
    from the reference (``models.weights.params_from_jax``) comes in
    here."""
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t, sh: as_dtensor(local_shard(t, sh), sh),
                    params, shardings)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def sharding_of(t) -> NamedSharding:
    """The :class:`NamedSharding` of a DTensor (from its placements)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    spec: list = [None] * t.ndim
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            cur = spec[p.dim]
            spec[p.dim] = name if cur is None else _axes(cur) + (name,)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} is neither Shard nor "
                             f"Replicate")
    return NamedSharding(mesh, tuple(spec))


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along dim 0."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's part of dim 0."""
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),
                       *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (in place; returned)."""
    dist.all_reduce(x, group=group)
    return x


def _along(t: torch.Tensor, d: int, fn) -> torch.Tensor:
    """``fn`` (a collective along dim 0) applied along dim ``d``."""
    moved = t.movedim(d, 0).contiguous()
    return fn(moved).movedim(0, d).contiguous()


def gather_full(local: torch.Tensor, sharding: NamedSharding,
                ) -> torch.Tensor:
    """The full tensor of this rank's shard ``local``: an all-gather over
    each sharding mesh dim, innermost first."""
    mesh = sharding.mesh
    out = local
    for i, d in reversed(sharding.sharded_dims()):
        group = mesh.get_group(i)
        out = _along(out, d, lambda x, g=group: all_gather(x, g))
    return out


def reduce_to_shard(full: torch.Tensor, sharding: NamedSharding,
                    sum_dims: Sequence[int]) -> torch.Tensor:
    """This rank's shard of a full tensor that each rank holds a part of
    (its gradient from its rows of the batch): summed over the mesh dims
    ``sum_dims`` (a reduce-scatter where the tensor is sharded there, an
    all-reduce where it is replicated), sliced over the others."""
    mesh = sharding.mesh
    coord = _coordinate(mesh)
    shard_of = dict(sharding.sharded_dims())
    out = full
    for i in range(mesh.ndim):
        d = shard_of.get(i)
        if i in sum_dims:
            group = mesh.get_group(i)
            if d is None:
                out = all_reduce(out.contiguous(), group)
            else:
                out = _along(out, d,
                             lambda x, g=group: reduce_scatter(x, g))
        elif d is not None:
            out = out.chunk(mesh.shape[i], dim=d)[coord[i]]
    return out.contiguous()


class _Gather(torch.autograd.Function):
    """Forward: the full tensor of a shard.  Backward: the gradient summed
    over the batch mesh dims and cut to the shard."""

    @staticmethod
    def forward(ctx, local, sharding, sum_dims):
        ctx.sharding, ctx.sum_dims = sharding, sum_dims
        return gather_full(local, sharding)

    @staticmethod
    def backward(ctx, grad):
        return reduce_to_shard(grad, ctx.sharding, ctx.sum_dims), None, None


def gather_params(locals_, shardings, sum_dims: Sequence[int]):
    """Full weights from each leaf's shard, differentiable in the shards
    (see :class:`_Gather`); ``locals_`` and ``shardings`` are lists."""
    return [_Gather.apply(t, sh, tuple(sum_dims))
            for t, sh in zip(locals_, shardings)]


# --------------------------------------------------------------------------- #
# the batch split over the data axes
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """A batch's rows split over the mesh dims ``dims`` (the rules'
    ``act_batch`` axes): ``n`` parts, this rank's is part ``index``
    (rank order: the first axis major)."""
    mesh: Any
    dims: tuple[int, ...]
    n: int
    index: int

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor (dim 0)."""
        if x.shape[0] % self.n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {self.n} data shards")
        return x.chunk(self.n, dim=0)[self.index]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(n, *t.shape)``: every part's ``t``, in part order."""
        out = t[None]
        for i in reversed(self.dims):
            out = all_gather(out.contiguous(),
                                       self.mesh.get_group(i))
            out = out.reshape(-1, *t.shape)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the parts."""
        for i in self.dims:
            t = all_reduce(t.contiguous(), self.mesh.get_group(i))
        return t


def batch_split_for(mesh, rules: Mapping[str, object],
                    global_batch: int | None = None) -> BatchSplit:
    """The split of a batch over ``rules["act_batch"]``'s mesh axes.  A
    batch that the axes' extent does not divide stays whole (``n`` 1),
    as ``tree_sharding`` replicates such a dim."""
    names = list(mesh.mesh_dim_names)
    m = rules.get("act_batch")
    dims = tuple(names.index(a) for a in _axes(m)) if m else ()
    n = 1
    for i in dims:
        n *= mesh.shape[i]
    if global_batch is not None and (global_batch % n or global_batch < n):
        return BatchSplit(mesh, (), 1, 0)
    coord = _coordinate(mesh)
    index = 0
    for i in dims:
        index = index * mesh.shape[i] + coord[i]
    return BatchSplit(mesh, dims, n, index)


# The batch split is the process's, not a thread's: on CUDA the autograd
# engine runs the backward, and with it remat's recomputed forward, on a
# thread of its own, which must see the split its forward saw.
_split: list[BatchSplit | None] = [None]


@contextlib.contextmanager
def batch_split(split: BatchSplit):
    """Mark the activations computed inside as this rank's rows of a batch
    split by ``split``: functions of the whole batch (the MoE's capacity,
    slot order and load-balance loss) then combine the parts.  Enclose
    the backward too (remat recomputes the forward there)."""
    prev = _split[0]
    _split[0] = split if split.n > 1 else None
    try:
        yield
    finally:
        _split[0] = prev


def current_split() -> BatchSplit | None:
    """The batch split of the activations being computed, or ``None``."""
    return _split[0]


# --------------------------------------------------------------------------- #
# activation constraint context
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def mesh_context(mesh, rules: Mapping[str, object]):
    _ctx.mesh = mesh
    _ctx.rules = rules
    try:
        yield
    finally:
        _ctx.mesh = None
        _ctx.rules = None


def current_mesh():
    """``(mesh, rules)`` of the active :func:`mesh_context`, or
    ``(None, None)``."""
    return getattr(_ctx, "mesh", None), getattr(_ctx, "rules", None)


_ACT_SPECS = {
    # (batch, seq, embed)
    "btd": ("act_batch", "act_seq", "act_embed"),
    # (batch, seq, heads, head_dim)
    "bthd": ("act_batch", "act_seq", "heads", None),
    # MoE expert buffers: (experts, capacity, embed); left unconstrained,
    # as the reference leaves them
    "ecd": (None, None, None),
}


def replicate(x):
    """Constrain to fully-replicated: a DTensor inside a mesh context is
    redistributed to ``Replicate()`` on every mesh dim; anything else is
    returned as it is (a plain tensor is already whole on its rank)."""
    mesh = getattr(_ctx, "mesh", None)
    if mesh is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def shard_activation(x, kind: str):
    """Constrain an activation of logical layout ``kind`` (``"btd"``,
    ``"bthd"``, ``"ecd"``) to the rules' placements: a DTensor inside a
    mesh context is redistributed; a spec of all ``None`` leaves ``x`` as
    it is (it would force replication); outside a context, or on a plain
    tensor (a rank's own rows), the identity."""
    mesh = getattr(_ctx, "mesh", None)
    rules = getattr(_ctx, "rules", None)
    if mesh is None or rules is None:
        return x
    logical = _ACT_SPECS.get(kind)
    if logical is None or len(logical) != x.ndim:
        return x
    sizes = _mesh_sizes(mesh)
    parts = []
    for dim, ax in zip(x.shape, logical):
        m = rules.get(ax, None) if ax else None
        if m is None:
            parts.append(None)
            continue
        extent = 1
        for a in _axes(m):
            extent *= sizes[a]
        parts.append(_canon(m) if dim % extent == 0 and dim >= extent
                     else None)
    if all(p is None for p in parts) or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          NamedSharding(x.device_mesh,
                                        tuple(parts)).placements)
