"""Mixture-of-Experts layer with SpTTN-planned dispatch (the JAX package's
``models/moe.py``; DESIGN.md §4).

The routing tensor D(t, e, c) (token t -> expert e at capacity slot c) is a
sparse tensor with nnz = top_k * n_tokens, and MoE dispatch/combine are
SpTTN kernels:

    dispatch:  Xe(e,c,d) = sum_t  D(t,e,c) * X(t,d)
    combine:   Y(t,m)    = sum_ec D(t,e,c) * Ye(e,c,m)

``choose_dispatch`` builds the dispatch spec and runs the paper's planner
(the port's ``core.spec``/``core.paths``/``core.cost``): the
"unfactorized" schedule is the dense one-hot einsum (O(N*E*C*D)); the
factorize-and-fuse schedule iterates the nnz only — the sort-based
capacity dispatch + grouped GEMM below (O(N*k*D)).

Every scatter here has a fixed result whatever order a device applies it
in: a dispatch slot has one writer (the overflow row ``E*C`` is thrown
away), the combine sums each token's ``top_k`` contributions along an
axis instead of scatter-adding them, and expert loads are integer counts.
So has the backward: the dispatch's token rows are an expand (its
backward sums over ``top_k``), and the combine's gather is
``F.embedding`` with the overflow row as its padding index (each other
row is read once).  ``top_k`` breaks ties by the lower expert index, as
``jax.lax.top_k`` does.

Capacity, slot order and the load-balance loss are functions of the
whole batch.  Under a batch split (``distributed.sharding.batch_split``:
each rank holds some rows) the capacity comes from the whole batch's
token count; an all-gather of each part's per-expert counts gives the
part's slot offsets (an exclusive prefix over the parts: a token keeps
its slot exactly when it keeps it on one device), and an all-reduce the
whole batch's top-1 counts.  The expert FFN stays local, over the part's
own slots (at most its token count an expert).  A part's aux loss uses
its own mean router probabilities, so the mean of the parts' losses is
the whole batch's.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed.sharding import current_split, shard_activation
from repro_torch.models import layers as L


@functools.lru_cache(maxsize=64)
def choose_dispatch(n_tokens: int, n_experts: int, top_k: int,
                    capacity: int, d_model: int) -> str:
    """Consult the SpTTN planner for the dispatch schedule ('grouped' or
    'onehot').  Cached per kernel signature (pattern-static, as in §5)."""
    from repro_torch.core.cost import path_flops
    from repro_torch.core.paths import min_depth_paths
    from repro_torch.core.spec import parse

    spec = parse("tec,td->ecd",
                 dims={"t": n_tokens, "e": n_experts, "c": capacity,
                       "d": d_model}, sparse=0, names=["D", "X"])
    nnz = {0: 1, 1: n_tokens, 2: n_tokens * top_k, 3: n_tokens * top_k}
    sparse_flops = min(path_flops(p, spec.dims, spec.sparse_indices, nnz)
                       for p in min_depth_paths(spec))
    dense_flops = 2.0 * n_tokens * n_experts * capacity * d_model
    return "grouped" if sparse_flops < dense_flops else "onehot"


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    p, s = {}, {}
    p["router"], s["router"] = L.dense_init(gen, d, m.n_experts, "embed",
                                            "experts", dtype)

    def expert_w(din, dout):
        return L.gaussian(gen, (m.n_experts, din, dout),
                          1.0 / math.sqrt(din)).to(dtype)

    p["w_gate"] = expert_w(d, m.d_expert)
    s["w_gate"] = ("experts", "embed", "ffn")
    p["w_up"] = expert_w(d, m.d_expert)
    s["w_up"] = ("experts", "embed", "ffn")
    p["w_down"] = expert_w(m.d_expert, d)
    s["w_down"] = ("experts", "ffn", "embed")
    if m.n_shared:
        p["shared"], s["shared"] = L.mlp_init(
            gen, "swiglu", d, m.n_shared * m.d_shared, dtype)
    return p, s


def _capacity(m: MoEConfig, n_tokens: int) -> int:
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 (sublane aligned)


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _counts(ids, n: int):
    """How often each of ``0..n-1`` occurs in ``ids``: an integer
    scatter-add, exact in any order (``torch.bincount`` reads the maximum
    back to the host on CUDA)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def _route(p, m: MoEConfig, x2d):
    logits = L.dense(p["router"], x2d).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, m.top_k)                 # (N,k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    aux = _load_balance_loss(probs, idx, m.n_experts)
    return gate, idx, aux


def _load_balance_loss(probs, idx, E):
    """``E · Σ_e f_e · P_e``: ``f`` the fraction of the batch's tokens
    whose first choice is ``e``, ``P`` the mean router probability (of
    this part's tokens under a batch split)."""
    N = idx.shape[0]
    top1 = _counts(idx[:, 0], E)
    split = current_split()
    if split is not None:
        top1 = split.all_reduce(top1)
        N = N * split.n
    frac_tokens = top1.float() / N
    frac_probs = probs.mean(0)
    return E * torch.sum(frac_tokens * frac_probs)


def _expert_ffn(p, xe):
    """xe (E, C, D) -> (E, C, D) SwiGLU via grouped GEMMs."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def moe_apply(p, cfg: ModelConfig, x,
              deterministic_dispatch: str | None = None, train: bool = True):
    """x (B, T, D) -> (y, aux_loss).  Dispatch mode from the SpTTN planner
    unless overridden by cfg.moe.dispatch / deterministic_dispatch.

    ``train=False`` (inference) uses *dropless* capacity, C = N rounded up
    to 8: per-expert load is at most N (top-k expert ids are distinct per
    token), so prefill/decode stay consistent with a batched forward.
    """
    m: MoEConfig = cfg.moe
    B, T, D = x.shape
    N = B * T
    x2d = x.reshape(N, D)
    split = current_split()
    n_all = N * (split.n if split is not None else 1)  # the whole batch's
    C = _capacity(m, n_all) if train else max(8, -(-n_all // 8) * 8)
    mode = deterministic_dispatch or m.dispatch
    if mode == "auto":
        mode = choose_dispatch(n_all, m.n_experts, m.top_k, C, D)

    gate, idx, aux = _route(p, m, x2d)

    if mode == "onehot":
        y = _apply_onehot(p, m, x2d, gate, idx, C)
    else:
        y = _apply_grouped(p, m, x2d, gate, idx, C)

    if m.n_shared:
        y = y + L.mlp_apply("swiglu", p["shared"], x2d)
    return y.reshape(B, T, D), aux


def _part_capacity(C: int, n_tokens: int) -> int:
    """Slots an expert's buffer holds for this batch: all ``C`` of them,
    or under a batch split at most the part's ``n_tokens`` (a token
    takes an expert once), rounded up to 8."""
    if current_split() is None:
        return C
    return min(C, max(8, -(-n_tokens // 8) * 8))


def _apply_onehot(p, m: MoEConfig, x2d, gate, idx, C):
    """Unfactorized baseline: dense one-hot dispatch einsum (kept for
    planner validation + tests)."""
    N, D = x2d.shape
    # D(t,e,c): one-hot over experts x capacity slots.  Dispatch uses the
    # unweighted pattern; the gate weights enter at combine (after the
    # nonlinear expert FFN), matching the grouped schedule exactly.
    pos = _slot_positions(idx, m.n_experts, C)         # (N,k) slot or -1
    C = _part_capacity(C, N)
    disp = x2d.new_zeros((N, m.n_experts, C))
    dispw = x2d.new_zeros((N, m.n_experts, C))
    t = torch.arange(N, device=x2d.device)
    for j in range(m.top_k):
        # (t, e, c) is distinct across t and j (a token's experts differ)
        valid = pos[:, j] >= 0
        e = idx[:, j]
        c = pos[:, j].clamp(0, C - 1)
        disp.index_put_((t, e, c), valid.to(x2d.dtype), accumulate=True)
        dispw.index_put_((t, e, c), torch.where(
            valid, gate[:, j].to(x2d.dtype), 0.0), accumulate=True)
    xe = torch.einsum("tec,td->ecd", disp, x2d)
    ye = _expert_ffn(p, xe)
    return torch.einsum("tec,ecd->td", dispw, ye)


def _slot_positions(idx, E, C):
    """Capacity-slot index per (token, choice); -1 when over capacity.

    Sort-based ranking, O(Nk log Nk) time and O(Nk) memory — the CSF
    construction for the routing tensor: sorting the nnz of D(t,e,c) into
    (e, slot) storage order, per step since routing is dynamic.
    Under a batch split the slot is the part's own (its rank among the
    part's tokens), kept when the slot it takes in the whole batch —
    after those the batch's earlier parts take (their counts,
    all-gathered) — is under ``C``.
    """
    N, k = idx.shape
    flat = idx.reshape(-1)                              # (Nk,) expert ids
    Nk = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = _counts(flat, E)
    starts = torch.cumsum(counts, 0) - counts          # first slot per expert
    rank_sorted = torch.arange(Nk, device=idx.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted                           # a permutation
    split = current_split()
    slot = rank
    if split is not None:
        slot = rank + split.all_gather(counts)[:split.index].sum(0)[flat]
    pos = torch.where(slot < C, rank, -1)
    return pos.reshape(N, k)


def _apply_grouped(p, m: MoEConfig, x2d, gate, idx, C):
    """Factorize-and-fuse schedule from the SpTTN planner: iterate only the
    nnz of D (sorted by expert = CSF order on (e, c)) + grouped GEMM."""
    N, D = x2d.shape
    E, k = m.n_experts, idx.shape[1]
    pos = _slot_positions(idx, E, C)                    # (N,k)
    C = _part_capacity(C, N)
    expert = idx.reshape(-1)
    slot = pos.reshape(-1)
    w = gate.reshape(-1).to(x2d.dtype)
    valid = slot >= 0
    dst = expert * C + slot.clamp(0, C - 1)             # (N*k,) slot addr
    dst = torch.where(valid, dst, E * C)                # overflow -> dump row
    # dispatch: copy token rows (each repeated for its k choices: an
    # expand, whose backward sums over k) into (E*C (+1), D); a slot has
    # one writer, the dump row (any of its writers) is dropped
    rows = x2d[:, None].expand(N, k, D).reshape(N * k, D)
    xe = x2d.new_zeros((E * C + 1, D)).index_copy_(
        0, dst, rows * valid[:, None].to(x2d.dtype))
    xe3 = shard_activation(xe[:-1].reshape(E, C, D), "ecd")
    ye = shard_activation(_expert_ffn(p, xe3), "ecd").reshape(E * C, D)
    # combine: gather slots back per (token, choice), weight, sum over k;
    # the gather's backward adds nothing into the dump row (its padding
    # index) and sums any other row's one use
    ye_pad = torch.cat([ye, ye.new_zeros((1, D))], 0)
    contrib = F.embedding(dst, ye_pad, padding_idx=E * C) * (
        w * valid.to(x2d.dtype))[:, None]
    return contrib.reshape(N, k, D).sum(1)
