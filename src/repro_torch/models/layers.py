"""Functional layer library (the JAX package's ``models/layers.py``): every
init returns (params, logical-axis specs).

Params are plain trees (nested dicts and lists of tensors) with the
reference's keys.  Inits draw from an explicit ``torch.Generator`` on the
device the parameters live on, in float32, then cast to ``dtype``, as the
reference draws with ``jax.random`` (the draws differ; the distributions
and shapes are the reference's).  The parallel ``specs`` tree holds tuples
of logical axis names per tensor.  Norms, RoPE and softmax logits compute
in float32, as the reference's do.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# trees
# --------------------------------------------------------------------------- #
def tree_map(fn, tree, *rest):
    """``jax.tree.map`` over nested dicts, lists, tuples and NamedTuples;
    ``None`` is an empty subtree, anything else a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list[Any] = []
    tree_map(out.append, tree)
    return out


def gaussian(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """``N(0, scale^2)`` draws in float32 on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


# --------------------------------------------------------------------------- #
# dense, embed, norms
# --------------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, d_in: int, d_out: int, in_axis: str,
               out_axis: str, dtype, bias: bool = False,
               scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": gaussian(gen, (d_in, d_out), scale).to(dtype)}
    s = {"w": (in_axis, out_axis)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
        s["b"] = (out_axis,)
    return p, s


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return ({"w": gaussian(gen, (vocab, d), 0.02).to(dtype)},
            {"w": ("vocab", "embed")})


def embed_lookup(p, ids):
    """The rows of ``p["w"]`` at ``ids``.  ``F.embedding`` gathers what
    ``p["w"][ids]`` does; its backward sums each row's duplicates in
    partial segments, where indexing's backward walks a row's duplicates
    one after another (a zipf token stream repeats a few ids thousands
    of times)."""
    return F.embedding(ids, p["w"])


def norm_init(kind: str, d: int, dtype, device=None):
    if kind == "nonparam_ln":       # OLMo: no learned affine
        return {}, {}
    return ({"scale": torch.ones((d,), dtype=dtype, device=device)},
            {"scale": ("embed",)})


def apply_norm(kind: str, p, x, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    elif kind in ("layernorm", "nonparam_ln"):
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    if p and kind != "nonparam_ln":
        y = y * p["scale"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary embeddings
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: (..., T)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)     # (D/2,)
    ang = positions[..., :, None].float() * freqs       # (..., T, D/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., T, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #
def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, kind: str, d: int, d_ff: int, dtype):
    p, s = {}, {}
    if kind in ("swiglu", "geglu"):
        p["gate"], s["gate"] = dense_init(gen, d, d_ff, "embed", "ffn", dtype)
    p["up"], s["up"] = dense_init(gen, d, d_ff, "embed", "ffn", dtype)
    p["down"], s["down"] = dense_init(gen, d_ff, d, "ffn", "embed", dtype)
    return p, s


def mlp_apply(kind: str, p, x):
    if kind == "swiglu":
        return dense(p["down"], F.silu(dense(p["gate"], x))
                     * dense(p["up"], x))
    if kind == "geglu":
        return dense(p["down"], gelu(dense(p["gate"], x))
                     * dense(p["up"], x))
    return dense(p["down"], gelu(dense(p["up"], x)))


# --------------------------------------------------------------------------- #
# spec/tree utilities
# --------------------------------------------------------------------------- #
def stack_params(plist):
    """Stack per-layer param trees along a new leading 'layers' axis."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *plist)


def stack_specs(spec):
    """Prepend the 'layers' logical axis to every spec tuple."""
    if isinstance(spec, dict):
        return {k: stack_specs(v) for k, v in spec.items()}
    return ("layers",) + tuple(spec)


def abstract_init(init_fn, *args, **kwargs):
    """Run an init under ``FakeTensorMode`` so dry-runs never allocate
    real parameters (the reference's ``jax.eval_shape``): its tensors
    come back fake, with shapes, dtypes and devices but no storage.  The
    generator draws (``torch.randn(..., generator=...)``) trace like any
    other op; a ``meta`` device would refuse a CPU generator.  Inside an
    active ``FakeTensorMode`` the init runs in that mode."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    if detect_fake_mode() is not None:
        return init_fn(*args, **kwargs)
    with FakeTensorMode():
        return init_fn(*args, **kwargs)
