"""K10, the RWKV6 (Finch) WKV recurrence, on the H100.

:func:`wkv6_kernel` replaces ``src/repro/kernels/wkv6.py:44``
``wkv6_pallas`` on ``r/k/v/w (BH, T, K)`` and ``u (BH, K)``: per head
``o_t = r_t (S + diag(u) k_t v_tᵀ)``, then
``S <- diag(exp(-exp(w_t))) S + k_t v_tᵀ`` from ``S = 0``, with a float32
state.  The CUDA kernel (``csrc/lm_kernels.cu``) gives each head one
thread block that walks ``T`` in order: up to ``K = 128``, thread ``j``
keeps column ``j`` of ``S`` in registers, and the block stages chunks of
steps in shared memory.  A wider head's state columns would spill, so
above 128 its value columns are split over ``ceil(K / kc)`` thread
blocks, each keeping its ``kc`` columns of ``S`` in shared memory (the
CUDA launcher picks ``kc`` and the staged steps that fit; neither
changes the order of a sum).  Bound by bytes and by the serial walk; no
chunk size constrains ``T``.

On CPU tensors the wrapper runs the plain version
(:func:`~repro_torch.kernels.ref.wkv6_ref`, stepping through time); on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native, ref

#: Heads up to this width keep their state columns in registers.
REGISTER_K = 128


def wkv6_plain(r, k, v, w, u) -> torch.Tensor:
    """Plain version of K10: the time-stepped float32 recurrence."""
    return ref.wkv6_ref(r, k, v, w, u)


def fits_a_thread_block(K: int) -> bool:
    """Whether a head of ``K`` channels fits K10: up to
    :data:`REGISTER_K` in registers; above, at least 32 state columns of
    ``K`` floats beside one staged step (``r``, ``k`` and the decay over
    ``K`` channels, ``u`` and one bonus sum) in a thread block's shared
    memory, the least ``launch_wkv6_wide`` in the CUDA source asks for."""
    return K <= REGISTER_K or 4 * (36 * K + 1) <= native.MAX_SHARED_BYTES


def wkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """K10: r/k/v/w ``(BH, T, K)``, u ``(BH, K)`` -> ``(BH, T, K)``."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u)
    native.check_cuda_tensors(r, k, v, w, u, dtype=r.dtype)
    native.check_dtype("wkv6", r.dtype)
    if r.dim() != 3 or any(t.shape != r.shape for t in (k, v, w)) \
            or u.shape != (r.shape[0], r.shape[2]):
        raise ValueError("wkv6: r/k/v/w (BH, T, K) and u (BH, K)")
    BH, T, K = r.shape
    if T >= 2**31:
        raise ValueError(f"wkv6: T = {T} exceeds the kernel's int steps")
    if not fits_a_thread_block(K):
        raise ValueError(f"wkv6: 32 state columns of a head of K = {K} "
                         f"channels exceed the shared memory of a thread "
                         f"block ({native.MAX_SHARED_BYTES} bytes)")
    out = torch.empty_like(r)
    native.check_grid(BH, 1)
    if BH * T * K:
        native.launch("wkv6", r.dtype, r.device, r, k, v, w, u, BH, T, K,
                      out)
    return out
