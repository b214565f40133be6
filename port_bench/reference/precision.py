"""The precisions a reference runs in: float64 to judge, and the
control's TF32 (float32 with TF32 off is what the configurations state,
so TF32 is the nearest precision below)."""
from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), as the
    tensor cores round a float32 operand, kept in float32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of the reference: float64, or float32 rounded to TF32."""
    if precision == "float64":
        return x.to(torch.float64)
    if precision == "tf32":
        return tf32(x)
    raise ValueError(f"unknown precision {precision!r}")


def accumulator(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32
