"""TTMc of an order-4 tensor ``ijkl,jr,ks,lt->irst``:
2 (nnz T + nnz^(IJK) S T + nnz^(IJ) R S T) operations."""
from port_bench.roofline import VALUE_BYTES, csf_bytes


def count(shape, ranks, levels):
    i, j, k, l_ = shape
    r, s, t = ranks["r"], ranks["s"], ranks["t"]
    nbytes = csf_bytes(levels) + VALUE_BYTES * (
        j * r + k * s + l_ * t + i * r * s * t)
    ops = 2 * (levels[4] * t + levels[3] * s * t + levels[2] * r * s * t)
    return {"bytes": nbytes, "ops": ops}
