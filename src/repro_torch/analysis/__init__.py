"""Static plan verification: loop-nest legality as a checkable property.

The paper's invariants (storage-prefix rule, strictly-descending fused
chains, block divisibility, slice-mode kind, dtype promotion, mesh
shape) re-derived symbolically into one pass — :func:`verify_plan` —
that ``execute_plan`` consults *before* any kernel is built.  The codes
are the JAX package's, so one plan gets the same verdict from both.
"""
from repro_torch.analysis.diagnostics import (DIAGNOSTIC_CODES, Diagnostic,
                                              PlanReport,
                                              PlanVerificationError, diag)
from repro_torch.analysis.invariants import (BACKENDS, chain_diagnostics,
                                             check_backend, check_block,
                                             check_block_grid, check_mesh,
                                             check_order, check_path_output,
                                             check_slice, dtype_diagnostics,
                                             fusible_chains)
from repro_torch.analysis.verify import verify_plan

__all__ = [
    "BACKENDS",
    "DIAGNOSTIC_CODES",
    "Diagnostic",
    "PlanReport",
    "PlanVerificationError",
    "chain_diagnostics",
    "check_backend",
    "check_block",
    "check_block_grid",
    "check_mesh",
    "check_order",
    "check_path_output",
    "check_slice",
    "diag",
    "dtype_diagnostics",
    "fusible_chains",
    "verify_plan",
]
