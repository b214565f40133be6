"""``verify_plan`` — the one static pre-flight every consumer calls.

Orchestrates the invariant checkers in :mod:`repro_torch.analysis.invariants`
over a plan (or raw ``(spec, path, order)`` plus axes) and returns a
:class:`~repro_torch.analysis.diagnostics.PlanReport`.  Wired as the
pre-flight of ``execute_plan``; callers who want the verdict without
running anything call it directly.
"""
from __future__ import annotations

from collections.abc import Mapping

from repro_torch.analysis import invariants as inv
from repro_torch.analysis.diagnostics import Diagnostic, PlanReport

_UNSET = object()


def verify_plan(plan_or_spec, path=None, order=None, *,
                backend=_UNSET, fused=_UNSET, block=_UNSET,
                slice_mode=_UNSET, slice_chunks=_UNSET, mesh=_UNSET,
                dtypes: Mapping[str, str] | None = None,
                device_kind: str | None = None) -> PlanReport:
    """Statically verify a loop-nest schedule against every invariant the
    engines enforce, before anything compiles or runs.

    Two call shapes:

    * ``verify_plan(plan)`` — an :class:`~repro_torch.core.planner.SpTTNPlan`;
      the plan's own axes (backend/fused/block/slice/mesh) are checked.
      Keyword arguments override individual axes.
    * ``verify_plan(spec, path, order, backend=..., ...)`` — raw
      schedule pieces, e.g. a tuner candidate before it exists as a plan.

    ``dtypes`` (name -> dtype string) enables the crossing-buffer
    promotion analysis.  ``device_kind`` (``"gpu"`` or ``"cpu"``) enables
    the backend/device-kind mismatch warning (SPTTN-W005) — omitted by
    default because running the CUDA engines on CPU tensors is how the
    tests hold them to the reference, not a defect.

    Returns a :class:`PlanReport`; ``report.ok`` is True iff no
    error-severity diagnostic fired — exactly the plans the engines
    accept.  Warnings (W-codes) never block execution.

    >>> from repro_torch.core import spec as S
    >>> from repro_torch.core.planner import plan
    >>> p = plan(S.mttkrp(8, 6, 5, 4))
    >>> verify_plan(p).ok
    True
    >>> import dataclasses
    >>> bad = dataclasses.replace(p, slice_mode="i", slice_chunks=4)
    >>> verify_plan(bad).codes
    ('SPTTN-E031',)
    """
    if path is None and hasattr(plan_or_spec, "spec"):
        plan = plan_or_spec
        spec, path, order = plan.spec, plan.path, plan.order
        if backend is _UNSET:
            backend = plan.backend
        if fused is _UNSET:
            fused = getattr(plan, "fused", False)
        if block is _UNSET:
            block = getattr(plan, "block", None)
        if slice_mode is _UNSET:
            slice_mode = getattr(plan, "slice_mode", None)
        if slice_chunks is _UNSET:
            slice_chunks = getattr(plan, "slice_chunks", 1)
        if mesh is _UNSET:
            mesh = getattr(plan, "mesh", None)
    else:
        spec = plan_or_spec
        if path is None or order is None:
            raise TypeError("verify_plan needs an SpTTNPlan or "
                            "(spec, path, order)")
        backend = "torch" if backend is _UNSET else backend
        fused = False if fused is _UNSET else fused
        block = None if block is _UNSET else block
        slice_mode = None if slice_mode is _UNSET else slice_mode
        slice_chunks = 1 if slice_chunks is _UNSET else slice_chunks
        mesh = None if mesh is _UNSET else mesh

    diags: list[Diagnostic] = []
    diags += inv.check_backend(backend)
    diags += inv.check_lowering(backend)
    diags += inv.check_device_kind(backend, device_kind)
    diags += inv.check_path_output(spec, path)
    diags += inv.check_order(spec, path, order)
    if fused:
        diags += inv.chain_diagnostics(spec, path)
    diags += inv.check_block(block)
    diags += inv.check_slice(spec, slice_mode, slice_chunks)
    diags += inv.check_mesh(mesh)
    diags += inv.dtype_diagnostics(spec, path, dtypes)
    return PlanReport(diagnostics=tuple(diags))
