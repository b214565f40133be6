"""Structured diagnostics for the static plan verifier.

Every legality fact the engines used to discover one at a time — a bare
bool from ``fusible_chains``, a ``ValueError`` three frames inside a
Pallas lowering — is reported here as a :class:`Diagnostic` with a
stable code, so callers (the tuner, CI, a user staring at a rejected
plan) can react to *which* invariant failed rather than parsing message
text.

Codes are namespaced ``SPTTN-<severity letter><number>``:

* ``SPTTN-Exxx`` — **errors**: the plan violates an invariant some
  engine enforces; executing it would raise (or worse, compute garbage).
* ``SPTTN-Wxxx`` — **warnings**: the plan is legal everywhere but some
  axis looks unprofitable or risky (e.g. an estimated VMEM overflow on
  real hardware); execution proceeds.

The registry :data:`DIAGNOSTIC_CODES` is the single source of truth for
the code table in the JAX package's ``docs/analysis.md``; the codes are
shared with it, so one plan gets the same codes from both packages.
"""
from __future__ import annotations

import dataclasses

ERROR = "error"
WARNING = "warning"

#: The execution-engine vocabulary.  Lives here — the leaf module of the
#: whole package graph — so both the verifier and ``core.executor``'s
#: dispatch share one tuple without an import cycle.
#:
#: * ``"torch"`` — the eager PyTorch engine (the JAX package's ``"xla"``);
#: * ``"cuda"`` — the stage code generator lowered to the segment-loop
#:   Hopper kernels (the JAX package's ``"pallas"``, TPU target);
#: * ``"cuda-splitk"`` — the same IR lowered to split-K partials plus a
#:   segment combine (the JAX package's ``"pallas-gpu"``).
BACKENDS = ("reference", "torch", "cuda", "cuda-splitk")

#: The subset of :data:`BACKENDS` that lowers through the stage code
#: generator and therefore shares its engine kwargs (``block``,
#: ``strategy``, ``tile_align``), its fused/block plan axes, and its
#: stage-lowering registry.
CODEGEN_BACKENDS = ("cuda", "cuda-splitk")

#: backend -> stage-lowering target in the kernels/codegen registry
#: (``repro_torch.kernels.codegen.ir``).  A backend listed here with no
#: registered lowering on the current host is SPTTN-E041.
CODEGEN_TARGETS = {"cuda": "hopper", "cuda-splitk": "hopper-splitk"}

#: backend -> the device kind its kernels run on.  Naming the host's
#: kind to ``verify_plan(device_kind=...)`` turns a mismatch into
#: SPTTN-W005.
BACKEND_DEVICE_KINDS = {"cuda": "gpu", "cuda-splitk": "gpu"}

#: The JAX package's backend names -> this package's engines: a plan
#: document written by the reference replays on the counterpart engine.
REFERENCE_BACKENDS = {"reference": "reference", "xla": "torch",
                      "pallas": "cuda", "pallas-gpu": "cuda-splitk"}

#: code -> one-line summary.  Append-only: codes are stable identifiers
#: (CI batteries and user scripts match on them), so a retired invariant
#: keeps its number reserved rather than renumbering the rest.
DIAGNOSTIC_CODES: dict[str, str] = {
    "SPTTN-E001": "storage-prefix violation: sparse indices out of CSF "
                  "storage order in a term's loop order",
    "SPTTN-E002": "loop order is not a permutation of its term's indices",
    "SPTTN-E003": "loop order length does not match contraction path length",
    "SPTTN-E004": "path's final term does not produce the spec output",
    "SPTTN-E010": "fused requested but the path has no provably safe "
                  "reducing chain",
    "SPTTN-E011": "fused-chain levels not strictly descending along the "
                  "CSF path",
    "SPTTN-E012": "fused-chain link operand not a dense input",
    "SPTTN-E013": "fused-chain consumer is not the next path term",
    "SPTTN-E020": "block is not a positive integer",
    "SPTTN-E021": "block is not a multiple of the TPU sublane (8)",
    "SPTTN-E022": "padded operand length is not a multiple of the block "
                  "(tile grid would drop tail slots)",
    "SPTTN-E030": "slice mode not in spec dims",
    "SPTTN-E031": "slice mode is a sparse index (sparse modes shard, "
                  "never slice)",
    "SPTTN-E032": "slice chunk count out of range for the sliced dim",
    "SPTTN-E033": "slice chunks > 1 with no slice mode",
    "SPTTN-E040": "unknown backend",
    "SPTTN-E041": "backend has no registered stage lowering on this host "
                  "(plan replayed where its per-target lowering is "
                  "unavailable)",
    "SPTTN-E050": "mesh context malformed",
    "SPTTN-E051": "plan not stackable: a sparse-structured stage has no "
                  "same-level zero-on-pads operand",
    "SPTTN-E052": "same-sparsity output on a distributed path (needs the "
                  "stacked layout to reassemble leaf values)",
    "SPTTN-E060": "plan JSON version mismatch (re-plan, never guess)",
    # TPU VMEM estimate of the JAX package; reserved, never emitted here
    "SPTTN-W003": "estimated VMEM scratch exceeds budget estimate",
    "SPTTN-W004": "dtype promotion widens a crossing buffer",
    "SPTTN-W005": "plan backend compiles for a different device kind than "
                  "the current host (plain-version execution only)",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verdict of the static verifier.

    ``stage_ref`` localizes the finding — ``"term[2]"``, ``"order[0]"``,
    ``"plan.block"``, ``"chain[1..3]"`` — so a diagnostic can be mapped
    back onto the plan axis or path position that caused it without
    re-running the analysis.
    """

    code: str
    severity: str       # ERROR | WARNING
    stage_ref: str
    message: str
    fix_hint: str = ""

    def __post_init__(self) -> None:
        if self.code not in DIAGNOSTIC_CODES:
            raise ValueError(f"unregistered diagnostic code {self.code!r}")

    def __str__(self) -> str:
        s = f"{self.code} [{self.severity}] {self.stage_ref}: {self.message}"
        if self.fix_hint:
            s += f" (fix: {self.fix_hint})"
        return s


def diag(code: str, stage_ref: str, message: str,
         fix_hint: str = "") -> Diagnostic:
    """Build a :class:`Diagnostic`, deriving severity from the code letter
    (``SPTTN-E...`` -> error, ``SPTTN-W...`` -> warning)."""
    severity = ERROR if code.startswith("SPTTN-E") else WARNING
    return Diagnostic(code=code, severity=severity, stage_ref=stage_ref,
                      message=message, fix_hint=fix_hint)


class PlanVerificationError(ValueError):
    """Raised by :meth:`PlanReport.raise_if_error`; carries the report."""

    def __init__(self, message: str, report: "PlanReport"):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """The verifier's full verdict on one plan: every diagnostic found,
    in path order, errors and warnings interleaved where they occurred."""

    diagnostics: tuple[Diagnostic, ...] = ()

    @property
    def errors(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == ERROR)

    @property
    def warnings(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == WARNING)

    @property
    def codes(self) -> tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)

    @property
    def ok(self) -> bool:
        """True when no error-severity diagnostic was found (warnings do
        not block execution)."""
        return not self.errors

    def __bool__(self) -> bool:
        return self.ok

    def raise_if_error(self, who: str = "verify_plan") -> "PlanReport":
        """Raise :class:`PlanVerificationError` listing every error
        diagnostic; return ``self`` unchanged when the plan is legal."""
        errs = self.errors
        if errs:
            lines = "; ".join(str(d) for d in errs)
            raise PlanVerificationError(
                f"{who}: plan rejected by static verification — {lines}",
                self)
        return self
