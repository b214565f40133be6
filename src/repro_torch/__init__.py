"""PyTorch/CUDA port of the SpTTN reproduction (the ``repro`` package).

The same pipeline as the JAX package — spec, loop-nest planning, CSF
layouts, generated stage kernels — with the stage kernels written by
hand in CUDA for the H100 (``csrc/``)::

    from repro_torch import mttkrp, build_csf, random_sparse, plan, execute_plan

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Exports resolve lazily (PEP 562), so
``import repro_torch`` imports neither torch nor any submodule until an
attribute is used.  The package never imports JAX or ``repro``.
"""
from __future__ import annotations

import importlib

__version__ = "0.1.0"

# name -> defining module (the single source of truth for __all__)
_EXPORTS = {
    "SpTTNSpec": "repro_torch.core.spec",
    "parse": "repro_torch.core.spec",
    "mttkrp": "repro_torch.core.spec",
    "ttmc3": "repro_torch.core.spec",
    "ttmc4": "repro_torch.core.spec",
    "tttp3": "repro_torch.core.spec",
    "sddmm": "repro_torch.core.spec",
    "tttc6": "repro_torch.core.spec",
    "COOTensor": "repro_torch.sparse",
    "CSFTensor": "repro_torch.sparse",
    "random_sparse": "repro_torch.sparse",
    "from_dense": "repro_torch.sparse",
    "build_csf": "repro_torch.sparse",
    "build_csf_batch": "repro_torch.sparse",
    "plan": "repro_torch.core.planner",
    "cached_plan": "repro_torch.core.planner",
    "SpTTNPlan": "repro_torch.core.planner",
    "make_executor": "repro_torch.core.executor",
    "execute_plan": "repro_torch.core.executor",
    "CSFArrays": "repro_torch.core.executor",
    "factors_to_torch": "repro_torch.core.executor",
    "dense_oracle": "repro_torch.core.executor",
    "reference_execute": "repro_torch.core.executor",
    "plan_to_json": "repro_torch.core.executor",
    "plan_from_json": "repro_torch.core.executor",
    "plan_peak_bytes": "repro_torch.core.slicing",
    "choose_slicing": "repro_torch.core.slicing",
    "sliced_execute": "repro_torch.core.slicing",
    "SliceDecision": "repro_torch.core.slicing",
    "MemoryBudgetError": "repro_torch.core.slicing",
    "tune": "repro_torch.autotune.tuner",
    "TunerConfig": "repro_torch.autotune.tuner",
    "SearchStats": "repro_torch.autotune.tuner",
    "PlanCache": "repro_torch.autotune.cache",
    "BACKENDS": "repro_torch.analysis.diagnostics",
    "verify_plan": "repro_torch.analysis",
    "Diagnostic": "repro_torch.analysis",
    "PlanReport": "repro_torch.analysis",
    "PlanVerificationError": "repro_torch.analysis",
    "PlanService": "repro_torch.serve.serve_step",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value          # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
