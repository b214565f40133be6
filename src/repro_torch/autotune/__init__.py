"""Autotuning runtime with a persistent plan cache.

Entry points:
  * :func:`tune` — model-pruned enumeration + measurement on the card;
    the engine behind ``plan(spec, autotune=True, cache_dir=...)``.
  * :class:`PlanCache` / :func:`cache_key` — disk persistence keyed by
    (spec signature, CSF nnz-level profile, device kind), the JAX
    package's key layout (``CACHE_VERSION`` 7).
"""
from repro_torch.autotune.cache import (CACHE_VERSION, PlanCache,
                                        bucket_nnz_levels,
                                        bucketed_cache_key, cache_key,
                                        device_kind, spec_signature)
from repro_torch.autotune.candidates import (Candidate, default_nnz_levels,
                                             generate_candidates)
from repro_torch.autotune.measure import (MeasureConfig, Measurement,
                                          measure_candidates, synth_factors,
                                          synth_inputs)
from repro_torch.autotune.tuner import (SearchStats, TunerConfig,
                                        default_backends, tune)

__all__ = [
    "CACHE_VERSION", "PlanCache", "bucket_nnz_levels", "bucketed_cache_key",
    "cache_key", "device_kind", "spec_signature", "Candidate",
    "default_nnz_levels", "generate_candidates", "MeasureConfig",
    "Measurement", "measure_candidates", "synth_factors", "synth_inputs",
    "SearchStats", "TunerConfig", "default_backends", "tune",
]
