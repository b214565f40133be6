"""The LM model stack (the JAX package's ``repro.models``): functional
layers over plain param trees with the reference's keys, run eagerly on
the params' device.  ``params_from_jax`` carries the reference's params
and caches across."""
from repro_torch.models import (attention, layers, moe, recurrent,
                                transformer, weights)
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            loss_fn, model_init, prefill)
from repro_torch.models.weights import params_from_jax

__all__ = ["attention", "layers", "moe", "recurrent", "transformer",
           "weights", "decode_step", "forward", "init_cache", "loss_fn",
           "model_init", "prefill", "params_from_jax"]
