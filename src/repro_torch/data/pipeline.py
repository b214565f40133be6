"""Deterministic, sharded, stateless-per-step data pipeline (the JAX
package's ``data/pipeline.py``).

Every (step, shard) pair maps to an independent PRNG stream, so:
  * restart-after-failure resumes mid-stream with zero replay state,
  * elastic re-sharding (``train/fault.py``) re-partitions the SAME global
    stream by changing only (n_shards, shard_id),
  * no inter-host coordination is ever needed (straggler-friendly).

The synthetic distribution is Zipf-like over the vocab with Markov
structure so losses are non-trivial.  The draws are numpy's, made exactly
as the reference makes them, so both packages get the same tokens; only
the last step differs: ``batch_at`` returns int32 tensors on ``device``
(``None``: the CUDA card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    per_shard_batch: int
    n_shards: int = 1
    shard_id: int = 0
    seed: int = 0
    device: str | torch.device | None = None

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for (step, shard)."""
        from repro_torch.core.executor import resolve_device
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_id]))
        B, S = self.per_shard_batch, self.seq_len
        # zipf-ish marginal + first-order markov dependence
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        tok = base % self.vocab
        shift = rng.integers(0, 17, size=(B, 1))
        tok[:, 1:] = (tok[:, 1:] + (tok[:, :-1] * 31 + shift) % 7) % self.vocab
        tokens = torch.from_numpy(tok.astype(np.int32)).to(
            resolve_device(self.device))
        return {"tokens": tokens, "labels": tokens}

    def reshard(self, n_shards: int, shard_id: int) -> "SyntheticLM":
        return dataclasses.replace(self, n_shards=n_shards,
                                   shard_id=shard_id)


def make_loader(vocab: int, seq_len: int, global_batch: int,
                n_shards: int = 1, shard_id: int = 0, seed: int = 0,
                device=None):
    per = max(1, global_batch // n_shards)
    ds = SyntheticLM(vocab=vocab, seq_len=seq_len, per_shard_batch=per,
                     n_shards=n_shards, shard_id=shard_id, seed=seed,
                     device=device)

    def it(start_step: int = 0):
        step = start_step
        while True:
            yield step, ds.batch_at(step)
            step += 1

    return ds, it
