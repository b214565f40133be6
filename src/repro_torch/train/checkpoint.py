"""Sharded, atomic, resumable checkpointing (the JAX package's
``train/checkpoint.py``, in the same format on disk).

Layout:   <dir>/step_<N>/shard_<p>.npz  +  manifest.json
  * one npz per host process (the format is multi-host);
  * the manifest carries step, per-leaf shapes/dtypes and a content
    checksum, written LAST and atomically (tmp + rename) — a crashed
    writer can never produce a manifest pointing at partial data;
  * ``latest_step`` scans for the newest manifest so restart-after-failure
    is a single call;  ``restore`` validates shapes against the live tree.

The leaf keys are the reference's (``train.tree.key_paths``: params under
``0/...``, the AdamW moments under ``1/0/...`` and ``1/1/...``, the step
as ``1/2``), and so are the manifest's ``leaves`` and ``checksum`` for
the same state, so either package reads the other's files.  A bf16 leaf
is written as the reference writes it — its bits as a 2-byte void array
(``|V2``, what ``np.savez`` makes of ml_dtypes' bfloat16), ``"bfloat16"``
in the manifest — and restored by the manifest's dtype through its bits,
not a numeric cast.  (The reference's own ``restore`` cannot read such a
leaf: ``jnp.asarray`` refuses ``|V2``.)

A sharded state (DTensor leaves, ``distributed.sharding``) is saved as one
device saves it: every rank gathers each leaf (a collective), rank 0
writes the one shard file and a manifest with ``n_processes`` 1, and all
ranks meet at a barrier.  ``restore`` into a sharded tree reads that
file on every rank and keeps each leaf's shard.  So a sharded run resumes
from a one-device checkpoint and the other way round.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import (as_dtensor, gather_full,
                                              is_dtensor, local_shard,
                                              sharding_of)
from repro_torch.train.tree import key_paths, map_with_keys

_BF16 = "bfloat16"


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(host array as the npz holds it, dtype name for the manifest)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {a.dtype}")
        bits = np.asarray(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, order="C"))


def _head_bytes(a: np.ndarray) -> bytes:
    """The first 4096 bytes of ``a`` (the reference hashes
    ``tobytes()[:4096]``), without copying the rest."""
    flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return flat[:4096].tobytes()


def _n_processes() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def save(tree: Any, directory: str, step: int, process_index: int = 0,
         keep: int = 3) -> str:
    """Write shard + manifest atomically; prune old checkpoints."""
    stepdir = os.path.join(directory, f"step_{step:08d}")
    if any(is_dtensor(t) for _, t in key_paths(tree)):
        return _save_gathered(tree, directory, step, stepdir, keep)
    os.makedirs(stepdir, exist_ok=True)
    flat, dtypes = {}, {}
    for k, leaf in key_paths(tree):
        flat[k], dtypes[k] = _to_numpy(leaf)
    _write(flat, dtypes, stepdir, step, process_index, _n_processes())
    _prune(directory, keep)
    return stepdir


def _save_gathered(tree, directory: str, step: int, stepdir: str,
                   keep: int) -> str:
    """A sharded state written as one device writes it (rank 0)."""
    writer = torch.distributed.get_rank() == 0
    flat, dtypes = {}, {}
    for k, leaf in key_paths(tree):
        if is_dtensor(leaf):
            leaf = gather_full(leaf.to_local(), sharding_of(leaf))
        if writer:
            flat[k], dtypes[k] = _to_numpy(leaf)
    if writer:
        os.makedirs(stepdir, exist_ok=True)
        _write(flat, dtypes, stepdir, step, 0, 1)
        _prune(directory, keep)
    torch.distributed.barrier()
    return stepdir


def _write(flat: dict, dtypes: dict, stepdir: str, step: int,
           process_index: int, n_processes: int) -> None:
    shard_path = os.path.join(stepdir, f"shard_{process_index}.npz")
    with tempfile.NamedTemporaryFile(dir=stepdir, delete=False) as tf:
        np.savez(tf, **flat)
        tmp = tf.name
    os.replace(tmp, shard_path)

    checksum = hashlib.sha256()
    for k in sorted(flat):
        checksum.update(k.encode())
        checksum.update(_head_bytes(flat[k]))
    manifest = {
        "step": step,
        "n_processes": n_processes,
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in flat.items()},
        "checksum": checksum.hexdigest(),
    }
    mpath = os.path.join(stepdir, "manifest.json")
    with tempfile.NamedTemporaryFile("w", dir=stepdir, delete=False) as tf:
        json.dump(manifest, tf)
        tmp = tf.name
    os.replace(tmp, mpath)


def _prune(directory: str, keep: int):
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep]:
        stepdir = os.path.join(directory, f"step_{s:08d}")
        for f in os.listdir(stepdir):
            os.unlink(os.path.join(stepdir, f))
        os.rmdir(stepdir)


def latest_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            mpath = os.path.join(directory, name, "manifest.json")
            if os.path.exists(mpath):  # manifest last => complete
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = latest_steps(directory)
    return steps[-1] if steps else None


def restore(tree_like: Any, directory: str, step: int | None = None,
            process_index: int = 0) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (validating keys and
    shapes); each leaf comes back on its live leaf's device and dtype (a
    DTensor leaf as its shard, with its placements)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    stepdir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(stepdir, f"shard_{process_index}.npz"))
    for k, _ in key_paths(tree_like):
        if k not in data:
            raise KeyError(f"checkpoint missing leaf {k}")

    def leaf(k, live):
        a = data[k]
        if tuple(a.shape) != tuple(live.shape):
            raise ValueError(f"shape mismatch for {k}: ckpt {a.shape} vs "
                             f"live {tuple(live.shape)}")
        dtype = manifest["leaves"].get(k, {}).get("dtype", str(a.dtype))
        t = _from_numpy(a, dtype)
        if is_dtensor(live):
            sh = sharding_of(live)
            return as_dtensor(local_shard(t, sh).to(
                device=live.to_local().device, dtype=live.dtype), sh)
        return t.to(device=live.device, dtype=live.dtype)

    return map_with_keys(leaf, tree_like), manifest["step"]
