"""Checkpoints of the port: its own round trips, and the format shared with
the reference.

* The reference's checkpoint tests (``tests/test_train_infra.py``) with
  the port's functions: round trip (float32 and bf16 params, bit for
  bit, dtypes and devices kept), prune and latest, an incomplete
  checkpoint ignored; ``restore`` refuses a missing leaf, a wrong shape
  and an empty directory.
* Interop: one training state (the reference's after one step, carried
  over by ``params_from_jax``) saved by both packages gives the same npz
  keys and arrays (a bf16 leaf as its bits in a 2-byte void array, as
  ``np.savez`` writes ml_dtypes' bfloat16), and the same manifest
  ``leaves`` and ``checksum``; a reference checkpoint with bf16 leaves
  restores in the port bit for bit; a port checkpoint of a float32 state
  restores in the reference.  The reference's own ``restore`` raises
  ``TypeError`` on a bf16 leaf (``jnp.asarray`` refuses ``|V2``): pinned
  here as its quirk, which the port does not copy.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.configs import make_batch as j_make_batch  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro_torch.configs import get_reduced, make_batch  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.models import model_init, params_from_jax  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import AdamWState  # noqa: E402
from repro_torch.train.train_step import (TrainState,  # noqa: E402
                                          init_train_state, make_train_step)
from repro_torch.train.tree import key_paths, map_with_keys  # noqa: E402

ARCH = "smollm-135m"


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _assert_same_state(a, b):
    ka, kb = key_paths(a), key_paths(b)
    assert [k for k, _ in ka] == [k for k, _ in kb]
    for (k, x), (_, y) in zip(ka, kb):
        assert _same_bits(x, y), k


def _port_state(dtype: str, steps: int = 2):
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    params, _ = model_init(cfg, 0, device="cpu")
    state = init_train_state(params)
    step = make_train_step(cfg, RunConfig(model=cfg, remat=False,
                                          warmup_steps=2))
    for i in range(steps):
        state, _ = step(state, make_batch(cfg, "train_4k", seed=i,
                                          batch_override=2, seq_override=8,
                                          device="cpu"))
    return state


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def states(request):
    """The reference's training state after one step, and the same state
    in the port."""
    jcfg = dataclasses.replace(j_get_reduced(ARCH), dtype=request.param)
    jrun = JRunConfig(model=jcfg, remat=False, warmup_steps=2)
    jb = j_make_batch(jcfg, "train_4k", batch_override=2, seq_override=8)

    def ref(key):
        state = JS.init_train_state(JT.model_init(key, jcfg)[0])
        return JS.make_train_step(jcfg, jrun)(state, jb)[0]

    jstate = jax.jit(ref)(jax.random.PRNGKey(1))
    np_tree = jax.tree.map(np.asarray, jstate)
    tstate = TrainState(
        params=params_from_jax(np_tree.params, "cpu"),
        opt=AdamWState(m=params_from_jax(np_tree.opt.m, "cpu"),
                       v=params_from_jax(np_tree.opt.v, "cpu"),
                       step=torch.from_numpy(np.array(np_tree.opt.step))))
    return request.param, jstate, tstate


# --------------------------------------------------------------------- #
# the reference's checkpoint tests, ported
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    state = _port_state(dtype)
    d = str(tmp_path / "ckpt")
    ckpt.save(state, d, step=3)
    fresh = init_train_state(model_init(
        dataclasses.replace(get_reduced(ARCH), dtype=dtype), 5,
        device="cpu")[0])
    restored, at = ckpt.restore(fresh, d)
    assert at == 3
    _assert_same_state(state, restored)
    assert restored.opt.step.shape == () and int(restored.opt.step) == 2
    assert {t.device.type for _, t in key_paths(restored)} == {"cpu"}


def test_checkpoint_prune_and_latest(tmp_path):
    state = _port_state("float32", steps=0)
    d = str(tmp_path / "c")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(state, d, step=s, keep=2)
    assert ckpt.latest_steps(d) == [4, 5]
    assert ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]


def test_checkpoint_incomplete_ignored(tmp_path):
    state = _port_state("float32", steps=0)
    d = str(tmp_path / "c")
    ckpt.save(state, d, step=1)
    # a crashed writer: shard present, manifest missing
    bad = os.path.join(d, "step_00000002")
    os.makedirs(bad)
    open(os.path.join(bad, "shard_0.npz"), "wb").write(b"partial")
    assert ckpt.latest_step(d) == 1
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_restore_validates_against_the_live_tree(tmp_path):
    state = _port_state("float32", steps=0)
    d = str(tmp_path / "c")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state, d)
    ckpt.save(state, d, step=1)
    extra = TrainState(params=dict(state.params, more=torch.zeros(2)),
                       opt=state.opt)
    with pytest.raises(KeyError, match="0/more"):
        ckpt.restore(extra, d)
    bigger = dict(state.params, final_norm={"scale": torch.ones(7)})
    with pytest.raises(ValueError, match="shape mismatch for 0/final_norm"):
        ckpt.restore(TrainState(params=bigger, opt=state.opt), d)


# --------------------------------------------------------------------- #
# interop with the reference's format
# --------------------------------------------------------------------- #
def _files(d, step=1):
    stepdir = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)
    return np.load(os.path.join(stepdir, "shard_0.npz")), manifest


def test_both_packages_write_the_same_checkpoint(tmp_path, states):
    dtype, jstate, tstate = states
    jckpt.save(jstate, str(tmp_path / "ref"), step=1)
    ckpt.save(tstate, str(tmp_path / "port"), step=1)
    (jdata, jman), (data, man) = (_files(str(tmp_path / "ref")),
                                  _files(str(tmp_path / "port")))
    assert sorted(data.files) == sorted(jdata.files)
    assert [k for k, _ in key_paths(tstate)] == list(jman["leaves"])
    for k in jdata.files:
        a, b = data[k], jdata[k]
        assert a.dtype.str == b.dtype.str and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert man == jman          # step, n_processes, leaves, checksum
    assert json.dumps(man["leaves"]) == json.dumps(jman["leaves"])
    kinds = {v["dtype"] for v in man["leaves"].values()}
    assert kinds == ({"float32", "int32"} if dtype == "float32" else
                     {"bfloat16", "float32", "int32"})
    if dtype == "bfloat16":
        assert data["0/embed/w"].dtype.str == "|V2"


def test_the_port_restores_the_references_checkpoint(tmp_path, states):
    """bf16 leaves through their bits: the reference's file restores in
    the port equal to the state the reference saved."""
    dtype, jstate, tstate = states
    d = str(tmp_path / "ref")
    jckpt.save(jstate, d, step=1)
    fresh = map_with_keys(lambda _, t: torch.zeros_like(t), tstate)
    restored, at = ckpt.restore(fresh, d)
    assert at == 1
    _assert_same_state(tstate, restored)


def test_the_reference_restores_a_float32_port_checkpoint(tmp_path,
                                                          states):
    dtype, jstate, tstate = states
    d = str(tmp_path / "port")
    ckpt.save(tstate, d, step=1)
    if dtype == "bfloat16":
        # the reference's quirk: its restore cannot read a bf16 leaf, the
        # port's file or its own
        for src in (d, str(tmp_path / "ref")):
            if src != d:
                jckpt.save(jstate, src, step=1)
            with pytest.raises(TypeError, match="V2"):
                jckpt.restore(jstate, src)
        return
    restored, at = jckpt.restore(jax.tree.map(np.zeros_like, jstate), d)
    assert at == 1
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_bfloat16_leaf_is_never_written_as_integers(tmp_path):
    """Written as ``uint16``, the reference would cast the integers to
    bf16 and restore garbage without a word; the port writes void bits
    and restores them by the manifest's dtype."""
    t = torch.tensor([1.5, -2.25, 3e-3, 65280.0], dtype=torch.bfloat16)
    d = str(tmp_path / "c")
    ckpt.save({"x": t}, d, step=1)
    data, man = _files(d)
    assert data["x"].dtype.kind == "V" and man["leaves"]["x"]["dtype"] == \
        "bfloat16"
    got, _ = ckpt.restore({"x": torch.zeros(4, dtype=torch.bfloat16)}, d)
    assert _same_bits(got["x"], t)
    # restored into a float32 live leaf: a numeric cast of the bf16 values
    got, _ = ckpt.restore({"x": torch.zeros(4)}, d)
    assert torch.equal(got["x"], t.float())
