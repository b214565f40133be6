"""Single-device training in the port, held to the reference.

* ``make_train_step`` against the reference's after one step from the
  same state (the reference's params carried over by
  ``params_from_jax``, its batch drawn by both packages) at
  ``microbatches`` 1 and 2: ``loss``, ``lr`` and ``grad_norm`` within
  ``1e-5`` relative; ``m`` and ``v`` leaf by leaf within the gradient
  bound ``2e-4 · max|ref| + 1e-7``; params within ``2·lr₁ + 1e-6 ·
  max|p|`` (the first AdamW step moves a param by about ``lr·sign(g)``,
  so a gradient near 0 whose sign another summation order flips moves it
  by ``2·lr``).
* ``lr_schedule``, ``clip_by_global_norm`` and ``adamw_update`` (float32
  and bf16 params) against the reference's.
* The reference's own training tests (``tests/test_train_infra.py``) run
  with the port's functions: loss decreases, resume determinism (bit for
  bit here), failure injection end to end, the elastic mesh plan, the
  straggler monitor, guarded-step retries, data determinism and
  resharding; ``SyntheticLM.batch_at`` gives the reference's tokens; the
  driver ``launch.train`` resumes from its checkpoints.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.configs import make_batch as j_make_batch  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JS  # noqa: E402
from repro_torch.configs import get_reduced, make_batch  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, make_loader  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model_init, params_from_jax  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import fault  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train.train_step import (TrainState,  # noqa: E402
                                          init_train_state, make_train_step)
from repro_torch.train.tree import key_paths  # noqa: E402

B, S = 2, 16


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _keyed_np(tree):
    """[(key, numpy leaf)] of a JAX tree under the reference's keys."""
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), np.asarray(leaf, np.float64))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _hold(got_tree, want_tree, bound, what):
    got = key_paths(got_tree)
    want = _keyed_np(want_tree)
    assert [k for k, _ in got] == [k for k, _ in want], what
    for (k, g), (_, w) in zip(got, want):
        err = float(np.abs(_np(g).astype(np.float64) - w).max(initial=0.0))
        assert err <= bound(w), f"{what} {k}: {err} > {bound(w)}"


def _rel(got, want, what, tol=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (what, got, want)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("k", [1, 2])
def test_train_step_matches_the_reference(arch, k):
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    kw = dict(remat=False, microbatches=k, learning_rate=3e-3,
              warmup_steps=5)
    jrun, run = JRunConfig(model=jcfg, **kw), RunConfig(model=cfg, **kw)
    jb = j_make_batch(jcfg, "train_4k", batch_override=B, seq_override=S)

    def ref(key):
        state = JS.init_train_state(JT.model_init(key, jcfg)[0])
        return state.params, JS.make_train_step(jcfg, jrun)(state, jb)

    jparams, (jstate, jm) = jax.jit(ref)(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = make_batch(cfg, "train_4k", batch_override=B, seq_override=S,
                       device="cpu")
    state, m = make_train_step(cfg, run)(init_train_state(params), batch)
    for name in ("loss", "lr", "grad_norm"):
        assert m[name].dtype == torch.float32 and m[name].ndim == 0
        _rel(m[name], jm[name], name)
    assert int(state.opt.step) == int(jstate.opt.step) == 1
    assert state.opt.step.dtype == torch.int32

    def grad_bound(w):
        return 2e-4 * float(np.abs(w).max(initial=0.0)) + 1e-7

    _hold(state.opt.m, jstate.opt.m, grad_bound, "m")
    _hold(state.opt.v, jstate.opt.v, grad_bound, "v")
    lr1 = float(jm["lr"])
    _hold(state.params, jstate.params,
          lambda w: 2 * lr1 + 1e-6 * float(np.abs(w).max(initial=0.0)),
          "params")
    # the step left no .grad and no requires_grad on the params it took
    assert all(t.grad is None and not t.requires_grad
               for t in tree_leaves(params))


@pytest.mark.parametrize("warmup", [1, 5, 100])
def test_lr_schedule_matches_the_reference(warmup):
    cfg = get_reduced("smollm-135m")
    run = RunConfig(model=cfg, warmup_steps=warmup, learning_rate=3e-4)
    jrun = JRunConfig(model=j_get_reduced("smollm-135m"),
                      warmup_steps=warmup, learning_rate=3e-4)
    for step in (0, 1, 3, 5, 50, 99, 100, 101, 5_000, 10_000, 20_000):
        got = O.lr_schedule(run, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _rel(got, JO.lr_schedule(jrun, jnp.float32(step)), f"lr {step}")
        _rel(O.lr_schedule(run, step), got, f"lr {step} (int)")


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((7, 5))).astype(np.float32),
            "b": [(scale * rng.standard_normal((3,))).astype(np.float32),
                  (scale * rng.standard_normal((2, 2))).astype(np.float32)]}


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_clip_by_global_norm_matches_the_reference(scale):
    g = _grads(0, scale)
    want, wn = JO.clip_by_global_norm(g, 1.0)
    got, gn = O.clip_by_global_norm(tree_map(torch.from_numpy, g), 1.0)
    _rel(gn, wn, "norm")
    for (k, a), (j, b) in zip(key_paths(got), _keyed_np(want)):
        assert k == j
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)
    assert bool(torch.sqrt(sum((x * x).sum() for x in tree_leaves(got)))
                <= 1.0 + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(dtype):
    """Three AdamW steps from the same params, grads and moments; bf16
    params are updated in float32 and cast back (one bf16 ulp apart at
    most, where the float32 update lands on a rounding boundary)."""
    cfg = get_reduced("smollm-135m")
    run = RunConfig(model=cfg, warmup_steps=2, learning_rate=1e-2)
    jrun = JRunConfig(model=j_get_reduced("smollm-135m"), warmup_steps=2,
                      learning_rate=1e-2)
    p = _grads(1, 1.0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jst, tst = JO.init_opt_state(jp), O.init_opt_state(tp)
    for i in range(3):
        g = _grads(10 + i, 0.5)
        jp, jst, jm = JO.adamw_update(
            jp, jax.tree.map(lambda a: jnp.asarray(a, dtype), g), jst, jrun)
        tp, tst, tm = O.adamw_update(tp, params_from_jax(jax.tree.map(
            np.asarray, jax.tree.map(lambda a: jnp.asarray(a, dtype), g)),
            "cpu"), tst, run)
        _rel(tm["lr"], jm["lr"], "lr")
        _rel(tm["grad_norm"], jm["grad_norm"], "grad_norm")
    for a, b in zip(key_paths(tp), _keyed_np(jp)):
        assert a[1].dtype == getattr(torch, dtype)
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(_np(a[1]), b[1], rtol=ulp, atol=1e-7)
    for a, b in zip(key_paths(tst.m), _keyed_np(jst.m)):
        np.testing.assert_allclose(_np(a[1]), b[1], rtol=1e-5, atol=1e-7)
    for a, b in zip(key_paths(tst.v), _keyed_np(jst.v)):
        np.testing.assert_allclose(_np(a[1]), b[1], rtol=1e-5, atol=1e-9)
    assert int(tst.step) == 3 and tst.step.dtype == torch.int32


# --------------------------------------------------------------------- #
# the reference's training tests (tests/test_train_infra.py), ported
# --------------------------------------------------------------------- #
def _tiny_setup(seed=0):
    cfg = get_reduced("smollm-135m")
    params, _ = model_init(cfg, seed, device="cpu")
    run = RunConfig(model=cfg, remat=False, learning_rate=3e-3,
                    warmup_steps=5)
    step = make_train_step(cfg, run)
    ds, _ = make_loader(cfg.vocab, 16, 4, seed=1, device="cpu")
    return cfg, step, init_train_state(params), ds


def _assert_same_state(a: TrainState, b: TrainState):
    for (k, x), (_, y) in zip(key_paths(a), key_paths(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_loss_decreases():
    cfg, step, state, ds = _tiny_setup()
    losses = []
    for i in range(30):
        state, m = step(state, ds.batch_at(i % 4))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_microbatch_equivalence():
    """k microbatches match the single-batch gradient step (the
    reference's ``tests/test_models.py`` check, its ``atol``)."""
    cfg = get_reduced("smollm-135m")
    params, _ = model_init(cfg, 0, device="cpu")
    batch = make_batch(cfg, "train_4k", batch_override=4, seq_override=16,
                       device="cpu")
    s1, m1 = make_train_step(cfg, RunConfig(model=cfg, remat=False))(
        init_train_state(params), batch)
    s2, m2 = make_train_step(cfg, RunConfig(model=cfg, remat=False,
                                            microbatches=2))(
        init_train_state(params), batch)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)
    # a dense model's mean loss over two equal halves is the whole's
    _rel(m2["loss"], m1["loss"], "loss", tol=1e-6)


def test_key_paths_keeps_no_leaf_alive():
    """A tree whose last holder lets go is freed at once, not at the
    garbage collector's next pass: ``key_paths`` leaves no reference
    cycle holding its leaves (a trainer would keep the old state)."""
    import gc
    import weakref

    from repro_torch.train.tree import key_paths
    tree = {"a": torch.zeros(3), "b": [torch.ones(2), {"c": torch.ones(1)}]}
    refs = [weakref.ref(t) for _, t in key_paths(tree)]
    assert len(refs) == 3
    gc.disable()
    try:
        del tree
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()


def test_checkpoint_resume_determinism(tmp_path):
    """train 6 straight == train 3, checkpoint, restore, train 3 more — bit
    for bit (the reference allows 1e-6)."""
    cfg, step, state, ds = _tiny_setup()
    s_straight = state
    for i in range(6):
        s_straight, _ = step(s_straight, ds.batch_at(i))
    s = state
    for i in range(3):
        s, _ = step(s, ds.batch_at(i))
    d = str(tmp_path / "c")
    ckpt.save(s, d, step=3)
    s2, at = ckpt.restore(s, d)
    assert at == 3
    for i in range(at, 6):
        s2, _ = step(s2, ds.batch_at(i))
    _assert_same_state(s_straight, s2)


def test_failure_injection_end_to_end(tmp_path):
    """Simulated failures mid-run: restore + deterministic data => the
    uninterrupted run's final state."""
    cfg, step, state, ds = _tiny_setup()
    d = str(tmp_path / "c")
    n_steps = 10
    golden = state
    for i in range(n_steps):
        golden, _ = step(golden, ds.batch_at(i))
    fails = set(fault.simulate_failure_schedule(n_steps, mtbf_steps=3,
                                                seed=1).tolist())
    assert fails
    s = state
    ckpt.save(s, d, step=0)
    i = 0
    while i < n_steps:
        if i in fails:
            fails.discard(i)     # fail once per scheduled step
            s, i = ckpt.restore(s, d)   # crash: reload latest
            continue
        s, _ = step(s, ds.batch_at(i))
        i += 1
        if i % 2 == 0:
            ckpt.save(s, d, step=i)
    _assert_same_state(golden, s)


@pytest.mark.parametrize("n,kw,shape,dropped", [
    (512, {"want_model": 16, "multi_pod": True}, (2, 16, 16), 0),
    (511, {"want_model": 16}, (31, 16), 511 - 31 * 16),
    (8, {"want_model": 16}, (1, 8), 0),
    (3, {}, (1, 2), 1),
])
def test_elastic_mesh_plan(n, kw, shape, dropped):
    from repro.train import fault as jfault
    p = fault.elastic_mesh_plan(n, **kw)
    assert (p.shape, p.dropped) == (shape, dropped)
    assert dataclasses.astuple(p) == dataclasses.astuple(
        jfault.elastic_mesh_plan(n, **kw))
    for gb, old, new in ((256, 16, 15), (64, 4, 2), (8, 8, 1)):
        per, accum = fault.rebalance_batch(gb, old_data=old, new_data=new)
        assert per * new <= gb and per >= 1
        assert (per, accum) == jfault.rebalance_batch(gb, old, new)


def test_straggler_monitor():
    mon = fault.StragglerMonitor(alpha=0.3, threshold=2.5)
    flags = [mon.observe(0.1) for _ in range(50)]
    assert not any(flags)
    assert mon.observe(10.0)     # 100x step time -> flagged


@pytest.mark.parametrize("fails,retries,ok", [(2, 3, True), (4, 3, False)])
def test_guarded_step_retries(fails, retries, ok):
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] <= fails:
            raise fault.TransientError("link flap")
        return state + 1, {}

    if ok:
        out, _ = fault.guarded_step(flaky, 1, None, retries=retries)
        assert out == 2 and calls["n"] == fails + 1
        return
    with pytest.raises(fault.TransientError):
        fault.guarded_step(flaky, 1, None, retries=retries)
    assert calls["n"] == retries + 1
    calls["n"] = 0
    out = fault.guarded_step(flaky, 1, None, retries=retries,
                             on_failure=lambda s, b: ("restored", s))
    assert out == ("restored", 1)


def test_guarded_step_does_not_retry_a_device_error():
    """A CUDA error is sticky: it is raised at once, never retried."""
    calls = {"n": 0}

    def broken(state, batch):
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        fault.guarded_step(broken, 0, None, retries=3)
    assert calls["n"] == 1


def test_failure_schedule_is_the_references():
    from repro.train import fault as jfault
    for n, mtbf, seed in ((10, 3, 1), (100, 7.5, 4), (5, 50, 0)):
        np.testing.assert_array_equal(
            fault.simulate_failure_schedule(n, mtbf, seed),
            jfault.simulate_failure_schedule(n, mtbf, seed))


def test_data_determinism_and_resharding():
    ds, _ = make_loader(vocab=1000, seq_len=8, global_batch=8, n_shards=1,
                        device="cpu")
    b1 = ds.batch_at(5)
    b2 = ds.batch_at(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["labels"] is b1["tokens"]
    b3 = ds.batch_at(6)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    # resharding keeps per-shard streams independent and deterministic
    a = SyntheticLM(1000, 8, 4, n_shards=2, shard_id=0,
                    device="cpu").batch_at(3)
    b = SyntheticLM(1000, 8, 4, n_shards=2, shard_id=1,
                    device="cpu").batch_at(3)
    assert not torch.equal(a["tokens"], b["tokens"])
    moved = ds.reshard(2, 1)
    assert (moved.n_shards, moved.shard_id, moved.device) == (2, 1, "cpu")


@pytest.mark.parametrize("vocab,seq,batch,shards,shard,seed", [
    (1000, 8, 8, 1, 0, 0),
    (49155, 64, 4, 2, 1, 3),
    (256, 33, 3, 4, 2, 7),
])
def test_synthetic_batches_are_the_references(vocab, seq, batch, shards,
                                              shard, seed):
    ds, it = make_loader(vocab, seq, batch, n_shards=shards, shard_id=shard,
                         seed=seed, device="cpu")
    jds, jit = JP.make_loader(vocab, seq, batch, n_shards=shards,
                              shard_id=shard, seed=seed)
    for (i, got), (j, want) in zip(it(4), jit(4)):
        assert i == j
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))
        if i == 6:
            break


def test_launch_train_resumes_from_its_checkpoints(tmp_path, capsys):
    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "12",
            "--ckpt-every", "5", "--ckpt-dir", str(tmp_path / "c"),
            "--device", "cpu"]
    launch_train.main(argv)
    first = capsys.readouterr().out
    assert "resumed" not in first and "train driver done" in first
    assert ckpt.latest_steps(str(tmp_path / "c")) == [5, 10]
    launch_train.main(argv)
    second = capsys.readouterr().out
    assert "resumed at 10" in second
    # the resumed steps print the straight run's losses
    def losses(out):
        return re.findall(r"step +(\d+) loss (\S+)", out)[-2:]
    assert losses(second) == losses(first)
    assert [i for i, _ in losses(first)] == ["10", "11"]
    # --mesh takes its ranks from torchrun: without them it says so
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        launch_train.main(argv + ["--mesh", "2x2"])
