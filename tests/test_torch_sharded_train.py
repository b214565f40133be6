"""The port's sharded train step on four real gloo ranks, held to its
single-device step (which ``tests/test_torch_train.py`` holds to the
reference; the reference's own sharded step does not run, see
``tests/test_torch_sharding.py``).

One group of four ranks (``torch.multiprocessing`` spawn, a ``file://``
store under ``tmp_path``, a 60 s ``init_process_group`` timeout and an
outer limit of 120 s) runs every case once, on a ``(2, 2)`` mesh of
``("data", "model")`` on the CPU:

* reduced granite-moe-1b (batch 8, seq 32, the reference test's sizes;
  capacity factor 0.75, so the batch drops slots), params placed by
  ``tree_sharding`` and ``distribute_params``: two sharded steps, a step
  at two microbatches, and ``loss_fn`` under the batch split (its ``ce``
  and ``aux`` and the MoE's dropped slots), against the same on one
  device;
* ``launch.train --mesh 2x2`` (smollm-135m reduced): six steps straight,
  and three, a checkpoint, three more; and a sharded state restored from
  a one-device checkpoint.

Tolerances (float32): ``loss``, ``ce``, ``aux``, ``grad_norm`` within
``1e-5`` relative; params, ``m`` and ``v`` within ``1e-5 · max|want|``
a leaf (the ranks sum partial gradients in another order).  A resume
and a checkpoint's restore: bit for bit.
"""
import contextlib
import datetime
import io
import os
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
ARCH = "granite-moe-1b-a400m"
BATCH, SEQ, STEPS = 8, 32, 2
TIMEOUT_S = 60
LIMIT_S = 120
DRIVER = ["--arch", "smollm-135m", "--reduced", "--batch", "4", "--seq",
          "16", "--device", "cpu"]


def _np(tree):
    from repro_torch.train.tree import key_paths
    return {k: t.detach().numpy().copy() for k, t in key_paths(tree)}


def _gathered(tree):
    """Every leaf of a sharded tree as a full host array, by key."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.train.tree import map_with_keys
    return _np(map_with_keys(lambda _, t: SH.gather_full(
        t.to_local(), SH.sharding_of(t)) if SH.is_dtensor(t) else t, tree))


@contextlib.contextmanager
def _drops(sink: list):
    """Record the dropped (over-capacity) slots of each MoE dispatch."""
    from repro_torch.models import moe
    real = moe._slot_positions

    def wrapped(idx, E, C):
        pos = real(idx, E, C)
        sink.append(int((pos < 0).sum()))
        return pos

    moe._slot_positions = wrapped
    try:
        yield
    finally:
        moe._slot_positions = real


def _driver(argv):
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = launch_train.main(DRIVER + argv)
    return state, buf.getvalue()


def _config():
    """Reduced granite-moe-1b with a capacity factor of 0.75, so the
    batch drops slots (at 1.25 its 512 choices over 4 experts fit)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    cfg = get_reduced(ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.75))


def _rank_cases(rank: int, outdir: str) -> dict:
    from repro_torch.configs import get_reduced, make_batch
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import loss_fn, model_init
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from repro_torch.train.tree import key_paths
    got: dict = {}
    mesh = make_host_mesh(2, "cpu")
    cfg = _config()
    params, specs = model_init(cfg, 0, device="cpu")
    rules = SH.default_rules(False, "train")
    shardings = SH.tree_sharding(params, specs, rules, mesh)
    dparams = SH.distribute_params(params, shardings)
    got["local_shapes"] = [tuple(t.to_local().shape)
                           for t in tree_leaves(dparams)]
    batch = make_batch(cfg, "train_4k", batch_override=BATCH,
                       seq_override=SEQ, device="cpu")
    step = make_train_step(cfg, RunConfig(model=cfg, remat=True))
    state, metrics = init_train_state(dparams), []
    with SH.mesh_context(mesh, rules):
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        split = SH.batch_split_for(mesh, rules, BATCH)
        drops: list = []
        with SH.batch_split(split), _drops(drops):
            _, parts = loss_fn(params, cfg, {k: split.rows(v)
                                             for k, v in batch.items()})
        got["loss_fn"] = {k: float(split.all_reduce(v.detach()) / split.n)
                          for k, v in parts.items()}
        two = make_train_step(cfg, RunConfig(model=cfg, remat=True,
                                             microbatches=2))
        s2, m2 = two(init_train_state(dparams), batch)
        got["micro"] = ({k: float(v) for k, v in m2.items()}, _gathered(s2))
    got["coord"] = list(mesh.get_coordinate())
    got["drops"] = drops
    got["metrics"] = metrics
    got["state"] = _gathered(state)
    got["opt_step"] = int(state.opt.step)

    # the driver: six steps straight; three, a checkpoint, three more
    straight, _ = _driver(["--steps", "6", "--ckpt-every", "100",
                           "--ckpt-dir", os.path.join(outdir, "straight"),
                           "--mesh", "2x2"])
    got["straight"] = _gathered(straight)
    ckdir = os.path.join(outdir, "resume")
    first, out1 = _driver(["--steps", "3", "--ckpt-every", "3",
                           "--ckpt-dir", ckdir, "--mesh", "2x2"])
    got["at3"] = _gathered(first)
    resumed, out2 = _driver(["--steps", "6", "--ckpt-every", "3",
                             "--ckpt-dir", ckdir, "--mesh", "2x2"])
    got["resumed"] = _gathered(resumed)
    got["driver_out"] = (out1, out2)

    # a sharded state restored from the one-device checkpoint
    small = get_reduced("smollm-135m")
    p, s = model_init(small, 1, device="cpu")
    live = init_train_state(SH.distribute_params(
        p, SH.tree_sharding(p, s, rules, mesh)))
    restored, at = ckpt.restore(live, os.path.join(outdir, "single"))
    got["restored"] = (at, _gathered(restored),
                       [type(t).__name__ for _, t in key_paths(restored)])
    return got


def _rank(rank: int, world: int, outdir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)       # four ranks share the test's cores
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(outdir, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        got = _rank_cases(rank, outdir)
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(got, fh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """A one-device driver run to step 3 (its checkpoint is what the ranks
    restore), then every case on four gloo ranks; returns each rank's
    results and the directory."""
    import torch.multiprocessing as mp
    outdir = str(tmp_path_factory.mktemp("sharded"))
    _driver(["--steps", "3", "--ckpt-every", "3", "--ckpt-dir",
             os.path.join(outdir, "single")])
    ctx = mp.start_processes(_rank, args=(WORLD, outdir), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + LIMIT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo ranks did not finish in {LIMIT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    got = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as fh:
            got.append(pickle.load(fh))
    return got, outdir


@pytest.fixture(scope="module")
def single():
    """The same steps and ``loss_fn`` on one device."""
    from repro_torch.configs import get_reduced, make_batch
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import loss_fn, model_init
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = _config()
    params, _ = model_init(cfg, 0, device="cpu")
    batch = make_batch(cfg, "train_4k", batch_override=BATCH,
                       seq_override=SEQ, device="cpu")
    step = make_train_step(cfg, RunConfig(model=cfg, remat=True))
    state, metrics = init_train_state(params), []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    drops: list = []
    with _drops(drops):
        _, parts = loss_fn(params, cfg, batch)
    two = make_train_step(cfg, RunConfig(model=cfg, remat=True,
                                         microbatches=2))
    s2, m2 = two(init_train_state(params), batch)
    return {"metrics": metrics, "state": _np(state), "drops": drops,
            "loss_fn": {k: float(v) for k, v in parts.items()},
            "micro": ({k: float(v) for k, v in m2.items()}, _np(s2))}


def _rel(got, want, tol, what):
    assert abs(got - want) <= tol * abs(want), (what, got, want)


def _same_step(got_metrics, got_state, want_metrics, want_state):
    for k in ("loss", "lr", "grad_norm"):
        _rel(got_metrics[k], want_metrics[k], 1e-5, k)
    for k, want in want_state.items():
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got_state[k] - want).max())
        assert err <= tol, (k, err, tol)


def test_the_sharded_step_equals_one_device(ranks, single):
    got, _ = ranks
    for g in got:
        assert g["opt_step"] == STEPS
        for gm, wm in zip(g["metrics"], single["metrics"]):
            _same_step(gm, {}, wm, {})
        _same_step(g["metrics"][-1], g["state"], single["metrics"][-1],
                   single["state"])


def test_two_sharded_microbatches_equal_one_devices(ranks, single):
    """Microbatch i's rows split over the data ranks, as the whole
    batch's are: the one-device step at two microbatches."""
    got, _ = ranks
    for g in got:
        _same_step(*g["micro"], *single["micro"])


def test_the_moe_is_the_whole_batchs(ranks, single):
    """Capacity, slot order and the aux loss of the whole batch: the
    batch drops slots, each part drops what its rows drop on one device,
    and ``ce`` and ``aux`` are the single device's."""
    got, _ = ranks
    assert sum(single["drops"]) >= 1
    parts = [g["drops"] for g in got if g["coord"][1] == 0]
    assert len(parts) == 2
    assert [sum(x) for x in zip(*parts)] == single["drops"]
    for g in got:
        for k in ("ce", "aux"):
            _rel(g["loss_fn"][k], single["loss_fn"][k], 1e-5, k)


def test_each_rank_holds_its_shards_only(ranks):
    """On the (2, 2) mesh a leaf sharded on both axes keeps a quarter."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model_init
    from repro_torch.models.layers import tree_leaves
    got, _ = ranks
    params, _ = model_init(get_reduced(ARCH), 0, device="cpu")
    full = [t.numel() for t in tree_leaves(params)]
    local = [int(np.prod(s)) for s in got[0]["local_shapes"]]
    assert sum(local) < sum(full) / 2
    assert any(a * 4 == b for a, b in zip(local, full))
    for g in got[1:]:
        assert g["local_shapes"] == got[0]["local_shapes"]


def test_the_sharded_driver_resumes_bit_for_bit(ranks):
    got, _ = ranks
    for g in got:
        out1, out2 = g["driver_out"]
        assert "resumed" not in out1 and "resumed at 3" in out2
        assert "train driver done" in out2
        for k, want in g["straight"].items():
            np.testing.assert_array_equal(g["resumed"][k], want, err_msg=k)


def test_a_sharded_checkpoint_is_a_one_device_checkpoint(ranks):
    """The sharded run's files at step 3 are the one-device run's files:
    the same keys, dtypes, shapes and manifest (``n_processes`` 1), the
    values the sharded state's; and a sharded state restores from the
    one-device checkpoint bit for bit, as DTensors."""
    import json

    from repro_torch.configs import get_reduced
    from repro_torch.models import model_init
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import init_train_state
    got, outdir = ranks

    def files(name):
        d = os.path.join(outdir, name, "step_00000003")
        with open(os.path.join(d, "manifest.json")) as fh:
            return np.load(os.path.join(d, "shard_0.npz")), json.load(fh)

    (sdata, sman), (odata, oman) = files("resume"), files("single")
    assert sorted(os.listdir(os.path.join(outdir, "resume",
                                          "step_00000003"))) == \
        ["manifest.json", "shard_0.npz"]
    assert sorted(sdata.files) == sorted(odata.files)
    assert sman["leaves"] == oman["leaves"]
    assert (sman["step"], sman["n_processes"]) == (oman["step"],
                                                   oman["n_processes"]) \
        == (3, 1)
    for k in odata.files:
        a, b = sdata[k], odata[k]
        assert a.dtype.str == b.dtype.str and a.shape == b.shape, k
        np.testing.assert_array_equal(a, got[0]["at3"][k], err_msg=k)
    # one device reads the sharded file
    p, _ = model_init(get_reduced("smollm-135m"), 1, device="cpu")
    back, at = ckpt.restore(init_train_state(p),
                            os.path.join(outdir, "resume"), step=3)
    assert at == 3
    for k, v in _np(back).items():
        np.testing.assert_array_equal(v, got[0]["at3"][k], err_msg=k)
    # the ranks read the one-device file
    for g in got:
        at, state, kinds = g["restored"]
        assert at == 3 and "DTensor" in kinds
        for k in odata.files:
            np.testing.assert_array_equal(state[k], odata[k], err_msg=k)
