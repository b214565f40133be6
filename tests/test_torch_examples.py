"""The port's examples (``repro_torch.examples``) against the JAX
package's (``examples/*.py``), on the CPU, from the same inputs.

The reference's scripts are loaded from their files
(``importlib.util.spec_from_file_location``; the quickstart, whose work
is module-level code, through ``runpy.run_path``).  Tolerances, float32
both sides:

* quickstart at ``EX_SCALE=0.1``: ``out`` and ``sliced`` within
  ``1e-5 * max(1, max|ref|)``;
* CP-ALS, 3 sweeps: the fit history within 1e-4, the factors within
  ``1e-3 * max|ref|`` (three sweeps of normal-equation solves amplify
  the last bits of the MTTKRPs);
* HOOI, 3 sweeps: the core norms within 2e-4 of the reference's printed
  ones (four decimals), and the projectors ``U Uᵀ`` within 1e-4 (a
  singular vector's sign is free);
* completion: the first step's gradients within ``1e-5 * max|g|`` of
  ``jax.value_and_grad`` of the reference's loss, and the printed
  ``mse`` lines of the default 300 steps within 2e-5 (five decimals).
  The printed lines agree through step 175; after that Adam's
  normalised steps amplify float32 rounding (another summation order in
  the einsums and the mean) to two units of the fifth decimal by step
  299 (0.00733 against 0.00735).  The port's
  completion runs under ``torch.use_deterministic_algorithms(True)``:
  the backward of its gathers (``index_put_`` with accumulation) sums
  in an order that varies run to run on the CPU otherwise, which moves
  the printed losses by up to 6.5e-5.

Each port ``main`` also runs on the CPU with its own asserts, and
``cp_als`` with ``--autotune`` searches cold and loads warm.

The LM drivers run from the reference's params (``model_init(PRNGKey(0))``
of reduced smollm-135m, float32, carried across by ``params_from_jax``):

* ``serve_lm``: the printed ``req{i}`` lines equal the reference
  ``main``'s (the same tokens);
* ``train_lm``, 3 steps: each step's loss and lr within 1e-5 relative
  of the reference's (recorded from its jitted step), and the same
  ``arch=... params=...M`` header;
* ``train_lm`` resumed: the reference writes its checkpoint at step 100
  (``--steps 101``); the port resumes from it to 102 (``resumed from
  step 100``) and its steps 100 and 101 are within 1e-5 relative of the
  reference's own resumed run.
"""
import dataclasses
import importlib.util
import os
import re
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro_torch import random_sparse  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.examples import (cp_als, quickstart,  # noqa: E402
                                  serve_lm, tensor_completion, train_lm,
                                  tucker_hooi)
from repro_torch.models import params_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text, pattern):
    return [float(m) for m in re.findall(pattern, text)]


def test_quickstart_matches_the_reference(monkeypatch):
    monkeypatch.setenv("EX_SCALE", "0.1")
    ref = runpy.run_path(os.path.join(REPO, "examples", "quickstart.py"))
    out, sliced, oracle = quickstart.main(device="cpu")
    np.testing.assert_array_equal(oracle, ref["oracle"])
    for got, want in ((out, ref["out"]), (sliced, ref["sliced"])):
        want = np.asarray(want)
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= tol


def _cp_tensor(pkg_random_sparse):
    """The reference ``main``'s tensor: rank-8 structure plus noise."""
    rng = np.random.default_rng(1)
    I, J, K, r0 = 128, 96, 80, 8
    A0, B0, C0 = (rng.standard_normal((n, r0)) for n in (I, J, K))
    T = pkg_random_sparse((I, J, K), 5e-3, seed=2)
    vals = (A0[T.coords[:, 0]] * B0[T.coords[:, 1]]
            * C0[T.coords[:, 2]]).sum(1).astype(np.float32)
    T.values[:] = vals + 0.01 * rng.standard_normal(len(vals))
    return T


def test_cp_als_matches_the_reference():
    ref = _reference("cp_als")
    jT, tT = _cp_tensor(repro.random_sparse), _cp_tensor(random_sparse)
    np.testing.assert_array_equal(jT.coords, tT.coords)
    np.testing.assert_array_equal(jT.values, tT.values)
    want, jhist = ref.cp_als(jT, rank=16, steps=3)
    got, thist = cp_als.cp_als(tT, rank=16, steps=3, device="cpu")
    assert len(thist) == len(jhist) == 2
    assert np.abs(np.subtract(thist, jhist)).max() <= 1e-4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-3 * np.abs(w).max()


def test_hooi_matches_the_reference(monkeypatch, capsys):
    ref = _reference("tucker_hooi")
    ranks = (8, 6, 4)
    svd, us = np.linalg.svd, []

    def recording_svd(a, *args, **kw):
        res = svd(a, *args, **kw)
        us.append(res[0])
        return res

    monkeypatch.setattr(np.linalg, "svd", recording_svd)
    ref.main(steps=3, ranks=ranks)
    monkeypatch.undo()
    want_norms = _lines(capsys.readouterr().out,
                        r"captured core norm ([0-9.]+)")
    want_u = [us[-3 + m][:, : ranks[m]] for m in range(3)]
    T = random_sparse((96, 80, 64), 5e-3, seed=3)
    U, norms = tucker_hooi.hooi(T, ranks, 3, device="cpu")
    assert len(norms) == len(want_norms) == 3
    assert np.abs(np.subtract(norms, want_norms)).max() <= 2e-4
    for u, w in zip(U, want_u):
        u = u.numpy().astype(np.float64)
        assert np.abs(u @ u.T - w @ w.T).max() <= 1e-4


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for the test's scope."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _completion_data():
    """The reference ``main``'s draws, in its order, and its rng after
    them (the initial factors come next)."""
    I, J, K, rank = 96, 80, 64, 12
    rng = np.random.default_rng(0)
    A0, B0, C0 = (rng.standard_normal((n, rank)).astype(np.float32) * 0.5
                  for n in (I, J, K))
    omega = random_sparse((I, J, K), 8e-3, seed=4)
    truth = (A0[omega.coords[:, 0]] * B0[omega.coords[:, 1]]
             * C0[omega.coords[:, 2]]).sum(1)
    return omega, truth, rng


def test_completion_first_gradients_match_jax_value_and_grad(
        deterministic):
    omega, truth, rng = _completion_data()
    seen = {}

    def on_step(it, v, params, grads):
        seen.update(v=float(v), params=[p.detach().numpy() for p in params],
                    grads=[g.numpy() for g in grads])

    tensor_completion.complete(omega, truth, 12, 1, 0.05, "cpu", rng,
                               on_step=on_step)
    # the reference's loss, built from its own package as its main does
    jcoo = repro.random_sparse((96, 80, 64), 8e-3, seed=4)
    np.testing.assert_array_equal(jcoo.coords, omega.coords)
    jcsf = repro.build_csf(jcoo)
    spec = repro.tttp3(96, 80, 64, 12)
    p = repro.plan(spec, nnz_levels=jcsf.nnz_levels())
    ex = repro.make_executor(spec, p.path, p.order)
    arrays = repro.CSFArrays.from_csf(jcsf)
    ones = dataclasses.replace(arrays, values=jnp.ones_like(arrays.values))
    obs = jnp.asarray(truth)

    def loss(params):
        A, B, C = params
        est = ex(ones, {"U": A, "V": B, "W": C})
        return 0.5 * jnp.mean((est - obs) ** 2)

    v, g = jax.value_and_grad(loss)(tuple(jnp.asarray(a)
                                          for a in seen["params"]))
    assert abs(seen["v"] - float(v)) <= 1e-6 * abs(float(v))
    for got, want in zip(seen["grads"], g):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_completion_mse_lines_match_the_reference(capsys,
                                                  deterministic):
    _reference("tensor_completion").main()
    want = capsys.readouterr().out
    losses = tensor_completion.main(device="cpu")
    got = capsys.readouterr().out
    assert "completion converged" in want and "completion converged" in got
    pattern = r"step +(\d+) +mse ([0-9.]+)"
    w, g = re.findall(pattern, want), re.findall(pattern, got)
    assert [s for s, _ in g] == [s for s, _ in w] and len(g) == 13
    # in units of the fifth decimal, so that 2e-5 is not lost to the
    # binary representation of the printed values
    assert max(abs(round(float(a) * 1e5) - round(float(b) * 1e5))
               for (_, a), (_, b) in zip(g, w)) <= 2
    assert len(losses) == 300 and losses[-1] < 0.25 * losses[0]


def test_cp_als_and_hooi_mains_run_on_the_cpu(capsys):
    hist = cp_als.main(["--device", "cpu"])
    assert len(hist) == 5 and hist[-1] > hist[0]
    U, norms = tucker_hooi.main(device="cpu")
    assert [tuple(u.shape) for u in U] == [(96, 8), (80, 6), (64, 4)]
    assert len(norms) == 8 and norms[-1] >= norms[0]
    out = capsys.readouterr().out
    assert "HOOI done" in out and "done in" in out


def test_cp_als_autotune_searches_cold_and_loads_warm(tmp_path, capsys):
    argv = ["--autotune", "--cache-dir", str(tmp_path), "--steps", "2",
            "--device", "cpu"]
    cp_als.main(argv)
    cold = capsys.readouterr().out
    cp_als.main(argv)
    warm = capsys.readouterr().out
    for name in "ABC":
        assert re.search(rf"mode {name}: plan from search \(\d+ timed\)",
                         cold), cold
        assert f"mode {name}: plan from cache" in warm, warm


@pytest.fixture(scope="module")
def lm_params():
    """Reduced smollm-135m's params as the reference's LM examples draw
    them, and the port's copy of them on the CPU."""
    from repro.models import model_init as j_model_init
    jp, _ = j_model_init(jax.random.PRNGKey(0), repro.configs.get_reduced(
        "smollm-135m"))
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_serve_lm_prints_the_reference_tokens(lm_params, capsys):
    _reference("serve_lm").main()
    want = capsys.readouterr().out
    done = serve_lm.serve(get_reduced("smollm-135m"), lm_params)
    got = capsys.readouterr().out
    assert len(done) == 6 and all(len(r.out) == 12 for r in done)
    assert all(type(t) is int for r in done for t in r.out)
    assert got == want
    assert len(re.findall(r"^req\d: prompt=", got, re.M)) == 6


def _recording_reference(monkeypatch):
    """The reference ``train_lm`` whose jitted step records each step's
    loss and lr (in call order)."""
    ref = _reference("train_lm")
    seen = []

    def jit(fn, **kw):
        step = jax.jit(fn, **kw)

        def run(state, batch):
            state, m = step(state, batch)
            seen.append((float(m["loss"]), float(m["lr"])))
            return state, m
        return run

    shim = type("jax", (), {"jit": staticmethod(jit),
                            "random": jax.random, "tree": jax.tree})
    monkeypatch.setattr(ref, "jax", shim)
    return ref, seen


def _port_train(params, steps, ckpt_dir):
    seen = {}
    train_lm.train(get_reduced("smollm-135m"), params, steps, str(ckpt_dir),
                   on_step=lambda i, m: seen.__setitem__(
                       i, (float(m["loss"]), float(m["lr"]))))
    return seen


def _within(got, want):
    for (gl, glr), (wl, wlr) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (gl, wl)
        assert abs(glr - wlr) <= 1e-5 * abs(wlr), (glr, wlr)


def test_train_lm_matches_the_reference(lm_params, monkeypatch, capsys,
                                        tmp_path):
    ref, want = _recording_reference(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["train_lm", "--steps", "3",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    ref.main()
    ref_out = capsys.readouterr().out
    got = _port_train(lm_params, 3, tmp_path / "port")
    capsys.readouterr()
    assert sorted(got) == [0, 1, 2] and len(want) == 3
    _within([got[i] for i in range(3)], want)
    train_lm.main(["--steps", "3", "--ckpt-dir", str(tmp_path / "main"),
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == ref_out.splitlines()[0]
    assert out.splitlines()[0].startswith("arch=smollm-135m (reduced) ")
    assert out.splitlines()[-1] == "done"


def test_train_lm_resumes_from_the_reference_checkpoint(
        lm_params, monkeypatch, capsys, tmp_path):
    ref, want = _recording_reference(monkeypatch)
    ckpt_dir = str(tmp_path / "ckpt")
    for steps in ("101", "102"):
        monkeypatch.setattr(sys, "argv", ["train_lm", "--steps", steps,
                                          "--ckpt-dir", ckpt_dir])
        ref.main()
    ref_out = capsys.readouterr().out
    assert "resumed from step 100" in ref_out and len(want) == 103
    got = _port_train(lm_params, 102, ckpt_dir)
    assert "resumed from step 100" in capsys.readouterr().out
    assert sorted(got) == [100, 101]
    _within([got[100], got[101]], want[-2:])
