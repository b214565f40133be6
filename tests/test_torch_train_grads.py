"""``loss_fn``'s gradient in the port, held to the reference's.

For each of the ten reduced architectures (float32, B 2, T 16, the batch
from ``make_batch`` in both packages), the reference's params
(``model_init(PRNGKey(1))``) cross over through ``params_from_jax``, and
the port's grads — ``torch.autograd.grad`` of its ``loss_fn`` over the
params' leaves — are compared with ``jax.grad`` of the reference's
``loss_fn(remat=False)``, leaf by leaf under the reference's keys:
``max|Δ| <= 2e-4 · max|g_ref| + 1e-7`` (the same function summed in
another order, through two layers or more).  Then ``remat=True``
(``torch.utils.checkpoint`` around each stacked group) must give the
loss and grads of ``remat=False`` bit for bit: the recomputation runs
the same operations on the same inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.configs import make_batch as j_make_batch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_reduced, make_batch  # noqa: E402
from repro_torch.models import loss_fn, model_init  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.train.tree import key_paths  # noqa: E402
from repro_torch.train.tree import map_with_keys  # noqa: E402

B, S = 2, 16


def grad_bound(want) -> float:
    return 2e-4 * float(np.abs(want).max(initial=0.0)) + 1e-7


def port_grads(params, cfg, batch, remat: bool):
    """(loss, [(key, grad)]) of the port's ``loss_fn`` in the reference's
    leaf order."""
    live = {k: t.detach().requires_grad_(True)
            for k, t in key_paths(params)}
    loss, _ = loss_fn(map_with_keys(lambda k, _: live[k], params), cfg,
                      batch, remat=remat)
    grads = torch.autograd.grad(loss, list(live.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), list(zip(live, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_the_reference(arch):
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    jb = j_make_batch(jcfg, "train_4k", batch_override=B, seq_override=S)

    def ref(key):
        jp = JT.model_init(key, jcfg)[0]
        (loss, _), g = jax.value_and_grad(
            lambda p: JT.loss_fn(p, jcfg, jb, remat=False),
            has_aux=True)(jp)
        return jp, loss, g

    jp, jloss, jg = jax.jit(ref)(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = make_batch(cfg, "train_4k", batch_override=B, seq_override=S,
                       device="cpu")
    loss, grads = port_grads(params, cfg, batch, remat=False)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), np.asarray(g))
            for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert [k for k, _ in grads] == [k for k, _ in want]
    for (k, got), (_, w) in zip(grads, want):
        assert tuple(got.shape) == w.shape, k
        err = float(np.abs(got.numpy().astype(np.float64) - w).max(
            initial=0.0))
        assert err <= grad_bound(w), f"{arch} {k}: {err} > {grad_bound(w)}"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_loss_and_grads_without_it(arch):
    cfg = get_reduced(arch)
    params, _ = model_init(cfg, 3, device="cpu")
    batch = make_batch(cfg, "train_4k", seed=2, batch_override=B,
                       seq_override=S, device="cpu")
    loss0, g0 = port_grads(params, cfg, batch, remat=False)
    loss1, g1 = port_grads(params, cfg, batch, remat=True)
    assert torch.equal(loss0, loss1)
    for (k, a), (_, b) in zip(g0, g1):
        assert torch.equal(a, b), k
