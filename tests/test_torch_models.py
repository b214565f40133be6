"""The model stack in the port, held to the reference.

``repro_torch.models`` against ``repro.models`` on the ten reduced
architectures: the reference's params (``model_init(PRNGKey(1))``) cross
over through ``params_from_jax``, both packages draw the same batch from
``make_batch`` (bit for bit), and the port's ``forward`` logits,
``loss_fn`` value, ``prefill`` logits and ``decode_step`` logits (from
its own prefill caches, and from the reference's caches carried across)
must match within ``1e-4 * max(1, max|ref|)`` in float32: the same
function, summed in another order (no architecture, the two MoE ones
included, needs more).  The port's decode must also match its own
forward, as ``tests/test_models.py`` checks the reference's.

In bf16 (MoE, GQA and RG-LRU architectures, with a padded vocabulary):
forward, prefill and decode from the reference's bf16 params, and each
float32 island of the bf16 path (the norms, RoPE's angles, ``_sdpa``'s
logits, the router's softmax) against the reference's function on inputs
a bf16 computation would get wrong.

Then the pieces the trouble is likely in: the MoE planner's choice over a
grid, the slot ranking, one-hot == grouped and zero-weight capacity drops
(as ``tests/test_moe.py`` has them), ``top_k``'s tie order, the RG-LRU's
log-step scan, the stateful WKV6, the cache writes' out-of-range rules
and ``input_specs``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.configs import make_batch as j_make_batch  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import SHAPES, get_reduced  # noqa: E402
from repro_torch.configs import input_specs, make_batch  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

B, S = 2, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _reference(jcfg, jb):
    """The reference's params, specs, forward logits, loss, prefill logits
    and caches, and decode logits, in one ``jax.jit`` (a third of the time
    of running them op by op)."""
    specs = {}

    def run(key, jb):
        jp, specs["tree"] = JT.model_init(key, jcfg)
        out = {"forward": JT.forward(jp, jcfg, jb, remat=False)[0],
               "loss": JT.loss_fn(jp, jcfg, jb, remat=False)[0]}
        pre = dict(jb, tokens=jb["tokens"][:, :S - 1])
        out["prefill"], jcaches = JT.prefill(jp, jcfg, pre, cache_len=S)
        enc = None
        if jcfg.encdec:
            enc = JT._encode(jp, jcfg, jb["enc_frames"].astype(
                jcfg.compute_dtype), remat=False)
        out["decode"], _ = JT.decode_step(jp, jcfg, jcaches,
                                          jb["tokens"][:, S - 1:],
                                          jnp.asarray(S - 1, jnp.int32),
                                          enc_out=enc)
        return jp, jcaches, out

    jp, jcaches, out = jax.jit(run)(jax.random.PRNGKey(1), jb)
    return _np_tree(jp), specs["tree"], _np_tree(jcaches), _np_tree(out)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """One architecture's reference outputs and the port's inputs, built
    once: the reference's params and caches carried across, the batch
    drawn by both packages."""
    arch = request.param
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    jb = j_make_batch(jcfg, "train_4k", batch_override=B, seq_override=S)
    jp, jspecs, jcaches, ref = _reference(jcfg, jb)
    return {"arch": arch, "jcfg": jcfg, "cfg": cfg, "jparams": jp,
            "jspecs": jspecs, "params": params_from_jax(jp, "cpu"),
            "jbatch": jb, "batch": make_batch(cfg, "train_4k",
                                              batch_override=B,
                                              seq_override=S, device="cpu"),
            "jcaches": jcaches, "ref": ref}


def _port_prefill(pair):
    cfg, p, b = pair["cfg"], pair["params"], pair["batch"]
    enc = None
    if cfg.encdec:
        enc = TT._encode(p, cfg, b["enc_frames"].to(cfg.compute_dtype))
    last, caches = TT.prefill(p, cfg, dict(b, tokens=b["tokens"][:, :S - 1]),
                              cache_len=S)
    return last, caches, enc


def test_make_batch_is_bit_equal(pair):
    jb, b = pair["jbatch"], pair["batch"]
    assert set(jb) == set(b)
    for k in jb:
        assert b[k].dtype == getattr(torch, str(jb[k].dtype))
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


def test_params_from_jax_keeps_keys_and_shapes(pair):
    """The carried tree has the reference's structure, keys and shapes
    (the stacked groups keep their ``n_groups`` axis), and equals a tree
    the port inits itself in keys, shapes and dtypes."""
    jl, jdef = jax.tree.flatten(pair["jparams"])
    leaves, tdef = jax.tree.flatten(pair["params"])
    assert tdef == jdef
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jl]
    for a, b in zip(leaves, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    own, specs = TT.model_init(pair["cfg"], 0, device="cpu")
    own_leaves, own_def = jax.tree.flatten(own)
    assert own_def == jdef
    assert [(tuple(x.shape), x.dtype) for x in own_leaves] == \
        [(tuple(x.shape), x.dtype) for x in leaves]
    assert specs == pair["jspecs"]


def test_forward_matches_reference(pair):
    logits, aux = TT.forward(pair["params"], pair["cfg"], pair["batch"])
    assert logits.shape == (B, S, pair["cfg"].padded_vocab)
    _close(logits, pair["ref"]["forward"], "forward")


def test_loss_matches_reference(pair):
    loss, parts = TT.loss_fn(pair["params"], pair["cfg"], pair["batch"])
    _close(loss, pair["ref"]["loss"], "loss")
    assert set(parts) == {"ce", "aux"}


def test_prefill_and_decode_match_reference(pair):
    cfg, p, b = pair["cfg"], pair["params"], pair["batch"]
    last, caches, enc = _port_prefill(pair)
    _close(last, pair["ref"]["prefill"], "prefill")
    step, _ = TT.decode_step(p, cfg, caches, b["tokens"][:, S - 1:], S - 1,
                             enc_out=enc)
    _close(step, pair["ref"]["decode"], "decode")
    # the reference's own prefill caches, carried across, decode the same
    carried = params_from_jax(pair["jcaches"], "cpu")
    step, _ = TT.decode_step(p, cfg, carried, b["tokens"][:, S - 1:],
                             S - 1, enc_out=enc)
    _close(step, pair["ref"]["decode"], "decode from carried caches")


def test_decode_matches_forward(pair):
    """Prefill + one decode step give forward's last two positions, in
    lockstep (one position) and per row (a position vector)."""
    cfg, p, b = pair["cfg"], pair["params"], pair["batch"]
    full, _ = TT.forward(p, cfg, b)
    last, caches, enc = _port_prefill(pair)
    _close(last[:, 0], full[:, S - 2].numpy(), "prefill vs forward")
    for pos in (S - 1, torch.full((B,), S - 1)):
        step, _ = TT.decode_step(p, cfg, caches, b["tokens"][:, S - 1:], pos,
                                 enc_out=enc)
        _close(step[:, 0], full[:, S - 1].numpy(), "decode vs forward")


# --------------------------------------------------------------------------- #
# bf16: the casts (norms, router softmax, attention logits in float32, the
# rest in the config's dtype) and the padded-vocab mask
# --------------------------------------------------------------------------- #
def _bf16_bound(want, vocab=None):
    """bf16 agreement, per element: the smaller of ``1e-2 * max(1,
    max|want|)`` and ``2**-7 |want| + 2**-4 rms(want)`` (one bf16 ulp, and
    a floor for the float32 sums a bf16 rounding turns into ulps)."""
    want = np.asarray(want).astype(np.float64)[..., :vocab]
    rms = float(np.sqrt(np.mean(want ** 2)))
    return np.minimum(1e-2 * max(1.0, float(np.abs(want).max())),
                      2.0 ** -7 * np.abs(want) + 2.0 ** -4 * rms)


def _close_bf16(got, want, what="", vocab=None, roundings=1):
    """``got`` within ``roundings`` times the bf16 bound of ``want`` over
    the first ``vocab`` columns (all of them by default); the columns past
    ``vocab`` (the padded vocabulary's) equal."""
    got = got.float().detach().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    if vocab is not None:
        np.testing.assert_array_equal(got[..., vocab:], want[..., vocab:])
    tol = roundings * _bf16_bound(want, vocab)
    err = np.abs(got[..., :vocab] - want[..., :vocab].astype(np.float64))
    assert (err <= tol).all(), f"{what}: {float((err / tol).max())} x bound"


def _bf16(cfg):
    # vocab 250 pads to 256: the -1e30 mask runs in bf16
    return dataclasses.replace(cfg, dtype="bfloat16", vocab=250)


@pytest.fixture(scope="module", params=["granite-moe-1b-a400m",
                                        "smollm-135m", "recurrentgemma-9b"])
def bf16_pair(request):
    """MoE, GQA and RG-LRU + local attention in bf16: the reference's
    params (bf16 leaves), forward, prefill and decode in one ``jax.jit``,
    and the port's inputs."""
    jcfg = _bf16(j_get_reduced(request.param))
    cfg = _bf16(get_reduced(request.param))
    jb = j_make_batch(jcfg, "train_4k", batch_override=B, seq_override=S)

    def run(key, jb):
        jp, _ = JT.model_init(key, jcfg)
        out = {"forward": JT.forward(jp, jcfg, jb, remat=False)[0]}
        pre = dict(jb, tokens=jb["tokens"][:, :S - 1])
        out["prefill"], jcaches = JT.prefill(jp, jcfg, pre, cache_len=S)
        out["decode"], _ = JT.decode_step(jp, jcfg, jcaches,
                                          jb["tokens"][:, S - 1:],
                                          jnp.asarray(S - 1, jnp.int32))
        return jp, jcaches, out

    jp, jcaches, out = map(_np_tree, jax.jit(run)(jax.random.PRNGKey(2), jb))
    return {"cfg": cfg, "jparams": jp, "params": params_from_jax(jp, "cpu"),
            "caches": params_from_jax(jcaches, "cpu"), "ref": out,
            "batch": make_batch(cfg, "train_4k", batch_override=B,
                                seq_override=S, device="cpu")}


def test_bf16_matches_reference(bf16_pair):
    """forward, prefill, and decode (from the port's own prefill caches and
    from the reference's carried across) in bf16, from the reference's
    bf16 params carried across bit for bit.  Each package rounds to bf16
    on its own through every layer, so the two logits agree within two
    roundings' bound; the casts themselves are held at one rounding by
    the bf16 cases below."""
    cfg, p, b, ref = (bf16_pair[k] for k in ("cfg", "params", "batch",
                                              "ref"))
    assert cfg.padded_vocab == 256 and cfg.compute_dtype == torch.bfloat16
    assert torch.bfloat16 in {x.dtype for x in jax.tree.leaves(p)}
    for a, w in zip(jax.tree.leaves(p), jax.tree.leaves(
            bf16_pair["jparams"])):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    V = cfg.vocab
    logits, _ = TT.forward(p, cfg, b)
    assert logits.dtype == torch.bfloat16
    _close_bf16(logits, ref["forward"], "bf16 forward", V, 2)
    last, caches = TT.prefill(p, cfg, dict(b, tokens=b["tokens"][:, :S - 1]),
                              cache_len=S)
    _close_bf16(last, ref["prefill"], "bf16 prefill", V, 2)
    for c, what in ((caches, "own caches"), (bf16_pair["caches"],
                                              "carried caches")):
        step, _ = TT.decode_step(p, cfg, c, b["tokens"][:, S - 1:], S - 1)
        _close_bf16(step, ref["decode"], f"bf16 decode, {what}", V, 2)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_bf16_norms_compute_in_float32(kind):
    """A bf16 input far from zero mean: its mean and variance in bf16
    would be off by many ulps of the result."""
    rng = np.random.default_rng(3)
    x = (40.0 + rng.standard_normal((4, 512))).astype(np.float32)
    scale = (1.0 + rng.standard_normal(512) / 4).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jp = {} if kind == "nonparam_ln" else {
        "scale": jnp.asarray(scale, jnp.bfloat16)}
    want = JL.apply_norm(kind, jp, jx)
    got = TL.apply_norm(kind, params_from_jax(_np_tree(jp), "cpu"),
                        params_from_jax(np.asarray(jx), "cpu"))
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want, kind)


def test_bf16_rope_angles_in_float32():
    """Positions in the thousands: an angle rounded to bf16 is off by
    whole radians."""
    rng = np.random.default_rng(4)
    jx = jnp.asarray(rng.standard_normal((2, 8, 2, 64)), jnp.bfloat16)
    pos = np.arange(4000, 4016).reshape(2, 8)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10000.0)
    got = TL.apply_rope(params_from_jax(np.asarray(jx), "cpu"),
                        torch.from_numpy(pos), 10000.0)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want, "rope")


def test_bf16_sdpa_logits_in_float32():
    """Logits of magnitude ~100 with gaps of ~0.1: a bf16 logit (ulp 0.5)
    would reorder the softmax's weights."""
    rng = np.random.default_rng(5)
    q = (rng.standard_normal((2, 6, 4, 16)) * 4).astype(np.float32)
    k = (rng.standard_normal((2, 6, 2, 16)) * 4).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want = JA._sdpa(jq, jk, jv, JA._mask(6, 6, 0, None), 1.0)
    tq, tk, tv = (params_from_jax(np.asarray(t), "cpu") for t in (jq, jk, jv))
    got = TA._sdpa(tq, tk, tv, TA._mask(6, 6, 0, None, "cpu"), 1.0)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want, "sdpa")


def test_bf16_router_softmax_in_float32(moe_pair):
    """The router's logits leave a bf16 dense, then the softmax, top-k and
    gates run in float32: the gates agree to float32 rounding and the
    experts exactly."""
    jcfg, cfg, jp, p, jx, x = moe_pair
    jpb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    jxb = jnp.asarray(jx, jnp.bfloat16).reshape(-1, jcfg.d_model)
    jg, ji, ja = JM._route(jpb, jcfg.moe, jxb)
    g, i, a = TM._route(params_from_jax(_np_tree(jpb), "cpu"), cfg.moe,
                        params_from_jax(np.asarray(jxb), "cpu"))
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def moe_pair():
    jcfg = j_get_reduced("granite-moe-1b-a400m")
    cfg = get_reduced("granite-moe-1b-a400m")
    jp, _ = JM.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, jcfg.d_model),
                          jnp.float32)
    return (jcfg, cfg, jp, params_from_jax(_np_tree(jp), "cpu"), x,
            torch.from_numpy(np.array(x)))


@pytest.mark.parametrize("n_tok", [1, 4, 64, 4096])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (32, 8), (160, 6)])
def test_choose_dispatch_matches_reference(n_tok, E, k):
    from repro.configs.base import MoEConfig as JMoEConfig
    for D in (16, 1024):
        for C in (8, JM._capacity(JMoEConfig(n_experts=E, top_k=k,
                                             d_expert=64), n_tok),
                  max(8, -(-n_tok // 8) * 8)):
            assert TM.choose_dispatch(n_tok, E, k, C, D) == \
                JM.choose_dispatch(n_tok, E, k, C, D)
    assert TM.choose_dispatch(4096, 32, 8, 1280, 1024) == "grouped"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_slot_positions_match_reference(seed, C):
    rng = np.random.default_rng(seed)
    idx = np.argsort(-rng.standard_normal((37, 6)), axis=1)[:, :3]
    want = np.asarray(JM._slot_positions(jnp.asarray(idx), 6, C))
    got = TM._slot_positions(torch.from_numpy(idx), 6, C)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_breaks_ties_by_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    want = jax.lax.top_k(jnp.asarray(probs), 2)
    got = TM._top_k(torch.from_numpy(probs), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["onehot", "grouped", "auto"])
@pytest.mark.parametrize("train", [True, False])
def test_moe_apply_matches_reference(moe_pair, mode, train):
    jcfg, cfg, jp, p, jx, x = moe_pair
    jy, ja = jax.jit(lambda jp, jx: JM.moe_apply(
        jp, jcfg, jx, deterministic_dispatch=mode, train=train))(jp, jx)
    y, a = TM.moe_apply(p, cfg, x, deterministic_dispatch=mode, train=train)
    _close(y, jy, "moe y")
    _close(a, ja, "moe aux")


def test_grouped_equals_onehot(moe_pair):
    _, cfg, _, p, _, x = moe_pair
    y1, a1 = TM.moe_apply(p, cfg, x, deterministic_dispatch="onehot")
    y2, a2 = TM.moe_apply(p, cfg, x, deterministic_dispatch="grouped")
    _close(y2, y1.numpy(), "grouped vs onehot")
    assert abs(float(a1) - float(a2)) <= 1e-6


def test_capacity_drops_are_weighted_zero(moe_pair):
    """Over-capacity tokens contribute nothing (not garbage), in both
    schedules and as in the reference."""
    jcfg, cfg, jp, p, jx, x = moe_pair
    tight = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.25))
    jtight = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.25))
    y, _ = TM.moe_apply(p, tight, x, deterministic_dispatch="grouped")
    y2, _ = TM.moe_apply(p, tight, x, deterministic_dispatch="onehot")
    assert torch.isfinite(y).all()
    _close(y, y2.numpy(), "tight grouped vs onehot")
    jy, _ = JM.moe_apply(jp, jtight, jx, deterministic_dispatch="grouped")
    _close(y, jy, "tight vs reference")
    pos = TM._slot_positions(TM._route(p, tight.moe, x.reshape(-1, 64))[1],
                             tight.moe.n_experts, 8)
    assert (pos < 0).any()        # the drops really happened


# --------------------------------------------------------------------------- #
# recurrences, cache writes, input specs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T", [1, 2, 5, 16, 37])
def test_lin_rec_scan_matches_reference(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 0.999, (2, T, 8)).astype(np.float32)
    x = rng.standard_normal((2, T, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    for init in (None, h0):
        want = jax.jit(JR._lin_rec_scan)(
            jnp.asarray(a), jnp.asarray(x),
            None if init is None else jnp.asarray(init))
        got = TR._lin_rec_scan(torch.from_numpy(a), torch.from_numpy(x),
                               None if init is None else
                               torch.from_numpy(init))
        _close(got, want, "lin_rec_scan")


def test_wkv6_with_state_matches_reference():
    rng = np.random.default_rng(0)
    r, k, v = (rng.standard_normal((2, 5, 2, 64)).astype(np.float32) / 4
               for _ in range(3))
    w = rng.uniform(-6, -1, (2, 5, 2, 64)).astype(np.float32)
    u = rng.standard_normal((2, 64)).astype(np.float32) / 10
    s0 = rng.standard_normal((2, 2, 64, 64)).astype(np.float32) / 10
    jo, js = JR._wkv6_with_state(*(jnp.asarray(t) for t in (r, k, v, w, u,
                                                             s0)))
    o, s = TR._wkv6_with_state(*(torch.from_numpy(t) for t in (r, k, v, w, u,
                                                              s0)))
    _close(o, jo, "wkv6 out")
    _close(s, js, "wkv6 state")


@pytest.mark.parametrize("update,T", [
    (0, 1), (7, 1), (9, 1), (0, 2), (5, 2), (7, 2), (9, 2),
    # per-row offsets are the decode step's (T == 1)
    ([0, 7], 1), ([8, 2], 1), ([9, 12], 1)])
def test_cache_write_drops_or_clamps_as_reference(update, T):
    """Past the cache, a per-row write is dropped (JAX's scatter) and a
    shared offset clamps its start (``dynamic_update_slice``)."""
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((2, 8, 3)).astype(np.float32)
    new = rng.standard_normal((2, T, 3)).astype(np.float32)
    us = np.asarray(update, np.int32)
    want = JA._cache_write(jnp.asarray(cache), jnp.asarray(new),
                           jnp.asarray(us))
    got = TA._cache_write(torch.from_numpy(cache), torch.from_numpy(new),
                          torch.from_numpy(us.astype(np.int64))
                          if us.ndim else int(us))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_reference(shape):
    for arch in ARCHS:
        want = j_input_specs(j_get_reduced(arch), shape)
        got = input_specs(get_reduced(arch), shape)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == w.shape
            assert got[k].dtype == getattr(torch, str(w.dtype))
