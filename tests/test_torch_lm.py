"""The LM kernels' drivers (K8-K11) and the model configs, port vs
reference, on the CPU.

``repro_torch.kernels.ops.{grouped_matmul, local_attn, wkv6, rglru}`` on
CPU tensors (so the kernel wrappers run their plain versions) against
``repro.kernels.ops`` with ``use_pallas=True, interpret=True`` and with
``use_pallas=False`` (the oracle), on the same numpy-seeded inputs; and
``repro_torch.configs`` against ``repro.configs`` field by field.

Tolerances, ``|port - jax| <= rel * max(1, max|jax|)``:

* float32 ``rel = 1e-4`` (another summation order); K10 ``1e-3``, as the
  reference's own ``test_wkv6_sweep`` tolerates for its two versions;
* bfloat16 ``rel = 5e-2`` (``tests/test_kernels.py``'s bf16 tolerance:
  the two packages round to bf16 at other points).

The Pallas ``rglru`` is held in float32 only: in bf16 it raises (it
stores its float32 state into the bf16 output).  The Pallas
``local_attn`` is held only with ``bk == bq``: with
``bq != bk`` it mixes query- and key-tile units in its kv-block index
and misses its own oracle by more than 1 (ROADMAP queue 3).  The port,
whose tiles are the kernel's own, is held to the dense oracle in that
setup.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.rglru import rglru_pallas  # noqa: E402
from repro.kernels.wkv6 import wkv6_pallas  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import native, ops, rglru, wkv6  # noqa: E402
from repro_torch.kernels.local_attn import (local_attn_plain,  # noqa: E402
                                            padded_head)

BF16 = np.dtype("bfloat16")
DTYPES = [pytest.param(np.float32, id="f32"), pytest.param(BF16, id="bf16")]


def _rel(dtype):
    return 1e-4 if dtype == np.float32 else 5e-2


def _close(port, ref, rel):
    port = np.asarray(torch.as_tensor(port).float(), np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    assert port.shape == ref.shape
    assert np.isfinite(port).all()
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= rel * scale, (err, rel * scale)


def _pair(a, dtype):
    """One numpy array as a JAX and a torch array of ``dtype`` (both
    round float32 to bf16 to nearest even)."""
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    return (jnp.asarray(a, jnp.dtype(dtype)),
            torch.from_numpy(np.asarray(a, np.float32)).to(tdtype))


def _arrays(dtype, *shapes, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    pairs = [_pair(rng.standard_normal(s).astype(np.float32) * scale, dtype)
             for s in shapes]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_matches_reference(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    want = getattr(jconfigs, get)(arch)
    got = getattr(configs, get)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got.compute_dtype).removeprefix("torch.") == \
        str(want.compute_dtype)
    assert (got.hd, got.padded_vocab, got.sub_quadratic) == \
        (want.hd, want.padded_vocab, want.sub_quadratic)
    assert got.pattern_for_layers() == want.pattern_for_layers()
    for shape in jconfigs.SHAPES:
        assert configs.shape_applicable(got, shape) == \
            jconfigs.shape_applicable(want, shape)


def test_config_registry_shapes_and_run_defaults_match_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    model = configs.get_reduced("olmo-1b")
    got = dataclasses.asdict(configs.RunConfig(model))
    want = dataclasses.asdict(jconfigs.RunConfig(
        jconfigs.get_reduced("olmo-1b")))
    assert got == want
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


# --------------------------------------------------------------------- #
# K8 grouped_matmul
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("E,C,D,F,tiles", [
    (4, 16, 32, 24, dict(bc=8, bf=8, bd=16)),
    (2, 8, 8, 8, dict(bc=8, bf=8, bd=8)),
    (8, 32, 16, 64, dict(bc=16, bf=32, bd=16)),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_matches_reference(E, C, D, F, tiles, dtype):
    (jx, jw), (x, w) = _arrays(dtype, (E, C, D), (E, D, F), seed=1)
    native.reset_launch_counts()
    got = ops.grouped_matmul(x, w)
    assert native.launch_counts()["grouped_matmul"] == 0   # CPU: plain
    assert got.dtype == x.dtype
    _close(got, jops.grouped_matmul(jx, jw, use_pallas=True,
                                    interpret=True, **tiles), _rel(dtype))
    _close(ops.grouped_matmul(x, w, use_kernel=False),
           jops.grouped_matmul(jx, jw, use_pallas=False), _rel(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_any_sizes_match_oracle(dtype):
    # sizes no tile divides (the Pallas kernel asserts divisibility)
    (jx, jw), (x, w) = _arrays(dtype, (3, 17, 33), (3, 33, 9), seed=2)
    _close(ops.grouped_matmul(x, w),
           jops.grouped_matmul(jx, jw, use_pallas=False), _rel(dtype))


@pytest.mark.parametrize("E,C,D,F", [(3, 70, 33, 65), (1, 5, 3, 7),
                                     (2, 130, 1000, 20), (2, 16, 64, 128)])
def test_grouped_matmul_padding_rule_matches_reference(E, C, D, F):
    """K8's bf16 path takes D and F in multiples of 8 (TMA's 16-byte
    strides): the padded plain product, sliced back to F, equals the
    reference on the same inputs; float32 is never padded."""
    from repro_torch.kernels import grouped_matmul as gmm
    Dp, Fp = gmm.padded_widths(D, F, torch.bfloat16)
    assert (Dp % 8, Fp % 8) == (0, 0) and 0 <= Dp - D < 8 \
        and 0 <= Fp - F < 8
    assert gmm.padded_widths(D, F, torch.float32) == (D, F)
    (jx, jw), (x, w) = _arrays(BF16, (E, C, D), (E, D, F), seed=4)
    xp, wp = gmm.pad_operands(x, w)
    assert tuple(xp.shape) == (E, C, Dp) and tuple(wp.shape) == (E, Dp, Fp)
    if (Dp, Fp) == (D, F):
        assert xp is x and wp is w
    assert not xp[..., D:].any() and not wp[:, D:].any() \
        and not wp[..., F:].any()
    got = gmm.grouped_matmul_plain(xp, wp)[..., :F]
    _close(got, gmm.grouped_matmul_plain(x, w).float(), _rel(BF16))
    _close(got, jops.grouped_matmul(jx, jw, use_pallas=False), _rel(BF16))


# --------------------------------------------------------------------- #
# K10 wkv6
# --------------------------------------------------------------------- #
def _wkv6_inputs(B, T, H, K, seed=3):
    return _arrays(np.float32, *[(B, T, H, K)] * 4, (H, K), seed=seed,
                   scale=0.5)


@pytest.mark.parametrize("B,T,H,K,chunk", [
    (2, 16, 2, 8, 8),
    (1, 32, 4, 16, 16),
    (3, 8, 1, 4, 8),
])
def test_wkv6_matches_reference(B, T, H, K, chunk):
    jin, tin = _wkv6_inputs(B, T, H, K)
    got = ops.wkv6(*tin)
    assert tuple(got.shape) == (B, T, H, K)
    _close(got, jops.wkv6(*jin, use_pallas=True, interpret=True,
                          chunk=chunk), 1e-3)
    _close(ops.wkv6(*tin, use_kernel=False),
           jops.wkv6(*jin, use_pallas=False), 1e-3)


def test_wkv6_wide_head_matches_reference():
    """A head of 256 channels (twice what a thread's registers hold on
    the card) through ``ops.wkv6`` against the Pallas kernel in
    interpret mode and the oracle."""
    jin, tin = _wkv6_inputs(1, 8, 2, 256, seed=5)
    got = ops.wkv6(*tin)
    _close(got, jops.wkv6(*jin, use_pallas=True, interpret=True, chunk=8),
           1e-3)
    _close(got, jops.wkv6(*jin, use_pallas=False), 1e-3)


@pytest.mark.parametrize("K,fits", [(128, True), (129, True),
                                    (256, True), (1614, True),
                                    (1615, False)])
def test_wkv6_tiling_fits_a_thread_block(K, fits):
    """Above 128 channels K10 keeps at least 32 state columns per thread
    block in shared memory beside one staged step: only a head too wide
    even for that is refused, and there is no other limit on ``K``."""
    assert wkv6.fits_a_thread_block(K) is fits
    assert not hasattr(wkv6, "MAX_K")


@pytest.mark.parametrize("T", [1, 13])
def test_wkv6_any_length_matches_oracle(T):
    # T = 1 and a T no chunk divides (the Pallas kernel needs T % chunk)
    jin, tin = _wkv6_inputs(2, T, 3, 16, seed=4)
    _close(ops.wkv6(*tin), jops.wkv6(*jin, use_pallas=False), 1e-3)


def _tree_sum(parts):
    """``parts[0] + ... + parts[n - 1]`` as a balanced tree, pairs of
    neighbours first: ``((p0 + p1) + (p2 + p3)) + ...``."""
    while len(parts) > 1:
        parts = [parts[x] + parts[x + 1] for x in range(0, len(parts), 2)]
    return parts[0]


def _wkv6_kernel_walk(r, k, v, w, u):
    """K10's order on the card, in plain PyTorch, on ``(BH, T, K)``: the
    state padded to the kernel's register width ``W`` (rows and columns
    from ``K`` up hold zeros), its rows in ``GROUPS`` groups of ``W /
    GROUPS``, chunks of ``chunk_steps(K)`` steps.  For each step, group
    ``g``'s partial ``p_g = Σ_{i∈g} r_i S_ij`` in ascending ``i`` before
    the state's update; ``bonus = Σ_i (r_i u_i) k_i`` as the kernel's
    warp sums it (lane ``l`` adds channels ``l, l + 32, ...``, then the
    lanes' sums are halved: 16 onto 0, 8, 4, 2, 1); for each chunk, ``o =
    bonus v`` plus the partials' balanced tree."""
    BH, T, K = r.shape
    W, G = wkv6.register_width(K), wkv6.GROUPS
    R, L = W // G, wkv6.chunk_steps(K)
    r, k, v, w, u = (torch.nn.functional.pad(t.float(), (0, W - K))
                     for t in (r, k, v, w, u))
    decay = torch.exp(-torch.exp(w))
    decay[..., K:] = 0.0
    S = torch.zeros(BH, G, R, W)
    out = torch.empty(BH, T, W)
    for t0 in range(0, T, L):
        n = min(L, T - t0)
        ruk = (r[:, t0:t0 + n] * u[:, None] * k[:, t0:t0 + n]).view(
            BH, n, W // 32, 32)
        lanes = torch.zeros(BH, n, 32)
        for x in range(W // 32):
            lanes = lanes + ruk[:, :, x]
        while lanes.shape[-1] > 1:
            half = lanes.shape[-1] // 2
            lanes = lanes[..., :half] + lanes[..., half:]
        bonus = lanes[..., 0]
        part = torch.empty(BH, G, n, W)
        for tt in range(n):
            t = t0 + tt
            rt, kt, dt = (x[:, t].view(BH, G, R) for x in (r, k, decay))
            p = torch.zeros(BH, G, W)
            for q in range(R):
                p = p + rt[:, :, q, None] * S[:, :, q]
            S = dt[..., None] * S + kt[..., None] * v[:, t, None, None, :]
            part[:, :, tt] = p
        out[:, t0:t0 + n] = bonus[..., None] * v[:, t0:t0 + n] + _tree_sum(
            list(part.unbind(1)))
    return out[..., :K]


@pytest.mark.parametrize("T", [1, 37, 70])
@pytest.mark.parametrize("K", [16, 48, 64])
def test_wkv6_kernel_order_matches_pallas(K, T):
    """K10's walk (row groups, chunks that ``T`` need not fill, the fixed
    sum of the groups' partials) against ``wkv6_pallas`` in interpret
    mode on the same numpy inputs, float32, ``rtol`` 1e-5."""
    jin, tin = _arrays(np.float32, *[(3, T, K)] * 4, (3, K), seed=K + T,
                       scale=0.5)
    want = wkv6_pallas(*jin, chunk=T, interpret=True)
    _close(_wkv6_kernel_walk(*tin), want, 1e-5)


# --------------------------------------------------------------------- #
# K11 rglru
# --------------------------------------------------------------------- #
def _rglru_inputs(B, T, D, dtype, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    a = rng.uniform(0.05, 0.98, (B, T, D)).astype(np.float32)
    (jx, x), (ja, a) = _pair(x, dtype), _pair(a, dtype)
    return (jx, ja), (x, a)


@pytest.mark.parametrize("B,T,D,chunk", [(2, 16, 8, 8), (1, 64, 32, 16)])
def test_rglru_matches_reference(B, T, D, chunk):
    jin, tin = _rglru_inputs(B, T, D, np.float32)
    got = ops.rglru(*tin)
    assert got.dtype == tin[0].dtype
    _close(got, jops.rglru(*jin, use_pallas=True, interpret=True,
                           chunk=chunk), 1e-4)
    _close(ops.rglru(*tin, use_kernel=False),
           jops.rglru(*jin, use_pallas=False), 1e-4)


@pytest.mark.parametrize("B,T,D", [(2, 16, 8), (1, 64, 32)])
def test_rglru_bf16_matches_oracle(B, T, D):
    """bf16 against the reference's oracle only: its Pallas kernel stores
    the float32 state into the bf16 output and raises (ROADMAP queue 3)."""
    jin, tin = _rglru_inputs(B, T, D, BF16)
    got = ops.rglru(*tin)
    assert got.dtype == torch.bfloat16
    want = jops.rglru(*jin, use_pallas=False)
    _close(got, want, 5e-2)
    _close(ops.rglru(*tin, use_kernel=False), want, 5e-2)


@pytest.mark.parametrize("T", [1, 13])
def test_rglru_any_length_matches_oracle(T):
    jin, tin = _rglru_inputs(3, T, 10, np.float32, seed=6)
    _close(ops.rglru(*tin), jops.rglru(*jin, use_pallas=False), 1e-4)


def _rglru_tiled_walk(x, a):
    """K11's order on the card, in plain PyTorch: tiles of ``rglru.TILE``
    channels, each walked in stages of ``stage_steps`` steps, one float32
    operation at a time in the plain version's order."""
    B, T, D = x.shape
    L = rglru.stage_steps(x.dtype)
    out = torch.empty(B, T, D)
    for c0 in range(0, D, rglru.TILE):
        xs = x[..., c0:c0 + rglru.TILE].float()
        as_ = a[..., c0:c0 + rglru.TILE].float()
        h = torch.zeros(B, xs.shape[2])
        for t0 in range(0, T, L):
            for t in range(t0, min(T, t0 + L)):
                at = as_[:, t]
                g = torch.sqrt(torch.clamp(1.0 - at * at, 0.0, 1.0)) * xs[:, t]
                h = at * h + g
                out[:, t, c0:c0 + rglru.TILE] = h
    return out.to(x.dtype)


@pytest.mark.parametrize("B,T,D", [(2, 37, 200), (1, 50, 300),
                                   (2, 17, 130)])
def test_rglru_tiled_walk_matches_pallas(B, T, D):
    """K11's tiled walk (``D`` no tile divides, ``T`` no stage divides)
    against ``rglru_pallas`` in interpret mode, float32, ``rtol`` 1e-5."""
    jin, tin = _rglru_inputs(B, T, D, np.float32, seed=B + T + D)
    want = rglru_pallas(*jin, chunk=T, interpret=True)
    _close(_rglru_tiled_walk(*tin), want, 1e-5)


# --------------------------------------------------------------------- #
# K9 local_attn
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("T,H,D,window,bq", [
    (32, 2, 16, 12, 8),
    (64, 1, 32, 64, 16),   # window == T: degenerates to causal
    (16, 2, 8, 4, 8),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_local_attn_matches_reference(T, H, D, window, bq, dtype):
    (jq, jk, jv), (q, k, v) = _arrays(dtype, *[(1, T, H, D)] * 3, seed=7)
    native.reset_launch_counts()
    got = ops.local_attn(q, k, v, window)
    assert native.launch_counts()["local_attn"] == 0
    assert got.dtype == q.dtype and tuple(got.shape) == (1, T, H, D)
    _close(got, jops.local_attn(jq, jk, jv, window, use_pallas=True,
                                interpret=True, bq=bq, bk=bq), _rel(dtype))
    _close(ops.local_attn(q, k, v, window, use_kernel=False),
           jops.local_attn(jq, jk, jv, window, use_pallas=False),
           _rel(dtype))


@pytest.mark.parametrize("window", [12, 40, 1, 63, 64, 100])
def test_local_attn_is_exact_where_the_pallas_kernel_misses(window):
    """The port against the dense oracle in the setup that shows the
    reference's ``bq != bk`` fault (T = 64, one head, D = 16, seed 0;
    windows 12 and 40 miss by more than 1 there): the kernel's tiles are
    its own, so no tile argument can go wrong."""
    (jq, jk, jv), (q, k, v) = _arrays(np.float32, *[(1, 64, 1, 16)] * 3)
    got = local_attn_plain(q[:, :, 0], k[:, :, 0], v[:, :, 0], window)
    want = jops.local_attn(jq, jk, jv, window, use_pallas=False)
    _close(got, np.asarray(want)[:, :, 0], 1e-4)
    _close(ops.local_attn(q, k, v, window), want, 1e-4)


@pytest.mark.parametrize("T,window", [(37, 1), (37, 10), (37, 500),
                                      (130, 64), (531, 77), (600, 300)])
def test_local_attn_any_length_and_window_match_oracle(T, window):
    # T no tile divides; window 1 (the diagonal only) and window >= T;
    # bands across the plain version's query chunks
    (jq, jk, jv), (q, k, v) = _arrays(np.float32, *[(2, T, 2, 8)] * 3,
                                      seed=8)
    _close(ops.local_attn(q, k, v, window),
           jops.local_attn(jq, jk, jv, window, use_pallas=False), 1e-4)


def test_local_attn_rejects_unequal_heads_and_empty_windows():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="expand k/v"):
        ops.local_attn(q, kv, kv, 4)
    # an MQA caller expands the single kv head to the query heads
    out = ops.local_attn(q, kv.expand(1, 8, 4, 16), kv.expand(1, 8, 4, 16),
                         4)
    assert tuple(out.shape) == (1, 8, 4, 16)
    with pytest.raises(ValueError, match="window"):
        ops.local_attn(q, q, q, 0)


@pytest.mark.parametrize("D", [36, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_local_attn_zero_padded_head_gives_the_unpadded_result(D, dtype):
    """The identity the bf16 wrapper's padding relies on: q, k and v
    zero-padded to the head size the kernel takes (D rounded up to 8; 40
    needs none), the original D's scale, the padded columns sliced off:
    zero columns add exact zeros to q.k and give zero output columns, so
    the result is the unpadded one bit for bit."""
    (jq, jk, jv), (q, k, v) = _arrays(dtype, *[(1, 70, 2, D)] * 3,
                                      seed=D)
    Dp = padded_head(D, torch.bfloat16)
    assert Dp == 40 and padded_head(D, torch.float32) == D
    folded = [t[0].transpose(0, 1) for t in (q, k, v)]       # (H, T, D)
    padded = [torch.nn.functional.pad(t, (0, Dp - D)) for t in folded]
    got = local_attn_plain(*padded, 20, D ** -0.5)[..., :D]
    assert torch.equal(got, local_attn_plain(*folded, 20))
    want = jops.local_attn(jq, jk, jv, 20, use_pallas=False)
    _close(got.transpose(0, 1)[None], want, _rel(dtype))


def _close_bf16(got, want):
    """PERF.md's element bound for bf16: the smaller of ``1e-2 * max(1,
    max|want|)`` and ``2**-7 |want| + 2**-4 rms(want)``."""
    got, want = got.double(), want.double()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert float(err.max()) <= 1e-2 * max(1.0, float(want.abs().max()))
    tol = 2.0 ** -7 * want.abs() + 2.0 ** -4 * want.square().mean().sqrt()
    assert not bool((err > tol).any()), float(err.max())


def _local_attn_tc_walk(q, k, v, window):
    """K9 bf16's order on the card, in plain PyTorch: 128-row query tiles
    of two 64-row halves (the consumer warpgroups), each walking the
    64-row key tiles from the one holding ``max(0, q0 - window + 1)`` to
    the one holding ``q1 - 1``.  A tile wholly outside a half's band is
    skipped and one wholly inside takes no mask, by the kernel's integer
    tests, which are checked against the mask here.  Online softmax in
    base 2 (``exp2(s log2e - m log2e)``), ``p`` rounded to bf16 for
    ``P V``, ``l`` summed from the float32 ``p``."""
    BH, T, D = q.shape
    window = min(window, T)
    log2e = torch.tensor(1.4426950408889634)
    zeros = torch.zeros(BH, 128, D)
    qs = torch.cat([(q.float() * D ** -0.5).to(q.dtype).float(), zeros], 1)
    kf = torch.cat([k.float(), zeros[:, :64]], 1)
    vf = torch.cat([v.float(), zeros[:, :64]], 1)
    out = torch.empty(BH, T, D)
    for q0 in range(0, T, 128):
        q1 = min(q0 + 128, T)
        kb0, kb1 = max(0, q0 - window + 1) // 64, (q1 - 1) // 64
        for qa in (q0, q0 + 64):
            rows = torch.arange(qa, qa + 64)
            m = torch.full((BH, 64), -torch.inf)
            l = torch.zeros(BH, 64)
            o = torch.zeros(BH, 64, D)
            for kb in range(kb0, kb1 + 1):
                k0 = kb * 64
                d = rows[:, None] - torch.arange(k0, k0 + 64)[None]
                band = (d >= 0) & (d < window)
                outside = k0 > qa + 63 or k0 + 63 <= qa - window
                inside = k0 + 63 <= qa and k0 > qa + 63 - window
                assert outside == (not bool(band.any()))
                assert inside == bool(band.all())
                if outside:
                    continue
                s = qs[:, qa:qa + 64] @ kf[:, k0:k0 + 64].mT
                if not inside:
                    s = torch.where(band, s, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1))
                ms = torch.where(m_new == -torch.inf, 0.0, m_new * log2e)
                alpha = torch.exp2(m * log2e - ms)
                p = torch.exp2(s * log2e - ms[..., None])
                l = alpha * l + p.sum(-1)
                o = alpha[..., None] * o + \
                    p.to(torch.bfloat16).float() @ vf[:, k0:k0 + 64]
                m = m_new
            res = o / l.clamp(min=1e-30)[..., None]
            n = max(0, min(64, T - qa))
            out[:, qa:qa + n] = res[:, :n]
    return out.to(q.dtype)


@pytest.mark.parametrize("T,D,window", [
    (127, 8, 50), (129, 36, 63), (257, 40, 64), (300, 16, 65),
    (300, 8, 1), (200, 8, 1000), (700, 8, 200), (1100, 8, 300),
])
def test_local_attn_bf16_kernel_walk_matches_plain(T, D, window):
    """The bf16 tensor-core kernel's tile walk and its skip / no-mask
    tests, against the plain version (PERF.md's bf16 element bound) and
    the JAX oracle, at lengths on both sides of a 128-row query tile and
    windows on both sides of a 64-row key tile."""
    (jq, jk, jv), (q, k, v) = _arrays(BF16, *[(1, T, 2, D)] * 3,
                                      seed=T + D)
    folded = [t[0].transpose(0, 1).contiguous() for t in (q, k, v)]
    got = _local_attn_tc_walk(*folded, window)
    _close_bf16(got, local_attn_plain(*folded, window))
    _close(got.transpose(0, 1)[None],
           jops.local_attn(jq, jk, jv, window, use_pallas=False),
           _rel(BF16))


def _local_attn_f32_walk(q, k, v, window):
    """K9 float32's order on the card, in plain PyTorch: ``D`` zero-padded
    to :func:`padded_head`'s multiple of 4 (the original ``D``'s scale),
    64-row query tiles walking the 64-row key tiles from the one holding
    ``max(0, q0 - window + 1)`` to the one holding ``q1 - 1``.  ``Q Kᵀ``
    is summed per quarter of d (quads ds, ds + 4, ...) and the quarters
    added as the lanes' shuffles add them: row ``r`` of a warp's 8 is
    owned by ``ds = r % 8 // 2`` and gets ``(s[ds] + s[ds ^ 2]) + (s[ds ^
    1] + s[ds ^ 3])``.  A warp's 8 rows skip the mask on a tile they hold
    whole, by the kernel's integer test, checked against the mask here.
    Online softmax from ``m = -1e30``: ``p = exp(s - m_new)`` (0 outside
    the band), ``l = alpha l + sum p``, ``acc = alpha acc + p v``, then
    ``acc / max(l, 1e-30)``."""
    BH, T, D = q.shape
    Dp = padded_head(D, torch.float32)
    window = min(window, T)
    zeros = torch.zeros(BH, 64, Dp)

    def tiles(t, scale=1.0):
        t = torch.nn.functional.pad(t.float() * scale, (0, Dp - D))
        return torch.cat([t, zeros], 1)

    qs, kf, vf = tiles(q, D ** -0.5), tiles(k), tiles(v)
    quads = torch.arange(Dp).view(-1, 4)
    cols = [quads[ds::4].reshape(-1) for ds in range(4)]
    own = torch.arange(64) % 8 // 2                  # each row's lane ds
    order = torch.stack([own, own ^ 2, own ^ 1, own ^ 3])
    out = torch.empty(BH, T, D)
    for q0 in range(0, T, 64):
        q1 = min(q0 + 64, T)
        kb0, kb1 = max(0, q0 - window + 1) // 64, (q1 - 1) // 64
        rows = torch.arange(q0, q0 + 64)
        m = torch.full((BH, 64), -1e30)
        l = torch.zeros(BH, 64)
        o = torch.zeros(BH, 64, Dp)
        for kb in range(kb0, kb1 + 1):
            k0 = kb * 64
            d = rows[:, None] - torch.arange(k0, k0 + 64)[None]
            band = (d >= 0) & (d < window)
            part = torch.stack([qs[:, q0:q0 + 64, c] @
                                kf[:, k0:k0 + 64, c].mT for c in cols])
            pick = [part[order[x], :, torch.arange(64)].transpose(0, 1)
                    for x in range(4)]
            s = (pick[0] + pick[1]) + (pick[2] + pick[3])
            for w in range(8):
                w0 = q0 + 8 * w
                whole = k0 + 63 <= w0 and k0 > w0 + 7 - window
                assert whole == bool(band[8 * w:8 * w + 8].all())
            s = torch.where(band, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(band, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            o = alpha[..., None] * o + p @ vf[:, k0:k0 + 64]
            m = m_new
        res = o / l.clamp(min=1e-30)[..., None]
        out[:, q0:q1] = res[:, :q1 - q0, :D]
    return out


@pytest.mark.parametrize("T,D,window", [
    (63, 8, 63), (64, 16, 64), (65, 37, 65), (127, 40, 50), (129, 36, 1),
    (200, 8, 8), (257, 13, 129), (300, 64, 63), (300, 20, 400),
    (40, 3, 1000),
])
def test_local_attn_f32_kernel_walk_matches_plain(T, D, window):
    """The float32 CUDA-core kernel's tile walk, its quarter-of-d sums and
    their shuffle order, and its whole-tile test, against the plain
    version and the JAX oracle (``1e-4 * max(1, max|want|)``, float32), at
    lengths on both sides of a 64-row tile, windows on both sides of one
    and of a warp's 8 rows, window 1, a window longer than ``T``, and
    heads the kernel pads to a multiple of 4."""
    (jq, jk, jv), (q, k, v) = _arrays(np.float32, *[(1, T, 2, D)] * 3,
                                      seed=T + D + window)
    folded = [t[0].transpose(0, 1).contiguous() for t in (q, k, v)]
    got = _local_attn_f32_walk(*folded, window)
    _close(got, local_attn_plain(*folded, window), 1e-4)
    _close(got.transpose(0, 1)[None],
           jops.local_attn(jq, jk, jv, window, use_pallas=False), 1e-4)


def test_local_attn_f32_pads_heads_to_whole_16_byte_rows():
    """The float32 kernel's ``cp.async`` copies whole 16-byte rows: the
    wrapper pads ``D`` to a multiple of 4 (bf16's TMA to 8)."""
    assert [padded_head(D, torch.float32) for D in (1, 4, 37, 254, 256)] \
        == [4, 4, 40, 256, 256]
    assert [padded_head(D, torch.bfloat16) for D in (1, 37, 254)] == \
        [8, 40, 256]


# --------------------------------------------------------------------- #
# precisions per kernel
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("stem,dtype", [
    ("reduce", torch.bfloat16), ("tttp", torch.bfloat16),
    ("grouped_matmul", torch.float64), ("wkv6", torch.float64),
    ("local_attn", torch.float16), ("rglru", torch.float16),
])
def test_launch_rejects_a_precision_the_kernel_lacks(stem, dtype):
    native.reset_launch_counts()
    with pytest.raises(TypeError, match=f"kernel '{stem}' takes"):
        native.launch(stem, dtype, torch.device("cpu"))
    assert native.KERNELS[stem].launches == 0


def test_every_kernel_has_its_precisions():
    lm = {"grouped_matmul", "local_attn", "wkv6", "rglru"}
    for stem, info in native.KERNELS.items():
        want = ((torch.float32, torch.bfloat16) if stem in lm
                else (torch.float32, torch.float64))
        assert info.dtypes == want, stem
