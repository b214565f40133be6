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
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import native, ops, wkv6  # noqa: E402
from repro_torch.kernels.local_attn import local_attn_plain  # noqa: E402

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
