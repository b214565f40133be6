"""The port's distributed host layer, held to the JAX package in-process.

No ranks here (``tests/test_torch_dist_engines.py`` runs real gloo
ranks): the reference's ``partition_mesh`` reads only its mesh's axis
sizes, so a ``SimpleNamespace(shape={...})`` stands in for a mesh on
both sides, and the port's host functions also take the plain mapping.

* ``partition_mesh`` equals the reference's bit for bit — padded
  arrays, permutation, factor permutations, shardings, local shape and
  spec, pad sizes, reduce axes — on MTTKRP, TTMc3 and TTTP3, mode 0 and
  modes 0 and 1, cyclic and block partitions;
* ``partition_nonzeros`` and ``undo_cyclic_plan`` / ``undo_cyclic``
  (numpy and tensors) equal the reference's; ``shard_mesh_key``'s
  doctest runs;
* ``unpad_local_csf`` inverts the padding bit for bit (Hypothesis,
  mirroring ``tests/test_stacked_hypothesis.py``), and the padded segment
  tails stay sorted;
* the stackability walk: ``plan_layout_walk``'s verdict and layout
  requests and ``stackable_diagnostics``' codes equal the reference's
  for every candidate path of the paper specs, fused and not, and
  ``verify_plan(stacked=True)`` gives the same codes;
* a ``ShardArrays`` operand runs the engines on its padded segment maps;
  with no ``device`` the entry points run on CUDA and raise where there
  is none.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.analysis import invariants as jinv  # noqa: E402
from repro.analysis import verify_plan as j_verify_plan  # noqa: E402
from repro.core import paths as jpaths  # noqa: E402
from repro.core import spec as JS  # noqa: E402
from repro.core.planner import plan as j_plan  # noqa: E402
from repro.distributed import spttn_dist as jd  # noqa: E402
from repro.sparse import random_sparse as j_random_sparse  # noqa: E402
from repro_torch.analysis import invariants as tinv  # noqa: E402
from repro_torch.analysis import verify_plan  # noqa: E402
from repro_torch.core import paths as tpaths  # noqa: E402
from repro_torch.core import spec as TS  # noqa: E402
from repro_torch.core.executor import (CSFArrays, execute_plan,  # noqa: E402
                                       make_executor)
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.distributed import spttn_dist as td  # noqa: E402
from repro_torch.sparse import COOTensor, build_csf  # noqa: E402
from repro_torch.sparse.csf import level_segments  # noqa: E402

SHAPE = (13, 9, 7)
SPECS = {"mttkrp": (13, 9, 7, 4), "ttmc3": (13, 9, 7, 3, 2),
         "tttp3": (13, 9, 7, 4)}
# every paper spec the walk is held on (name -> args)
WALK_SPECS = {"mttkrp": (8, 6, 5, 4), "ttmc3": (8, 6, 5, 3, 2),
              "ttmc4": (6, 5, 4, 3, 2, 2, 2), "tttp3": (8, 6, 5, 4),
              "sddmm": (8, 6, 4), "tttc6": (3, 2)}


def _coos(seed=0, density=0.15, shape=SHAPE):
    """The reference's random tensor and the same arrays as the port's
    COO."""
    j = j_random_sparse(shape, density, seed=seed)
    return j, COOTensor(coords=j.coords.copy(), values=j.values.copy(),
                        shape=j.shape)


def _mesh(mode_axis):
    sizes = {"data": 4} if len(mode_axis) == 1 else {"data": 2, "model": 2}
    return types.SimpleNamespace(shape=sizes), sizes


def _spec_out(spec_tuple):
    """A reference PartitionSpec as the port's tuple (a one-axis tuple
    entry, which newer JAX may keep or flatten, as the bare axis)."""
    def norm(e):
        return e[0] if isinstance(e, tuple) and len(e) == 1 else e
    return tuple(norm(e) for e in spec_tuple)


@pytest.mark.parametrize("cyclic", [True, False])
@pytest.mark.parametrize("mode_axis", [{0: "data"}, {0: "data", 1: "model"}])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_partition_mesh_equals_the_reference(name, mode_axis, cyclic):
    jcoo, tcoo = _coos()
    jspec, tspec = (getattr(m, name)(*SPECS[name]) for m in (JS, TS))
    ns, sizes = _mesh(mode_axis)
    want = jd.partition_mesh(jspec, jcoo, ns, mode_axis, cyclic=cyclic)
    for mesh in (ns, sizes):
        got = td.partition_mesh(tspec, tcoo, mesh, mode_axis, cyclic=cyclic)
        assert got.nshards == want.nshards == 4
        assert got.order == want.order
        assert got.local_shape == want.local_shape
        assert got.max_nnz == want.max_nnz
        assert got.max_nfib == want.max_nfib
        assert got.part_axes == want.part_axes
        assert got.reduce_axes == want.reduce_axes
        assert got.local_spec.dims == want.local_spec.dims
        np.testing.assert_array_equal(got.perm, want.perm)
        for gp, wp, gs in zip(got.packed, want.packed, got.stacked):
            assert sorted(gp) == sorted(wp)
            for k in wp:
                assert gp[k].dtype == wp[k].dtype, k
                np.testing.assert_array_equal(gp[k], wp[k])
                np.testing.assert_array_equal(gs[k].numpy(), wp[k])
        assert got.factor_perm.keys() == want.factor_perm.keys()
        for k, w in want.factor_perm.items():
            g = got.factor_perm[k]
            assert (g is None) == (w is None), k
            if w is not None:
                assert g[0] == w[0]
                np.testing.assert_array_equal(g[1], w[1])
        assert {k: _spec_out(v) for k, v in want.factor_specs.items()} == \
            {k: _spec_out(v) for k, v in got.factor_specs.items()}
        assert _spec_out(want.out_spec) == _spec_out(got.out_spec)


@pytest.mark.parametrize("cyclic", [True, False])
@pytest.mark.parametrize("nparts", [{0: 4}, {0: 2, 1: 2}, {1: 3}])
def test_partition_nonzeros_and_undo_cyclic_equal_the_reference(nparts,
                                                                cyclic):
    jcoo, tcoo = _coos(seed=3)
    want = jd.partition_nonzeros(jcoo, nparts, cyclic=cyclic)
    got = td.partition_nonzeros(tcoo, nparts, cyclic=cyclic)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.coords, w.coords)
        np.testing.assert_array_equal(g.values, w.values)
    axes = ("data", "model")
    mode_axis = {m: axes[i] for i, m in enumerate(sorted(nparts))}
    sizes = {axes[i]: n for i, (m, n) in enumerate(sorted(nparts.items()))}
    for name in ("mttkrp", "ttmc3"):
        jspec, tspec = (getattr(m, name)(*SPECS[name]) for m in (JS, TS))
        wplan = jd.undo_cyclic_plan(jspec, mode_axis,
                                    types.SimpleNamespace(shape=sizes),
                                    SHAPE, cyclic=cyclic)
        gplan = td.undo_cyclic_plan(tspec, mode_axis, sizes, SHAPE,
                                    cyclic=cyclic)
        assert [a for a, _ in gplan] == [a for a, _ in wplan]
        for (_, g), (_, w) in zip(gplan, wplan):
            np.testing.assert_array_equal(g, w)
        rows = -(-SHAPE[0] // sizes["data"]) * sizes["data"]
        out = np.random.default_rng(0).standard_normal(
            (rows,) + tuple(tspec.dims[i] for i in tspec.output.indices[1:]))
        want_out = jd.undo_cyclic(out, jspec, mode_axis,
                                  types.SimpleNamespace(shape=sizes), SHAPE,
                                  cyclic=cyclic)
        np.testing.assert_array_equal(
            td.undo_cyclic(out, tspec, mode_axis, sizes, SHAPE,
                           cyclic=cyclic), want_out)
        np.testing.assert_array_equal(
            td.undo_cyclic(torch.from_numpy(out), tspec, mode_axis, sizes,
                           SHAPE, cyclic=cyclic).numpy(), want_out)


def test_shard_mesh_key_and_its_doctest():
    import doctest
    res = doctest.testmod(td, optionflags=doctest.ELLIPSIS
                          | doctest.NORMALIZE_WHITESPACE)
    assert res.attempted > 0 and res.failed == 0
    for shard in range(4):
        assert td.shard_mesh_key({"model": 2, "data": 2},
                                 {1: "model", 0: "data"}, shard) == \
            jd.shard_mesh_key({"model": 2, "data": 2},
                              {1: "model", 0: "data"}, shard)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), nshards=st.sampled_from([1, 2, 3, 4]),
       density=st.floats(0.02, 0.4))
def test_pad_unpad_round_trip(seed, nshards, density):
    spec = TS.mttkrp(13, 9, 7, 4)
    _, coo = _coos(seed=seed, density=density)
    if coo.nnz == 0:
        return
    part = td.partition_mesh(spec, coo, {"data": nshards}, {0: "data"})
    total = 0
    for s, csf in enumerate(part.csfs):
        back = td.unpad_local_csf(part.packed[s], csf.order, csf.nnz,
                                  csf.nfib)
        np.testing.assert_array_equal(back["values"], csf.values)
        for p in range(1, csf.order + 1):
            fc = csf.fiber_coords(p)
            for m in range(p):
                np.testing.assert_array_equal(back[f"coord_{p}_{m}"],
                                              fc[:, m])
        for child in range(1, csf.order + 1):
            for par in range(0, child):
                np.testing.assert_array_equal(
                    back[f"seg_{child}_{par}"],
                    level_segments(csf, child, par))
                seg = part.packed[s][f"seg_{child}_{par}"]
                assert (np.diff(seg) >= 0).all(), (s, child, par)
        total += csf.nnz
    assert total == coo.nnz           # the partition is a disjoint cover


def _walk_cases():
    for name, args in WALK_SPECS.items():
        jspec, tspec = getattr(JS, name)(*args), getattr(TS, name)(*args)
        jps = list(jpaths.enumerate_paths(jspec))
        tps = list(tpaths.enumerate_paths(tspec))
        assert [[str(t) for t in p] for p in jps] == \
            [[str(t) for t in p] for p in tps]
        yield name, jspec, tspec, jps, tps


def test_stackability_walk_equals_the_reference():
    """Every candidate path of every paper spec, fused and not: the
    walk's verdict and requests under two strategy choices, and the
    diagnostics' codes."""
    checked = stackable = 0
    for name, jspec, tspec, jps, tps in _walk_cases():
        for jp, tp in zip(jps, tps):
            for fused in (False, True):
                jch = jinv.fusible_chains(jspec, jp) if fused else {}
                tch = tinv.fusible_chains(tspec, tp) if fused else {}
                assert jch == tch
                for row_for in (lambda lvl, out: False,
                                lambda lvl, out: (lvl + out) % 2 == 1):
                    assert tinv.plan_layout_walk(tspec, tp, tch, row_for) \
                        == jinv.plan_layout_walk(jspec, jp, jch, row_for)
                want = [d.code for d in jinv.stackable_diagnostics(
                    jspec, jp, fused=fused)]
                got = [d.code for d in tinv.stackable_diagnostics(
                    tspec, tp, fused=fused)]
                assert got == want, (name, [str(t) for t in tp], fused)
                assert td.stackable_plan(tspec, tp, fused=fused) == \
                    jd.stackable_plan(jspec, jp, fused=fused)
                checked += 1
                stackable += not got
    assert checked > 50 and 0 < stackable < checked


@pytest.mark.parametrize("name", sorted(WALK_SPECS))
def test_verify_plan_stacked_gives_the_reference_codes(name):
    args = WALK_SPECS[name]
    jspec, tspec = getattr(JS, name)(*args), getattr(TS, name)(*args)
    jp, tp = j_plan(jspec), plan(tspec)
    for fused in (False, True):
        for stacked in (False, True):
            want = j_verify_plan(jp, fused=fused, stacked=stacked,
                                 backend="xla").codes
            got = verify_plan(tp, fused=fused, stacked=stacked).codes
            assert got == want, (fused, stacked)
    if jspec.output_is_sparse:
        assert "SPTTN-E052" in verify_plan(tp, stacked=True).codes


def test_shard_arrays_run_the_engines_on_the_padded_maps():
    """A padded shard on the CPU: the layouts are cut from the padded
    segment maps (pad tail in the last segment), the segment sums' rows
    end at the shard's own, its pad fibers repeat coordinate 0, and
    every engine gives the unpadded shard's output."""
    spec = TS.mttkrp(13, 9, 7, 4)
    _, coo = _coos(seed=5)
    part = td.partition_mesh(spec, coo, {"data": 2}, {0: "data"})
    rng = np.random.default_rng(1)
    factors = {"B": rng.standard_normal((9, 4)).astype(np.float32),
               "C": rng.standard_normal((7, 4)).astype(np.float32)}
    p = plan(part.local_spec)
    for s, csf in enumerate(part.csfs):
        arrays = td._unpack_csf(part.stacked[s], part.order, part.max_nfib,
                                part.local_shape, "cpu", csf.nfib)
        assert not arrays.distinct_fibers and CSFArrays.distinct_fibers
        np.testing.assert_array_equal(
            arrays.host_segments(3, 1), part.packed[s]["seg_3_1"])
        # the segment sums' row ranges end at the shard's own rows
        ptr = arrays.segment_ptr(3, 2).numpy()
        assert ptr[-1] == csf.nnz and len(ptr) == part.max_nfib[2] + 1
        np.testing.assert_array_equal(
            ptr[:csf.nfib[2] + 1],
            np.searchsorted(level_segments(csf, 3, 2),
                            np.arange(csf.nfib[2] + 1)))
        want = execute_plan(p, csf, factors, device="cpu").numpy()
        for backend, kw in (("torch", {}), ("cuda", {"block": 8}),
                            ("cuda", {"block": 8, "strategy": "fused"}),
                            ("cuda-splitk", {"block": 8})):
            ex = make_executor(part.local_spec, p.path, p.order,
                               backend=backend, **kw)
            got = ex(arrays, factors).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * max(1, np.abs(want).max()))


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TS.mttkrp(13, 9, 7, 4)
    _, coo = _coos()
    p = plan(spec)
    for entry in (td.make_distributed, td.make_distributed_cuda):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(spec, p, coo, {"data": 1}, {0: "data"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.make_distributed_tuned(spec, coo, {"data": 1}, {0: "data"})
    tttp = TS.tttp3(13, 9, 7, 4)
    with pytest.raises(ValueError, match="dense output"):
        td.make_distributed_cuda(tttp, plan(tttp), coo, {"data": 1},
                                 {0: "data"}, device="cpu")
    with pytest.raises(ValueError, match="dense output"):
        td.make_distributed_tuned(tttp, coo, {"data": 1}, {0: "data"},
                                  device="cpu")
    assert dataclasses.is_dataclass(td.ShardArrays)


def test_rank_shards_and_owners_follow_mode_axis_order():
    """A rank's shard is its coordinates along the partition axes in
    ``mode_axis`` order (the reference's owner enumeration); a shard's
    owner is its replica at coordinate 0 on every other axis."""
    ranks = torch.arange(4).reshape(2, 2)          # (data, model)

    def mesh_of(rank):
        coord = dict(zip(("data", "model"), divmod(rank, 2)))
        return types.SimpleNamespace(
            mesh_dim_names=("data", "model"), shape=(2, 2), mesh=ranks,
            get_local_rank=coord.__getitem__)

    want = {("data",): [0, 2], ("model",): [0, 1],
            ("data", "model"): [0, 1, 2, 3], ("model", "data"): [0, 2, 1, 3]}
    for axes, owners in want.items():
        assert td.shard_owners(mesh_of(0), axes) == owners
        for rank in range(4):
            shard, first = td.rank_shard(mesh_of(rank), axes)
            assert (owners[shard] == rank) == first
