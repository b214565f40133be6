"""The port's dry-run tools held to the JAX package's.

* ``roofline``: ``model_flops``, ``active_params``, ``total_params``,
  ``_cache_bytes`` and ``analytic_memory``'s byte terms equal the
  reference's for every architecture x shape (the port's configs are the
  reference's, field for field); the hardware constants are the H100's;
* ``dryrun.abstract_params``: every leaf's shape and dtype, and the
  specs tree, equal the reference's ``jax.eval_shape`` of its init;
* ``report``: both tables equal the reference's strings for one results
  list (the fit column named for the card's 80 GB);
* ``dryrun.lower_cell`` on a fake ``(4, 2)`` mesh with a reduced config:
  the reference's keys, argument bytes equal to the rank's shards and
  rows, and ``None`` with a reason where a field has no counterpart;
* ``roofline.CollectiveBytes``: the reference parser's dict, counting
  what ``CommDebugMode`` counts.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import report as JR  # noqa: E402
from repro.launch import roofline as JRF  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import report as R  # noqa: E402
from repro_torch.launch import roofline as RF  # noqa: E402

# the reference's lower_cell keys (src/repro/launch/dryrun.py, lower_cell)
REFERENCE_KEYS = {"arch", "shape", "mesh", "preset", "n_devices", "lower_s",
                  "compile_s", "cost", "memory", "cost_corrected",
                  "probe_body", "collectives_probe", "collectives",
                  "analytic_memory", "roofline"}


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_arithmetic_equals_the_reference(arch):
    assert tuple(J_ARCHS) == tuple(ARCHS)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert RF.active_params(cfg) == JRF.active_params(jcfg)
    assert RF.total_params(cfg) == JRF.total_params(jcfg)
    for name in SHAPES:
        sc, jsc = SHAPES[name], J_SHAPES[name]
        assert RF.model_flops(cfg, sc) == JRF.model_flops(jcfg, jsc)
        assert RF._cache_bytes(cfg, sc) == JRF._cache_bytes(jcfg, jsc)
        for n_dev, mp in ((256, False), (512, True)):
            got = RF.analytic_memory(cfg, sc, n_dev, mp)
            want = JRF.analytic_memory(jcfg, jsc, n_dev, mp)
            assert got.pop("fits_80GB") == (got["total_per_dev_B"]
                                            < 80e9)
            want.pop("fits_16GiB")
            assert got == want, (name, n_dev)


def test_the_hardware_is_the_h100s():
    """Only the constants differ: each term is the reference's seconds
    times the ratio of the two machines' rates."""
    assert (RF.PEAK_FLOPS, RF.HBM_BW, RF.NVLINK_BW, RF.HBM_BYTES) == (
        989e12, 3.35e12, 450e9, 80e9)
    cfg, jcfg = get_config("granite-moe-1b-a400m"), j_get_config(
        "granite-moe-1b-a400m")
    res = {"cost": {"flops": 3e14, "bytes_accessed": 2e12},
           "collectives": {"wire_bytes": 5e9}}
    got = RF.roofline_terms(res, cfg, SHAPES["train_4k"], 256)
    want = JRF.roofline_terms(res, jcfg, J_SHAPES["train_4k"], 256)
    for k, ratio in (("compute_s", JRF.PEAK_FLOPS / RF.PEAK_FLOPS),
                     ("memory_s", JRF.HBM_BW / RF.HBM_BW),
                     ("collective_s", JRF.ICI_BW / RF.NVLINK_BW)):
        assert got[k] == pytest.approx(want[k] * ratio, rel=1e-12)
    for k in ("model_flops_total", "model_flops_per_dev",
              "hlo_flops_per_dev", "useful_flops_ratio"):
        assert got[k] == want[k]
    with open(RF.__file__) as fh:
        src = fh.read()
    # no TPU v5e rate or memory size anywhere in the module
    assert not re.search(r"\b(197e12|819e9|50e9)\b|16 \* 2 \*\* 30|"
                         r"v5e|TPU", src)


def _reference_abstract(arch):
    from repro.models import transformer as JT
    box = {}

    def init(k):
        p, s = JT.model_init(k, j_get_config(arch))
        box["s"] = s
        return p
    return jax.eval_shape(init, jax.random.PRNGKey(0)), box["s"]


def _leaves(tree, path=(), out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], path + (str(k),), out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _leaves(v, path + (str(i),), out)
    else:
        out["/".join(path)] = tree
    return out


def test_abstract_params_equal_the_references_eval_shape():
    from repro_torch.launch.dryrun import abstract_params
    from repro_torch.models.layers import tree_leaves
    for arch in ARCHS:
        jp, js = _reference_abstract(arch)
        p, s = abstract_params(get_config(arch))
        assert s == js, arch
        got, want = _leaves(p), _leaves(jp)
        assert list(got) == list(want), arch
        for k, t in got.items():
            assert tuple(t.shape) == tuple(want[k].shape), (arch, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype), (
                arch, k)
        # nothing was allocated: every leaf is a fake tensor
        assert all(type(t).__name__ == "FakeTensor" for t in tree_leaves(p))


def _results():
    """One results list of each kind of row the tables print."""
    base = {"preset": "2d", "compile_s": 1.5,
            "memory": {"argument_size_in_bytes": 123 * 2 ** 20},
            "collectives": {"wire_bytes": 7.5e9}}
    rows = []
    for i, (mesh, dom, useful) in enumerate((
            ("16x16", "compute", 0.8), ("16x16", "compute", 0.2),
            ("16x16", "collective", 0.9), ("2x16x16", "compute", 0.7))):
        am = {"total_per_dev_B": (5 + i) * 2 ** 30}
        am["fits_16GiB"] = am["fits_80GB"] = i % 2 == 0
        rows.append({**base, "arch": f"arch{i}", "shape": "train_4k",
                     "mesh": mesh, "cost": {"flops": 3.2e12 * (i + 1)},
                     "cost_corrected": {"flops": 3.3e12 * (i + 1)},
                     "analytic_memory": am,
                     "roofline": {"compute_s": 0.0123 * (i + 1),
                                  "memory_s": 0.004, "collective_s": 0.2,
                                  "bottleneck": dom,
                                  "model_flops_total": 1.5e15 * (i + 1),
                                  "useful_flops_ratio": useful}})
    rows[1]["preset"] = "seq_parallel"
    rows.append({"arch": "x", "shape": "long_500k", "mesh": "16x16",
                 "skipped": "pure full-attention arch: long_500k skipped"})
    rows.append({"arch": "y", "shape": "decode_32k", "mesh": "16x16",
                 "error": "ValueError: something went wrong in the cell"})
    return rows


def test_report_tables_equal_the_references_strings():
    rows = _results()
    want = JR.dryrun_table(rows).replace("| fits 16GiB |", "| fits 80GB |")
    assert R.dryrun_table(rows) == want
    for mesh in ("16x16", "2x16x16"):
        assert R.roofline_table(rows, mesh) == JR.roofline_table(rows, mesh)


def test_lower_cell_on_a_fake_4x2_mesh():
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.dryrun import abstract_params, lower_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import tree_leaves
    cfg = get_reduced("granite-moe-1b-a400m")
    sc = ShapeConfig("train_4k", 32, 8, "train")
    res = lower_cell(cfg.name, sc, False, cfg_override=cfg,
                     mesh_shape=(4, 2))
    assert not dist.is_initialized()
    got = set(res) - {"unavailable"}
    for k in REFERENCE_KEYS - got:
        assert k in res["unavailable"], k
    assert got <= REFERENCE_KEYS
    assert res["compile_s"] is None and "compile_s" in res["unavailable"]
    assert (res["mesh"], res["n_devices"]) == ("4x2", 8)
    assert res["cost_corrected"] == res["cost"]
    assert res["cost"]["flops"] > 0 and res["cost"]["bytes_accessed"] > 0
    assert set(res["collectives"]) == set(
        JRF.collective_bytes_from_hlo("", []))
    per_op = res["collectives"]["per_op_bytes"]
    assert per_op["all-gather"] > 0 and per_op["reduce-scatter"] > 0
    mem = res["memory"]
    assert mem["temp_size_in_bytes"] > 0
    # argument bytes: the rank's shards of params, m and v, the step,
    # and its 2 of the batch's 8 rows of tokens and labels
    from repro_torch.launch.dryrun import fake_world
    params, specs = abstract_params(cfg)
    with fake_world(8):
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        sh = SH.tree_sharding(params, specs,
                              SH.default_rules(False, "train"), mesh)
        local = 0
        for t, s in zip(tree_leaves(params), tree_leaves(sh)):
            n = t.numel()
            for i, _ in s.sharded_dims():
                n //= mesh.shape[i]
            local += n * (t.element_size() + 4 + 4)
    assert mem["argument_size_in_bytes"] == local + 4 + 2 * (2 * 32 * 4)
    assert set(res["roofline"]) == set(JRF.roofline_terms(
        {"cost": {"flops": 1.0}}, j_get_config("granite-moe-1b-a400m"),
        J_SHAPES["train_4k"], 8))


def test_collective_bytes_counts_what_comm_debug_mode_counts():
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.dryrun import fake_world
    with fake_world(8):
        x = torch.ones(16, dtype=torch.float32)
        with CommDebugMode() as cdm, RF.CollectiveBytes() as c:
            out = torch.empty(8 * 16)
            dist.all_gather_into_tensor(out, x)
            dist.reduce_scatter_tensor(torch.empty(2), x)
            dist.all_reduce(x)
        got = c.summary()
        assert got["n_collectives"] == cdm.get_total_counts() == 3
    assert got["per_op_bytes"] == {"all-gather": 8 * 16 * 4,
                                   "reduce-scatter": 2 * 4,
                                   "all-reduce": 16 * 4}
    assert got["wire_bytes"] == 8 * 16 * 4 + 2 * 4 + 2 * 16 * 4
    assert set(got) == set(JRF.collective_bytes_from_hlo("", []))
    assert np.isscalar(got["wire_bytes"])
