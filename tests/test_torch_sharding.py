"""The port's sharding rules and meshes held to the JAX package.

* ``tree_sharding``: for every architecture of ``ARCHS`` at its full
  widths, on ``(4, 2)``, ``(16, 16)`` and ``(2, 16, 16)`` meshes, each
  leaf's spec equals the reference's ``PartitionSpec`` — the reference
  over ``jax.eval_shape`` of its init in a subprocess with 512 fake CPU
  devices, the port over ``dryrun.abstract_params`` (fake tensors) on a
  fake process group of the mesh's size — and its DTensor placements
  are what the spec means;
* the three shapes of the reference's ``test_tree_sharding_rules``;
  ``default_rules`` and ``spec_for``;
* ``mesh_context``, ``replicate`` and ``shard_activation``: the identity
  outside a context and on a plain tensor, an all-``None`` spec leaves
  ``x`` as it is, a DTensor is redistributed to the rules' placements;
* ``make_host_mesh`` and ``make_production_mesh``;
* the reference's own sharded train step raises ``DuplicateSpecError``
  (pinned as its quirk: the port's sharded step is held to the port's
  single-device step instead, ``tests/test_torch_sharded_train.py``).
"""
import contextlib
import inspect
import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import run_with_devices  # noqa: E402

MESHES = {"4x2": ((4, 2), ("data", "model"), False),
          "16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}


def walk(node, path, out):
    """Each leaf's spec by its key path (run on both sides)."""
    if isinstance(node, dict):
        for k in sorted(node):
            walk(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            walk(v, path + (str(i),), out)
    else:
        out["/".join(path)] = [list(a) if isinstance(a, tuple) else a
                               for a in node.spec]


REFERENCE = '''
import json
import jax
from repro.configs import ARCHS, get_config
from repro.distributed import sharding as SH
from repro.models import transformer as T


def abstract(cfg):
    box = {}

    def init(k):
        p, s = T.model_init(k, cfg)
        box["s"] = s
        return p
    return jax.eval_shape(init, jax.random.PRNGKey(0)), box["s"]


got = {}
for arch in ARCHS:
    shapes, specs = abstract(get_config(arch))
    for label, (shape, axes, mp) in MESHES.items():
        sh = SH.tree_sharding(shapes, specs, SH.default_rules(mp, "train"),
                              jax.make_mesh(shape, axes))
        out = {}
        walk(sh, (), out)
        got[arch + " " + label] = out
print("SPECS " + json.dumps(got))
'''


@contextlib.contextmanager
def _mesh(shape, axes):
    """A fake process group of the mesh's size and the mesh over it."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    n = 1
    for s in shape:
        n *= s
    with fake_world(n):
        yield make_mesh(shape, axes, "cpu")


@pytest.fixture(scope="module")
def reference_specs():
    code = f"MESHES = {MESHES!r}\n{inspect.getsource(walk)}\n{REFERENCE}"
    out = run_with_devices(code, 512)
    line = next(x for x in out.splitlines() if x.startswith("SPECS "))
    return json.loads(line[len("SPECS "):])


@pytest.fixture(scope="module")
def port_specs():
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.dryrun import abstract_params
    abstract = {a: abstract_params(get_config(a)) for a in ARCHS}
    got, placements = {}, {}
    for label, (shape, axes, mp) in MESHES.items():
        with _mesh(shape, axes) as mesh:
            rules = SH.default_rules(mp, "train")
            for arch, (params, specs) in abstract.items():
                sh = SH.tree_sharding(params, specs, rules, mesh)
                out: dict = {}
                walk(sh, (), out)
                got[f"{arch} {label}"] = out
                leaves: dict = {}
                _placements(sh, (), leaves)
                placements[f"{arch} {label}"] = leaves
    return got, placements


def _placements(node, path, out):
    if isinstance(node, dict):
        for k in sorted(node):
            _placements(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _placements(v, path + (str(i),), out)
    else:
        out["/".join(path)] = node.placements


@pytest.mark.parametrize("label", list(MESHES))
def test_every_architectures_placements_equal_the_reference(
        reference_specs, port_specs, label):
    from repro_torch.configs import ARCHS
    got, _ = port_specs
    for arch in ARCHS:
        key = f"{arch} {label}"
        assert got[key] == reference_specs[key], key


def test_placements_are_what_the_spec_means(port_specs):
    """``Shard(d)`` on each mesh axis that a spec puts on dim ``d``,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    specs, placements = port_specs
    for key, leaves in placements.items():
        axes = MESHES[key.split()[-1]][1]
        for path, pl in leaves.items():
            spec = specs[key][path]
            assert len(pl) == len(axes)
            for name, p in zip(axes, pl):
                dims = [d for d, m in enumerate(spec) if m == name or (
                    isinstance(m, list) and name in m)]
                assert p == (Shard(dims[0]) if dims else Replicate()), (
                    key, path, spec, pl)


def test_tree_sharding_rules():
    """The reference's ``test_tree_sharding_rules``, on the port."""
    from repro_torch.distributed import sharding as SH
    with _mesh((4, 2), ("data", "model")) as mesh:
        rules = SH.default_rules(False, "train")
        shapes = {"w": torch.empty(32, 8, device="meta"),
                  "e": torch.empty(6, 32, 8, device="meta"),
                  "tiny": torch.empty(3, 5, device="meta")}
        specs = {"w": ("embed", "ffn"), "e": ("experts", "embed", "ffn"),
                 "tiny": ("embed", "ffn")}
        sh = SH.tree_sharding(shapes, specs, rules, mesh)
        # one axis in a tuple is the axis, as PartitionSpec keeps it
        assert sh["w"].spec == ("data", "model")
        # experts 6 % model 2 == 0 -> sharded; ffn blocked (model used)
        assert sh["e"].spec == ("model", "data", None)
        # indivisible dims are replicated, never an error
        assert sh["tiny"].spec == (None, None)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_default_rules_and_spec_for_equal_the_reference(multi_pod, kind):
    from repro.distributed import sharding as JSH
    from repro_torch.distributed import sharding as SH
    for preset in ("2d", "seq_parallel"):
        for seq_shard in (False, True):
            want = JSH.default_rules(multi_pod, kind, seq_shard, preset)
            got = SH.default_rules(multi_pod, kind, seq_shard, preset)
            assert got == want
            for logical in (None, ("embed", "ffn"), ("vocab", "embed"),
                            ("layers", "experts", "embed", "ffn"),
                            ("act_batch", "act_seq", "act_embed"),
                            ("heads", "nope")):
                assert SH.spec_for(logical, got) == tuple(
                    JSH.spec_for(logical, want))


def test_activation_constraints():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import sharding as SH
    x = torch.randn(8, 4, 6)
    # outside a context: the identity
    assert SH.replicate(x) is x and SH.shard_activation(x, "btd") is x
    with _mesh((4, 2), ("data", "model")) as mesh:
        rules = SH.default_rules(False, "train")
        dt = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                                run_check=False)
        assert SH.shard_activation(dt, "btd") is dt    # no context yet
        with SH.mesh_context(mesh, rules):
            assert SH.current_mesh() == (mesh, rules)
            # a plain tensor is a rank's own rows: left as it is
            assert SH.shard_activation(x, "btd") is x
            assert SH.replicate(x) is x
            # all-None spec (MoE buffers, or a batch of 3 over 4 ranks)
            assert SH.shard_activation(dt, "ecd") is dt
            odd = DTensor.from_local(torch.randn(3, 4, 6), mesh,
                                     [Replicate(), Replicate()],
                                     run_check=False)
            assert SH.shard_activation(odd, "btd") is odd
            # an unknown kind or rank: unchanged
            assert SH.shard_activation(dt, "bthd") is dt
            y = SH.shard_activation(dt, "btd")
            assert tuple(y.placements) == (Shard(0), Replicate())
            assert tuple(y.to_local().shape) == (2, 4, 6)
            z = SH.replicate(y)
            assert tuple(z.placements) == (Replicate(), Replicate())
            assert tuple(z.shape) == (8, 4, 6)
        assert SH.current_mesh() == (None, None)
        assert SH.shard_activation(dt, "btd") is dt


def test_shards_and_the_batch_split():
    """``local_shard`` cuts in mesh order (the first axis major);
    ``sharding_of`` reads a DTensor's placements back; the batch split
    follows ``act_batch``."""
    from repro_torch.distributed import sharding as SH
    with _mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
        t = torch.arange(8 * 6).reshape(8, 6).float()
        sh = SH.NamedSharding(mesh, (("pod", "data"), "model"))
        local = SH.local_shard(t, sh)
        assert torch.equal(local, t[:2, :3])          # rank 0's corner
        assert local.untyped_storage().nbytes() == local.numel() * 4
        dt = SH.as_dtensor(local, sh)
        assert tuple(dt.shape) == (8, 6)
        assert SH.sharding_of(dt).placements == sh.placements
        split = SH.batch_split_for(mesh, SH.default_rules(True, "train"),
                                   8)
        assert (split.n, split.index) == (4, 0)
        assert torch.equal(split.rows(t), t[:2])
        assert SH.batch_split_for(mesh, SH.default_rules(True, "train"),
                                  3).n == 1


def test_meshes():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="torchrun"):
        make_host_mesh(device_type="cpu")
    with fake_world(8):
        mesh = make_host_mesh(device_type="cpu")
        assert (tuple(mesh.shape), mesh.mesh_dim_names) == (
            (4, 2), ("data", "model"))
        assert tuple(make_host_mesh(16, device_type="cpu").shape) == (1, 8)
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        assert (tuple(mesh.shape), mesh.mesh_dim_names) == (
            (16, 16), ("data", "model"))
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert (tuple(mesh.shape), mesh.mesh_dim_names) == (
            (2, 16, 16), ("pod", "data", "model"))
    assert not dist.is_initialized()


def test_the_references_sharded_step_raises_duplicate_spec_error():
    """The reference's ``tests/test_distributed.py::
    test_sharded_train_step_runs`` fails in its ``embed_lookup`` under
    GSPMD: pinned here as its quirk, which the port does not copy."""
    code = """
import jax
from repro.configs import get_reduced, make_batch
from repro.configs.base import RunConfig
from repro.distributed import sharding as SH
from repro.models import model_init
from repro.train.train_step import init_train_state, make_train_step

mesh = jax.make_mesh((4, 2), ("data", "model"))
cfg = get_reduced("granite-moe-1b-a400m")
params, specs = model_init(jax.random.PRNGKey(0), cfg)
rules = SH.default_rules(False, "train")
params = jax.device_put(params, SH.tree_sharding(params, specs, rules, mesh))
batch = make_batch(cfg, "train_4k", batch_override=8, seq_override=32)
batch = jax.device_put(batch, jax.tree.map(
    lambda _: SH.NamedSharding(mesh, SH.P("data")), batch))
with SH.mesh_context(mesh, rules):
    step = jax.jit(make_train_step(cfg, RunConfig(model=cfg, remat=True)))
    step(init_train_state(params), batch)
"""
    with pytest.raises(AssertionError, match="DuplicateSpecError"):
        run_with_devices(code, 8)


def test_the_batch_split_is_seen_by_the_backwards_thread():
    """On CUDA the autograd engine runs the backward (and remat's
    recomputed forward, whose MoE reads the split) on a thread of its
    own: the split set around a backward must be visible there."""
    import threading

    from repro_torch.distributed import sharding as SH
    with _mesh((4, 2), ("data", "model")) as mesh:
        split = SH.batch_split_for(mesh, SH.default_rules(False, "train"),
                                   8)
        seen = []
        with SH.batch_split(split):
            t = threading.Thread(target=lambda: seen.append(
                SH.current_split()))
            t.start()
            t.join()
        assert seen == [split] and SH.current_split() is None
