"""The port's sharding rules and mesh builders against the JAX package's:
the logical axes of every registry config's parameters (leaf for leaf
through the bridge), spec_for and batch_spec over four mesh shapes (a
duck-typed mesh for the reference: no jax devices needed), the rules
table, the DTensor placements of a spec, and make_serving_mesh's
refusals."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch.dryrun import abstract_init  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import is_stacked, jax_path  # noqa: E402
from repro_torch.configs import _MODULES, get_config  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ARCHS = sorted(_MODULES)
MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


class DuckMesh:
    """What the reference's spec_for reads of a mesh: axis_names and
    devices.shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _is_names(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _flat_axes(tree, prefix=""):
    if _is_names(tree):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_axes(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def trees():
    """{arch: (cfg, port {name: (axes, shape)}, reference {path: (axes, shape)})}."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg, device="meta")
        shapes = {n: tuple(p.shape) for n, p in model.lm.named_parameters()}
        port = {n: (a, shapes[n]) for n, a in model.axes().items()}
        sds, axes = abstract_init(jax_build_model(jax_get_config(arch, smoke=True)))
        flat_sds = dict(zip(tree_paths(sds), (tuple(x.shape) for x in
                                              jax.tree_util.tree_leaves(sds))))
        ref = {p: (a, flat_sds[p]) for p, a in _flat_axes(axes).items()}
        out[arch] = (cfg, port, ref)
    return out


def _ref_of(cfg, name, ref):
    """The reference leaf of the port's `name`: (its axes and spec-ready
    shape with the leading "layers" entry dropped when stacked, stacked)."""
    path = jax_path(name, cfg)
    axes, shape = ref[path]
    if is_stacked(path, cfg):
        assert axes[0] == "layers", (path, axes)
        return path, axes[1:], shape, True
    return path, axes, shape, False


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_the_reference_tree_through_the_bridge(trees, arch):
    cfg, port, ref = trees[arch]
    seen = set()
    for name, (axes, shape) in port.items():
        path, want, ref_shape, stacked = _ref_of(cfg, name, ref)
        assert axes == tuple(want), (name, axes, want)
        assert (ref_shape[1:] if stacked else ref_shape) == shape, name
        seen.add(path)
    assert seen == set(ref), sorted(set(ref) ^ seen)


@pytest.mark.parametrize("mesh_shape", list(MESHES))
def test_spec_for_and_batch_spec_equal_the_reference(trees, mesh_shape):
    names = MESHES[mesh_shape]
    duck = DuckMesh(mesh_shape, names)
    sizes = dict(zip(names, mesh_shape))
    assert sh.mesh_axis_sizes(duck) == jsh.mesh_axis_sizes(duck) == sizes
    assert sh.mesh_axis_sizes(sizes) == sizes
    for arch in ARCHS:
        cfg, port, ref = trees[arch]
        for name, (axes, shape) in port.items():
            path, _, ref_shape, stacked = _ref_of(cfg, name, ref)
            want = tuple(jsh.spec_for(ref[path][0], ref_shape, duck))
            if stacked:
                assert want[:1] in ((), (None,)), (path, want)
                want = want[1:]
            got = sh.spec_for(axes, shape, duck)
            assert got == want, (arch, name, got, want)
            assert sh.spec_for(axes, shape, sizes) == want
        specs = sh.shardings_for({n: a for n, (a, _) in port.items()},
                                 {n: s for n, (_, s) in port.items()}, sizes)
        assert specs == {n: sh.spec_for(a, s, sizes) for n, (a, s) in port.items()}
    for batch in (1, 2, 4, 8, 32, 48, 512):
        for ndim in (1, 2, 3):
            assert sh.batch_spec(duck, batch, ndim) == tuple(jsh.batch_spec(duck, batch, ndim))
    # activations: a batch dim over several axes and a seq dim
    for shape in ((32, 64, 128), (512, 16, 2048)):
        want = tuple(jsh.spec_for(("batch", "seq", "embed"), shape, duck))
        assert sh.spec_for(("batch", "seq", "embed"), shape, duck) == want


def test_rules_table_equals_the_reference_and_covers_every_registry_axis(trees):
    assert sh.DEFAULT_RULES == jsh.DEFAULT_RULES
    names = set()
    for _, port, _ in trees.values():
        for axes, _ in port.values():
            names.update(axes)
    missing = {n for n in names if n not in sh.DEFAULT_RULES}
    assert not missing, missing


def test_placements_block_and_replication_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    sizes = {"data": 2, "model": 4}
    spec = sh.spec_for(("embed", "q_heads", "head_dim"), (64, 8, 16), sizes)
    assert spec == ("data", "model")
    assert sh.placements(spec, sizes) == [Shard(0), Shard(1)]
    assert sh.placements((None, "model"), sizes) == [Replicate(), Shard(1)]
    assert sh.placements((), sizes) == [Replicate(), Replicate()]
    # the batch dim over several axes: each axis shards the same dim
    assert sh.placements((("data", "model"), None), sizes) == [Shard(0), Shard(0)]
    # outside and inside the activation context, the port's constraint is x
    x = torch.ones(2, 3)
    assert sh.shard_act(x, "batch") is x
    with sh.activation_sharding(sizes):
        assert sh.shard_act(x, "batch", "seq") is x


@pytest.mark.parametrize("args", [(0, 1), (4, 0), (6, 4), (4096, 2)])
def test_make_serving_mesh_raises_as_the_reference(args):
    with pytest.raises(ValueError) as want:
        jmesh.make_serving_mesh(*args)
    with pytest.raises(ValueError) as got:
        tmesh.make_serving_mesh(*args)
    if args[0] < 4096:   # the argument checks: the reference's words
        assert str(got.value) == str(want.value)
    else:                # more than there are: devices there, ranks here
        assert str(want.value).startswith("mesh wants 4096 devices but only")
        assert str(got.value).startswith(
            "mesh wants 4096 devices but only 1 ranks are running")


def test_make_mesh_needs_one_rank_a_device():
    with pytest.raises(ValueError, match="wants 4 ranks but 1 are running"):
        tmesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_mesh((2, 2), ("data",), device_type="cpu")
