"""The parameter bridge and the port's boundaries: the bridged tree has the
JAX tree's paths, shapes and dtypes; the port's own full-size init has
them too; the port never imports JAX or the JAX package; entry points do
not drop to the CPU on their own."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "gpt2s-polysketch"


def _flat(tree):
    return dict(zip(tree_paths(tree), jax.tree_util.tree_leaves(tree)))


def test_bridged_smoke_tree_round_trips_paths_shapes_dtypes_values():
    jm = jax_build_model(jax_get_config(ARCH, smoke=True))
    params, _ = jm.init(jax.random.PRNGKey(1))
    flat = {k: np.asarray(v) for k, v in _flat(params).items()}
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu", params=params_from_jax(flat, cfg))
    back = params_to_jax(model.lm)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        assert back[path].shape == arr.shape, path
        assert back[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


def test_full_config_init_matches_jax_eval_shape():
    """The port's own init of the full CONFIG (on the meta device, nothing
    allocated) has JAX's paths, shapes and dtypes, leaf for leaf."""
    jm = jax_build_model(jax_get_config(ARCH))
    shapes = jax.eval_shape(lambda key: jm.init(key)[0], jax.random.PRNGKey(0))
    want = {p: (tuple(s.shape), np.dtype(s.dtype))
            for p, s in _flat(shapes).items()}
    model = build_model(get_config(ARCH), device="meta")
    got = {p: (a.shape, a.dtype) for p, a in params_to_jax(model.lm).items()}
    assert got == want
    n_params = sum(np.prod(s) for s, _ in want.values())
    assert n_params == sum(p.numel() for p in model.lm.parameters())


def test_seeded_init_is_reproducible_and_matches_reference_scales():
    cfg = get_config(ARCH, smoke=True)
    a = build_model(cfg, device="cpu", seed=4).lm.state_dict()
    b = build_model(cfg, device="cpu", seed=4).lm.state_dict()
    c = build_model(cfg, device="cpu", seed=5).lm.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.table"], c["embed.table"])
    # the reference's init distributions: N(0, 0.02) embeddings, fan-in
    # N(0, 1/d) dense weights, U(+-1/sqrt(d_in)) sketch layers, LN at 1/0
    assert abs(a["embed.table"].std().item() - 0.02) < 0.002
    wq = a["layers.0.mixer.wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5
    w1 = a["layers.0.mixer.sketch.proj1.w1"]
    assert w1.abs().max().item() <= cfg.resolved_head_dim ** -0.5
    assert torch.equal(a["layers.1.norm1.scale"], torch.ones(cfg.d_model))
    assert not a["layers.1.norm1.bias"].any()


def test_bridge_rejects_misplaced_leaves():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(KeyError):
        params_from_jax({"lm_head": np.zeros((2, 2), np.float32)}, cfg)
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_jax({"groups/block0/norm1/scale":
                         np.zeros((3, 64), np.float32)}, cfg)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("root", ["src/repro_torch", "chip_smoke.py"])
def test_port_imports_neither_jax_nor_the_jax_package(root):
    target = REPO / root
    files = sorted(target.rglob("*.py")) if target.is_dir() else [target]
    assert files
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no device named, the port raises; it never drops
    to the CPU on its own."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--gen", "1", "--prompt-len", "4"])
    assert build_model(cfg, device="cpu").device.type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
