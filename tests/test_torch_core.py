"""The port's core math held to the JAX package on the same numpy inputs:
sketches, q/k LayerNorm, the block algorithm with z0/return_state, the
factored-state conversions and the O(n^2) oracles."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import linear_attention as jla  # noqa: E402
from repro.core import poly_attention as jpa  # noqa: E402
from repro.core import sketches as jsk  # noqa: E402
from repro.kernels import polysketch_causal as jpc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.utils import self_kron as jself_kron  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch import utils as tu  # noqa: E402
from repro_torch.core import linear_attention as tla  # noqa: E402
from repro_torch.core import poly_attention as tpa  # noqa: E402
from repro_torch.core import sketches as tsk  # noqa: E402
from repro_torch.kernels import polysketch_causal as tpc  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_TOL = 1e-4


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _load_tree(module, tree):
    """Copy a JAX param tree into a port module by tree path."""
    leaves = jax.tree_util.tree_leaves(tree)
    paths = tree_paths(tree)
    names = {n for n, _ in module.named_parameters()}
    assert {p.replace("/", ".") for p in paths} == names
    for path, leaf in zip(paths, leaves):
        module.get_parameter(path.replace("/", ".")).data.copy_(_t(leaf))


@pytest.mark.parametrize("degree", [2, 4, 8])
@pytest.mark.parametrize("learned", [True, False])
def test_sketch_half_matches_jax(degree, learned):
    h, r = 16, 8
    params, _ = jsk.init_sketch(jax.random.PRNGKey(degree), h, r, degree,
                                learned)
    sk = tsk.init_sketch(h, r, degree, learned,
                         generator=torch.Generator().manual_seed(0))
    _load_tree(sk, params)
    x = _np((2, 3, 10, h), degree, 0.25)
    want = jsk.sketch_half(params, jnp.asarray(x), degree, learned)
    got = tsk.sketch_half(sk, _t(x), degree, learned)
    _close(got, want)


@pytest.mark.parametrize("degree", [2, 4, 8])
@pytest.mark.parametrize("learned", [True, False])
def test_sketch_param_count_matches_module(degree, learned):
    h, r = 16, 8
    sk = tsk.init_sketch(h, r, degree, learned)
    n = sum(p.numel() for p in sk.parameters())
    assert n == tsk.sketch_param_count(h, r, degree, learned)
    assert n == jsk.sketch_param_count(h, r, degree, learned)


def test_sketch_rejects_bad_degree():
    with pytest.raises(ValueError):
        tsk.init_sketch(8, 4, 6, True)
    sk = tsk.init_sketch(8, 4, 4, True)
    with pytest.raises(ValueError):
        tsk.sketch_half(sk, torch.zeros(2, 8), 8, True)


def test_qk_layernorm_matches_jax():
    x = _np((2, 4, 9, 16), 0, 3.0) + 1.5
    scale, bias = _np((16,), 1), _np((16,), 2)
    want = jpa.qk_layernorm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias))
    got = tpa.qk_layernorm(_t(x), _t(scale), _t(bias))
    _close(got, want)


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_poly_attention_full_matches_jax(degree, causal):
    q, k, v = (_np((2, 3, 12, 8), s) for s in (0, 1, 2))
    want = jpa.poly_attention_full(*map(jnp.asarray, (q, k, v)),
                                   degree=degree, causal=causal)
    got = tpa.poly_attention_full(*map(_t, (q, k, v)), degree=degree,
                                  causal=causal)
    _close(got, want)


@pytest.mark.parametrize("local_exact", [True, False])
@pytest.mark.parametrize("with_z0", [False, True])
def test_block_causal_linear_attention_matches_jax(local_exact, with_z0):
    B, H, S, r, h, blk = 2, 3, 48, 4, 8, 16
    qm, km = _np((B, H, S, r), 0, 0.5), _np((B, H, S, r), 1, 0.5)
    q, k, v = (_np((B, H, S, h), s) for s in (2, 3, 4))
    z0 = np.abs(_np((B, H, r * r, h + 1), 5, 0.1)) if with_z0 else None
    kw = dict(degree=4, scale=1.0 / h, block_size=blk,
              local_exact=local_exact, return_state=True)
    jo, jz = jla.block_causal_linear_attention(
        *map(jnp.asarray, (qm, km, v, q, k)),
        z0=None if z0 is None else jnp.asarray(z0), **kw)
    to, tz = tla.block_causal_linear_attention(
        *map(_t, (qm, km, v, q, k)), z0=None if z0 is None else _t(z0), **kw)
    _close(to, jo)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-4)


def test_block_causal_resume_is_bit_identical():
    """The port's block path: resuming from the returned state at a block
    boundary gives the one-shot run's bits."""
    B, H, S, r, h, blk, cut = 1, 2, 64, 4, 8, 16, 32
    qm, km = _t(_np((B, H, S, r), 0, 0.5)), _t(_np((B, H, S, r), 1, 0.5))
    q, k, v = (_t(_np((B, H, S, h), s)) for s in (2, 3, 4))
    kw = dict(degree=4, scale=1.0 / h, block_size=blk, return_state=True)
    full, zf = tla.block_causal_linear_attention(qm, km, v, q, k, **kw)
    c = lambda x: x[..., :cut, :]  # noqa: E731
    s = lambda x: x[..., cut:, :]  # noqa: E731
    o1, z1 = tla.block_causal_linear_attention(c(qm), c(km), c(v), c(q),
                                               c(k), **kw)
    o2, z2 = tla.block_causal_linear_attention(s(qm), s(km), s(v), s(q),
                                               s(k), z0=z1, **kw)
    assert torch.equal(torch.cat([o1, o2], dim=-2), full)
    assert torch.equal(z2, zf)


def test_z_to_factored_round_trip_matches_jax():
    z = _np((2, 3, 16, 9), 0)
    jzv, jzd = jpc.z_to_factored(jnp.asarray(z))
    tzv, tzd = tpc.z_to_factored(_t(z))
    assert tzv.shape == (2, 3, 4, 32) and tzd.shape == (2, 3, 4, 4)
    np.testing.assert_array_equal(tzv.numpy(), np.asarray(jzv))
    np.testing.assert_array_equal(tzd.numpy(), np.asarray(jzd))
    np.testing.assert_array_equal(tpc.factored_to_z(tzv, tzd).numpy(), z)
    np.testing.assert_array_equal(
        np.asarray(jpc.factored_to_z(jzv, jzd)),
        tpc.factored_to_z(tzv, tzd).numpy())


@pytest.mark.parametrize("local_exact", [True, False])
def test_polysketch_causal_ref_matches_jax(local_exact):
    qm, km = _np((2, 40, 4), 0, 0.5), _np((2, 40, 4), 1, 0.5)
    q, k, v = (_np((2, 40, 8), s) for s in (2, 3, 4))
    kw = dict(degree=4, scale=1.0 / 8, block_size=16, local_exact=local_exact)
    want = jref.polysketch_causal_ref(*map(jnp.asarray, (qm, km, q, k, v)),
                                      **kw)
    got = tref.polysketch_causal_ref(*map(_t, (qm, km, q, k, v)), **kw)
    _close(got, want)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8])
def test_int_pow_matches_integer_pow(p):
    x = _np((64,), p, 2.0)
    np.testing.assert_array_equal(tu.int_pow(_t(x), p).numpy(),
                                  np.asarray(jnp.asarray(x) ** p))


def test_self_kron_and_pad_match_jax():
    x = _np((3, 5, 4), 0)
    np.testing.assert_array_equal(tu.self_kron(_t(x)).numpy(),
                                  np.asarray(jself_kron(jnp.asarray(x))))
    padded, n = tu.pad_to_multiple(_t(x), 4, axis=1)
    assert n == 5 and padded.shape == (3, 8, 4)
    assert torch.equal(padded[:, :5], _t(x)) and not padded[:, 5:].any()
    same, n = tu.pad_to_multiple(_t(x), 5, axis=1)
    assert n == 5 and same.shape == (3, 5, 4)
