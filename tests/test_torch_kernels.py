"""The port's polysketch kernel layer held to the JAX package.

On the CPU, ops.polysketch_attention runs the kernel's plain PyTorch
version; it is held to the JAX ops.polysketch_attention run in Pallas
interpret mode, at the reference's own tolerances (tests/test_kernels.py:
1e-4 f32, 5e-2 bf16). The CUDA kernel itself runs only on a card; its
cases are in tests/test_torch_gpu.py.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import polysketch_causal as tpc  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(seed, B, Hq, Hkv, S, hd, r):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(B, Hq, S, r) * 0.5, n(B, Hkv, S, r) * 0.5, n(B, Hq, S, hd),
            n(B, Hkv, S, hd), n(B, Hkv, S, hd))


def _jax(xs, dtype):
    return [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in xs]


def _torch(xs, dtype, device="cpu"):
    return [torch.from_numpy(x).to(device, getattr(torch, dtype)) for x in xs]


def _f32(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("degree", [2, 4, 8])
@pytest.mark.parametrize("local_exact", [True, False])
def test_polysketch_attention_matches_jax_interpret(degree, local_exact,
                                                    dtype):
    xs = _inputs(degree, 2, 4, 2, 96, 16, 8)            # GQA 4:2
    kw = dict(degree=degree, scale=1.0 / 16, local_exact=local_exact,
              block_size=32)
    want = jops.polysketch_attention(*_jax(xs, dtype), impl="interpret", **kw)
    got = tops.polysketch_attention(*_torch(xs, dtype), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 4, 96, 16)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_unaligned_seq_padding_matches_jax():
    xs = _inputs(0, 1, 2, 2, 77, 16, 8)
    kw = dict(degree=4, scale=1.0 / 16, block_size=32)
    want = jops.polysketch_attention(*_jax(xs, "float32"), impl="interpret",
                                     **kw)
    got = tops.polysketch_attention(*_torch(xs, "float32"), **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_resume_from_state_matches_full_and_jax(hq, hkv):
    """Split at a block boundary, resume with z0 = the first part's state:
    the port reproduces its one-shot run bit for bit, and the JAX kernel's
    (interpret mode) within tolerance."""
    cut = 64
    xs = _inputs(7, 2, hq, hkv, 96, 16, 8)
    kw = dict(degree=4, scale=1.0 / 16, block_size=32, return_state=True)
    t = _torch(xs, "float32")
    out_full, z_full = tops.polysketch_attention(*t, **kw)
    o1, z1 = tops.polysketch_attention(*(x[..., :cut, :] for x in t), **kw)
    o2, z2 = tops.polysketch_attention(*(x[..., cut:, :] for x in t), z0=z1,
                                       **kw)
    assert torch.equal(torch.cat([o1, o2], dim=-2), out_full)
    assert torch.equal(z2, z_full)
    j = _jax(xs, "float32")
    jo, jz = jops.polysketch_attention(*j, impl="interpret", **kw)
    np.testing.assert_allclose(_f32(out_full), _f32(jo), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_f32(z_full), _f32(jz), atol=1e-4, rtol=1e-5)
    jz1 = jops.polysketch_attention(*(x[..., :cut, :] for x in j),
                                    impl="interpret", **kw)[1]
    jo2 = jops.polysketch_attention(*(x[..., cut:, :] for x in j), z0=jz1,
                                    impl="interpret", **kw)[0]
    np.testing.assert_allclose(_f32(o2), _f32(jo2), atol=1e-4, rtol=1e-4)


def test_state_reset_between_heads():
    """Head 2 computed alone matches head 2 computed in the batch."""
    xs = _inputs(1, 1, 3, 3, 64, 8, 4)
    kw = dict(degree=4, scale=1.0 / 8, block_size=16)
    t = _torch(xs, "float32")
    out = tops.polysketch_attention(*t, **kw)
    solo = tops.polysketch_attention(*(x[:, 2:] for x in t), **kw)
    np.testing.assert_allclose(_f32(out[:, 2:]), _f32(solo), atol=1e-5)
    want = jops.polysketch_attention(*_jax(xs, "float32"), impl="interpret",
                                     **kw)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=1e-4, rtol=1e-4)


def test_plain_version_matches_oracle_on_factored_state():
    """polysketch_causal_torch (factored state) == the O(n^2) oracle."""
    from repro_torch.kernels.ref import polysketch_causal_ref
    qm, km, q, k, v = _torch(_inputs(3, 1, 2, 2, 64, 8, 4), "float32")
    flat = [x.reshape(-1, *x.shape[-2:]) for x in (qm, km, q, k, v)]
    kw = dict(degree=4, scale=1.0 / 8, block_size=16)
    got = tpc.polysketch_causal_torch(*flat, **kw)
    want = polysketch_causal_ref(*flat, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("local_exact", [True, False])
@pytest.mark.parametrize("with_z0", [False, True])
def test_plain_version_matches_block_linear_attention(local_exact, with_z0):
    """ops.polysketch_attention's plain version (factored state) against
    the combined-state block algorithm, output and returned state, seeded
    from a z0 or not."""
    from repro_torch.core.linear_attention import block_causal_linear_attention
    qm, km, q, k, v = _torch(_inputs(4, 2, 3, 3, 48, 8, 4), "float32")
    z0 = None
    if with_z0:
        z0 = torch.from_numpy(np.abs(np.random.default_rng(5).standard_normal(
            (2, 3, 16, 9)).astype(np.float32)) * 0.1)
    kw = dict(degree=4, scale=1.0 / 8, block_size=16, local_exact=local_exact,
              z0=z0, return_state=True)
    got, gz = tops.polysketch_attention(qm, km, q, k, v, **kw)
    want, wz = block_causal_linear_attention(qm, km, v, q, k, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_f32(gz), _f32(wz), atol=1e-4, rtol=1e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs a CPU tensor (no silent fallback), and
    ops takes no implementation name it does not know."""
    t = _torch(_inputs(0, 1, 2, 2, 32, 16, 8), "float32")
    flat = [x.reshape(-1, *x.shape[-2:]) for x in t]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpc.polysketch_causal_cuda(*flat, degree=4, scale=1.0 / 16,
                                   block_size=16)
    with pytest.raises(ValueError, match="impl"):
        tops.polysketch_attention(*t, degree=4, scale=1.0 / 16, impl="xla")
