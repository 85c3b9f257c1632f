"""The port's exact polynomial attention (the paper's quadratic baseline)
and its lt_mult primitive, held to the JAX package on the same numpy
inputs.

On the CPU, ops.poly_attention and ops.lt_mult run their kernels' plain
PyTorch versions; they are held to the JAX ops run in Pallas interpret
mode at the reference's own tolerances (tests/test_kernels.py). The SMOKE
model with attention="polynomial" is held to the JAX model from bridged
parameters: train, prefill and decode logits within 1e-4, greedy tokens
exactly equal. The CUDA kernels run only on a card; their cases are in
tests/test_torch_gpu.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import decode as jdec  # noqa: E402
from repro.core import state as jst  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.gpt2_paper import GPT2_SMALL_POLY4  # noqa: E402
from repro_torch.core import decode as tdec  # noqa: E402
from repro_torch.core.state import mixer_state_kind  # noqa: E402
from repro_torch.kernels import lt_mult as tlt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import poly_flash as tpf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import generate  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCH = "gpt2s-polysketch"


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def _jax(xs, dtype="float32"):
    return [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in xs]


def _torch(xs, dtype="float32"):
    return [torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype))
            for x in xs]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float32)


# ---------------------------------------------------------------------------
# B2: ops.poly_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("degree", [4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_poly_attention_matches_jax_interpret(degree, causal, dtype):
    """test_poly_flash_sweep's grid: B=2, H=2, S=128, hd=16."""
    xs = [_np((2, 2, 128, 16), degree + causal + s) for s in range(3)]
    kw = dict(degree=degree, scale=1.0 / 16, causal=causal)
    want = jops.poly_attention(*_jax(xs, dtype), block_q=32, block_kv=32,
                               impl="interpret", **kw)
    got = tops.poly_attention(*_torch(xs, dtype), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 2, 128, 16)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("case", ["gqa_4_2", "unaligned_77", "noncausal_n_ne_t"])
def test_poly_attention_shapes_match_jax_interpret(case):
    """GQA 4:2 (kv heads repeated), n = 77 (no tile multiple; the JAX
    kernel runs it as one block of 77) and non-causal with n != t."""
    if case == "gqa_4_2":
        shapes, kw = [(2, 4, 64, 16), (2, 2, 64, 16), (2, 2, 64, 16)], {}
    elif case == "unaligned_77":
        shapes, kw = [(1, 2, 77, 16)] * 3, {}
    else:
        shapes = [(2, 2, 64, 16), (2, 2, 96, 16), (2, 2, 96, 16)]
        kw = dict(causal=False)
    xs = [_np(s, i) for i, s in enumerate(shapes)]
    want = jops.poly_attention(*_jax(xs), degree=4, impl="interpret", **kw)
    got = tops.poly_attention(*_torch(xs), degree=4, **kw)
    assert got.shape == shapes[0]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_poly_flash_ref_and_plain_version_match_jax_ref(causal):
    xs = [_np((2, 40, 8), s) for s in range(3)]
    kw = dict(degree=4, scale=1.0 / 8, causal=causal)
    want = jref.poly_flash_ref(*_jax(xs), **kw)
    np.testing.assert_allclose(_f32(tref.poly_flash_ref(*_torch(xs), **kw)),
                               _f32(want), atol=1e-5, rtol=1e-5)
    plain = tpf.poly_flash_torch(*_torch(xs), block_q=16, **kw)
    np.testing.assert_allclose(_f32(plain), _f32(want), atol=1e-5, rtol=1e-5)


def test_poly_attention_rejects_causal_n_ne_t_and_cpu_tensors_in_kernel():
    q, k = torch.zeros(1, 1, 8, 4), torch.zeros(1, 1, 12, 4)
    with pytest.raises(ValueError, match="n == t"):
        tops.poly_attention(q, k, k, degree=4)
    flat = [x.reshape(-1, *x.shape[-2:]) for x in (q, q, q)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpf.poly_flash_cuda(*flat, degree=4, scale=0.25)
    with pytest.raises(ValueError, match="impl"):
        tops.poly_attention(q, q, q, degree=4, impl="xla")


# ---------------------------------------------------------------------------
# B3: ops.lt_mult
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,k,blk", [(64, 8, 16, 16), (128, 32, 8, 32),
                                       (96, 16, 16, 32), (256, 64, 64, 64)])
def test_lt_mult_matches_jax_interpret(n, m, k, blk, dtype):
    """test_lt_mult_sweep's grid, at its tolerances."""
    xs = [_np((2, n, m), n + m), _np((2, n, m), n + m + 1),
          _np((2, n, k), n + m + 2)]
    want = jops.lt_mult(*_jax(xs, dtype), block_size=blk, impl="interpret")
    got = tops.lt_mult(*_torch(xs, dtype), block_size=blk)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, n, k)
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol * n, rtol=tol)


@pytest.mark.parametrize("n,blk", [(32, 16), (32, 32), (64, 16), (64, 32),
                                   (96, 16), (96, 32)])
@pytest.mark.parametrize("seed", [0, 271, 828])
def test_lt_mult_property_matches_jax_interpret(n, blk, seed):
    """test_lt_mult_property's grid, at its tolerance."""
    xs = [_np((1, n, 8), seed), _np((1, n, 8), seed + 1),
          _np((1, n, 4), seed + 2)]
    want = jops.lt_mult(*_jax(xs), block_size=blk, impl="interpret")
    got = tops.lt_mult(*_torch(xs), block_size=blk)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_f32(tref.lt_mult_ref(*_torch(xs))),
                               _f32(jref.lt_mult_ref(*_jax(xs))),
                               atol=1e-4, rtol=1e-4)


def test_lt_mult_rejects_unaligned_n_and_cpu_tensors_in_kernel():
    a, c = torch.zeros(1, 40, 4), torch.zeros(1, 40, 2)
    with pytest.raises(ValueError, match="multiple of the block"):
        tops.lt_mult(a, a, c, block_size=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlt.lt_mult_cuda(a, a, c, block_size=8)
    assert tops.REFS["lt_mult"] is tref.lt_mult_ref
    assert set(tops.REFS) == set(jops.REFS)


# ---------------------------------------------------------------------------
# poly_kv decode state
# ---------------------------------------------------------------------------

def test_poly_kv_decode_step_matches_jax_and_keeps_its_input():
    bsz, hq, hkv, smax, hd, pos = 2, 4, 2, 24, 8, 13
    kc, vc = _np((bsz, hkv, smax, hd), 0), _np((bsz, hkv, smax, hd), 1)
    kc[:, :, pos:] = 0.0
    vc[:, :, pos:] = 0.0
    q, k, v = (_np((bsz, h_, hd), s) for s, h_ in ((2, hq), (3, hkv), (4, hkv)))
    kw = dict(degree=4, scale=1.0 / hd)
    jc = jdec.KVCache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos, jnp.int32))
    jo, jc2 = jdec.poly_kv_decode_step(jc, *_jax((q, k, v)), **kw)
    tc = tdec.KVCache(*_torch((kc, vc)), pos)
    to, tc2 = tdec.poly_kv_decode_step(tc, *_torch((q, k, v)), **kw)
    np.testing.assert_allclose(_f32(to), _f32(jo), atol=1e-5, rtol=1e-5)
    assert tc2.pos == pos + 1 == int(jc2.pos)
    np.testing.assert_array_equal(tc2.k.numpy(), np.asarray(jc2.k))
    np.testing.assert_array_equal(tc2.v.numpy(), np.asarray(jc2.v))
    np.testing.assert_array_equal(tc.k.numpy(), kc)      # input left as it was
    np.testing.assert_array_equal(tc.v.numpy(), vc)
    with pytest.raises(ValueError, match="full"):
        tdec.poly_kv_decode_step(tc._replace(pos=smax), *_torch((q, k, v)), **kw)


# ---------------------------------------------------------------------------
# the SMOKE model with attention="polynomial", against the JAX model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[4, 8], ids=["p4", "p8"])
def pair(request):
    """(jax model, jax params, port model) from one JAX init."""
    over = dict(attention="polynomial", poly_degree=request.param)
    jm = jax_build_model(jax_get_config(ARCH, smoke=True, **over))
    params, _ = jm.init(jax.random.PRNGKey(0))
    flat = dict(zip(tree_paths(params),
                    (np.asarray(x) for x in jax.tree_util.tree_leaves(params))))
    cfg = get_config(ARCH, smoke=True, **over)
    tm = build_model(cfg, device="cpu", params=params_from_jax(flat, cfg))
    return jm, params, tm


def _tokens(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_polynomial_train_logits_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(40, (2, 40))
    want, _, _ = jm.apply(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                          mode="train", impl="interpret")
    got, cache = tm.lm(torch.from_numpy(toks), mode="train")
    assert cache is None
    _close(got, want)


def test_polynomial_prefill_and_decode_match_jax(pair):
    """One prefill call over the whole 37-token prompt (off every block
    grid) fills the KV cache at 0 with post-RoPE, post-LN keys; then two
    decode steps read it."""
    jm, params, tm = pair
    toks = _tokens(3, (2, 37))
    jl, jc = jm.state.prefill(params, jnp.asarray(toks, jnp.int32), max_len=48)
    tl, tc = tm.state.prefill(torch.from_numpy(toks), max_len=48)
    _close(tl, jl)
    node = jc["groups"]["block0"]
    for i, c in enumerate(tc):
        assert c.pos == 37 == int(node.pos[i]) and c.k.shape == (2, 4, 48, 16)
        _close(c.k, node.k[i])
        _close(c.v, node.v[i])
    for step, nxt in enumerate((np.array([[5], [77]]), np.array([[9], [1]]))):
        jl, jc = jm.state.decode_step(params, jnp.asarray(nxt, jnp.int32),
                                      37 + step, jc)
        tl, tc = tm.state.decode_step(torch.from_numpy(nxt), 37 + step, tc)
        _close(tl, jl)
        assert all(c.pos == 38 + step for c in tc)


def test_polynomial_greedy_generate_matches_jax(pair):
    jm, params, tm = pair
    prompt = _tokens(13, (3, 13))
    want = jax_generate(jm, jm.cfg, params, jnp.asarray(prompt, jnp.int32), 8)
    got = generate(tm, prompt, 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.logits_last, want.logits_last)


def test_poly_kv_state_is_not_resumable_and_needs_max_len(pair):
    jm, _, tm = pair
    st = tm.state
    assert st.kind == "poly_kv" == jst.mixer_state_kind(jm.cfg, "attn")
    assert st.resumable is False is jst.get_spec("poly_kv").resumable
    toks = torch.from_numpy(_tokens(1, (1, 8)))
    with pytest.raises(ValueError, match="max_len"):
        st.prefill(toks)
    _, cache = st.prefill(toks, max_len=16)
    with pytest.raises(ValueError, match="not resumable"):
        st.resume(toks, cache, 8)


def test_polynomial_decode_step_leaves_its_input_cache_unchanged(pair):
    _, _, tm = pair
    _, cache = tm.state.prefill(torch.from_numpy(_tokens(6, (2, 15))),
                                max_len=20)
    before = [(c.k.clone(), c.v.clone()) for c in cache]
    nxt = torch.from_numpy(np.array([[5], [77]]))
    first, _ = tm.state.decode_step(nxt, 15, cache)
    for c, (k, v) in zip(cache, before):
        assert c.pos == 15 and torch.equal(c.k, k) and torch.equal(c.v, v)
    again, _ = tm.state.decode_step(nxt, 15, cache)
    assert torch.equal(first, again)


def test_polynomial_tree_round_trips_through_the_bridge(pair):
    """The polynomial tree has the q/k LayerNorm leaves and no sketch."""
    jm, params, tm = pair
    flat = {k: np.asarray(v) for k, v in
            zip(tree_paths(params), jax.tree_util.tree_leaves(params))}
    assert not any("sketch" in p for p in flat)
    assert "groups/block0/mixer/pln_q_scale" in flat
    back = params_to_jax(tm.lm)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        assert back[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


def test_full_poly4_config_builds_on_meta_with_jax_shapes():
    """GPT2_SMALL_POLY4 at full width: the port's leaves have JAX's paths,
    shapes and dtypes, and its state kind is poly_kv."""
    from repro.configs.gpt2_paper import GPT2_SMALL_POLY4 as JAX_POLY4
    jm = jax_build_model(JAX_POLY4)
    shapes = jax.eval_shape(lambda key: jm.init(key)[0], jax.random.PRNGKey(0))
    want = {p: (tuple(s.shape), np.dtype(s.dtype))
            for p, s in zip(tree_paths(shapes),
                            jax.tree_util.tree_leaves(shapes))}
    model = build_model(GPT2_SMALL_POLY4, device="meta")
    got = {p: (a.shape, a.dtype) for p, a in params_to_jax(model.lm).items()}
    assert got == want
    assert mixer_state_kind(GPT2_SMALL_POLY4) == "poly_kv"
