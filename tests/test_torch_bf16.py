"""The port at compute_dtype="bfloat16" held to the JAX package on the
CPU at 5e-2 (tests/test_kernels.py's bf16 tolerance): SMOKE polysketch
and exact-polynomial (degree 4) train-mode logits, prefill logits, greedy
decode tokens (exactly equal) with their last logits, and the two core
functions that differ in where they round (the port takes the q.k product
and self_kron(qm) in f32, the reference rounds them through bf16). The
f32 path is held bit for bit by the other test files.

bf16 training (polysketch attention; the exact polynomial baseline's
backward stays f32): SMOKE gradients of gpt2s-polysketch and qwen3-14b
against jax.grad of the reference, both in bf16, every leaf within
GRAD_TOL of its max|.| and the median leaf within GRAD_MEDIAN; and B1's
plain backward on bf16 operands equal to its f32 result on the same
values, rounded to bf16. The gates come from scripts/bf16_grad_study.py:
against the float64 gradient, the reference's bf16 leaves lie up to
0.189 of their max|.| off (the sketch's LayerNorm biases and scales the
worst), its median leaf up to 0.0474, and the port's 0.125 and 0.0279;
two paths each within that of float64 may lie twice it apart (port and
reference were up to 0.172 apart, median 0.036)."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.linear_attention import (  # noqa: E402
    block_causal_linear_attention as jax_block_causal)
from repro.core.poly_attention import poly_attention_full as jax_poly_full  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import named_to_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.linear_attention import block_causal_linear_attention  # noqa: E402
from repro_torch.core.poly_attention import poly_attention_full  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import polysketch_causal as pc  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import generate  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402

TOL = 5e-2
GRAD_TOL, GRAD_MEDIAN = 0.38, 0.095
ARCH = "gpt2s-polysketch"
MECHS = ["polysketch", "polynomial"]


@pytest.fixture(scope="module")
def pairs():
    """{mechanism: (jax model, jax params, port model)} at bf16 from one
    JAX init."""
    out = {}
    for mech in MECHS:
        kw = dict(smoke=True, attention=mech, compute_dtype="bfloat16")
        jm = jax_build_model(jax_get_config(ARCH, **kw))
        params, _ = jm.init(jax.random.PRNGKey(0))
        flat = dict(zip(tree_paths(params),
                        map(np.asarray, jax.tree_util.tree_leaves(params))))
        cfg = get_config(ARCH, **kw)
        out[mech] = jm, params, build_model(cfg, device="cpu",
                                            params=params_from_jax(flat, cfg))
    return out


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, size=shape)


def _close(got, want):
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seq", [16, 40])
@pytest.mark.parametrize("mech", MECHS)
def test_train_logits_match_jax(pairs, mech, seq):
    jm, params, tm = pairs[mech]
    toks = _tokens(seq, (2, seq))
    want, _, _ = jm.apply(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                          mode="train", impl="interpret")
    with torch.no_grad():
        got, _ = tm.lm(torch.from_numpy(toks), mode="train")
    _close(got, want)


@pytest.mark.parametrize("seq", [13, 40])
@pytest.mark.parametrize("mech", MECHS)
def test_prefill_logits_match_jax(pairs, mech, seq):
    jm, params, tm = pairs[mech]
    toks = _tokens(seq + 1, (2, seq))
    want, _ = jm.state.prefill(params, jnp.asarray(toks, jnp.int32), max_len=seq + 8)
    got, _ = tm.state.prefill(torch.from_numpy(toks), max_len=seq + 8)
    _close(got, want)


@pytest.mark.parametrize("mech", MECHS)
def test_greedy_decode_matches_jax(pairs, mech):
    """A 13-token prompt and 8 steps (polysketch folds at position 15)."""
    jm, params, tm = pairs[mech]
    prompt = _tokens(13, (3, 13))
    want = jax_generate(jm, jm.cfg, params, jnp.asarray(prompt, jnp.int32), 8)
    got = generate(tm, prompt, 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.logits_last, want.logits_last)


@pytest.mark.parametrize("fn", ["poly_attention_full", "block_causal_linear_attention"])
def test_core_functions_match_jax(fn):
    rng = np.random.default_rng(0)

    def ln(x):
        return (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)

    q, k, v = (rng.standard_normal((2, 3, 64, 16)).astype(np.float32) for _ in range(3))
    q, k = ln(q), ln(k)
    qm, km = (rng.standard_normal((2, 3, 64, 8)).astype(np.float32) * 0.5 for _ in range(2))
    ins = (q, k, v) if fn == "poly_attention_full" else (qm, km, v, q, k)
    kw = dict(degree=4) if fn == "poly_attention_full" else dict(degree=4, block_size=16)
    jfn = jax_poly_full if fn == "poly_attention_full" else jax_block_causal
    tfn = poly_attention_full if fn == "poly_attention_full" else block_causal_linear_attention
    want = jfn(*(jnp.asarray(x).astype(jnp.bfloat16) for x in ins), **kw)
    got = tfn(*(torch.from_numpy(x).to(torch.bfloat16) for x in ins), **kw)
    _close(got, want)


def _flat(tree):
    return dict(zip(tree_paths(tree), map(np.asarray, jax.tree_util.tree_leaves(tree))))


@pytest.mark.parametrize("arch", ["gpt2s-polysketch", "qwen3-14b"])
def test_bf16_gradients_match_jax(arch):
    """One batch's loss gradients at compute_dtype="bfloat16" (parameters
    f32, bridged), port (B1's plain forward and backward) against jax.grad
    of the reference: every leaf within GRAD_TOL of its max|.|, the median
    leaf within GRAD_MEDIAN, the loss within TOL."""
    kw = dict(smoke=True, compute_dtype="bfloat16")
    jcfg = jax_get_config(arch, **kw)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    toks = synthetic.make_markov_lm(128, seed=1)(4, 40, 0)
    (jloss, _), jgrads = jax.value_and_grad(jax_make_loss_fn(jm, jcfg), has_aux=True)(
        params, {"tokens": jnp.asarray(toks)})
    cfg = get_config(arch, **kw)
    model = build_model(cfg, device="cpu", trainable=True,
                        params=params_from_jax(_flat(params), cfg))
    loss, _ = make_loss_fn(cfg)(model.lm, {"tokens": torch.from_numpy(toks.astype(np.int64))})
    loss.backward()
    got = named_to_jax({n: p.grad for n, p in model.lm.named_parameters()}, model.cfg)
    want = _flat(jgrads)
    assert sorted(got) == sorted(want)
    errs = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    assert np.median(list(errs.values())) <= GRAD_MEDIAN
    assert abs(loss.item() - float(jloss)) <= TOL


@pytest.mark.parametrize("local_exact", [True, False])
def test_plain_backward_bf16_is_its_f32_result_rounded(local_exact):
    """B1's plain backward on bf16 operands computes in f32 on the same
    values (as the kernel stages them): its gradients are the f32
    backward's on the upcast operands, rounded to bf16 (the state's
    gradient stays f32)."""
    rng = np.random.default_rng(5)
    bh, n, r, h, blk = 3, 64, 8, 16, 16

    def x(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale
                                ).to(torch.bfloat16)

    ins = (x(bh, n, r, scale=0.5), x(bh, n, r, scale=0.5), x(bh, n, h, scale=0.5),
           x(bh, n, h, scale=0.5), x(bh, n, h))
    kw = dict(degree=4, scale=1.0 / h, local_exact=local_exact, block_size=blk)
    out, _, _, saved = pc.polysketch_causal_torch(*ins, return_saved=True, **kw)
    dout = x(bh, n, h)
    got = pc.polysketch_causal_backward_torch(dout, *ins, out, saved, **kw)
    want = pc.polysketch_causal_backward_torch(
        dout.float(), *(t.float() for t in ins), out.float(), saved, **kw)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.to(torch.bfloat16))
    for g, w in zip(got[5:], want[5:]):
        assert g.dtype == torch.float32 and torch.equal(g, w)
