"""Training the exact polynomial baseline (gpt2s-poly4's mechanism) in the
port, held to the JAX package on the CPU: B2's plain backward
(poly_flash_backward_torch) against jax.vjp of poly_attention_full and
against torch.autograd of the plain forward, ops.poly_attention's
gradients (GQA included) against jax.grad, the guards of the gradient
path, and 12 SMOKE-polynomial AdamW steps whose loss follows the JAX
package's within 1e-4. The CUDA backward runs only on a card; its cases
are in tests/test_torch_gpu.py.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.poly_attention import poly_attention_full as jax_poly_full  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import named_to_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import poly_flash as pf  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

ARCH = "gpt2s-polysketch"


def _inputs(seed, shapes, degree):
    """q, k, v LayerNorm'd per row like the model's; at odd degree |q| and
    |k|, so that 1 + den stays >= 1."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    for i in (0, 1):
        x = xs[i]
        xs[i] = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
        if degree % 2:
            xs[i] = np.abs(xs[i])
    return xs


def _rel_close(got, want, tol, name=""):
    want = np.asarray(want, np.float64)
    e = np.abs(np.asarray(got, np.float64) - want).max()
    assert e <= tol * np.abs(want).max(), (name, e, np.abs(want).max())


# ---------------------------------------------------------------------------
# B2's plain backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [16, 77, 200])
def test_plain_backward_matches_jax_vjp_and_autograd(degree, n):
    """poly_flash_backward_torch from the plain forward's out and D, in
    query blocks of 32 (n 77 and 200 end in a ragged block), against
    jax.vjp of poly_attention_full and torch.autograd of poly_flash_torch,
    each gradient within 1e-4 (autograd: 1e-5) of its own max|.|."""
    bh, h = 3, 16
    q, k, v = _inputs(degree + n, [(bh, n, h)] * 3, degree)
    dout = np.random.default_rng(n).standard_normal((bh, n, h)).astype(np.float32)
    kw = dict(degree=degree, scale=1.0 / h)
    _, vjp = jax.vjp(lambda a, b, c: jax_poly_full(a, b, c, causal=True, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, den = pf.poly_flash_torch(tq, tk, tv, return_den=True, block_q=32, **kw)
    assert den.shape == (bh, n) and den.dtype == torch.float32
    got = pf.poly_flash_backward_torch(tdo, tq, tk, tv, out, den, block_q=32, **kw)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    auto = torch.autograd.grad(pf.poly_flash_torch(*leaves, **kw), leaves, tdo)
    for name, g, w, a in zip("qkv", got, want, auto):
        _rel_close(g.numpy(), w, 1e-4, "d" + name)
        _rel_close(g.numpy(), a.numpy(), 1e-5, "d" + name)


@pytest.mark.parametrize("case", ["mha", "gqa_4_2"])
@pytest.mark.parametrize("degree", [2, 4])
def test_ops_gradients_match_jax(case, degree):
    """ops.poly_attention's gradients (through the Function and the plain
    backward; GQA repeats the kv heads before it, and autograd sums the
    repeats) against jax.grad of the JAX op on its XLA path."""
    hkv = 4 if case == "mha" else 2
    b, hq, s, hd = 2, 4, 40, 16
    q, k, v = _inputs(7, [(b, hq, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)], degree)
    dout = np.random.default_rng(8).standard_normal((b, hq, s, hd)).astype(np.float32)

    def jloss(*xs):
        return jnp.sum(jax_ops.poly_attention(*xs, degree=degree, impl="xla") * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (ops.poly_attention(*xs, degree=degree) * torch.from_numpy(dout)).sum().backward()
    for name, x, w in zip("qkv", xs, want):
        assert x.grad.shape == x.shape
        _rel_close(x.grad.numpy(), w, 1e-4, "d" + name)


def test_bf16_gradient_raises():
    """Since B2's backward takes bfloat16, a bf16 gradient no longer raises
    and comes back in bf16 (tests/test_torch_b2_bf16.py holds its values
    to jax.grad); float16, which neither version takes, still raises."""
    x = torch.zeros(1, 2, 32, 8, dtype=torch.bfloat16, requires_grad=True)
    out = ops.poly_attention(x, x, x, degree=4)
    (g,) = torch.autograd.grad(out.sum(), x)
    assert g.dtype == torch.bfloat16 and g.shape == x.shape
    h = torch.zeros(1, 2, 32, 8, dtype=torch.float16, requires_grad=True)
    with pytest.raises(TypeError, match="float32"):
        ops.poly_attention(h, h, h, degree=4).sum().backward()


def test_noncausal_gradient_raises():
    x = torch.zeros(1, 2, 32, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="causal"):
        ops.poly_attention(x, x, x, degree=4, causal=False)
    with torch.no_grad():   # without grad, non-causal runs as before
        assert ops.poly_attention(x, x, x, degree=4, causal=False).shape == x.shape


def test_cuda_backward_refuses_cpu_tensors_and_wide_heads():
    x, den = torch.zeros(2, 32, 8), torch.ones(2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pf.poly_flash_backward_cuda(x, x, x, x, x, den, degree=4, scale=0.125)
    with pytest.raises(ValueError, match="h <= 128"):
        pf.check_backward_shapes(256)


# ---------------------------------------------------------------------------
# SMOKE-polynomial training against the JAX package
# ---------------------------------------------------------------------------

def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


@pytest.fixture(scope="module")
def jax_pair():
    """(jax model, jax params) of SMOKE-polynomial p4 from PRNGKey(0)."""
    jm = jax_build_model(jax_get_config(ARCH, smoke=True, attention="polynomial"))
    params, _ = jm.init(jax.random.PRNGKey(0))
    return jm, params


def _trainable(params):
    cfg = get_config(ARCH, smoke=True, attention="polynomial")
    return build_model(cfg, device="cpu", trainable=True,
                       params=params_from_jax(_flat(params), cfg))


def _markov(batch, seq, step):
    return jax_synthetic.make_markov_lm(128, seed=1)(batch, seq, step)


def test_polynomial_loss_gradients_match_jax(jax_pair):
    jm, params = jax_pair
    toks = _markov(4, 40, 0)
    (want_loss, _), want = jax.value_and_grad(
        jax_make_loss_fn(jm, jm.cfg), has_aux=True)(params, {"tokens": jnp.asarray(toks)})
    model = _trainable(params)
    loss, _ = make_loss_fn(model.cfg)(model.lm,
                                      {"tokens": torch.from_numpy(toks.astype(np.int64))})
    loss.backward()
    got = named_to_jax({n: p.grad for n, p in model.lm.named_parameters()}, model.cfg)
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want = _flat(want)
    assert sorted(got) == sorted(want)
    for path in want:
        _rel_close(got[path], want[path], 1e-4, path)


def test_polynomial_twelve_steps_match_jax(jax_pair):
    """12 AdamW steps at lr 3e-3 from bridged params through B2's plain
    forward and backward: the loss within 1e-4 at every step, the params
    within 1e-4 of each leaf's max."""
    jm, params = jax_pair
    kw = dict(seq_len=40, global_batch=4, steps=12, peak_lr=3e-3)
    jstep = jax.jit(jax_make_train_step(jm, jm.cfg, JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(params)
    model = _trainable(params)
    state = init_train_state(model.lm)
    step = make_train_step(model.cfg, TrainConfig(**kw))
    calls = pf.poly_flash_backward_torch
    seen = []

    def counted(*a, **k):
        seen.append(1)
        return calls(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "poly_flash_backward_torch", counted)
        for i in range(12):
            toks = _markov(4, 40, i)
            jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
            state, met = step(state, {"tokens": torch.from_numpy(toks.astype(np.int64))})
            assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4, i
    assert len(seen) == 12 * model.cfg.n_layers      # the backward, once a layer a step
    assert state.step == int(jstate.step) == 12
    want = _flat(jstate.params)
    got = params_to_jax(state.lm)
    for path in want:
        _rel_close(got[path], want[path], 1e-4, path)
