"""The port's softmax baseline (gpt2s-softmax's mechanism) held to the JAX
package on the same numpy inputs, on the CPU: softmax_attention_full and
kv_decode_step, the kv_full decode state, and the SMOKE model with
attention="softmax" (train, prefill and decode logits within 1e-4, greedy
tokens exactly equal, gradients per leaf within 1e-4 of the leaf's max, 12
AdamW steps whose loss follows the JAX package's within 1e-4). Softmax runs
no kernel of the port: plain ops, as the reference computes it.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import decode as jdec  # noqa: E402
from repro.core import state as jst  # noqa: E402
from repro.core.poly_attention import softmax_attention_full as jax_softmax  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import named_to_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.gpt2_paper import GPT2_SMALL_SOFTMAX  # noqa: E402
from repro_torch.core import decode as tdec  # noqa: E402
from repro_torch.core.poly_attention import softmax_attention_full  # noqa: E402
from repro_torch.core.state import mixer_state_kind  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import generate  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

ARCH = "gpt2s-polysketch"


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


# ---------------------------------------------------------------------------
# softmax_attention_full and kv_decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["causal", "noncausal", "s_lt_t", "window",
                                  "s_lt_t_window", "scale"])
def test_softmax_attention_full_matches_jax(case):
    """Causal and not, fewer queries than keys (the mask offset by t - s),
    a sliding window, and an explicit scale."""
    s, t = (24, 40) if case.startswith("s_lt_t") else (40, 40)
    kw = {"noncausal": dict(causal=False), "window": dict(window=7),
          "s_lt_t_window": dict(window=9), "scale": dict(scale=0.3)}.get(case, {})
    q, k, v = _np((2, 3, s, 16), 0), _np((2, 3, t, 16), 1), _np((2, 3, t, 16), 2)
    want = jax_softmax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = softmax_attention_full(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.shape == (2, 3, s, 16) and got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_softmax_attention_full_gqa_repeat_matches_jax():
    """GQA as the mixer runs it: kv heads repeated to the query heads
    (jnp.repeat against repeat_interleave), then causal softmax."""
    q, k, v = _np((2, 4, 32, 8), 3), _np((2, 2, 32, 8), 4), _np((2, 2, 32, 8), 5)
    want = jax_softmax(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=1),
                       jnp.repeat(jnp.asarray(v), 2, axis=1), causal=True)
    tk, tv = (torch.from_numpy(x).repeat_interleave(2, dim=1) for x in (k, v))
    _close(softmax_attention_full(torch.from_numpy(q), tk, tv, causal=True), want, 1e-5)


@pytest.mark.parametrize("pos", [0, 13, 23])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa_4_2"])
def test_kv_decode_step_matches_jax_and_keeps_its_input(pos, hkv):
    """MHA and GQA 4:2 over a cache of 24 slots, at the first and the last
    slot; the input cache is left as it was."""
    bsz, hq, smax, hd = 2, 4, 24, 8
    kc, vc = _np((bsz, hkv, smax, hd), 0), _np((bsz, hkv, smax, hd), 1)
    kc[:, :, pos:] = 0.0
    vc[:, :, pos:] = 0.0
    q, k, v = _np((bsz, hq, hd), 2), _np((bsz, hkv, hd), 3), _np((bsz, hkv, hd), 4)
    jc = jdec.KVCache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos, jnp.int32))
    jo, jc2 = jdec.kv_decode_step(jc, *map(jnp.asarray, (q, k, v)))
    tc = tdec.KVCache(torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), pos)
    to, tc2 = tdec.kv_decode_step(tc, *map(torch.from_numpy, (q, k, v)))
    _close(to, jo, 1e-5)
    assert tc2.pos == pos + 1 == int(jc2.pos)
    np.testing.assert_array_equal(tc2.k.numpy(), np.asarray(jc2.k))
    np.testing.assert_array_equal(tc2.v.numpy(), np.asarray(jc2.v))
    np.testing.assert_array_equal(tc.k.numpy(), kc)      # input left as it was
    np.testing.assert_array_equal(tc.v.numpy(), vc)
    with pytest.raises(ValueError, match="full"):
        tdec.kv_decode_step(tc._replace(pos=smax), *map(torch.from_numpy, (q, k, v)))


# ---------------------------------------------------------------------------
# the SMOKE model with attention="softmax", against the JAX model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa_4_2"])
def pair(request):
    """(jax model, jax params, port model) from one JAX init; n_kv_heads 4
    (SMOKE's) or 2 (GQA)."""
    over = dict(attention="softmax", n_kv_heads=request.param)
    jm = jax_build_model(jax_get_config(ARCH, smoke=True, **over))
    params, _ = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True, **over)
    tm = build_model(cfg, device="cpu", params=params_from_jax(_flat(params), cfg))
    return jm, params, tm


def _tokens(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def test_softmax_train_logits_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(40, (2, 40))
    want, _, _ = jm.apply(params, {"tokens": jnp.asarray(toks, jnp.int32)}, mode="train")
    got, cache = tm.lm(torch.from_numpy(toks), mode="train")
    assert cache is None
    _close(got, want)


def test_softmax_prefill_and_decode_match_jax(pair):
    """One prefill call over the 37-token prompt fills the KV cache at 0;
    then two decode steps read it."""
    jm, params, tm = pair
    toks = _tokens(3, (2, 37))
    jl, jc = jm.state.prefill(params, jnp.asarray(toks, jnp.int32), max_len=48)
    tl, tc = tm.state.prefill(torch.from_numpy(toks), max_len=48)
    _close(tl, jl)
    node = jc["groups"]["block0"]
    hkv = tm.cfg.n_kv_heads
    for i, c in enumerate(tc):
        assert c.pos == 37 == int(node.pos[i]) and c.k.shape == (2, hkv, 48, 16)
        _close(c.k, node.k[i])
        _close(c.v, node.v[i])
    for step, nxt in enumerate((np.array([[5], [77]]), np.array([[9], [1]]))):
        jl, jc = jm.state.decode_step(params, jnp.asarray(nxt, jnp.int32), 37 + step, jc)
        tl, tc = tm.state.decode_step(torch.from_numpy(nxt), 37 + step, tc)
        _close(tl, jl)
        assert all(c.pos == 38 + step for c in tc)


def test_softmax_greedy_generate_matches_jax(pair):
    jm, params, tm = pair
    prompt = _tokens(13, (3, 13))
    want = jax_generate(jm, jm.cfg, params, jnp.asarray(prompt, jnp.int32), 8)
    got = generate(tm, prompt, 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.logits_last, want.logits_last)


def test_kv_full_state_is_not_resumable_and_needs_max_len(pair):
    jm, _, tm = pair
    st = tm.state
    assert st.kind == "kv_full" == jst.mixer_state_kind(jm.cfg, "attn")
    assert st.resumable is False is jst.get_spec("kv_full").resumable
    toks = torch.from_numpy(_tokens(1, (1, 8)))
    with pytest.raises(ValueError, match="max_len"):
        st.prefill(toks)
    _, cache = st.prefill(toks, max_len=16)
    with pytest.raises(ValueError, match="not resumable"):
        st.resume(toks, cache, 8)


def test_softmax_tree_round_trips_through_the_bridge(pair):
    """The softmax tree has neither the q/k LayerNorm leaves nor a sketch,
    and goes both ways leaf for leaf."""
    jm, params, tm = pair
    flat = _flat(params)
    assert not any("pln_" in p or "sketch" in p for p in flat)
    assert not any("pln_" in n for n, _ in tm.lm.named_parameters())
    back = params_to_jax(tm.lm)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        assert back[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


def test_full_softmax_config_builds_on_meta_with_jax_shapes():
    """GPT2_SMALL_SOFTMAX at full width: the port's leaves have JAX's paths,
    shapes and dtypes, and its state kind is kv_full."""
    from repro.configs.gpt2_paper import GPT2_SMALL_SOFTMAX as JAX_SOFTMAX
    jm = jax_build_model(JAX_SOFTMAX)
    shapes = jax.eval_shape(lambda key: jm.init(key)[0], jax.random.PRNGKey(0))
    want = {p: (tuple(s.shape), np.dtype(s.dtype))
            for p, s in zip(tree_paths(shapes), jax.tree_util.tree_leaves(shapes))}
    model = build_model(GPT2_SMALL_SOFTMAX, device="meta")
    got = {p: (a.shape, a.dtype) for p, a in params_to_jax(model.lm).items()}
    assert got == want
    assert mixer_state_kind(GPT2_SMALL_SOFTMAX) == "kv_full"


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _markov(batch, seq, step):
    return jax_synthetic.make_markov_lm(128, seed=1)(batch, seq, step)


def _leaf_close(got: dict, want: dict, tol):
    """Every leaf within tol of its own max|.|."""
    assert sorted(got) == sorted(want)
    for path in want:
        w = np.asarray(want[path], np.float64)
        e = np.abs(np.asarray(got[path], np.float64) - w).max()
        assert e <= tol * max(np.abs(w).max(), 1e-30), (path, e, np.abs(w).max())


def _trainable(params, cfg):
    return build_model(cfg, device="cpu", trainable=True,
                       params=params_from_jax(_flat(params), cfg))


def test_softmax_loss_gradients_match_jax(pair):
    jm, params, _ = pair
    cfg = pair[2].cfg
    toks = _markov(4, 40, 0)
    (want_loss, _), want = jax.value_and_grad(
        jax_make_loss_fn(jm, jm.cfg), has_aux=True)(params, {"tokens": jnp.asarray(toks)})
    model = _trainable(params, cfg)
    loss, _ = make_loss_fn(cfg)(model.lm, {"tokens": torch.from_numpy(toks.astype(np.int64))})
    loss.backward()
    got = named_to_jax({n: p.grad for n, p in model.lm.named_parameters()}, model.cfg)
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    _leaf_close(got, _flat(want), 1e-4)


def test_softmax_twelve_steps_match_jax(pair):
    """12 AdamW steps at lr 3e-3 from bridged params: the loss within 1e-4
    at every step, the params within 1e-4 of each leaf's max."""
    jm, params, _ = pair
    cfg = pair[2].cfg
    kw = dict(seq_len=40, global_batch=4, steps=12, peak_lr=3e-3)
    jstep = jax.jit(jax_make_train_step(jm, jm.cfg, JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(params)
    state = init_train_state(_trainable(params, cfg).lm)
    step = make_train_step(cfg, TrainConfig(**kw))
    for i in range(12):
        toks = _markov(4, 40, i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, met = step(state, {"tokens": torch.from_numpy(toks.astype(np.int64))})
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4, i
    assert state.step == int(jstate.step) == 12
    _leaf_close(params_to_jax(state.lm), _flat(jstate.params), 1e-4)


def test_train_cli_runs_softmax_smoke_on_cpu(tmp_path):
    """The trainer through its CLI with --set attention=softmax, as the
    README says, and a checkpoint."""
    from repro_torch.launch import train as train_cli
    state = train_cli.main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
                            "--seq", "32", "--set", "attention=softmax",
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    assert state.step == 3 and state.lm.cfg.attention == "softmax"
    assert not any("pln_" in n for n, _ in state.lm.named_parameters())
