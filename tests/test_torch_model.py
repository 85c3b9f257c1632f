"""The port's gpt2s-polysketch SMOKE model held to the JAX package, from
bridged parameters: train-mode logits, prefill logits and cache, a decode
step, and greedy `generate` tokens across a fold."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import generate  # noqa: E402

TOL = 1e-4
ARCH = "gpt2s-polysketch"


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) from one JAX init."""
    jm = jax_build_model(jax_get_config(ARCH, smoke=True))
    params, _ = jm.init(jax.random.PRNGKey(0))
    flat = dict(zip(tree_paths(params),
                    (np.asarray(x) for x in jax.tree_util.tree_leaves(params))))
    cfg = get_config(ARCH, smoke=True)
    tm = build_model(cfg, device="cpu", params=params_from_jax(flat, cfg))
    return jm, params, tm


def _tokens(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("seq", [16, 40])
def test_train_logits_match_jax(pair, seq):
    jm, params, tm = pair
    toks = _tokens(seq, (2, seq))
    want, _, _ = jm.apply(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                          mode="train", impl="interpret")
    got, cache = tm.lm(torch.from_numpy(toks), mode="train")
    assert cache is None and got.shape == (2, seq, 128)
    _close(got, want)


@pytest.mark.parametrize("seq", [13, 32, 37])
def test_prefill_logits_and_cache_match_jax(pair, seq):
    jm, params, tm = pair
    toks = _tokens(seq, (2, seq))
    jl, jc = jm.state.prefill(params, jnp.asarray(toks, jnp.int32),
                              max_len=seq + 8)
    tl, tc = tm.state.prefill(torch.from_numpy(toks))
    _close(tl, jl)
    node = jc["groups"]["block0"]
    assert len(tc) == 2
    for i, c in enumerate(tc):
        assert c.pos == seq == int(node.pos[i])
        np.testing.assert_allclose(c.z.numpy(), np.asarray(node.z[i]),
                                   atol=TOL, rtol=1e-5)
        for name in ("kbuf", "vbuf", "mbuf"):
            _close(getattr(c, name), getattr(node, name)[i])


def test_decode_step_matches_jax(pair):
    jm, params, tm = pair
    toks = _tokens(3, (2, 15))     # the decode token fills the block: a fold
    jl, jc = jm.state.prefill(params, jnp.asarray(toks, jnp.int32),
                              max_len=32)
    tl, tc = tm.state.prefill(torch.from_numpy(toks))
    nxt = np.array([[5], [77]])
    jl2, jc2 = jm.state.decode_step(params, jnp.asarray(nxt, jnp.int32), 15,
                                    jc)
    tl2, tc2 = tm.state.decode_step(torch.from_numpy(nxt), 15, tc)
    _close(tl2, jl2)
    for i, c in enumerate(tc2):
        assert c.pos == 16
        np.testing.assert_allclose(c.z.numpy(),
                                   np.asarray(jc2["groups"]["block0"].z[i]),
                                   atol=TOL, rtol=1e-5)


def test_greedy_generate_matches_jax_across_a_fold(pair):
    """A 13-token prompt and 8 steps cross SMOKE's 16-token block: the
    decode step folds at position 15. Tokens must be exactly equal."""
    jm, params, tm = pair
    prompt = _tokens(13, (3, 13))
    want = jax_generate(jm, jm.cfg, params, jnp.asarray(prompt, jnp.int32), 8)
    got = generate(tm, prompt, 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.logits_last, want.logits_last)


def test_resumed_prefill_is_bit_identical_to_cold(pair):
    """The port against itself: prefill 16 tokens, resume with 21 more ==
    cold prefill of 37, in logits and every cache leaf."""
    _, _, tm = pair
    toks = torch.from_numpy(_tokens(5, (2, 37)))
    cold_l, cold = tm.state.prefill(toks)
    _, part = tm.state.prefill(toks[:, :16])
    res_l, res = tm.state.resume(toks[:, 16:], part, 16)
    assert torch.equal(cold_l, res_l)
    for a, b in zip(cold, res):
        assert a.pos == b.pos == 37
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y)


def test_decode_step_leaves_its_input_cache_unchanged(pair):
    """Caches are values, as in the reference: a decode step (here one that
    folds a block) returns a new cache and leaves the one it was given as
    it was, so stepping from it again gives the same logits."""
    _, _, tm = pair
    _, cache = tm.state.prefill(torch.from_numpy(_tokens(6, (2, 15))))
    before = [[x.clone() for x in c[:4]] for c in cache]
    nxt = torch.from_numpy(np.array([[5], [77]]))
    first, _ = tm.state.decode_step(nxt, 15, cache)
    for c, b in zip(cache, before):
        assert c.pos == 15
        assert all(torch.equal(x, y) for x, y in zip(c[:4], b))
    again, _ = tm.state.decode_step(nxt, 15, cache)
    assert torch.equal(first, again)


def test_prefill_segment_lies_in_one_block():
    from repro_torch.core.decode import init_polysketch_cache, polysketch_prefill
    cache = init_polysketch_cache(1, 1, 8, 4, 16)
    m, x = torch.zeros(1, 1, 17, 4), torch.zeros(1, 1, 17, 8)
    kw = dict(degree=4, scale=1.0 / 8)
    with pytest.raises(ValueError, match="one block"):
        polysketch_prefill(cache, m, m, x, x, x, **kw)
    with pytest.raises(ValueError, match="one block"):
        polysketch_prefill(cache._replace(pos=3), m[:, :, :4], m[:, :, :4],
                           x[:, :, :4], x[:, :, :4], x[:, :, :4], **kw)


def test_generate_rejects_sampling_and_overflow(pair):
    _, _, tm = pair
    prompt = _tokens(0, (1, 4))
    with pytest.raises(NotImplementedError, match="A.9"):
        generate(tm, prompt, 2, temperature=0.7)
    with pytest.raises(ValueError, match="max_len"):
        generate(tm, prompt, 8, max_len=10)


def test_serve_cli_runs_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--smoke", "--device", "cpu", "--requests", "2", "--prompt-len",
          "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert "req0: len=20 +3 tok" in out and "req1:" in out
    assert "generated tok/s" in out
