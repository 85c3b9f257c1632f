"""The port's threefry PRNG and sampler held to JAX bit for bit: PRNGKey,
fold_in, split (chained), random_bits, uniform, gumbel and categorical
against jax.random (jax_threefry_partitionable, the installed default),
and sample_token / sample_step against the reference's vmapped sampler
for greedy, temperature, top-k, top-p, their mix, and tied logits."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serve import sampling as jsamp  # noqa: E402

from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve import sampling as tsamp  # noqa: E402

SEEDS = [0, 1, 7, 42, 12345, 2 ** 31 - 1, -1, -12345]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (1000,)]


def _u32(key_t):
    return key_t.numpy().astype(np.uint32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_installed_jax_uses_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_high_dynamic_range_gumbel


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_chained_split_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    for data in (0, 1, 3, 2 ** 31 + 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(_u32(prng.fold_in(tk, data)),
                                      np.asarray(jax.random.fold_in(jk, data)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_u32(prng.split(tk, num)),
                                      np.asarray(jax.random.split(jk, num)))
    # a chain of splits, as a request's stream advances one token at a time
    for _ in range(6):
        jk, jsub = jax.random.split(jk)
        pair = prng.split(tk)
        tk, tsub = pair[0], pair[1]
        np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
        np.testing.assert_array_equal(_u32(tsub), np.asarray(jsub))


def test_prng_key_rejects_seeds_outside_int32():
    with pytest.raises(OverflowError):
        prng.prng_key(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_and_uniform_match_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(
        _u32(prng.random_bits(tk, shape)),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    np.testing.assert_array_equal(_bits(prng.uniform(tk, shape).numpy()),
                                  _bits(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        _bits(prng.uniform(tk, shape, -2.0, 3.0).numpy()),
        _bits(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0)))


@pytest.mark.parametrize("seed", range(6))
def test_gumbel_and_categorical_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(_bits(prng.gumbel(tk, (4096,)).numpy()),
                                  _bits(jax.random.gumbel(jk, (4096,))))
    logits = np.random.default_rng(seed).standard_normal((4, 300)).astype(
        np.float32) * 2
    logits[1] = np.round(logits[1])           # ties
    logits[2, ::3] = -np.inf                  # masked entries
    jsub, tsub = jax.random.split(jk, 4), prng.split(tk, 4)
    want = jax.vmap(jax.random.categorical)(jsub, jnp.asarray(logits))
    got = prng.categorical(tsub, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_xla_log_matches_xla_on_every_uniform_value():
    """Gumbel noise takes log(u) for u = k / 2^23 + tiny and log of its
    negation: XLA's CPU log (not correctly rounded) is matched on all
    2^23 values of u, and on a spread of other positive floats."""
    k = np.arange(2 ** 23, dtype=np.uint32)
    fl = (k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    tiny = np.finfo(np.float32).tiny
    u = np.maximum(np.float32(tiny), fl + np.float32(tiny))
    want1 = np.asarray(jnp.log(u))
    got1 = prng.xla_log(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(_bits(got1), _bits(want1))
    y = -want1
    np.testing.assert_array_equal(
        _bits(prng.xla_log(torch.from_numpy(y)).numpy()),
        _bits(jnp.log(y)))
    x = np.abs(np.random.default_rng(0).standard_normal(100000)
               ).astype(np.float32) * np.float32(1e3) + np.float32(1e-20)
    np.testing.assert_array_equal(_bits(prng.xla_log(torch.from_numpy(x))),
                                  _bits(jnp.log(x)))


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

ROWS = [  # (temperature, top_k, top_p, greedy)
    (0.0, 0, 1.0, True),      # greedy
    (0.7, 0, 1.0, False),     # pure temperature
    (1.3, 40, 1.0, False),    # top-k
    (0.9, 0, 0.6, False),     # top-p
    (0.8, 12, 0.9, False),    # mix
    (1.0, 1, 1.0, False),     # top-k 1 (== greedy)
    (2.0, 200, 0.95, False),  # k above the candidate budget
]


def _params(rows):
    t, k, p, g = zip(*rows)
    return (np.asarray(t, np.float32), np.asarray(k), np.asarray(p, np.float32),
            np.asarray(g))


@pytest.mark.parametrize("vocab", [64, 300])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_sample_step_matches_reference(vocab, ties):
    """One step of every row's schedule (split, then sample with the second
    key), the port's batched call against the reference's vmap."""
    t, k, p, g = _params(ROWS)
    rng = np.random.default_rng(vocab + ties)
    for trial in range(8):
        logits = rng.standard_normal((len(ROWS), vocab)).astype(np.float32) * 3
        if ties:
            logits = np.round(logits)
        seeds = [trial * 11 + i for i in range(len(ROWS))]
        jkeys = jnp.stack([jsamp.request_key(s) for s in seeds])
        want_tok, want_key = jax.vmap(jsamp.sample_step)(
            jkeys, jnp.asarray(logits), jnp.asarray(t),
            jnp.asarray(k, jnp.int32), jnp.asarray(p), jnp.asarray(g))
        tkeys = torch.stack([tsamp.request_key(s) for s in seeds])
        got_tok, got_key = tsamp.sample_step(
            tkeys, torch.from_numpy(logits), torch.from_numpy(t),
            torch.from_numpy(k), torch.from_numpy(p), torch.from_numpy(g))
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
        np.testing.assert_array_equal(_u32(got_key), np.asarray(want_key))


def test_sample_first_logprob_and_advance_key_match_reference():
    logits = np.random.default_rng(3).standard_normal((1, 128)).astype(
        np.float32)
    sp_t = tsamp.SamplingParams(temperature=0.8, top_k=40, top_p=0.95, seed=9)
    sp_j = jsamp.SamplingParams(temperature=0.8, top_k=40, top_p=0.95, seed=9)
    wt, wk, wl = jsamp.sample_first(jnp.asarray(logits), jsamp.request_key(9),
                                    *jsamp.device_scalars(sp_j), logprobs=True)
    gt, gk, gl = tsamp.sample_first(torch.from_numpy(logits),
                                    tsamp.request_key(9)[None],
                                    tsamp.device_scalars(sp_t), logprobs=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(_u32(gk[0]), np.asarray(wk))
    np.testing.assert_allclose(gl.numpy()[0], float(wl), atol=1e-6)
    np.testing.assert_array_equal(
        _u32(tsamp.advance_key(tsamp.request_key(4), 5)),
        np.asarray(jsamp.advance_key(jsamp.request_key(4), 5)))


def test_top_k_one_and_greedy_flag_give_the_argmax():
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 50)).astype(np.float32))
    keys = torch.stack([tsamp.request_key(s) for s in range(3)])
    samp = tsamp.SlotSampling(torch.tensor([1.5, 0.0, 0.9]),
                              torch.tensor([1, 0, 0]),
                              torch.tensor([1.0, 1.0, 1.0]),
                              torch.tensor([False, True, False]))
    tok = tsamp.sample_token(keys, logits, *samp)
    argmax = logits.argmax(-1)
    assert tok[0] == argmax[0] and tok[1] == argmax[1]


def test_sampling_params_validation():
    with pytest.raises(ValueError):
        tsamp.SamplingParams(temperature=-0.1)
    with pytest.raises(ValueError):
        tsamp.SamplingParams(top_k=-1)
    with pytest.raises(ValueError):
        tsamp.SamplingParams(top_p=0.0)
    with pytest.raises(ValueError):
        tsamp.SamplingParams(greedy=False)
    sp = tsamp.SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
    assert not sp.is_greedy and sp.describe() == "t=0.8 k=40 p=0.95"
    assert tsamp.SamplingParams().describe() == "greedy"
