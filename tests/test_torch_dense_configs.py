"""The registry's dense polysketch models (deepseek-7b, starcoder2-3b,
qwen3-14b, yi-34b) in the port, held to the JAX package on their SMOKE
configs from bridged parameters: the registry, train-mode logits, prefill
logits and caches, greedy tokens (exactly equal) with their last logits,
12 AdamW steps on the JAX loss, and qwen3's per-head q/k RMS norm against
the reference's `_rms`. f32 at 1e-4. One JAX init per arch, shared by the
module."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.attention import _rms as jax_rms  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models.layers import rms  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import generate  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

TOL = 1e-4
ARCHS = ["deepseek-7b", "starcoder2-3b", "qwen3-14b", "yi-34b"]


@pytest.fixture(scope="module")
def inits():
    """{arch: (jax model, jax params, flat params)}, one JAX init each,
    made on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = jax_build_model(jax_get_config(arch, smoke=True))
            params, _ = jm.init(jax.random.PRNGKey(0))
            flat = dict(zip(tree_paths(params),
                            map(np.asarray, jax.tree_util.tree_leaves(params))))
            cache[arch] = jm, params, flat
        return cache[arch]
    return get


def _port(flat, arch, trainable=False):
    cfg = get_config(arch, smoke=True)
    return build_model(cfg, device="cpu", trainable=trainable,
                       params=params_from_jax(flat, cfg))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, size=shape)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_resolves_the_reference_configs(arch):
    """CONFIG and SMOKE equal the reference's field for field, and the full
    config builds (on the meta device: no weights drawn)."""
    for smoke in (False, True):
        cfg, ref = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
        for field in cfg.__dataclass_fields__:
            assert getattr(cfg, field) == getattr(ref, field), (arch, smoke, field)
    cfg = get_config(arch)
    assert cfg.resolved_head_dim == 128 and cfg.compute_dtype == "bfloat16"
    lm = build_model(cfg, device="meta").lm
    assert len(lm.layers) == cfg.n_layers
    assert hasattr(lm.layers[0].mixer, "q_norm") == cfg.qk_norm


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_jax(inits, arch):
    jm, params, flat = inits(arch)
    toks = _tokens(40, (2, 40))
    want, _, _ = jm.apply(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                          mode="train", impl="xla")
    with torch.no_grad():
        got, _ = _port(flat, arch).lm(torch.from_numpy(toks), mode="train")
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(inits, arch):
    jm, params, flat = inits(arch)
    toks = _tokens(37, (2, 37))
    jl, jc = jm.state.prefill(params, jnp.asarray(toks, jnp.int32), max_len=45)
    tl, tc = _port(flat, arch).state.prefill(torch.from_numpy(toks))
    _close(tl, jl)
    node = jc["groups"]["block0"]
    assert len(tc) == 2
    for i, c in enumerate(tc):
        assert c.pos == 37 == int(node.pos[i])
        np.testing.assert_allclose(c.z.numpy(), np.asarray(node.z[i]),
                                   atol=TOL, rtol=1e-5)
        for name in ("kbuf", "vbuf", "mbuf"):
            _close(getattr(c, name), getattr(node, name)[i])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(inits, arch):
    """A 13-token prompt and 8 steps, across SMOKE's 16-token block (the
    decode step folds at position 15): tokens exactly equal."""
    jm, params, flat = inits(arch)
    prompt = _tokens(13, (3, 13))
    want = jax_generate(jm, jm.cfg, params, jnp.asarray(prompt, jnp.int32), 8)
    got = generate(_port(flat, arch), prompt, 8)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.logits_last, want.logits_last)


@pytest.mark.parametrize("arch", ARCHS)
def test_twelve_steps_match_jax(inits, arch):
    """12 AdamW steps at lr 3e-3 from bridged params: the loss within 1e-4
    at every step."""
    jm, params, flat = inits(arch)
    kw = dict(seq_len=40, global_batch=4, steps=12, peak_lr=3e-3)
    jstep = jax.jit(jax_make_train_step(jm, jax_get_config(arch, smoke=True),
                                        JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(params)
    state = init_train_state(_port(flat, arch, trainable=True).lm)
    step = make_train_step(get_config(arch, smoke=True), TrainConfig(**kw))
    data = synthetic.make_markov_lm(128, seed=1)
    for i in range(12):
        toks = data(4, 40, i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, met = step(state, {"tokens": torch.from_numpy(toks.astype(np.int64))})
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= TOL, i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_rms_norm_matches_reference(dtype):
    """The port's per-head RMS norm (f32 inside, eps 1e-6, cast back) against
    the reference's `_rms`, with a scale away from its init."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32) * 3.0
    scale = rng.standard_normal(16).astype(np.float32)
    want = jax_rms(jnp.asarray(x).astype(dtype), jnp.asarray(scale))
    got = rms(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale))
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got, want, TOL if dtype == "float32" else 1e-2)
