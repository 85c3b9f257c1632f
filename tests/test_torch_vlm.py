"""llava-next-mistral-7b (the VLM: precomputed image embeddings spliced
over the first n_image_tokens positions, GQA 2:1 in SMOKE) and untied
embeddings (the ``lm_head`` leaf) in the port, held to the JAX package on
SMOKE from one JAX init each: the registry and the parameter count; the
bridge both ways with the training state's keys, and the decay mask leaf
for leaf; train logits with and without image_embeds (1e-4), and the
image rows changing them; the reference's batch-dict prefill (one call)
against the port's on the block grid, then decode steps; the engine's
token-only tokens against the JAX engine's; a prompt shorter than the
image refused; gradients against jax.grad; 12 AdamW steps with image
embeddings under remat "none" and "dots"; the config's input specs; the
training CLI on tokens. The JAX side runs under jax.jit."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import SHAPES  # noqa: E402
from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.models.model_zoo import input_specs as jax_input_specs  # noqa: E402
from repro.optim.adamw import _wd_mask  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import make_serve_fns as jax_make_serve_fns  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.bridge import (jax_path, params_from_jax,  # noqa: E402
                                params_to_jax, train_state_from_jax,
                                train_state_to_jax)
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model_zoo import build_model, input_specs  # noqa: E402
from repro_torch.serve.engine import ServeEngine, generate, make_serve_fns  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

TOL = 1e-4
ARCH = "llava-next-mistral-7b"
N_IMG, D = 8, 64                 # SMOKE's n_image_tokens and d_model
TIES = [True, False]             # tied embeddings (published), untied (lm_head)


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


@pytest.fixture(scope="module")
def inits():
    """{tie: (jax model, jax params, flat params)}, one JAX init each."""
    cache = {}

    def get(tie=True):
        if tie not in cache:
            jm = jax_build_model(jax_get_config(ARCH, smoke=True, tie_embeddings=tie))
            params, _ = jm.init(jax.random.PRNGKey(0))
            cache[tie] = jm, params, _flat(params)
        return cache[tie]
    return get


def _port(flat, trainable=False, **over):
    cfg = get_config(ARCH, smoke=True, **over)
    return build_model(cfg, device="cpu", trainable=trainable,
                       params=params_from_jax(flat, cfg))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, size=shape)


def _image(seed, batch, n=N_IMG):
    return (np.random.default_rng(seed).standard_normal((batch, n, D)) * 0.5
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()
                                          if torch.is_tensor(got) else got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _markov(batch, seq, step):
    return synthetic.make_markov_lm(128, seed=1)(batch, seq, step)


# ---------------------------------------------------------------------------
# registry, bridge, decay mask
# ---------------------------------------------------------------------------

def test_registry_and_parameter_count():
    """CONFIG and SMOKE equal the reference's field for field (the five
    encoder-decoder and VLM fields included); the full config builds on
    the meta device with jax.eval_shape's parameter count."""
    for smoke in (False, True):
        cfg, ref = get_config(ARCH, smoke=smoke), jax_get_config(ARCH, smoke=smoke)
        for field in cfg.__dataclass_fields__:
            assert getattr(cfg, field) == getattr(ref, field), (smoke, field)
        for field in ("encoder_layers", "encoder_len", "cross_attention",
                      "n_image_tokens", "unroll_layers"):
            assert field in cfg.__dataclass_fields__
    lm = build_model(get_config(ARCH), device="meta").lm
    jm = jax_build_model(jax_get_config(ARCH))
    shapes = jax.eval_shape(lambda key: jm.init(key)[0], jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in lm.parameters()) == want == 7_114_403_840


@pytest.mark.parametrize("tie", TIES)
def test_bridge_both_ways_and_training_state_keys(inits, tie):
    """Every leaf round-trips (lm_head when untied); the training state's
    flat arrays carry the reference checkpoint's keys and shapes, and load
    back into a fresh model."""
    _, params, flat = inits(tie)
    assert ("lm_head" in flat) == (not tie)
    model = _port(flat, trainable=True, tie_embeddings=tie)
    back = params_to_jax(model.lm)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
    got = train_state_to_jax(init_train_state(model.lm))
    want = jax_flatten(jax_init_train_state(params))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].shape == np.shape(arr) and got[key].dtype == arr.dtype, key
    lm = build_model(get_config(ARCH, smoke=True, tie_embeddings=tie), device="cpu",
                     seed=3, trainable=True).lm
    restored = train_state_from_jax(got, lm)
    for name, p in restored.lm.named_parameters():
        assert torch.equal(p, dict(model.lm.named_parameters())[name]), name


@pytest.mark.parametrize("tie", TIES)
def test_decay_mask_is_the_reference_mask_leaf_for_leaf(inits, tie):
    _, params, flat = inits(tie)
    cfg = get_config(ARCH, smoke=True, tie_embeddings=tie)
    want = dict(zip(tree_paths(params), jax.tree_util.tree_leaves(_wd_mask(params))))
    lm = _port(flat, trainable=True, tie_embeddings=tie).lm
    got = optim.decay_mask(dict(lm.named_parameters()), cfg)
    for name, m in got.items():
        assert m == want[jax_path(name, cfg)], name
    assert {jax_path(n, cfg) for n in got} == set(want)
    if not tie:
        assert got["lm_head"] == 1.0


def test_input_specs_match_the_reference():
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        for arch in (ARCH, "whisper-large-v3", "qwen3-14b"):
            want = jax_input_specs(jax_get_config(arch), SHAPES[kind])
            got = input_specs(get_config(arch), SHAPES[kind])
            assert sorted(got) == sorted(want), (arch, kind)
            for k, (shape, dt) in got.items():
                assert shape == want[k].shape, (arch, kind, k)
                assert str(dt)[6:] == str(want[k].dtype), (arch, kind, k)


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tie", TIES)
def test_train_logits_with_and_without_image_embeds_match_jax(inits, tie):
    """2 x 40 tokens, with and without 8 image rows: logits within 1e-4;
    image_embeds + 1 changes them (tests/test_models.py's check), and the
    text rows' embeddings alone do not reach the image rows."""
    jm, params, flat = inits(tie)
    toks, img = _tokens(40, (2, 40)), _image(41, 2)
    japply = jax.jit(lambda p, b: jm.apply(p, b, mode="train")[0])
    lm = _port(flat, tie_embeddings=tie).lm
    outs = {}
    for name, im in (("text", None), ("image", img), ("image+1", img + 1.0)):
        batch = {"tokens": jnp.asarray(toks, jnp.int32)}
        if im is not None:
            batch["image_embeds"] = jnp.asarray(im)
        want = japply(params, batch)
        with torch.no_grad():
            got, _ = lm(torch.from_numpy(toks), mode="train",
                        image_embeds=None if im is None else torch.from_numpy(im))
        _close(got, want)
        outs[name] = got
    assert (outs["image"] - outs["image+1"]).abs().max() > 1e-4
    assert (outs["image"] - outs["text"]).abs().max() > 1e-4


def test_a_prompt_shorter_than_the_image_raises(inits):
    _, _, flat = inits()
    model = _port(flat)
    img = torch.from_numpy(_image(1, 1))
    with pytest.raises(ValueError, match="image embeddings"):
        model.lm(torch.zeros((1, N_IMG - 1), dtype=torch.long), image_embeds=img)
    prefill, _ = make_serve_fns(model)
    with pytest.raises(ValueError, match="image embeddings"):
        prefill({"tokens": np.zeros((1, N_IMG - 1), np.int64), "image_embeds": img})


@pytest.mark.parametrize("tie", TIES)
@pytest.mark.parametrize("n_img", [N_IMG, 20])
def test_batch_dict_prefill_and_decode_match_the_reference(inits, tie, n_img):
    """The reference's make_serve_fns prefill (one call over the prompt,
    the image spliced) against the port's on the block grid of 16, where
    20 image rows span two calls: last logits within 1e-4, then 5 decode
    steps (positions shared, then one per row)."""
    jm, params, flat = inits(tie)
    jcfg = jax_get_config(ARCH, smoke=True, tie_embeddings=tie, n_image_tokens=n_img)
    jm = jax_build_model(jcfg)
    jpre, jdec = jax_make_serve_fns(jm, jcfg)
    jpre, jdec = jax.jit(jpre), jax.jit(jdec)
    model = _port(flat, tie_embeddings=tie, n_image_tokens=n_img)
    prefill, decode = make_serve_fns(model)
    toks, img = _tokens(7, (2, 45)), _image(8, 2, n_img)
    jl, jc = jpre(params, {"tokens": jnp.asarray(toks[:, :37], jnp.int32),
                           "image_embeds": jnp.asarray(img)})
    tl, tc = prefill({"tokens": toks[:, :37], "image_embeds": img})
    _close(tl, jl)
    for i in range(37, 42):
        jl, jc = jdec(params, jnp.asarray(toks[:, i:i + 1], jnp.int32), jc,
                      jnp.asarray([i]))
        pos = i if i < 40 else torch.tensor([i, i])
        tl, tc = decode(torch.from_numpy(toks[:, i:i + 1]), tc, pos)
        _close(tl, jl)


def test_engine_token_only_matches_the_jax_engine(inits):
    """Token-only serving through DecodeState (the reference's llava path):
    a greedy and a sampled request on 2 slots emit the JAX engine's
    tokens; the greedy one equals batch-1 generate's."""
    from repro.serve import SamplingParams as JaxSamplingParams
    from repro_torch.serve.sampling import SamplingParams
    _, params, flat = inits()
    jcfg = jax_get_config(ARCH, smoke=True)
    tm = _port(flat)
    work = [(19, 6, {}), (33, 5, dict(temperature=0.8, top_k=12, top_p=0.9, seed=7))]
    prompts = [_tokens(50 + i, n) for i, (n, _, _) in enumerate(work)]
    jeng = JaxServeEngine(jax_build_model(jcfg), jcfg, params, slots=2, max_len=48)
    eng = ServeEngine(tm, slots=2, max_len=48)
    for p, (_, gen, kw) in zip(prompts, work):
        jeng.submit(jnp.asarray(p, jnp.int32), gen, sampling=JaxSamplingParams(**kw))
        eng.submit(p, gen, sampling=SamplingParams(**kw))
    want = {o.rid: np.asarray(o.tokens) for o in jeng.run()}
    got = {o.rid: o.tokens for o in eng.run()}
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=str(rid))
    ref = generate(tm, prompts[0][None], work[0][1]).tokens[0].numpy()
    np.testing.assert_array_equal(got[0], ref)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(seed, batch=2, seq=32):
    return {"tokens": _markov(batch, seq, seed), "image_embeds": _image(100 + seed, batch)}


@pytest.mark.parametrize("tie", TIES)
def test_gradients_match_jax_grad(inits, tie):
    """One batch with image rows: every leaf's gradient within 1e-4 of
    jax.grad of the reference's loss (relative to the leaf's max)."""
    jm, params, flat = inits(tie)
    batch = _batch(0)
    jloss = jax_make_loss_fn(jm, jm.cfg)
    jgrads = jax.jit(jax.grad(lambda p, b: jloss(p, b)[0]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = _flat(jgrads)
    cfg = get_config(ARCH, smoke=True, tie_embeddings=tie)
    lm = _port(flat, trainable=True, tie_embeddings=tie).lm
    loss, _ = make_loss_fn(cfg)(lm, {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64)),
                                     "image_embeds": torch.from_numpy(batch["image_embeds"])})
    loss.backward()
    got = params_to_jax_grads(lm, cfg)
    assert sorted(got) == sorted(want)
    for path, g in want.items():
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(got[path] / scale, np.asarray(g) / scale, atol=TOL,
                                   err_msg=path)


def params_to_jax_grads(lm, cfg):
    from repro_torch.bridge import named_to_jax
    return named_to_jax({n: p.grad for n, p in lm.named_parameters()}, cfg)


@pytest.mark.parametrize("tie,remat", [(True, "none"), (False, "dots")])
def test_twelve_steps_with_image_embeds_match_jax(inits, tie, remat):
    """12 AdamW steps at lr 3e-3 on batches that carry image rows: loss
    within 1e-4 of the reference's step at every step."""
    _, params, flat = inits(tie)
    kw = dict(seq_len=32, global_batch=2, steps=12, peak_lr=3e-3)
    jcfg = jax_get_config(ARCH, smoke=True, tie_embeddings=tie, remat=remat)
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jcfg, JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(params)
    cfg = get_config(ARCH, smoke=True, tie_embeddings=tie, remat=remat)
    state = init_train_state(_port(flat, trainable=True, tie_embeddings=tie,
                                   remat=remat).lm)
    step = make_train_step(cfg, TrainConfig(**kw))
    for i in range(12):
        b = _batch(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {"tokens": torch.from_numpy(b["tokens"].astype(np.int64)),
                                  "image_embeds": torch.from_numpy(b["image_embeds"])})
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= TOL, i


def test_train_cli_trains_llava_on_tokens(caplog):
    """The CLI trains the VLM on tokens only, as the reference's does."""
    import logging
    with caplog.at_level(logging.INFO):
        state = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                "--steps", "2", "--batch", "2", "--seq", "32"])
    assert state.step == 2
    assert "done: 2 steps" in caplog.text
