"""whisper-large-v3 (the encoder-decoder: a bidirectional softmax encoder
over precomputed frames plus sinusoidal positions, a polysketch decoder
with softmax cross-attention over the encoder's memory) in the port, held
to the JAX package on SMOKE from one JAX init: the registry and the
parameter count; the bridge both ways with the training state's keys,
and the decay mask leaf for leaf (enc/ and dec/ stacked, enc_norm not);
the encoder's output, train logits, the reference's batch-dict prefill
with frames and its decode steps with every layer's caches (1e-4); the
reference's own decode-matches-train check; sinusoidal positions; the
engine and generate refusing the model; gradients against jax.grad with
remat "none" and "dots", "dots" rematerialising fully as the reference's
plain jax.checkpoint does; 12 AdamW steps; the training CLI's refusal.
The JAX side runs under jax.jit."""
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import whisper as jax_whisper  # noqa: E402
from repro.models.layers import sinusoidal_positions as jax_sinusoidal  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.optim.adamw import _wd_mask  # noqa: E402
from repro.serve.engine import make_serve_fns as jax_make_serve_fns  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.bridge import (jax_path, named_to_jax,  # noqa: E402
                                params_from_jax, params_to_jax,
                                train_state_from_jax, train_state_to_jax)
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.models.layers import sinusoidal_positions  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serve.engine import ServeEngine, generate, make_serve_fns  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

TOL = 1e-4
ARCH = "whisper-large-v3"
T_ENC, D = 24, 64                # SMOKE's encoder_len and d_model


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


@pytest.fixture(scope="module")
def init():
    """(jax model, jax params, flat params), one JAX init."""
    jm = jax_build_model(jax_get_config(ARCH, smoke=True))
    params, _ = jm.init(jax.random.PRNGKey(0))
    return jm, params, _flat(params)


def _port(flat, trainable=False, **over):
    cfg = get_config(ARCH, smoke=True, **over)
    return build_model(cfg, device="cpu", trainable=trainable,
                       params=params_from_jax(flat, cfg))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, size=shape)


def _frames(seed, batch):
    return (np.random.default_rng(seed).standard_normal((batch, T_ENC, D)) * 0.5
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()
                                          if torch.is_tensor(got) else got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# registry, bridge, decay mask, refusals
# ---------------------------------------------------------------------------

def test_registry_and_parameter_count():
    """CONFIG and SMOKE equal the reference's field for field; the full
    config builds a Whisper (no DecodeState) on the meta device with
    jax.eval_shape's parameter count, 1.96 B (7.29 GiB in f32)."""
    for smoke in (False, True):
        cfg, ref = get_config(ARCH, smoke=smoke), jax_get_config(ARCH, smoke=smoke)
        for field in cfg.__dataclass_fields__:
            assert getattr(cfg, field) == getattr(ref, field), (smoke, field)
    model = build_model(get_config(ARCH), device="meta")
    assert isinstance(model.lm, whisper.Whisper) and model.state is None
    jm = jax_build_model(jax_get_config(ARCH))
    shapes = jax.eval_shape(lambda key: jm.init(key)[0], jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.lm.parameters()) == want == 1_956_918_784


def test_bridge_both_ways_and_training_state_keys(init):
    """Every leaf round-trips (enc/ and dec/ stacked over their layers,
    enc_norm and dec_norm at the top); the training state's flat arrays
    carry the reference checkpoint's keys and shapes, and load back."""
    _, params, flat = init
    model = _port(flat, trainable=True)
    back = params_to_jax(model.lm)
    assert sorted(back) == sorted(flat)
    assert back["enc/attn/wq"].shape[0] == back["dec/cross_attn/wk"].shape[0] == 2
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
    got = train_state_to_jax(init_train_state(model.lm))
    want = jax_flatten(jax_init_train_state(params))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].shape == np.shape(arr) and got[key].dtype == arr.dtype, key
    lm = build_model(get_config(ARCH, smoke=True), device="cpu", seed=3,
                     trainable=True).lm
    restored = train_state_from_jax(got, lm)
    for name, p in restored.lm.named_parameters():
        assert torch.equal(p, dict(model.lm.named_parameters())[name]), name
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_jax(flat, get_config(ARCH, smoke=True, encoder_layers=3))


def test_decay_mask_is_the_reference_mask_leaf_for_leaf(init):
    """Every enc/ and dec/ leaf is decayed (their norms and biases too: the
    stacks give them ndim >= 2); enc_norm and dec_norm are not."""
    _, params, flat = init
    cfg = get_config(ARCH, smoke=True)
    want = dict(zip(tree_paths(params), jax.tree_util.tree_leaves(_wd_mask(params))))
    got = optim.decay_mask(dict(_port(flat, trainable=True).lm.named_parameters()), cfg)
    for name, m in got.items():
        assert m == want[jax_path(name, cfg)], name
    assert {jax_path(n, cfg) for n in got} == set(want)
    assert got["enc.0.norm1.bias"] == 1.0 and got["enc_norm.scale"] == 0.0


def test_engine_generate_and_the_lm_refuse_it(init):
    _, _, flat = init
    model = _port(flat)
    with pytest.raises(NotImplementedError, match="DecodeState"):
        ServeEngine(model, slots=1, max_len=32)
    with pytest.raises(NotImplementedError, match="DecodeState"):
        generate(model, np.zeros((1, 4), np.int64), 2)
    with pytest.raises(NotImplementedError, match="whisper"):
        LM(get_config(ARCH, smoke=True))
    with pytest.raises(SystemExit, match="frames"):
        train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="DecodeState"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("n,d", [(37, 64), (1500, 1280), (5, 2), (9, 7), (4, 1)])
def test_sinusoidal_positions_match_the_reference(n, d):
    """Even widths within 1e-4 of the reference's table (the 1500 x 1280
    table of whisper-large-v3's encoder included), and width 1; an odd
    width above 1 raises in both packages."""
    if d % 2 and d > 1:
        with pytest.raises(ValueError):
            jax_sinusoidal(n, d)
        with pytest.raises(ValueError, match="even width"):
            sinusoidal_positions(n, d)
        return
    _close(sinusoidal_positions(n, d), jax_sinusoidal(n, d))


# ---------------------------------------------------------------------------
# encoder, logits, caches
# ---------------------------------------------------------------------------

def test_encoder_output_matches_jax(init):
    _, params, flat = init
    fr = _frames(1, 2)
    want = jax.jit(lambda p, f: jax_whisper.whisper_encode(p, jax_get_config(ARCH, smoke=True),
                                                           f))(params, jnp.asarray(fr))
    with torch.no_grad():
        got = _port(flat).lm.encode(torch.from_numpy(fr))
    _close(got, want)


def test_train_logits_match_jax(init):
    """2 x 40 tokens over 24 frames: logits within 1e-4; other frames
    change them (not frames + 1: the encoder's LayerNorms remove a shift
    of every feature)."""
    jm, params, flat = init
    toks, fr = _tokens(40, (2, 40)), _frames(2, 2)
    japply = jax.jit(lambda p, b: jm.apply(p, b, mode="train")[0])
    lm = _port(flat).lm
    outs = []
    for f in (fr, _frames(3, 2)):
        want = japply(params, {"tokens": jnp.asarray(toks, jnp.int32),
                               "frames": jnp.asarray(f)})
        with torch.no_grad():
            got, cache = lm(torch.from_numpy(toks), frames=torch.from_numpy(f), mode="train")
        assert cache is None
        _close(got, want)
        outs.append(got)
    assert (outs[0] - outs[1]).abs().max() > 1e-4


def test_prefill_with_frames_and_decode_match_the_reference(init):
    """The reference's make_serve_fns: a 37-token prefill with frames (one
    call, the block grid of 16 inside it), then 5 decode steps at shared
    and at per-row positions: logits within 1e-4, and every layer's
    self-attention state and cross-attention k, v too."""
    jm, params, flat = init
    jpre, jdec = jax_make_serve_fns(jm, jm.cfg)
    jpre, jdec = jax.jit(jpre), jax.jit(jdec)
    prefill, decode = make_serve_fns(_port(flat))
    toks, fr = _tokens(7, (2, 42)), _frames(8, 2)
    jl, jc = jpre(params, {"tokens": jnp.asarray(toks[:, :37], jnp.int32),
                           "frames": jnp.asarray(fr)})
    tl, tc = prefill({"tokens": toks[:, :37], "frames": fr})
    _close(tl, jl)
    for i in range(37, 42):
        jl, jc = jdec(params, jnp.asarray(toks[:, i:i + 1], jnp.int32), jc,
                      jnp.asarray([i]))
        pos = i if i < 40 else torch.tensor([i, i])
        tl, tc = decode(torch.from_numpy(toks[:, i:i + 1]), tc, pos)
        _close(tl, jl)
    for i, node in enumerate(tc):
        jnode = jax.tree_util.tree_map(lambda x: x[i], jc)   # noqa: B023
        assert int(node["self"].pos) == int(jnode["self"].pos) == 42
        for name in ("z", "kbuf", "vbuf", "mbuf"):
            _close(getattr(node["self"], name), getattr(jnode["self"], name))
        assert int(node["cross"].pos) == int(jnode["cross"].pos) == T_ENC
        _close(node["cross"].k, jnode["cross"].k)
        _close(node["cross"].v, jnode["cross"].v)


def test_decode_matches_train(init):
    """The reference's own check (tests/test_models.py): a 1-token prefill
    with the frames, then 19 decode steps, give the train-mode logits
    within 2e-3."""
    _, _, flat = init
    lm = _port(flat).lm
    toks, fr = torch.from_numpy(_tokens(3, (1, 20))), torch.from_numpy(_frames(4, 1))
    with torch.no_grad():
        train, _ = lm(toks, frames=fr, mode="train")
        logits, cache = lm(toks[:, :1], frames=fr, mode="prefill",
                           cache=lm.init_cache(1, 24))
        outs = [logits[:, 0]]
        for t in range(1, 20):
            lg, cache = lm(toks[:, t:t + 1], mode="decode", cache=cache,
                           positions=torch.tensor([t]))
            outs.append(lg[:, 0])
    _close(torch.stack(outs, 1), train.numpy(), tol=2e-3)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(seed, batch=2, seq=24):
    return {"tokens": synthetic.make_markov_lm(128, seed=1)(batch, seq, seed),
            "frames": _frames(100 + seed, batch)}


def _torch_batch(b):
    return {"tokens": torch.from_numpy(b["tokens"].astype(np.int64)),
            "frames": torch.from_numpy(b["frames"])}


def test_gradients_match_jax_grad_and_dots_is_full_remat(init):
    """jax.grad of the reference's loss with remat "dots" against the port's
    gradients with "none", "dots" and "full": each leaf within 1e-4 of its
    max; "dots" and "full" equal bit for bit, since the reference's plain
    jax.checkpoint makes Whisper's "dots" a full rematerialisation, and
    every encoder and decoder block ran under "full" checkpointing."""
    _, params, flat = init
    batch = _batch(0)
    jcfg = jax_get_config(ARCH, smoke=True, remat="dots")
    jloss = jax_make_loss_fn(jax_build_model(jcfg), jcfg)
    want = _flat(jax.jit(jax.grad(lambda p, b: jloss(p, b)[0]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    grads = {}
    for remat in ("none", "dots", "full"):
        cfg = get_config(ARCH, smoke=True, remat=remat)
        lm = _port(flat, trainable=True, remat=remat).lm
        used = []
        run = whisper._run_block

        def spy(how, *a, **kw):
            used.append(how)
            return run(how, *a, **kw)
        with mock.patch.object(whisper, "_run_block", spy):
            loss, _ = make_loss_fn(cfg)(lm, _torch_batch(batch))
        assert used == ["none" if remat == "none" else "full"] * 4, (remat, used)
        loss.backward()
        grads[remat] = named_to_jax({n: p.grad for n, p in lm.named_parameters()}, cfg)
    assert sorted(grads["none"]) == sorted(want)
    for path, g in want.items():
        assert np.array_equal(grads["dots"][path], grads["full"][path]), path
        top = max(float(np.abs(grads["none"][path]).max()), 1e-6)
        np.testing.assert_allclose(grads["dots"][path] / top, grads["none"][path] / top,
                                   atol=TOL, err_msg=f"dots vs none {path}")
        scale = max(float(np.abs(g).max()), 1e-6)
        for remat in ("none", "dots"):
            np.testing.assert_allclose(grads[remat][path] / scale, np.asarray(g) / scale,
                                       atol=TOL, err_msg=f"{remat} {path}")


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_twelve_steps_match_jax(init, remat):
    """12 AdamW steps at lr 3e-3 on batches of tokens and frames: loss
    within 1e-4 of the reference's step at every step."""
    _, params, flat = init
    kw = dict(seq_len=24, global_batch=2, steps=12, peak_lr=3e-3)
    jcfg = jax_get_config(ARCH, smoke=True, remat=remat)
    jstep = jax.jit(jax_make_train_step(jax_build_model(jcfg), jcfg, JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(params)
    cfg = get_config(ARCH, smoke=True, remat=remat)
    state = init_train_state(_port(flat, trainable=True, remat=remat).lm)
    step = make_train_step(cfg, TrainConfig(**kw))
    for i in range(12):
        b = _batch(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, _torch_batch(b))
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= TOL, i
