"""mamba2-780m (SSD, mixer-only blocks) and recurrentgemma-9b (rglru, rglru,
local_attn; SMOKE's 5 layers are one group and a tail of 2) in the port,
held to the JAX package on their SMOKE configs from one JAX init each:
the registry and the bridge both ways (training state and checkpoint
keys included); train, prefill and decode logits and caches (1e-4);
greedy tokens; 12 AdamW steps with the decay mask leaf for leaf (stacked
groups against the tail); gradients against jax.grad (1e-4) and remat
bit for bit; the serve engine's greedy and sampled tokens against the
JAX engine's; prefix-cache hits equal to cold runs; serialized snapshots
in the reference's layout; bf16 at 5e-2; and the two CLIs."""
import json

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.optim.adamw import _wd_mask  # noqa: E402
from repro.serve import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.bridge import (jax_path, named_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax, train_state_from_jax,
                                train_state_to_jax)
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import check_supported  # noqa: E402
from repro_torch.serve.engine import ServeEngine, generate  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

TOL = 1e-4
ARCHS = ["mamba2-780m", "recurrentgemma-9b"]
BLK = 16            # the serving tests' lt_block_size, as the reference's tests


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


@pytest.fixture(scope="module")
def inits():
    """{arch: (jax model, jax params, flat params)}, one JAX init each,
    made on first use. lt_block_size changes no parameter, so the serving
    tests' block-16 models share them."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = jax_build_model(jax_get_config(arch, smoke=True))
            params, _ = jm.init(jax.random.PRNGKey(0))
            cache[arch] = jm, params, _flat(params)
        return cache[arch]
    return get


def _port(flat, arch, trainable=False, **over):
    cfg = get_config(arch, smoke=True, **over)
    return build_model(cfg, device="cpu", trainable=trainable,
                       params=params_from_jax(flat, cfg))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, size=shape)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()
                                          if torch.is_tensor(got) else got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _jax_node(jcache, cfg, i):
    """The JAX cache node of the port's layer i (groups stacked, tail not)."""
    g = len(cfg.block_pattern)
    n_groups = cfg.n_layers // g
    if i < n_groups * g:
        node = jcache["groups"][f"block{i % g}"]
        return jax.tree_util.tree_map(lambda x: x[i // g], node)
    return jcache["tail"][f"block{i - n_groups * g}"]


def _caches_close(tc, jc, cfg, tol=TOL):
    assert len(tc) == cfg.n_layers
    for i, node in enumerate(tc):
        jnode = _jax_node(jc, cfg, i)
        assert type(node).__name__ == type(jnode).__name__
        for name in node._fields:
            got, want = getattr(node, name), getattr(jnode, name)
            if name == "pos":
                assert int(got) == int(want)
            else:
                _close(got, want, tol)


# ---------------------------------------------------------------------------
# registry and bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_registry_resolves_the_reference_configs(arch):
    """CONFIG and SMOKE equal the reference's field for field, and the
    full config builds on the meta device with the reference's parameter
    count (jax.eval_shape of its init)."""
    for smoke in (False, True):
        cfg, ref = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
        for field in cfg.__dataclass_fields__:
            assert getattr(cfg, field) == getattr(ref, field), (arch, smoke, field)
    cfg = get_config(arch)
    lm = build_model(cfg, device="meta").lm
    jm = jax_build_model(jax_get_config(arch))
    shapes = jax.eval_shape(lambda key: jm.init(key)[0], jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in lm.parameters()) == want
    assert [b.kind for b in lm.layers] == [
        cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    assert (lm.layers[0].ffn is None) == (cfg.d_ff == 0)


def test_the_lm_refuses_unknown_families_audio_and_whisper_mixers():
    """The LM's real refusals: an unknown family, the audio family (an
    encoder-decoder, models/whisper.py's), and Whisper's attention kinds in
    a block pattern; the VLM family and untied embeddings build."""
    cfg = get_config("mamba2-780m", smoke=True)
    for over, match in ((dict(family="omni"), "not ported"),
                        (dict(family="audio"), "models/whisper.py"),
                        (dict(block_pattern=("cross_attn",)), "no LM block mixers"),
                        (dict(block_pattern=("ssd", "encoder_attn")),
                         "no LM block mixers")):
        with pytest.raises(NotImplementedError, match=match):
            check_supported(cfg.replace(**over))
    for over in (dict(family="vlm"), dict(tie_embeddings=False)):
        check_supported(cfg.replace(**over))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_both_ways_and_training_state_keys(inits, arch, tmp_path):
    """params_from_jax / params_to_jax round-trip every leaf; the training
    state's flat arrays carry the reference checkpoint's keys, group-
    stacked and tail leaves with their own shapes, and load back."""
    jm, params, flat = inits(arch)
    model = _port(flat, arch, trainable=True)
    back = params_to_jax(model.lm)
    assert sorted(back) == sorted(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)
    state = init_train_state(model.lm)
    got = train_state_to_jax(state)
    want = jax_flatten(jax_init_train_state(params))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].shape == np.shape(arr) and got[key].dtype == arr.dtype, key
    lm = build_model(get_config(arch, smoke=True), device="cpu", seed=3,
                     trainable=True).lm
    restored = train_state_from_jax(got, lm)
    for name, p in restored.lm.named_parameters():
        assert torch.equal(p, dict(model.lm.named_parameters())[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_is_the_reference_mask_leaf_for_leaf(inits, arch):
    """Every groups/ leaf is decayed (stacked, ndim >= 2 there); a tail
    leaf and the final norm by their own ndim."""
    jm, params, flat = inits(arch)
    cfg = get_config(arch, smoke=True)
    want = dict(zip(tree_paths(params), jax.tree_util.tree_leaves(_wd_mask(params))))
    lm = _port(flat, arch, trainable=True).lm
    got = optim.decay_mask(dict(lm.named_parameters()), cfg)
    for name, m in got.items():
        assert m == want[jax_path(name, cfg)], name
    assert {jax_path(n, cfg) for n in got} == set(want)
    if cfg.n_layers % len(cfg.block_pattern):
        assert got["layers.4.mixer.conv_b"] == 0.0 and got["layers.0.mixer.conv_b"] == 1.0


# ---------------------------------------------------------------------------
# logits, caches, tokens
# ---------------------------------------------------------------------------

def _jit_train(jm):
    return jax.jit(lambda p, t: jm.apply(p, {"tokens": t}, mode="train")[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_jax(inits, arch):
    """64 tokens: recurrentgemma's blocked band of 2 windows of 32 (the
    windowed fallback is held in test_torch_recurrent.py)."""
    jm, params, flat = inits(arch)
    toks = _tokens(64, (2, 64))
    want = _jit_train(jm)(params, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = _port(flat, arch).lm(torch.from_numpy(toks), mode="train")
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_and_caches_match_jax(inits, arch):
    """A 37-token prefill on block 16 (three resumable chunks, a ring of
    32 slots for recurrentgemma, wrapped by the decode steps), then 6
    decode steps: logits and every layer's cache within 1e-4."""
    jm, params, flat = inits(arch)
    jm16 = jax_build_model(jax_get_config(arch, smoke=True, lt_block_size=BLK))
    jprefill = jax.jit(lambda p, t: jm16.state.prefill(p, t, max_len=64))
    jdecode = jax.jit(jm16.state.decode_step)
    tm = _port(flat, arch, lt_block_size=BLK)
    cfg = tm.cfg
    toks = _tokens(37, (2, 43))
    jl, jc = jprefill(params, jnp.asarray(toks[:, :37], jnp.int32))
    tl, tc = tm.state.prefill(torch.from_numpy(toks[:, :37]), max_len=64)
    _close(tl, jl)
    _caches_close(tc, jc, cfg)
    for i in range(37, 43):
        jl, jc = jdecode(params, jnp.asarray(toks[:, i:i + 1], jnp.int32), i, jc)
        tl, tc = tm.state.decode_step(torch.from_numpy(toks[:, i:i + 1]), i, tc)
        _close(tl, jl)
    _caches_close(tc, jc, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(inits, arch):
    """A 21-token prompt and 14 steps, past recurrentgemma's 32-token
    window: tokens exactly equal, last logits within 1e-4."""
    jm, params, flat = inits(arch)
    prompt = _tokens(21, (2, 21))
    want = jax.jit(lambda p, t: jax_generate(jm, jm.cfg, p, t, 14))(
        params, jnp.asarray(prompt, jnp.int32))
    got = generate(_port(flat, arch), prompt, 14)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.logits_last, want.logits_last)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _markov(batch, seq, step):
    return synthetic.make_markov_lm(128, seed=1)(batch, seq, step)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad_and_remat_is_bit_exact(inits, arch):
    """One batch's gradients against jax.grad at 1e-4 of each leaf's max;
    remat "dots" and "full" give remat "none"'s gradients bit for bit."""
    jm, params, flat = inits(arch)
    toks = _markov(2, 64, 0)
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jm, jm.cfg), has_aux=True))(params, {"tokens": jnp.asarray(toks)})
    want = _flat(want)
    grads = {}
    for remat in ("none", "dots", "full"):
        model = _port(flat, arch, trainable=True, remat=remat)
        loss, _ = make_loss_fn(model.cfg)(model.lm, {"tokens": torch.from_numpy(
            toks.astype(np.int64))})
        loss.backward()
        grads[remat] = {n: p.grad for n, p in model.lm.named_parameters()}
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    got = named_to_jax(grads["none"], model.cfg)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        e = np.abs(got[path] - w).max()
        assert e <= TOL * max(np.abs(w).max(), 1e-30), (path, e)
    for remat in ("dots", "full"):
        for name, g in grads["none"].items():
            assert torch.equal(grads[remat][name], g), (remat, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_twelve_steps_match_jax(inits, arch):
    """12 AdamW steps at lr 3e-3 from bridged params: the loss within 1e-4
    at every step (the decay mask of stacked and tail leaves in play)."""
    jm, params, flat = inits(arch)
    kw = dict(seq_len=32, global_batch=2, steps=12, peak_lr=3e-3)
    jstep = jax.jit(jax_make_train_step(jm, jm.cfg, JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(params)
    state = init_train_state(_port(flat, arch, trainable=True).lm)
    step = make_train_step(get_config(arch, smoke=True), TrainConfig(**kw))
    for i in range(12):
        toks = _markov(2, 32, i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, met = step(state, {"tokens": torch.from_numpy(toks.astype(np.int64))})
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= TOL, i


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_smoke_matches_jax(inits, arch):
    """compute_dtype bfloat16 (f32 weights cast on use, the recurrences in
    f32): train logits and a prefill's last logits within 5e-2."""
    jm, params, flat = inits(arch)
    jmb = jax_build_model(jax_get_config(arch, smoke=True, compute_dtype="bfloat16",
                                         lt_block_size=BLK))
    tm = _port(flat, arch, compute_dtype="bfloat16", lt_block_size=BLK)
    toks = _tokens(3, (2, 40))
    want = _jit_train(jmb)(params, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = tm.lm(torch.from_numpy(toks), mode="train")
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)
    jl, _ = jax.jit(lambda p, t: jmb.state.prefill(p, t, max_len=48))(
        params, jnp.asarray(toks, jnp.int32))
    tl, tc = tm.state.prefill(torch.from_numpy(toks), max_len=48)
    _close(tl, jl, 5e-2)
    assert tc[0].conv.dtype == torch.bfloat16 and tc[0].h.dtype == torch.float32


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

WORKLOAD = [(5, 6, {}), (19, 5, dict(temperature=0.8, top_k=12, top_p=0.9, seed=7)),
            (33, 6, {}), (40, 4, dict(temperature=1.1, seed=11))]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_jax_engine(inits, arch):
    """Mixed prompt lengths on 2 slots with a queue, greedy and sampled:
    the port's engine emits the JAX engine's tokens (log-probabilities
    within 1e-4), and its greedy requests equal batch-1 generate."""
    jm, params, flat = inits(arch)
    jcfg = jax_get_config(arch, smoke=True, lt_block_size=BLK)
    tm = _port(flat, arch, lt_block_size=BLK)
    prompts = [_tokens(50 + i, n) for i, (n, _, _) in enumerate(WORKLOAD)]
    jeng = JaxServeEngine(jax_build_model(jcfg), jcfg, params, slots=2, max_len=64,
                          logprobs=True)
    eng = ServeEngine(tm, slots=2, max_len=64, logprobs=True, overlap=True,
                      prefill_budget=16)
    for p, (_, gen, sp) in zip(prompts, WORKLOAD):
        jeng.submit(jnp.asarray(p, jnp.int32), gen, sampling=JaxSamplingParams(**sp))
        eng.submit(p, gen, sampling=SamplingParams(**sp))
    want = {o.rid: o for o in jeng.run()}
    got = {o.rid: o for o in eng.run()}
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, np.asarray(want[rid].tokens))
        _close(got[rid].logprobs, want[rid].logprobs)
    for rid in (0, 2):
        ref = generate(tm, prompts[rid][None], WORKLOAD[rid][1], max_len=64)
        np.testing.assert_array_equal(ref.tokens[0].numpy(), got[rid].tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_hits_equal_cold_runs(inits, arch):
    """A 3-block shared prefix and suffixes that are not block-aligned (the
    truncation split runs): the cached run hits, restores, and emits the
    cold run's tokens and log-probabilities bit for bit; one snapshot's
    bytes are the reckoned state."""
    jm, params, flat = inits(arch)
    tm = _port(flat, arch, lt_block_size=BLK)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 128, 3 * BLK)
    prompts = [np.concatenate([shared, rng.integers(0, 128, BLK - 3 + 5 * i)])
               for i in range(4)]
    samp = [SamplingParams(), SamplingParams(temperature=0.8, seed=3)] * 2
    runs = {}
    for name, pc in (("cold", None), ("cached", PrefixCache(1 << 22))):
        eng = ServeEngine(tm, slots=2, max_len=128, prefix_cache=pc, logprobs=True)
        for p, sp in zip(prompts, samp):
            eng.submit(p, 5, sampling=sp)
        runs[name] = {o.rid: o for o in eng.run()}
        if pc is not None:
            st = eng.stats()
            nbytes = {e.nbytes for e in pc._entries.values()}
    assert st["prefix_cache"]["hits"] >= 2
    assert st["prefix_cache"]["hit_tokens"] >= 2 * 3 * BLK
    for rid, o in runs["cold"].items():
        assert np.array_equal(o.tokens, runs["cached"][rid].tokens)
        assert np.array_equal(o.logprobs, runs["cached"][rid].logprobs)
    cfg = tm.cfg
    w = cfg.rglru_width or cfg.d_model
    per = {"ssd": 4 * (cfg.ssm_expand * cfg.d_model) * cfg.ssm_state
           + 4 * 3 * (cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state),
           "rglru": 4 * w + 4 * 3 * w,
           "local_attn": 2 * 4 * cfg.n_kv_heads * min(cfg.sliding_window, 128)
           * cfg.resolved_head_dim}
    assert nbytes == {sum(per[b.kind] for b in tm.lm.layers)}


@pytest.mark.parametrize("arch", ARCHS)
def test_serialized_snapshot_loads_in_jax_and_back(inits, arch):
    """A snapshot serialized by the port has the reference's leaves in its
    tree order (groups stacked, a ring's pos per group, the tail unstacked):
    the JAX DecodeState deserializes it, and the port reads it back."""
    jm, params, flat = inits(arch)
    jm16 = jax_build_model(jax_get_config(arch, smoke=True, lt_block_size=BLK))
    tm = _port(flat, arch, lt_block_size=BLK)
    toks = _tokens(8, (1, 2 * BLK))
    _, state = tm.state.prefill(torch.from_numpy(toks), max_len=BLK)
    snap = tm.state.snapshot(state)
    data = tm.state.serialize(snap, 2 * BLK)
    jsnap, n = jm16.state.deserialize(data)
    _, jstate = jax.jit(lambda p, t: jm16.state.prefill(p, t, max_len=BLK))(
        params, jnp.asarray(toks, jnp.int32))
    assert n == 2 * BLK
    want = jax.tree_util.tree_leaves(jm16.state.snapshot(jstate))
    got = jax.tree_util.tree_leaves(jsnap)
    assert [np.shape(x) for x in got] == [np.shape(x) for x in want]
    for a, b in zip(got, want):
        _close(np.asarray(a, np.float32), np.asarray(b, np.float32))
    back, n2 = tm.state.deserialize(data, max_len=BLK)
    assert n2 == 2 * BLK
    for a, b in zip(back, snap):
        for x, y in zip(tst.snapshot_fields(a), tst.snapshot_fields(b)):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    with pytest.raises(ValueError, match="do not fit"):
        one = tst.snapshot_layout(tm.cfg.replace(n_layers=1))   # a one-layer model's
        tm.state.deserialize(tst.serialize_snapshot(snap[:1], 0, one), max_len=BLK)
    if arch == "recurrentgemma-9b":           # a ring of another window
        with pytest.raises(ValueError, match="do not fit"):
            tm.state.deserialize(data, max_len=4 * BLK)


def test_ring_snapshots_are_not_shared_across_max_len(inits):
    """A ring snapshot holds min(sliding_window, max_len) slots: a prefix
    cache bound by an engine of one window refuses an engine of another,
    and takes one of the same shapes (mirrors the reference's test)."""
    _, _, flat = inits("recurrentgemma-9b")
    tm = _port(flat, "recurrentgemma-9b", lt_block_size=BLK)
    pc = PrefixCache(1 << 20)
    ServeEngine(tm, max_len=24, prefix_cache=pc)
    with pytest.raises(ValueError, match="snapshot shape"):
        ServeEngine(tm, max_len=64, prefix_cache=pc)
    ServeEngine(tm, max_len=24, prefix_cache=pc)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_clis_run_the_smoke_configs_on_cpu(arch, tmp_path, capsys):
    out = tmp_path / "toks.json"
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                    "--slots", "2", "--prompt-len", "40", "--gen", "4", "--rate", "0",
                    "--shared-prefix", "24", "--prefix-cache-mb", "8",
                    "--block-size", "16", "--tokens-out", str(out)])
    text = capsys.readouterr().out
    assert "served 3 requests" in text and "prefix cache:" in text
    assert len(json.loads(out.read_text())["outputs"]) == 3
    state = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                            "2", "--batch", "2", "--seq", "32", "--log-every", "1"])
    assert state.step == 2
