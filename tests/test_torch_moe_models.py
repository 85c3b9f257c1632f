"""dbrx-132b (an MoE FFN, 4 experts top-2 in SMOKE, in every layer) and
llama4-maverick-400b-a17b (8 experts top-1 in every second layer: an
effective pattern of a GLU and an MoE layer, one group of 2 in SMOKE) in
the port, held to the JAX package on their SMOKE configs from one JAX
init each: the registry and the parameter count; the bridge both ways
(training state keys included) and the decay mask leaf for leaf; train
logits and summed aux losses, prefill and decode logits and caches
(1e-4); the reference's call structure in prefill and resume, drops
included; 12 AdamW steps whose loss, ce_loss and two aux metrics follow
the reference's step; the aux losses through remat "dots" / "full" and
microbatches; the serve engine's greedy and sampled tokens against the
JAX engine's; the prefix cache; a snapshot in the reference's layout;
bf16 at 5e-2; the in-place clip and slabbed AdamW; the two CLIs. The serving tests use lt_block_size 16, as the reference's own
tests do."""
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
from repro.models.transformer import effective_pattern as jax_pattern  # noqa: E402
from repro.optim.adamw import _wd_mask  # noqa: E402
from repro.serve import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.bridge import (group_shape, jax_path,  # noqa: E402
                                params_from_jax, params_to_jax, train_state_from_jax,
                                train_state_to_jax)
from repro_torch.configs import TrainConfig, effective_pattern, get_config  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.serve.engine import ServeEngine, generate  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

TOL = 1e-4
ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
BLK = 16


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


@pytest.fixture(scope="module")
def inits():
    """{arch: (jax model, jax params, flat params)}, one JAX init each."""
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


def _markov(batch, seq, step):
    return synthetic.make_markov_lm(128, seed=1)(batch, seq, step)


# ---------------------------------------------------------------------------
# registry, bridge, decay mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_registry_pattern_and_parameter_count(arch):
    """CONFIG and SMOKE equal the reference's field for field; the
    effective pattern is the reference's; the full config builds on the
    meta device with the reference's parameter count (jax.eval_shape of
    its init) and an MoE FFN exactly where the pattern puts one."""
    for smoke in (False, True):
        cfg, ref = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
        for field in cfg.__dataclass_fields__:
            assert getattr(cfg, field) == getattr(ref, field), (arch, smoke, field)
        assert effective_pattern(cfg) == jax_pattern(ref)
    cfg = get_config(arch)
    lm = build_model(cfg, device="meta").lm
    jm = jax_build_model(jax_get_config(arch))
    shapes = jax.eval_shape(lambda key: jm.init(key)[0], jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in lm.parameters()) == want
    period = cfg.moe_period
    assert [isinstance(b.ffn, MoE) for b in lm.layers] == [
        i % period == period - 1 for i in range(cfg.n_layers)]
    assert group_shape(cfg) == ((period, cfg.n_layers // period, 0))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_both_ways_and_training_state_keys(inits, arch):
    """Every leaf round-trips (the expert leaves groups/block{b}/ffn/...
    stacked over the groups); the training state's flat arrays carry the
    reference checkpoint's keys and shapes, and load back."""
    jm, params, flat = inits(arch)
    model = _port(flat, arch, trainable=True)
    back = params_to_jax(model.lm)
    assert sorted(back) == sorted(flat)
    b = get_config(arch, smoke=True).moe_period - 1
    assert back[f"groups/block{b}/ffn/wi"].ndim == 4
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
@pytest.mark.parametrize("layers", [2, 3])
def test_decay_mask_is_the_reference_mask_leaf_for_leaf(arch, layers):
    """Every groups/ leaf (the router and experts included) is decayed;
    with 3 layers a tail layer's leaves by their own ndim."""
    jcfg = jax_get_config(arch, smoke=True, n_layers=layers)
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True, n_layers=layers)
    want = dict(zip(tree_paths(params), jax.tree_util.tree_leaves(_wd_mask(params))))
    lm = build_model(cfg, device="cpu", trainable=True, params=params_from_jax(
        _flat(params), cfg)).lm
    got = optim.decay_mask(dict(lm.named_parameters()), cfg)
    for name, m in got.items():
        assert m == want[jax_path(name, cfg)], name
    assert {jax_path(n, cfg) for n in got} == set(want)


# ---------------------------------------------------------------------------
# logits, caches, tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_and_aux_losses_match_jax(inits, arch):
    """A train-mode forward of 2 x 40 tokens: logits and the aux losses
    summed over the layers within 1e-4; prefill and decode compute none."""
    jm, params, flat = inits(arch)
    toks = _tokens(40, (2, 40))
    want, _, jaux = jax.jit(lambda p, t: jm.apply(p, {"tokens": t}, mode="train"))(
        params, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, cache, aux = _port(flat, arch).lm(torch.from_numpy(toks), mode="train",
                                               return_aux=True)
    assert cache is None and sorted(aux) == sorted(jaux)
    _close(got, want)
    for k in aux:
        _close(aux[k], jaux[k])


def _jax_node(jcache, cfg, i):
    g, n_groups, _ = group_shape(cfg)
    node = jcache["groups"][f"block{i % g}"]
    return jax.tree_util.tree_map(lambda x: x[i // g], node)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_and_caches_match_jax(inits, arch):
    """A 37-token prefill on block 16, then 6 decode steps of a batch of 2:
    logits and every layer's polysketch cache within 1e-4."""
    jm, params, flat = inits(arch)
    jm16 = jax_build_model(jax_get_config(arch, smoke=True, lt_block_size=BLK))
    tm = _port(flat, arch, lt_block_size=BLK)
    toks = _tokens(37, (2, 43))
    jl, jc = jax.jit(lambda p, t: jm16.state.prefill(p, t, max_len=64))(
        params, jnp.asarray(toks[:, :37], jnp.int32))
    tl, tc = tm.state.prefill(torch.from_numpy(toks[:, :37]), max_len=64)
    _close(tl, jl)
    jdecode = jax.jit(jm16.state.decode_step)
    for i in range(37, 43):
        jl, jc = jdecode(params, jnp.asarray(toks[:, i:i + 1], jnp.int32), i, jc)
        tl, tc = tm.state.decode_step(torch.from_numpy(toks[:, i:i + 1]), i, tc)
        _close(tl, jl)
    for i, node in enumerate(tc):
        jnode = _jax_node(jc, tm.cfg, i)
        assert int(node.pos) == int(jnode.pos)
        for name in ("z", "kbuf", "vbuf", "mbuf"):
            _close(getattr(node, name), getattr(jnode, name))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_the_aux_losses_bit_for_bit(inits, arch):
    """Remat "dots" and "full" (the aux losses returned through the
    checkpoint, not set on a module) give remat "none"'s loss, aux metrics
    and gradients bit for bit, the router's included; jax.grad itself is
    held by tests/test_torch_moe.py and, through the loss of every step,
    by the twelve steps below."""
    _, _, flat = inits(arch)
    toks = torch.from_numpy(_markov(2, 48, 0).astype(np.int64))
    grads, mets = {}, {}
    for remat in ("none", "dots", "full"):
        model = _port(flat, arch, trainable=True, remat=remat)
        loss, mets[remat] = make_loss_fn(model.cfg)(model.lm, {"tokens": toks})
        loss.backward()
        grads[remat] = {n: p.grad for n, p in model.lm.named_parameters()}
    assert set(mets["none"]) == {"loss", "ce_loss", "aux_load_balance", "aux_router_z"}
    assert float(mets["none"]["loss"]) > float(mets["none"]["ce_loss"])
    router = f"layers.{model.cfg.moe_period - 1}.ffn.router"
    assert grads["none"][router].abs().max() > 0
    for remat in ("dots", "full"):
        assert all(torch.equal(mets[remat][k], v) for k, v in mets["none"].items())
        for name, g in grads["none"].items():
            assert torch.equal(grads[remat][name], g), (remat, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_twelve_steps_match_jax(inits, arch):
    """12 AdamW steps at lr 3e-3 from bridged params: loss, ce_loss and
    both aux metrics within 1e-4 of the reference's step at every step."""
    jm, params, flat = inits(arch)
    kw = dict(seq_len=32, global_batch=2, steps=12, peak_lr=3e-3)
    jstep = jax.jit(jax_make_train_step(jm, jm.cfg, JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(params)
    state = init_train_state(_port(flat, arch, trainable=True).lm)
    step = make_train_step(get_config(arch, smoke=True), TrainConfig(**kw))
    keys = ("loss", "ce_loss", "aux_load_balance", "aux_router_z")
    for i in range(12):
        toks = _markov(2, 32, i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, met = step(state, {"tokens": torch.from_numpy(toks.astype(np.int64))})
        for k in keys:
            assert abs(float(met[k]) - float(jmet[k])) <= TOL, (i, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_carry_the_aux_metrics(inits, arch):
    """Two microbatches a step: the step's metrics are the last slice's,
    as the reference's scan carries them, the two aux metrics included
    (the loss function on the last slice before the step, bit for bit)."""
    _, _, flat = inits(arch)
    cfg = get_config(arch, smoke=True)
    lm = _port(flat, arch, trainable=True).lm
    batch = {"tokens": torch.from_numpy(_markov(4, 32, 0).astype(np.int64))}
    _, want = make_loss_fn(cfg)(lm, {"tokens": batch["tokens"][2:]})
    step = make_train_step(cfg, TrainConfig(seq_len=32, global_batch=4, steps=3,
                                            microbatches=2))
    _, met = step(init_train_state(lm), batch)
    for k, v in want.items():
        assert torch.equal(met[k], v), k


# token rows of the bf16 train-mode logits that may lie outside 5e-2: the
# router's top-k is a discrete choice, and under bf16 rounding a near-tie
# can go either way in the two packages (maverick's top-1 router flips one
# token of these 80, by 0.40; every other row agrees within 8e-3)
BF16_FLIPS = {"dbrx-132b": 0, "llama4-maverick-400b-a17b": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_smoke_matches_jax(inits, arch):
    """compute_dtype bfloat16 (f32 weights cast on use, the router's
    softmax in f32): train logits within 5e-2 of the reference's on all
    token rows but BF16_FLIPS."""
    jm, params, flat = inits(arch)
    jmb = jax_build_model(jax_get_config(arch, smoke=True, compute_dtype="bfloat16"))
    tm = _port(flat, arch, compute_dtype="bfloat16")
    toks = _tokens(3, (2, 40))
    want = jax.jit(lambda p, t: jmb.apply(p, {"tokens": t}, mode="train")[0])(
        params, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got, _ = tm.lm(torch.from_numpy(toks), mode="train")
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    bound = 5e-2 * (1 + np.abs(np.asarray(want, np.float32)))
    assert (diff > bound).any(-1).sum() <= BF16_FLIPS[arch]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

WORKLOAD = [(5, 6, {}), (19, 5, dict(temperature=0.8, top_k=12, top_p=0.9, seed=7)),
            (33, 6, {}), (40, 4, dict(temperature=1.1, seed=11))]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_jax_engine(inits, arch):
    """Mixed prompt lengths on 2 slots with a queue, greedy and sampled, at
    the published capacity factor, both engines chunking prefills under
    the same budget (capacity couples a chunk's tokens): the port's engine
    emits the JAX engine's tokens (log-probabilities within 1e-4); its
    greedy requests equal batch-1 generate's."""
    jm, params, flat = inits(arch)
    jcfg = jax_get_config(arch, smoke=True, lt_block_size=BLK)
    tm = _port(flat, arch, lt_block_size=BLK)
    prompts = [_tokens(50 + i, n) for i, (n, _, _) in enumerate(WORKLOAD)]
    jeng = JaxServeEngine(jax_build_model(jcfg), jcfg, params, slots=2, max_len=64,
                          logprobs=True, overlap=True, prefill_budget=16)
    eng = ServeEngine(tm, slots=2, max_len=64, logprobs=True, overlap=True,
                      prefill_budget=16)
    for p, (_, gen, sp) in zip(prompts, WORKLOAD):
        jeng.submit(jnp.asarray(p, jnp.int32), gen, sampling=JaxSamplingParams(**sp))
        eng.submit(p, gen, sampling=SamplingParams(**sp))
    want = {o.rid: o for o in jeng.run()}
    got = {o.rid: o for o in eng.run()}
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, np.asarray(want[rid].tokens))
        _close(got[rid].logprobs, want[rid].logprobs)
    for rid in (0, 2):
        ref = generate(tm, prompts[rid][None], WORKLOAD[rid][1], max_len=64)
        np.testing.assert_array_equal(ref.tokens[0].numpy(), got[rid].tokens)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b"])
def test_serialized_snapshot_loads_in_jax(inits, arch):
    """The snapshot layout follows the effective pattern (maverick's two
    blocks a group): a snapshot serialized by the port loads in the JAX
    DecodeState with the reference's leaves, and back."""
    jm, params, flat = inits(arch)
    jm16 = jax_build_model(jax_get_config(arch, smoke=True, lt_block_size=BLK))
    tm = _port(flat, arch, lt_block_size=BLK)
    g = len(effective_pattern(tm.cfg))
    assert [p for p, _, _ in tst.snapshot_layout(tm.cfg)] == [
        f"groups/block{b}" for b in range(g)]
    toks = _tokens(8, (1, 2 * BLK))
    _, state = tm.state.prefill(torch.from_numpy(toks), max_len=3 * BLK)
    snap = tm.state.snapshot(state)
    data = tm.state.serialize(snap, 2 * BLK)
    jsnap, n = jm16.state.deserialize(data)
    _, jstate = jax.jit(lambda p, t: jm16.state.prefill(p, t, max_len=3 * BLK))(
        params, jnp.asarray(toks, jnp.int32))
    assert n == 2 * BLK
    want = jax.tree_util.tree_leaves(jm16.state.snapshot(jstate))
    got = jax.tree_util.tree_leaves(jsnap)
    assert [np.shape(x) for x in got] == [np.shape(x) for x in want]
    for a, b in zip(got, want):
        _close(np.asarray(a), np.asarray(b))
    back, _ = tm.state.deserialize(data, max_len=3 * BLK)
    assert all(torch.equal(a, b) for a, b in zip(back, snap))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_resume_make_the_reference_calls(inits, arch, cf=0.25):
    """A cold 53-token prefill, and 32 tokens then a resume of 21 (block
    16), at capacity factor 0.25: each within 1e-4 of the reference's same
    calls, drops included. Capacity couples the tokens of a call, so the port makes the
    reference's one call a segment (its attention runs B1's block grid
    inside it)."""
    jm, params, flat = inits(arch)
    jm16 = jax_build_model(jax_get_config(arch, smoke=True, lt_block_size=BLK,
                                          capacity_factor=cf))
    tm = _port(flat, arch, lt_block_size=BLK, capacity_factor=cf)
    toks = _tokens(12, (1, 53))
    jt = jnp.asarray(toks, jnp.int32)
    jprefill = jax.jit(lambda p, t: jm16.state.prefill(p, t, max_len=64))
    jl, _ = jprefill(params, jt)
    _, jpart = jprefill(params, jt[:, :32])
    jr, _ = jax.jit(jm16.state.resume, static_argnums=3)(params, jt[:, 32:], jpart, 32)
    calls = []
    hook = tm.lm.layers[cfg_moe_layer(tm.cfg)].ffn.register_forward_pre_hook(
        lambda mod, args: calls.append(args[0].shape[1]))
    tl, _ = tm.state.prefill(torch.from_numpy(toks), max_len=64)
    _, part = tm.state.prefill(torch.from_numpy(toks[:, :32]), max_len=64)
    tr, _ = tm.state.resume(torch.from_numpy(toks[:, 32:]), part, 32)
    hook.remove()
    assert calls == [53, 32, 21]
    _close(tl, jl)
    _close(tr, jr)


def cfg_moe_layer(cfg):
    return cfg.moe_period - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_serves_an_moe_model(inits, arch):
    """A shared 3-block prefix through the prefix cache at capacity factor
    8.0 (nothing drops): the cached run hits, and its tokens equal the cold
    run's, log-probabilities within 1e-4 (a hit resumes in other calls
    than the cold prefill makes)."""
    from repro_torch.serve.prefix_cache import PrefixCache
    _, _, flat = inits(arch)
    tm = _port(flat, arch, lt_block_size=BLK, capacity_factor=8.0)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 128, 3 * BLK)
    prompts = [np.concatenate([shared, rng.integers(0, 128, 5 + 4 * i)]) for i in range(4)]
    runs = {}
    for name, pc in (("cold", None), ("cached", PrefixCache(1 << 22))):
        eng = ServeEngine(tm, slots=2, max_len=128, prefix_cache=pc, logprobs=True)
        for p in prompts:
            eng.submit(p, 5)
        runs[name] = {o.rid: o for o in eng.run()}
    assert eng.stats()["prefix_cache"]["hits"] >= 2
    for rid, o in runs["cold"].items():
        np.testing.assert_array_equal(o.tokens, runs["cached"][rid].tokens)
        _close(o.logprobs, runs["cached"][rid].logprobs)


def test_inplace_clip_and_slabbed_adamw_keep_the_bits(inits, monkeypatch):
    """The train step clips in place and updates a slab of rows at a time
    (memory for dbrx's 4 GiB expert tensors): two steps with slabs of a
    few rows give the same parameters and moments, bit for bit, as with
    whole tensors, and the in-place clip gives the bits of the
    out-of-place formula, f32 and bf16."""
    _, _, flat = inits("dbrx-132b")
    cfg = get_config("dbrx-132b", smoke=True)
    kw = dict(seq_len=32, global_batch=2, steps=4, peak_lr=3e-3)
    runs, whole = [], optim.adamw.SLAB
    for slab in (whole, 1000):
        monkeypatch.setattr(optim.adamw, "SLAB", slab)
        state = init_train_state(_port(flat, "dbrx-132b", trainable=True).lm)
        step = make_train_step(cfg, TrainConfig(**kw))
        for i in range(2):
            state, _ = step(state, {"tokens": torch.from_numpy(
                _markov(2, 32, i).astype(np.int64))})
        runs.append(state)
    (a, b) = runs
    for name, p in a.lm.named_parameters():
        assert torch.equal(p, dict(b.lm.named_parameters())[name]), name
        assert torch.equal(a.opt.m[name], b.opt.m[name]) and torch.equal(
            a.opt.v[name], b.opt.v[name]), name
    wi = a.lm.layers[0].ffn.wi.detach()
    assert len(optim.adamw._slabs(wi)) == 4          # a slab of one expert
    monkeypatch.setattr(optim.adamw, "SLAB", whole)
    assert optim.adamw._slabs(wi) == [...]
    grads = {f"{n} {dt}": torch.randn(p.shape, dtype=dt)
             for dt in (torch.float32, torch.bfloat16) for n, p in a.lm.named_parameters()}
    norm = optim.global_norm(grads)
    scale = torch.clamp(0.5 / torch.clamp(norm, min=1e-9), max=1.0)
    want = {n: (g.to(torch.float32) * scale).to(g.dtype) for n, g in grads.items()}
    got, gn = optim.clip_by_global_norm({n: g.clone() for n, g in grads.items()}, 0.5)
    assert torch.equal(gn, norm) and all(torch.equal(got[n], want[n]) for n in want)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_clis_run_the_smoke_configs_on_cpu(arch, tmp_path, capsys, caplog):
    out = tmp_path / "toks.json"
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                    "--slots", "2", "--prompt-len", "40", "--gen", "4", "--rate", "0",
                    "--tokens-out", str(out)])
    text = capsys.readouterr().out
    assert "served 3 requests" in text
    assert len(json.loads(out.read_text())["outputs"]) == 3
    caplog.set_level("INFO", logger="repro_torch.train")
    state = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                            "2", "--batch", "2", "--seq", "32", "--log-every", "1"])
    assert state.step == 2
    assert "aux_load_balance" in caplog.text and "aux_router_z" in caplog.text
