"""Compute over the "model" mesh axis, held to the JAX package and to the
port's own one-device runs on the CPU, in gloo processes
(torch.multiprocessing, rendezvous through a file under the test's
tmp_path, as tests/test_torch_distributed.py):

- training (make_sharded_train_step) at 1x2 and 2x2 (data, model) for
  SMOKE gpt2s-polysketch, its exact polynomial twin (GPT2_SMALL_POLY4's
  mechanism) and qwen3-14b (GQA 4:2 with q/k norms), 3 AdamW steps from
  the schedule's second step on the same bridged weights and batches:
  against the reference's jitted make_train_step and against the port's
  own one-device step, losses within 1e-4 a step and the whole parameters
  within 1e-4 of each leaf's max; each rank holds half the heads;
- serving (ServeEngine on ServePlan.build(D, M, shard_model=True)) at
  2x1, 1x2 and 2x2 for gpt2s-polysketch and mamba2-780m, on weights
  bridged from a reference init, on the reference's mesh-parity workload
  (tests/test_sharded_serve.py): tokens equal to the port's one-device
  engine's and to the reference's one-device ServeEngine's;
  log-probabilities against the port's one-device engine bit for bit or
  within LP_TOL (at 1x2 they are bit for bit; at 2x1 and 2x2 a data rank
  decodes 2 of the 4 slots, and a product over 2 rows may round otherwise
  than over 4: up to 9.5e-7 nats), against the reference's within
  JAX_LP_TOL (the bound tests/test_torch_serve.py holds the one-device
  engine to); the mesh in stats(), a prefix-cache hit, and every rank's
  decision digest equal after every tick;
- launch/serve.py at --mesh 1x2 --shard-model and --mesh 2x1 under timed
  arrivals (the ranks agree each tick on what arrived): its --tokens-out
  against the one-device CLI's;
- a checkpoint written at 2x1 restored at 1x2 and with no mesh, bit for
  bit, and the resumed runs' losses against the uninterrupted run's;
- the refusals, each naming its ROADMAP item, and the device default."""
import contextlib
import dataclasses
import io
import json
import multiprocessing
import os

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

if multiprocessing.parent_process() is None:
    # the test process; the spawned gloo workers need none of the reference
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.serve import PrefixCache as JaxPrefixCache
    from repro.serve import SamplingParams as JaxSamplingParams
    from repro.serve import ServeEngine as JaxServeEngine
    from repro.train import init_train_state as jax_init_train_state
    from repro.train import make_train_step as jax_make_train_step
    from repro.utils import tree_paths

from repro_torch.bridge import named_to_jax, params_from_jax  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import replicas  # noqa: E402
from repro_torch.serve.engine import RecoveredRequest, ServeEngine  # noqa: E402
from repro_torch.serve.plan import ServePlan, default_device  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.train.step import (init_sharded_train_state,  # noqa: E402
                                    make_sharded_train_step, whole_train_state)
from test_torch_distributed import _join, _spawn  # noqa: E402

TRAIN = {"polysketch": ("gpt2s-polysketch", {}),
         "poly4": ("gpt2s-polysketch", {"attention": "polynomial"}),
         "qwen3-gqa": ("qwen3-14b", {})}
STEPS, BATCH, SEQ = 3, 4, 32
# AdamW's first steps move a weight by about lr whatever its gradient's
# size, so a gradient at float-noise level (the split products' rounding,
# ~1e-6 of a leaf's max in m after a step) moves it by a noise-sized share
# of lr: at lr 3e-3 up to 1.3e-4 of a leaf's max (the one-device port is
# 1.0e-4 from the reference on qwen3's sketch there). At 3e-4 that share
# is ten times less, while a wrong gradient still moves a leaf by ~lr; m
# and v hold the gradients themselves.
TCFG = dict(seq_len=SEQ, global_batch=BATCH, steps=10, peak_lr=3e-4)
SERVE = {"polysketch": "gpt2s-polysketch", "ssd": "mamba2-780m"}
LP_TOL = 1e-5          # log-probabilities that are not bit for bit
JAX_LP_TOL = 1e-4      # log-probabilities against the reference's engine
CKPT_AT = 3            # the checkpoint's step (the run starts at step 1)
# the serving CLI under Poisson arrivals spread over several ticks
SERVE_CLI = ["--smoke", "--device", "cpu", "--requests", "4", "--slots", "2",
             "--prompt-len", "40", "--gen", "8", "--rate", "100", "--logprobs"]
CLI_MESHES = {"1x2": ["--mesh", "1x2", "--shard-model"], "2x1": ["--mesh", "2x1"]}


def _cfg(key):
    arch, over = TRAIN[key]
    return get_config(arch, smoke=True, **over)


def _batches(cfg, n=STEPS):
    rng = np.random.default_rng(3)
    return rng.integers(0, cfg.vocab_size, size=(n, BATCH, SEQ + 1)).astype(np.int32)


def _whole(state, cfg):
    """The whole parameters, m and v of a sharded state by the reference's
    paths (copies: on the CPU the bridge's arrays share the tensors)."""
    return {k: {p: v.copy() for p, v in named_to_jax(t, cfg).items()}
            for k, t in whole_train_state(state).items()}


def _mesh_run(cfg, init, shape, batches):
    """make_sharded_train_step over a (data, model) mesh of `shape` from the
    weights `init`, from the schedule's second step: each step's loss, and
    the whole parameters after the last."""
    dmesh = tmesh.make_mesh(shape, ("data", "model"), "cpu")
    model = build_model(cfg, device="cpu", trainable=True, params=init)
    state = dataclasses.replace(
        init_sharded_train_state(model.lm, dmesh, model.axes()), step=1)
    heads = tuple(state.params["layers.0.mixer.wq"].shape)
    step = make_sharded_train_step(cfg, TrainConfig(**TCFG))
    losses = []
    for b in batches:
        state, metrics = step(state, {"tokens": torch.from_numpy(b)})
        losses.append(float(metrics["loss"]))
    return losses, _whole(state, cfg), heads


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _serve_workload(cfg):
    blk = cfg.lt_block_size
    prompt, shared, gen = 3 * blk + 5, 2 * blk, 6
    rng = np.random.default_rng(11)
    head = rng.integers(0, cfg.vocab_size, size=shared)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size,
                                                  size=prompt - shared)])
               for _ in range(5)]
    return prompts, gen


def _sampling_kw(i):
    # alternating greedy / sampled slots in one batch
    return {} if i % 2 == 0 else dict(temperature=0.8, top_k=12, seed=100 + i)


def _sampling(i):
    return SamplingParams(**_sampling_kw(i))


def _serve_run(model, plan=None):
    """The reference's mesh-parity workload: a warm-up of the cold and the
    restore path, a stats reset, then 5 shared-prefix prompts on 4 slots
    under a one-block prefill budget with overlap. Returns (tokens,
    log-probabilities, stats, the decision digest after every tick)."""
    cfg = model.cfg
    prompts, gen = _serve_workload(cfg)
    eng = ServeEngine(model, slots=4, max_len=len(prompts[0]) + gen + 2,
                      prefix_cache=PrefixCache(8 << 20), logprobs=True,
                      prefill_budget=cfg.lt_block_size, overlap=True, plan=plan)
    for i in (0, 1):
        eng.submit(prompts[0], gen, sampling=_sampling(i))
        eng.run()
    eng.reset_stats()
    for i, p in enumerate(prompts):
        eng.submit(p, gen, sampling=_sampling(i))
    outs, digests = [], []
    while eng.busy:
        outs += eng.step()
        digests.append(eng.decision_digest())
    outs.sort(key=lambda o: o.rid)
    return ([o.tokens.tolist() for o in outs], [o.logprobs for o in outs],
            eng.stats(), digests, eng)


def _serve_cfg(key):
    return get_config(SERVE[key], smoke=True, lt_block_size=16)


def _serve_models(inits):
    """{key: the port's model} on the bridged weights `inits`."""
    return {key: build_model(_serve_cfg(key), device="cpu", params=init)
            for key, init in inits.items()}


def _worker(rank, world, tmp, inits, serve_inits):
    _join(rank, world, tmp)
    shapes = {2: ((1, 2),), 4: ((2, 2),)}[world]
    out = {}
    for key, init in inits.items():
        cfg = _cfg(key)
        for shape in shapes:
            out[("train", key, shape)] = _mesh_run(cfg, init, shape, _batches(cfg))
    models = _serve_models(serve_inits)
    for key, model in models.items():
        for d, m in {2: ((2, 1), (1, 2)), 4: ((2, 2),)}[world]:
            plan = ServePlan.build(d, m, shard_model=True, device="cpu")
            *got, eng = _serve_run(model, plan)
            out[("serve", key, (d, m))] = tuple(got)
    if world == 2:
        from repro_torch.launch.serve import main as serve_main
        for label, mesh in CLI_MESHES.items():
            with contextlib.redirect_stdout(io.StringIO()):
                serve_main(SERVE_CLI + mesh + ["--tokens-out",
                                               os.path.join(tmp, f"cli_{label}.json")])
        out["ckpt"] = _ckpt_worker(tmp, inits["polysketch"])
        plan = ServePlan.build(1, 2, shard_model=True, device="cpu")
        eng = ServeEngine(models["polysketch"], slots=2, max_len=64, plan=plan)
        rec = RecoveredRequest(np.arange(5), [1], [0.0], 3, None, SamplingParams(), 0.0)
        try:
            eng.admit_recovered(rec)
        except NotImplementedError as e:
            out["recover_refusal"] = str(e)
    torch.save(out, os.path.join(tmp, f"tp{world}_{rank}.pt"))
    dist.destroy_process_group()


def _ckpt_worker(tmp, init):
    """Write a checkpoint at 2x1 after two steps and run two more; restore
    it at 1x2 and run the same two. Returns (the 2x1 run's last two losses,
    the restored whole parameters / m / v, the 1x2 run's losses)."""
    cfg = _cfg("polysketch")
    batches = _batches(cfg, 4)
    tcfg = TrainConfig(**TCFG)
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))

    def state_on(shape):
        dmesh = tmesh.make_mesh(shape, ("data", "model"), "cpu")
        model = build_model(cfg, device="cpu", trainable=True, params=init)
        return dataclasses.replace(
            init_sharded_train_state(model.lm, dmesh, model.axes()), step=1)

    step = make_sharded_train_step(cfg, tcfg)
    state, uninterrupted = state_on((2, 1)), []
    for i, b in enumerate(batches):
        state, metrics = step(state, {"tokens": torch.from_numpy(b)})
        if i >= 2:
            uninterrupted.append(float(metrics["loss"]))
        if state.step == CKPT_AT:
            ckpt.save(state.step, state, block=True)
    restored, _ = ckpt.restore(CKPT_AT, state_on((1, 2)))
    at_restore = _whole(restored, cfg)
    resumed = []
    for b in batches[2:]:
        restored, metrics = step(restored, {"tokens": torch.from_numpy(b)})
        resumed.append(float(metrics["loss"]))
    return uninterrupted, at_restore, resumed, restored.step


# ---------------------------------------------------------------------------
# the parent's references
# ---------------------------------------------------------------------------

def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


@pytest.fixture(scope="module")
def inits():
    """{config key: (reference params, the port's bridged state dict)}."""
    out = {}
    for key, (arch, over) in TRAIN.items():
        jcfg = jax_get_config(arch, smoke=True, **over)
        params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(5))
        out[key] = (params, params_from_jax(_flat(params), _cfg(key)))
    return out


@pytest.fixture(scope="module")
def serve_inits():
    """{serve key: (reference model, its params, the port's bridged state
    dict)}, the reference's init at PRNGKey(0) as its parity script."""
    out = {}
    for key, arch in SERVE.items():
        jm = jax_build_model(jax_get_config(arch, smoke=True, lt_block_size=16))
        params, _ = jm.init(jax.random.PRNGKey(0))
        out[key] = (jm, params, params_from_jax(_flat(params), _serve_cfg(key)))
    return out


def _jax_serve_run(jm, params):
    """The reference's one-device ServeEngine on _serve_run's workload:
    (tokens, log-probabilities)."""
    prompts, gen = _serve_workload(jm.cfg)
    prompts = [jnp.asarray(p, jnp.int32) for p in prompts]
    eng = JaxServeEngine(jm, jm.cfg, params, slots=4, max_len=len(prompts[0]) + gen + 2,
                         prefix_cache=JaxPrefixCache(8 << 20), logprobs=True,
                         prefill_budget=jm.cfg.lt_block_size, overlap=True)
    for i in (0, 1):
        eng.submit(prompts[0], gen, sampling=JaxSamplingParams(**_sampling_kw(i)))
        eng.run()
    eng.reset_stats()
    for i, p in enumerate(prompts):
        eng.submit(p, gen, sampling=JaxSamplingParams(**_sampling_kw(i)))
    outs = sorted(eng.run(), key=lambda o: o.rid)
    return [o.tokens.tolist() for o in outs], [np.asarray(o.logprobs) for o in outs]


@pytest.fixture(scope="module")
def serve_refs(serve_inits):
    """{serve key: (the port's one-device run, the reference's)}."""
    models = _serve_models({k: v[2] for k, v in serve_inits.items()})
    return {key: (_serve_run(models[key]), _jax_serve_run(*serve_inits[key][:2]))
            for key in SERVE}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inits, serve_inits):
    got = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"tp{world}")
        _spawn(_worker, world, tmp, {k: v[1] for k, v in inits.items()},
               {k: v[2] for k, v in serve_inits.items()})
        got[world] = [torch.load(tmp / f"tp{world}_{r}.pt", weights_only=False)
                      for r in range(world)]
        got[("dir", world)] = tmp
    return got


def _reference(key, params):
    """The reference's jitted make_train_step, STEPS steps from step 1."""
    arch, over = TRAIN[key]
    jcfg = jax_get_config(arch, smoke=True, **over)
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg), jcfg, TrainConfig(**TCFG)))
    state = jax_init_train_state(params)._replace(step=jnp.ones((), jnp.int32))
    losses = []
    for b in _batches(_cfg(key)):
        state, metrics = step(state, {"tokens": jnp.asarray(b)})
        losses.append(float(metrics["loss"]))
    return losses, {"params": _flat(state.params), "m": _flat(state.opt.m),
                    "v": _flat(state.opt.v)}


def _one_device(key, init):
    """The port's make_train_step on one device, STEPS steps from step 1."""
    cfg = _cfg(key)
    model = build_model(cfg, device="cpu", trainable=True, params=init)
    state = dataclasses.replace(init_train_state(model.lm), step=1)
    step = make_train_step(cfg, TrainConfig(**TCFG))
    losses = []
    for b in _batches(cfg):
        state, metrics = step(state, {"tokens": torch.from_numpy(b)})
        losses.append(float(metrics["loss"]))
    named = {"params": dict(model.lm.named_parameters()), "m": state.opt.m,
             "v": state.opt.v}
    return losses, {k: {p: v.copy() for p, v in named_to_jax(t, cfg).items()}
                    for k, t in named.items()}


def _close(trees, want, what):
    """Parameters, m and v within 1e-4 of each leaf's max."""
    for k in ("params", "m", "v"):
        assert sorted(trees[k]) == sorted(want[k]), what
        for path, w in want[k].items():
            e = np.abs(trees[k][path] - w).max() / max(np.abs(w).max(), 1e-30)
            assert e <= 1e-4, (what, k, path, e)


@pytest.mark.parametrize("key", list(TRAIN))
def test_training_over_model_follows_the_reference_and_one_device(runs, inits, key):
    """Each step's loss and the whole parameters, m and v after 3 steps at
    1x2 and 2x2 against the reference's jitted make_train_step and the
    port's own one-device step; every rank holds its half of the heads
    (wq's block)."""
    want_losses, want = _reference(key, inits[key][0])
    one_losses, one = _one_device(key, inits[key][1])
    np.testing.assert_allclose(one_losses, want_losses, rtol=0, atol=1e-4)
    _close(one, want, (key, "one device", "reference"))
    cfg = _cfg(key)
    for world, shape in ((2, (1, 2)), (4, (2, 2))):
        for rank, got in enumerate(runs[world]):
            losses, params, heads = got[("train", key, shape)]
            assert heads == (cfg.d_model // shape[0], cfg.n_heads // 2,
                             cfg.resolved_head_dim), (shape, heads)
            np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-4)
            np.testing.assert_allclose(losses, one_losses, rtol=0, atol=1e-4)
            _close(params, want, (key, shape, rank, "reference"))
            _close(params, one, (key, shape, rank, "one device"))


@pytest.mark.parametrize("key", list(SERVE))
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_serving_over_a_mesh_follows_one_device(runs, serve_refs, key, shape):
    """Tokens equal to the port's one-device engine's and to the
    reference's; log-probabilities against the port's bit for bit, or
    within LP_TOL where the split products round otherwise, and within
    JAX_LP_TOL of the reference's (the largest differences are printed);
    the mesh in stats(); a prefix-cache hit; every rank's decision digest
    equal after every tick."""
    (base_toks, base_lps, _, base_digests, _), (jax_toks, jax_lps) = serve_refs[key]
    assert base_toks == jax_toks, key
    world = shape[0] * shape[1]
    got = [r[("serve", key, shape)] for r in runs[world]]
    worst, exact, worst_jax = 0.0, 0, 0.0
    for toks, lps, stats, digests in got:
        assert toks == base_toks == jax_toks, (key, shape)
        for a, b, j in zip(lps, base_lps, jax_lps):
            worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()))
            worst_jax = max(worst_jax, float(np.abs(a.astype(np.float64) - j).max()))
            exact += int(np.array_equal(a.view(np.uint32), b.view(np.uint32)))
        assert stats["mesh"]["shape"] == f"{shape[0]}x{shape[1]}", stats["mesh"]
        assert stats["mesh"]["devices"] == {"data": shape[0], "model": shape[1]}
        assert stats["prefix_cache"]["hits"] >= 1, stats["prefix_cache"]
        assert digests == got[0][3], "ranks took different decisions"
    print(f"{key} {shape}: {exact}/{len(base_lps) * world} requests' log-probabilities "
          f"bit for bit, max|diff| {worst:.3e}; against the reference {worst_jax:.3e}")
    assert worst <= LP_TOL, (key, shape, worst)
    assert worst_jax <= JAX_LP_TOL, (key, shape, worst_jax)
    assert len(got[0][3]) == len(base_digests)


@pytest.mark.parametrize("label", list(CLI_MESHES))
def test_serve_cli_over_a_mesh_follows_one_device(runs, tmp_path, label):
    """launch/serve.py over two ranks under timed arrivals: rank 0's
    --tokens-out holds the one-device CLI's tokens, and log-probabilities
    within JAX_LP_TOL (the batches the arrivals form may differ by a tick)."""
    from repro_torch.launch.serve import main as serve_main
    base = tmp_path / "cli_1x1.json"
    with contextlib.redirect_stdout(io.StringIO()):
        serve_main(SERVE_CLI + ["--tokens-out", str(base)])
    want = json.loads(base.read_text())["outputs"]
    got = json.loads((runs[("dir", 2)] / f"cli_{label}.json").read_text())["outputs"]
    assert sorted(got) == sorted(want) and len(want) == 4
    for rid, w in want.items():
        assert got[rid]["tokens"] == w["tokens"], (label, rid)
        np.testing.assert_allclose(got[rid]["logprobs"], w["logprobs"], rtol=0,
                                   atol=JAX_LP_TOL)


def test_checkpoint_at_2x1_restores_on_1x2_and_without_a_mesh(runs, inits):
    """A checkpoint written at 2x1 after two steps: restored at 1x2 (every
    rank) and with no mesh, the parameters and AdamW moments are the
    file's bits; both resumed runs' next two losses lie within 1e-6 of the
    uninterrupted 2x1 run's."""
    uninterrupted, at_restore, _, step_after = runs[2][0]["ckpt"]
    assert step_after == CKPT_AT + 2
    for r in runs[2]:
        _, at_r, resumed_r, _ = r["ckpt"]
        for k in at_restore:
            for p in at_restore[k]:
                np.testing.assert_array_equal(at_r[k][p], at_restore[k][p])
        np.testing.assert_allclose(resumed_r, uninterrupted, rtol=0, atol=1e-6)
    cfg = _cfg("polysketch")
    ckpt = CheckpointManager(str(runs[("dir", 2)] / "ckpt"))
    assert ckpt.latest_step() == CKPT_AT
    with np.load(os.path.join(ckpt.dir, f"step_{CKPT_AT}", "arrays.npz")) as f:
        for k, prefix in (("params", ".params/"), ("m", ".opt/.m/"), ("v", ".opt/.v/")):
            for p, v in at_restore[k].items():
                np.testing.assert_array_equal(f[prefix + p], v, err_msg=(k, p))
    model = build_model(cfg, device="cpu", trainable=True, params=inits["polysketch"][1])
    state, _ = ckpt.restore(CKPT_AT, init_train_state(model.lm))
    plain = {"params": dict(model.lm.named_parameters()), "m": state.opt.m,
             "v": state.opt.v}
    for k, named in plain.items():
        for p, v in named_to_jax(named, cfg).items():
            np.testing.assert_array_equal(v, at_restore[k][p], err_msg=(k, p))
    step = make_train_step(cfg, TrainConfig(**TCFG))
    losses = []
    for b in _batches(cfg, 4)[2:]:
        state, metrics = step(state, {"tokens": torch.from_numpy(b)})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, uninterrupted, rtol=0, atol=1e-6)


def test_refusals_name_their_roadmap_items(runs):
    with pytest.raises(NotImplementedError, match="experts.*A.9 item 4"):
        tp.check_trainable(get_config("dbrx-132b", smoke=True, n_experts=3), 2)
    with pytest.raises(NotImplementedError, match="A.9 item 4"):
        tp.check_trainable(get_config("mamba2-780m", smoke=True), 2)
    with pytest.raises(NotImplementedError, match="head_dim.*A.9 item 4"):
        tp.check_heads(get_config("qwen3-14b", smoke=True), 4)   # 2 kv heads
    tp.check_trainable(get_config("gpt2s-polysketch", smoke=True), 2)
    assert "A.9 item 4" in runs[2][0]["recover_refusal"]
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="A.9 item 4"):
        main(["--smoke", "--device", "cpu", "--replicas", "2", "--mesh", "1x2"])
    with pytest.raises(SystemExit, match="share-card"):
        train_cli.run(["--smoke", "--device", "cpu", "--steps", "1", "--share-card"])


def test_device_default_raises_without_a_card_and_never_picks_the_cpu(monkeypatch):
    assert default_device("cpu") == torch.device("cpu")
    assert ServePlan.single_device("cpu").device == torch.device("cpu")
    assert tmesh._device_type("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: default_device(None), ServePlan.single_device,
                 lambda: ServePlan.build(1, 1), lambda: replicas.replica_plans(2),
                 lambda: tmesh._device_type(None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_shard_act_gathers_only_where_the_rules_map_a_gather_point_to_nothing():
    x = torch.arange(6.0).reshape(2, 3)
    sizes = {"data": 1, "model": 1}
    with shd.activation_sharding(sizes, {"act_heads": ()}):
        assert shd.shard_act(x, "batch", "act_heads") is x
        assert not tp.keeps("act_heads")
    assert tp.active() is None and tp.model_size() == 1
    # a plain {axis: size} names no ranks to compute over
    with shd.activation_sharding({"data": 1, "model": 2}):
        assert tp.model_size() == 1 and shd.shard_act(x, "act_mlp") is x
