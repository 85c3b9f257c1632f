"""The MoE family over a device mesh, held to the JAX package and to the
port's own one-device runs on the CPU, in gloo processes
(torch.multiprocessing, rendezvous through a file under the test's
tmp_path, as tests/test_torch_distributed.py):

- training (make_sharded_train_step) of SMOKE dbrx-132b (4 experts,
  top-2, every layer) and llama4-maverick (8 experts, top-1, every second
  layer) at 1x2, 2x1 and 2x2 (data, model) for 3 AdamW steps from the
  schedule's second step, at capacity 1.25 and at a capacity that drops
  (0.5), at dispatch groups 1 (gathered over "data") and 2 (one local
  group a data rank), and with 2 microbatches: against the reference's
  jitted make_train_step on the same bridged weights and global batches
  and against the port's one-device step, losses within 1e-4 a step,
  both aux metrics within 1e-6 of their value, the parameters, m and v
  within 1e-4 of each leaf's max; each rank's wi block holds E/M experts,
  and the dispatch plans' digests are equal over each "model" axis;
- the three faults this repairs on the "data" axis, each a case above
  at 2x1: the aux losses over each rank's rows (dbrx at 1.25), dispatch
  groups counted per rank with capacity reckoned on its rows (dbrx at
  0.5), microbatches cut from each rank's rows (dbrx at 0.5, groups 2
  and 2 microbatches);
- serving: a dbrx ServeEngine on 16 greedy slots at capacity 1.0, one
  device, 2x1 and 1x2 with shard_model, against the reference's engine:
  tokens equal. The reference's tick maps the decode over the slots, so
  each slot's token routes alone and never drops; a batched call of the
  16 tokens would have dropped (an expert got more than its capacity);
- launch/train.py --mesh 1x2:data,model on dbrx against one device;
- a checkpoint written from an expert-sharded state at 1x2 restored at
  2x1 and with no mesh, bit for bit;
- the refusal of a "model" axis that does not divide the experts;
- at 1x2, dbrx and a dense model (qwen3-14b) under remat "full" and
  "dots", every backward on a thread of its own as on CUDA: remat
  "none"'s losses and state bit for bit (the recompute runs under the
  mesh context its forward ran under).

The reference's runs go to processes of their own (the only ones that
import JAX), started beside the gloo spawns, so its compiles run side by
side.

The weights are the port's seeded init plus seeded noise on every leaf
(a trained state's), bridged to the reference: on a leaf that starts at zero (the sketch's and the
norms' biases) AdamW's sign-like first steps make float noise a share of
the whole leaf, and the one-device port is 2.4e-4 of such a leaf's max
from the reference on dbrx at capacity 0.5."""
import contextlib
import dataclasses
import os
import threading
from concurrent.futures import ProcessPoolExecutor

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.bridge import named_to_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.plan import ServePlan  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.train.step import (init_sharded_train_state,  # noqa: E402
                                    make_sharded_train_step, whole_train_state)
from test_torch_distributed import _join  # noqa: E402

DBRX, MAVERICK = "dbrx-132b", "llama4-maverick-400b-a17b"
# key: (arch, config overrides, microbatches)
CASES = {"dbrx": (DBRX, {}, 1),
         "dbrx-drop": (DBRX, {"capacity_factor": 0.5}, 1),
         "dbrx-g2-mb2-drop": (DBRX, {"capacity_factor": 0.5, "moe_dispatch_groups": 2}, 2),
         "maverick": (MAVERICK, {}, 1),
         "maverick-drop": (MAVERICK, {"capacity_factor": 0.5}, 1)}
MESHES = ((1, 2), (2, 1), (2, 2))
STEPS, BATCH, SEQ = 3, 4, 32
TCFG = dict(seq_len=SEQ, global_batch=BATCH, steps=10, peak_lr=3e-4)
NOISE = 0.02           # the seeded noise on every leaf of the reference's init
AUX_TOL = 1e-6         # the aux metrics, relative to their value
SERVE_SLOTS, SERVE_CF, SERVE_GEN = 16, 1.0, 12
CKPT_AT = 3            # the checkpoint's step (the run starts at step 1)
# remat runs at 1x2: (arch, config overrides, weights: a case of CASES or None
# for the port's seed-0 init)
REMAT = {"dbrx": (DBRX, {}, "dbrx"), "qwen3-gqa": ("qwen3-14b", {}, None)}
REMAT_STEPS = 2
CLI = ["--arch", DBRX, "--smoke", "--device", "cpu", "--steps", str(STEPS), "--batch",
       str(BATCH), "--seq", str(SEQ), "--log-every", "100"]


def _cfg(key):
    arch, over, _ = CASES[key]
    return get_config(arch, smoke=True, **over)


def _tcfg(key):
    return TrainConfig(microbatches=CASES[key][2], **TCFG)


def _batches(cfg, n=STEPS):
    rng = np.random.default_rng(3)
    return rng.integers(0, cfg.vocab_size, size=(n, BATCH, SEQ + 1)).astype(np.int32)


class PlanLog:
    """Wraps moe.dispatch_plan while active: each plan's (digest, tokens,
    capacity, the most assignments an expert got in a group, dropped
    assignments), in call order."""

    def __enter__(self):
        self.calls, self._fn = [], moe.dispatch_plan

        def logged(cfg, ids, *a, **k):
            plan = self._fn(cfg, ids, *a, **k)
            self.calls.append((moe.plan_digest(plan), int(ids.shape[0]), plan.cap,
                               int(plan.count.max()), int((~plan.keep).sum())))
            return plan
        moe.dispatch_plan = logged
        return self

    def __exit__(self, *exc):
        moe.dispatch_plan = self._fn

    @property
    def dropped(self) -> int:
        return sum(c[-1] for c in self.calls)


def _whole(state, cfg):
    """The whole parameters, m and v of a sharded state by the reference's
    paths (copies: on the CPU the bridge's arrays share the tensors)."""
    return {k: {p: v.copy() for p, v in named_to_jax(t, cfg).items()}
            for k, t in whole_train_state(state).items()}


def _losses(metrics):
    return tuple(float(metrics[k]) for k in ("loss", "aux_load_balance", "aux_router_z"))


def _mesh_state(cfg, init, shape):
    dmesh = tmesh.make_mesh(shape, ("data", "model"), "cpu")
    model = build_model(cfg, device="cpu", trainable=True, params=init)
    return dataclasses.replace(init_sharded_train_state(model.lm, dmesh, model.axes()),
                               step=1)


def _mesh_run(key, init, shape):
    """make_sharded_train_step over a (data, model) mesh of `shape`: each
    step's (loss, aux_load_balance, aux_router_z), the whole parameters /
    m / v after the last, the first MoE layer's wi block, and the plans'
    log."""
    cfg = _cfg(key)
    state = _mesh_state(cfg, init, shape)
    wi = next(n for n in state.params if n.endswith("ffn.wi") and
              state.params[n].dim() == 3)
    step = make_sharded_train_step(cfg, _tcfg(key))
    out = []
    with PlanLog() as plans:
        for b in _batches(cfg):
            state, metrics = step(state, {"tokens": torch.from_numpy(b)})
            out.append(_losses(metrics))
    return out, _whole(state, cfg), tuple(state.params[wi].shape), plans.calls


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _serve_prompts(vocab):
    rng = np.random.default_rng(30)
    return [rng.integers(0, vocab, size=n) for n in (12, 20) * (SERVE_SLOTS // 2)]


def _serve_cfg():
    return get_config(DBRX, smoke=True, lt_block_size=16, capacity_factor=SERVE_CF)


def _serve_run(init, plan=None):
    """16 greedy requests on 16 slots: (tokens by request, the plans' log)."""
    model = build_model(_serve_cfg(), device="cpu", params=init)
    eng = ServeEngine(model, slots=SERVE_SLOTS, max_len=48, plan=plan)
    for p in _serve_prompts(model.cfg.vocab_size):
        eng.submit(p, SERVE_GEN)
    with PlanLog() as plans:
        outs = sorted(eng.run(), key=lambda o: o.rid)
    return [o.tokens.tolist() for o in outs], plans.calls


@contextlib.contextmanager
def _backward_on_threads_of_its_own():
    """Inside: every Tensor.backward runs on a new thread, outside the
    thread-local contexts of the caller (as autograd runs a CUDA tensor's
    backward on a device thread of its own)."""
    plain = torch.Tensor.backward

    def backward(self, *a, **k):
        errors = []

        def run():
            try:
                plain(self, *a, **k)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
        t = threading.Thread(target=run)
        t.start()
        t.join()
        if errors:
            raise errors[0]
    torch.Tensor.backward = backward
    try:
        yield
    finally:
        torch.Tensor.backward = plain


def _remat_run(key, remat, inits):
    """REMAT_STEPS steps of `key` at 1x2 under `remat`, every backward on a
    thread of its own: (each step's loss, the whole parameters / m / v)."""
    arch, over, weights = REMAT[key]
    cfg = get_config(arch, smoke=True, remat=remat, **over)
    state = _mesh_state(cfg, None if weights is None else inits[weights], (1, 2))
    step = make_sharded_train_step(cfg, TrainConfig(**TCFG))
    losses = []
    with _backward_on_threads_of_its_own():
        for b in _batches(cfg, REMAT_STEPS):
            state, metrics = step(state, {"tokens": torch.from_numpy(b)})
            losses.append(float(metrics["loss"]))
    return losses, _whole(state, cfg)


def _worker(rank, world, tmp, inits, serve_init):
    _join(rank, world, tmp)
    out = {}
    shapes = [s for s in MESHES if s[0] * s[1] == world]
    for key, init in inits.items():
        for shape in shapes:
            try:
                out[("train", key, shape)] = _mesh_run(key, init, shape)
            except NotImplementedError as e:   # the same on every rank
                out[("train", key, shape)] = repr(e)
    if world == 2:
        for d, m in ((2, 1), (1, 2)):
            plan = ServePlan.build(d, m, shard_model=True, device="cpu")
            out[("serve", (d, m))] = _serve_run(serve_init, plan)
        try:
            _, losses = train_cli.run(CLI + ["--mesh", "1x2:data,model"])
            out["cli"] = losses
            out["ckpt"] = _ckpt_worker(tmp, inits["dbrx"])
        except NotImplementedError as e:
            out["cli"] = out["ckpt"] = repr(e)
        for key in REMAT:
            for remat in ("none", "full", "dots"):
                try:
                    out[("remat", key, remat)] = _remat_run(key, remat, inits)
                except Exception as e:  # noqa: BLE001 - the test reports it
                    out[("remat", key, remat)] = repr(e)
    torch.save(out, os.path.join(tmp, f"ep{world}_{rank}.pt"))
    dist.destroy_process_group()


def _ckpt_worker(tmp, init):
    """Write a checkpoint at 1x2 after two steps and run two more; restore
    it at 2x1 and run the same two. Returns (the 1x2 run's last two
    losses, the restored whole parameters / m / v, the 2x1 run's losses,
    the restored step)."""
    cfg = _cfg("dbrx")
    batches = _batches(cfg, 4)
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    step = make_sharded_train_step(cfg, _tcfg("dbrx"))
    state, uninterrupted = _mesh_state(cfg, init, (1, 2)), []
    for i, b in enumerate(batches):
        state, metrics = step(state, {"tokens": torch.from_numpy(b)})
        if i >= 2:
            uninterrupted.append(float(metrics["loss"]))
        if state.step == CKPT_AT:
            ckpt.save(state.step, state, block=True)
    restored, _ = ckpt.restore(CKPT_AT, _mesh_state(cfg, init, (2, 1)))
    at_restore = _whole(restored, cfg)
    resumed = []
    for b in batches[2:]:
        restored, metrics = step(restored, {"tokens": torch.from_numpy(b)})
        resumed.append(float(metrics["loss"]))
    return uninterrupted, at_restore, resumed, restored.step


# ---------------------------------------------------------------------------
# the reference: each run in a process of its own, the only ones that
# import JAX, started beside the gloo spawns
# ---------------------------------------------------------------------------

def _jax_params(arch, flat, **over):
    """The reference's parameter tree holding the arrays of `flat` (its
    paths), built without running the reference's init."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.utils import tree_paths
    init = jax_build_model(jax_get_config(arch, smoke=True, **over)).init
    shapes = jax.eval_shape(lambda key: init(key)[0], jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(shapes)
    return jax.tree_util.tree_unflatten(treedef, [jax.numpy.asarray(flat[p])
                                                  for p in tree_paths(shapes)])


def _flat(tree):
    import jax
    from repro.utils import tree_paths
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


def _reference(key, flat):
    """The reference's jitted make_train_step on the weights `flat`, STEPS
    steps from step 1: ((loss, aux_load_balance, aux_router_z) a step,
    {"params", "m", "v"} after the last)."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.train import init_train_state as jax_init_train_state
    from repro.train import make_train_step as jax_make_train_step
    arch, over, _ = CASES[key]
    jcfg = jax_get_config(arch, smoke=True, **over)
    step = jax.jit(jax_make_train_step(jax_build_model(jcfg), jcfg, _tcfg(key)))
    state = jax_init_train_state(_jax_params(arch, flat, **over))
    state = state._replace(step=jax.numpy.ones((), jax.numpy.int32))
    out = []
    for b in _batches(_cfg(key)):
        state, metrics = step(state, {"tokens": jax.numpy.asarray(b)})
        out.append(_losses(metrics))
    return out, {"params": _flat(state.params), "m": _flat(state.opt.m),
                 "v": _flat(state.opt.v)}


def _jax_serve(flat):
    """The reference's one-device ServeEngine on the serving case: its
    tokens by request."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.serve import ServeEngine as JaxServeEngine
    over = dict(lt_block_size=16, capacity_factor=SERVE_CF)
    jm = jax_build_model(jax_get_config(DBRX, smoke=True, **over))
    eng = JaxServeEngine(jm, jm.cfg, _jax_params(DBRX, flat, **over), slots=SERVE_SLOTS,
                         max_len=48)
    for p in _serve_prompts(jm.cfg.vocab_size):
        eng.submit(jax.numpy.asarray(p, jax.numpy.int32), SERVE_GEN)
    return [o.tokens.tolist() for o in sorted(eng.run(), key=lambda o: o.rid)]


# ---------------------------------------------------------------------------
# the parent: the spawns and the references' processes start together
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inits():
    """{case: (the weights by the reference's paths, the port's state
    dict)}: the port's seeded init plus NOISE x N(0, 1) on every leaf
    (seeded), one an architecture."""
    by_arch, out = {}, {}
    rng = np.random.default_rng(31)
    for key, (arch, _, _) in CASES.items():
        if arch not in by_arch:
            cfg = get_config(arch, smoke=True)
            lm = build_model(cfg, device="cpu", seed=5).lm
            flat = {p: v + (NOISE * rng.standard_normal(v.shape)).astype(v.dtype)
                    for p, v in params_to_jax(lm).items()}
            by_arch[arch] = flat, params_from_jax(flat, cfg)
        out[key] = by_arch[arch]
    return out


@pytest.fixture(scope="module")
def serve_init():
    """(the weights by the reference's paths, the port's state dict) of
    the serving case: the port's seed-0 init."""
    cfg = _serve_cfg()
    flat = {p: v.copy() for p, v in
            params_to_jax(build_model(cfg, device="cpu", seed=0).lm).items()}
    return flat, params_from_jax(flat, cfg)


@pytest.fixture(scope="module")
def started(tmp_path_factory, inits, serve_init):
    """Both spawns (2 and 4 ranks), started before the references run."""
    out = []
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"ep{world}")
        ctx = mp.spawn(_worker, args=(world, str(tmp), {k: v[1] for k, v in inits.items()},
                                      serve_init[1]), nprocs=world, join=False)
        out.append((world, tmp, ctx))
    return out


@pytest.fixture(scope="module")
def references(started, inits, serve_init):
    """{case: (the reference's run, the port's one-device run)}, the
    one-device run with its plans' log; "serve": the port's one-device
    engine's tokens and plans, the reference's tokens."""
    with ProcessPoolExecutor(len(CASES) + 1, mp_context=mp.get_context("spawn")) as pool:
        refs = {key: pool.submit(_reference, key, inits[key][0]) for key in CASES}
        jax_serve = pool.submit(_jax_serve, serve_init[0])
        out = {key: (refs[key].result(), _one_device(key, inits[key][1])) for key in CASES}
        out["serve"] = _serve_run(serve_init[1]), jax_serve.result()
    return out


@pytest.fixture(scope="module")
def runs(started, references):
    """The spawns joined: {world: every rank's results}, {("dir", world):
    its directory}."""
    got = {}
    for world, tmp, ctx in started:
        while not ctx.join():
            pass
        got[world] = [torch.load(tmp / f"ep{world}_{r}.pt", weights_only=False)
                      for r in range(world)]
        got[("dir", world)] = tmp
    return got


def _one_device(key, init):
    cfg = _cfg(key)
    model = build_model(cfg, device="cpu", trainable=True, params=init)
    state = dataclasses.replace(init_train_state(model.lm), step=1)
    step = make_train_step(cfg, _tcfg(key))
    out = []
    with PlanLog() as plans:
        for b in _batches(cfg):
            state, metrics = step(state, {"tokens": torch.from_numpy(b)})
            out.append(_losses(metrics))
    named = {"params": dict(model.lm.named_parameters()), "m": state.opt.m,
             "v": state.opt.v}
    return out, {k: {p: v.copy() for p, v in named_to_jax(t, cfg).items()}
                 for k, t in named.items()}, plans


def _close_steps(got, want, what):
    """Losses within 1e-4 a step; both aux metrics within AUX_TOL of their
    value."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-4, err_msg=what)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=AUX_TOL, atol=0, err_msg=what)


def _close(trees, want, what):
    """Parameters, m and v within 1e-4 of each leaf's max."""
    for k in ("params", "m", "v"):
        assert sorted(trees[k]) == sorted(want[k]), what
        for path, w in want[k].items():
            e = np.abs(trees[k][path] - w).max() / max(np.abs(w).max(), 1e-30)
            assert e <= 1e-4, (what, k, path, e)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("key", list(CASES))
def test_moe_training_over_a_mesh_follows_the_reference_and_one_device(
        runs, references, key, shape):
    """Each step's loss and aux metrics and the whole parameters, m and v
    after 3 steps against the reference's jitted make_train_step and the
    port's one-device step; every rank holds E/M experts of wi; the plans'
    digests are equal on the ranks of each "model" axis; a drop case
    dropped (in the one-device run)."""
    (want_steps, want), (one_steps, one, one_plans) = references[key]
    _close_steps(one_steps, want_steps, (key, "one device"))
    _close(one, want, (key, "one device", "reference"))
    if CASES[key][1].get("capacity_factor", 1.25) < 1:
        assert one_plans.dropped > 0, key
    cfg = _cfg(key)
    world = shape[0] * shape[1]
    got = [r[("train", key, shape)] for r in runs[world]]
    for rank, g in enumerate(got):
        assert not isinstance(g, str), (key, shape, rank, g)
        steps, trees, wi, plans = g
        assert wi == (cfg.n_experts // shape[1], cfg.d_model // shape[0], cfg.d_ff), wi
        _close_steps(steps, want_steps, (key, shape, rank, "reference"))
        _close_steps(steps, one_steps, (key, shape, rank, "one device"))
        _close(trees, want, (key, shape, rank, "reference"))
        _close(trees, one, (key, shape, rank, "one device"))
    for d in range(shape[0]):      # ranks d * M .. are data rank d's "model" axis
        axis = got[d * shape[1]:(d + 1) * shape[1]]
        assert all(g[3] == axis[0][3] for g in axis), (key, shape, "plans differ")
        assert axis[0][3], (key, shape, "no plan logged")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2-shard-model"])
def test_moe_engine_routes_each_slot_alone_as_the_reference(runs, references, shape):
    """dbrx on 16 greedy slots at capacity 1.0: the port's one-device
    engine and every rank's engine emit the reference's tokens; no tick
    dropped, though an expert got more of a tick's 16 tokens than a
    batched call of them has room for."""
    (base, plans), want = references["serve"]
    assert base == want
    # the ticks (16 tokens, room for each): nothing dropped, and an expert
    # got more than a batched call of 16 tokens would have room for
    ticks = [c for c in plans if c[1:3] == (SERVE_SLOTS, SERVE_SLOTS)]
    assert ticks and not any(c[4] for c in ticks)
    assert max(c[3] for c in ticks) > moe.capacity(_serve_cfg(), SERVE_SLOTS)
    for r in runs[2]:
        toks, _ = r[("serve", shape)]
        assert toks == base, shape


def test_train_cli_over_1x2_follows_one_device(runs):
    """launch/train.py --mesh 1x2:data,model trains dbrx (each rank half of
    the experts): the losses of one device within 1e-4."""
    _, want = train_cli.run(CLI)
    for r in runs[2]:
        assert not isinstance(r["cli"], str), r["cli"]
        np.testing.assert_allclose(r["cli"], want, rtol=0, atol=1e-4)


def test_checkpoint_of_expert_blocks_restores_on_2x1_and_without_a_mesh(runs, inits):
    """A checkpoint written from an expert-sharded state at 1x2: restored at
    2x1 (every rank) and with no mesh, the parameters and AdamW moments are
    the file's bits, and both resumed runs' losses lie within 1e-6 of the
    uninterrupted run's."""
    assert not isinstance(runs[2][0]["ckpt"], str), runs[2][0]["ckpt"]
    uninterrupted, at_restore, _, step_after = runs[2][0]["ckpt"]
    assert step_after == CKPT_AT + 2
    for r in runs[2]:
        _, at_r, resumed_r, _ = r["ckpt"]
        for k in at_restore:
            for p in at_restore[k]:
                np.testing.assert_array_equal(at_r[k][p], at_restore[k][p])
        np.testing.assert_allclose(resumed_r, uninterrupted, rtol=0, atol=1e-6)
    cfg = _cfg("dbrx")
    ckpt = CheckpointManager(str(runs[("dir", 2)] / "ckpt"))
    assert ckpt.latest_step() == CKPT_AT
    with np.load(os.path.join(ckpt.dir, f"step_{CKPT_AT}", "arrays.npz")) as f:
        for k, prefix in (("params", ".params/"), ("m", ".opt/.m/"), ("v", ".opt/.v/")):
            for p, v in at_restore[k].items():
                np.testing.assert_array_equal(f[prefix + p], v, err_msg=(k, p))
    model = build_model(cfg, device="cpu", trainable=True, params=inits["dbrx"][1])
    state, _ = ckpt.restore(CKPT_AT, init_train_state(model.lm))
    plain = {"params": dict(model.lm.named_parameters()), "m": state.opt.m,
             "v": state.opt.v}
    for k, named in plain.items():
        for p, v in named_to_jax(named, cfg).items():
            np.testing.assert_array_equal(v, at_restore[k][p], err_msg=(k, p))
    step = make_train_step(cfg, _tcfg("dbrx"))
    losses = []
    for b in _batches(cfg, 4)[2:]:
        state, metrics = step(state, {"tokens": torch.from_numpy(b)})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, uninterrupted, rtol=0, atol=1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("key", list(REMAT))
def test_a_rematerialised_block_recomputes_under_the_forward_contexts(runs, key, remat):
    """At 1x2, a rematerialised block is recomputed where autograd runs the
    backward (on CUDA a thread of its own; here every backward runs on a
    Python thread of its own, outside every context the step set): the
    recompute still runs with its collectives, so dbrx's experts (whose
    recompute would otherwise fail) and a dense model's Megatron pair
    (whose gradients would otherwise be wrong, with no error) give remat
    "none"'s losses and parameters, m and v bit for bit."""
    for r in runs[2]:
        got, want = r[("remat", key, remat)], r[("remat", key, "none")]
        assert not isinstance(got, str), (key, remat, got)
        assert got[0] == want[0], (key, remat, got[0], want[0])
        for k in ("params", "m", "v"):
            for path, w in want[1][k].items():
                np.testing.assert_array_equal(got[1][k][path], w, err_msg=(key, remat, k, path))


def test_a_model_axis_that_does_not_divide_the_experts_is_refused():
    with pytest.raises(NotImplementedError, match="3 experts.*A.9 item 4"):
        tp.check_trainable(get_config(DBRX, smoke=True, n_experts=3), 2)
    tp.check_trainable(get_config(DBRX, smoke=True), 2)
    tp.check_trainable(get_config(DBRX, smoke=True, n_experts=3), 1)
