"""The port's data-parallel training held to the JAX package on the CPU,
in gloo processes (torch.multiprocessing, rendezvous through a file under
the test's tmp_path, so that no two runs share a port):

- the int8 all-reduce against the reference's int8_allreduce_mean, run
  under jax.vmap over a stacked (N, ...) array (axis_name "d"): bit for
  bit at N 1, within one int8 level of the second stage's scale at N 2
  and 4 (a sum in another order may flip one rounding);
- the manual-DP step at 2 ranks, psum and int8, for 3 steps of SMOKE
  gpt2s-polysketch, against the reference composed from its own
  functions: jax.grad of make_loss_fn per shard, tree_psum_mean /
  tree_int8_allreduce_mean under vmap, clip_by_global_norm, adamw_update;
- the sharded step of --mesh (make_sharded_train_step) on meshes 2x1 and
  1x2 against the reference composed from its own functions on the
  global batch (jax.grad of make_loss_fn, clip_by_global_norm,
  adamw_update), from the schedule's second step so that every step has
  lr > 0: after each step the loss, the grad norm and the gathered
  parameters, m and v (1e-4 of each leaf's max);
- launch/train.py --mesh 2x1:data,model and 1x2:data,model against one
  device, each rank holding only its blocks of the parameters and of
  AdamW's m and v."""
import dataclasses
import multiprocessing
import os

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

if multiprocessing.parent_process() is None:
    # the test process; the spawned gloo workers import this module too, and
    # need none of the reference (JAX doubles their start-up)
    import jax
    import jax.numpy as jnp

    from repro import optim as jax_optim
    from repro.configs import get_config as jax_get_config
    from repro.distributed import compression as jcomp
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.train import make_loss_fn as jax_make_loss_fn
    from repro.utils import tree_paths

from repro_torch.bridge import named_to_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.optim import linear_warmup_linear_decay  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402
from repro_torch.train.step import (init_sharded_train_state,  # noqa: E402
                                    make_manual_dp_train_step, make_sharded_train_step)

ARCH = "gpt2s-polysketch"
SHAPES = ((37,), (3, 5, 7), (4, 250))
STEPS, BATCH, SEQ = 3, 4, 32
TCFG = dict(seq_len=SEQ, global_batch=BATCH, steps=10, peak_lr=3e-3)
CLI = ["--smoke", "--device", "cpu", "--steps", str(STEPS), "--batch", str(BATCH),
       "--seq", str(SEQ), "--log-every", "100"]
MESHES = ("2x1:data,model", "1x2:data,model")


def _spawn(fn, world, tmp_path, *args):
    mp.spawn(fn, args=(world, str(tmp_path), *args), nprocs=world, join=True)


def _join(rank, world, tmp):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    torch.set_num_threads(1)


def _inputs(n_ranks):
    rng = np.random.default_rng(7)
    return [np.stack([rng.standard_normal(s).astype(np.float32) * (1 + i)
                      for i in range(n_ranks)]) for s in SHAPES]


# ---------------------------------------------------------------------------
# the int8 all-reduce
# ---------------------------------------------------------------------------

def _compression_worker(rank, world, tmp):
    _join(rank, world, tmp)
    out = {}
    for n in (1, 2, 4):
        # every rank makes every group; rank r is in group r // n
        groups = [dist.new_group(list(range(g * n, (g + 1) * n))) for g in range(world // n)]
        group, idx = groups[rank // n], rank % n
        xs = _inputs(n)
        out[n] = [compression.int8_allreduce_mean(torch.from_numpy(x[idx]), group).numpy()
                  for x in xs]
        out[(n, "psum")] = [compression.tree_psum_mean(
            {"x": torch.from_numpy(x[idx].copy())}, group)["x"].numpy() for x in xs]
    torch.save(out, os.path.join(tmp, f"comp{rank}.pt"))
    dist.destroy_process_group()


def _stage2_level(x, n):
    """The largest second-stage int8 level (scale / 127) of the reference's
    schedule on the stacked (n, ...) x."""
    flat = x.reshape(n, -1)
    m = flat.shape[1]
    pad = (-m) % n
    chunks = np.pad(flat, ((0, 0), (0, pad))).reshape(n, n, -1)
    s = np.maximum(np.abs(chunks).max(axis=2, keepdims=True), 1e-20)
    q = np.clip(np.round(chunks / s * 127.0), -127, 127)
    part = (q * s / 127.0).sum(axis=0) / n          # (n chunks, c)
    return float(np.abs(part).max(axis=1).max() / 127.0)


def test_int8_allreduce_matches_the_reference_at_1_2_and_4_ranks(tmp_path):
    _spawn(_compression_worker, 4, tmp_path)
    got = [torch.load(tmp_path / f"comp{r}.pt", weights_only=False) for r in range(4)]
    pmean = jax.jit(jax.vmap(lambda v: jax.lax.pmean(v, "d"), axis_name="d"))
    for n in (1, 2, 4):
        int8 = jax.jit(jax.vmap(lambda v: jcomp.int8_allreduce_mean(v, "d", n),  # noqa: B023
                                axis_name="d"))
        for i, x in enumerate(_inputs(n)):
            ref = np.asarray(int8(jnp.asarray(x)))
            pm = np.asarray(pmean(jnp.asarray(x)))
            level = _stage2_level(x, n)
            for rank in range(4):
                mine = got[rank][n][i]
                assert mine.shape == x.shape[1:] and mine.dtype == np.float32
                if n == 1:
                    np.testing.assert_array_equal(mine, ref[rank % n])
                else:
                    assert np.abs(mine - ref[rank % n]).max() <= level * (1 + 1e-6), (n, i)
                np.testing.assert_allclose(got[rank][(n, "psum")][i], pm[rank % n],
                                           rtol=1e-6, atol=1e-6)
    # every rank of a group holds the same result
    for n in (2, 4):
        for rank in range(4):
            first = (rank // n) * n
            for a, b in zip(got[rank][n], got[first][n]):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the manual-DP step and --mesh
# ---------------------------------------------------------------------------

def _batches():
    rng = np.random.default_rng(3)
    vocab = get_config(ARCH, smoke=True).vocab_size
    return rng.integers(0, vocab, size=(STEPS, BATCH, SEQ + 1)).astype(np.int32)


def _dp_worker(rank, world, tmp, init):
    _join(rank, world, tmp)
    cfg = get_config(ARCH, smoke=True)
    out = {}
    for mode in ("none", "int8"):
        model = build_model(cfg, device="cpu", trainable=True, params=init)
        step = make_manual_dp_train_step(cfg, TrainConfig(**TCFG, grad_compression=mode))
        state, losses, stages = init_train_state(model.lm), [], []
        sync = compression.tree_int8_allreduce_mean

        def copy(named):   # on the CPU the bridge's arrays share the tensors' memory
            return {k: v.copy() for k, v in named_to_jax(named, cfg).items()}

        def recorded(grads, group):
            # each step's gradients before and after the sync
            stages[-1]["local"] = copy(grads)
            synced = sync(grads, group)
            stages[-1]["synced"] = copy(synced)
            return synced
        compression.tree_int8_allreduce_mean = recorded
        try:
            for b in _batches():
                stages.append({"params": copy(dict(model.lm.named_parameters())),
                               "m": copy(state.opt.m), "v": copy(state.opt.v),
                               "count": int(state.opt.count)})
                state, metrics = step(state, {"tokens": torch.from_numpy(b)})
                losses.append(float(metrics["loss"]))
                stages[-1]["after"] = copy(dict(model.lm.named_parameters()))
        finally:
            compression.tree_int8_allreduce_mean = sync
        out[mode] = (losses, params_to_jax(model.lm), stages)
    for mesh in MESHES:
        out[(mesh, "steps")] = _mesh_steps(cfg, init, mesh)
        state, losses = train_cli.run(CLI + ["--mesh", mesh])
        held = {n: tuple(p.shape) for n, p in state.params.items()}
        moments = {n: (tuple(state.opt.m[n].shape), tuple(state.opt.v[n].shape))
                   for n in state.params}
        empty = all(p.numel() == 0 for p in state.lm.parameters())
        out[mesh] = (losses, held, moments, empty, dict(state.specs))
    torch.save(out, os.path.join(tmp, f"dp{rank}.pt"))
    dist.destroy_process_group()


def _mesh_steps(cfg, init, mesh):
    """make_sharded_train_step on `mesh` from the weights `init`, STEPS steps
    on _batches() from the schedule's second step: after each, the loss,
    the grad norm and the whole parameters, m and v, gathered from every
    rank's blocks (by the reference's paths)."""
    dmesh = make_mesh(*train_cli.parse_mesh(mesh), device_type="cpu")
    model = build_model(cfg, device="cpu", trainable=True, params=init)
    state = dataclasses.replace(
        init_sharded_train_state(model.lm, dmesh, model.axes()), step=1)
    step = make_sharded_train_step(cfg, TrainConfig(**TCFG))

    def whole(blocks):
        return {k: v.copy() for k, v in named_to_jax(
            {n: shd.gather(x, state.specs[n], dmesh) for n, x in blocks.items()},
            cfg).items()}
    out = []
    for b in _batches():
        state, metrics = step(state, {"tokens": torch.from_numpy(b)})
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    float(metrics["lr"]), whole(state.params), whole(state.opt.m),
                    whole(state.opt.v)))
    return out


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


def _reference_dp(params, mode, n=2):
    """The reference's manual-DP step composed from its own functions,
    STEPS steps on _batches(): per-shard jax.grad of make_loss_fn, the
    sync under vmap over the shards, clip_by_global_norm, adamw_update."""
    jcfg = jax_get_config(ARCH, smoke=True)
    loss_fn = jax_make_loss_fn(jax_build_model(jcfg), jcfg)
    grad_fn = jax.grad(loss_fn, has_aux=True)
    tcfg = TrainConfig(**TCFG)
    sched = linear_warmup_linear_decay(tcfg.peak_lr, tcfg.steps, tcfg.warmup_frac)

    @jax.jit
    def synced(params, shards):
        def one(b):
            g, m = grad_fn(params, {"tokens": b})
            g = (jcomp.tree_int8_allreduce_mean(g, "d", n) if mode == "int8"
                 else jcomp.tree_psum_mean(g, "d"))
            return g, jax.tree_util.tree_map(lambda x: jax.lax.pmean(x, "d"), m)
        g, m = jax.vmap(one, axis_name="d")(shards)
        return jax.tree_util.tree_map(lambda x: x[0], (g, m))

    update = _jax_update(tcfg)
    opt, losses = jax_optim.adamw_init(params), []
    for i, b in enumerate(_batches()):
        g, m = synced(params, jnp.asarray(b.reshape(n, BATCH // n, SEQ + 1)))
        params, opt = update(g, opt, params, float(sched(i)))
        losses.append(float(m["loss"]))
    return losses, _flat(params)


def _jax_update(tcfg):
    """The reference's clip_by_global_norm then adamw_update, jitted."""
    @jax.jit
    def update(g, opt, params, lr):
        g, _ = jax_optim.clip_by_global_norm(g, tcfg.grad_clip)
        return jax_optim.adamw_update(g, opt, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                                      weight_decay=tcfg.weight_decay)
    return update


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    jcfg = jax_get_config(ARCH, smoke=True)
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(5))
    init = params_from_jax(_flat(params), get_config(ARCH, smoke=True))
    _spawn(_dp_worker, 2, tmp, init)
    return params, [torch.load(tmp / f"dp{r}.pt", weights_only=False) for r in range(2)]


def test_manual_dp_psum_step_follows_the_reference_composition(dp_run):
    params, got = dp_run
    want_losses, want = _reference_dp(params, "none")
    for rank in range(2):
        losses, flat, _ = got[rank]["none"]
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-4)
        assert sorted(flat) == sorted(want)
        for path, w in want.items():
            e = np.abs(flat[path] - w).max() / max(np.abs(w).max(), 1e-30)
            assert e <= 1e-4, (rank, path, e)
    # the ranks stay replicas of each other, bit for bit
    for path in want:
        np.testing.assert_array_equal(got[0]["none"][1][path], got[1]["none"][1][path])


def _tree(flat, like):
    leaves = [jnp.asarray(flat[p]) for p in tree_paths(like)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves)


def test_manual_dp_int8_step_follows_the_reference_composition_stage_by_stage(dp_run):
    """The int8 step, each of its 3 steps from the port's own state: each
    rank's gradient against jax.grad of the reference's loss on its shard
    (1e-4 of each leaf's max), the synced gradients against the
    reference's tree_int8_allreduce_mean under vmap of the same per-rank
    gradients (within one level of the second stage's scale), and the
    parameters after against the reference's clip_by_global_norm and
    adamw_update of those synced gradients (1e-4 of each leaf's max).
    Whole runs are not compared: a per-rank gradient 1e-7 off the
    reference's may round to the next int8 level (1/127 of its chunk's
    max), and AdamW's first steps turn a level between 0 and 1 into a
    whole step of lr (2.1e-2 of embed/table's max after 3 steps)."""
    params, got = dp_run
    jcfg = jax_get_config(ARCH, smoke=True)
    loss_fn = jax_make_loss_fn(jax_build_model(jcfg), jcfg)
    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    tcfg = TrainConfig(**TCFG)
    sched = linear_warmup_linear_decay(tcfg.peak_lr, tcfg.steps, tcfg.warmup_frac)
    sync = jax.jit(jax.vmap(lambda g: jcomp.tree_int8_allreduce_mean(g, "d", 2),
                            axis_name="d"))
    update = _jax_update(tcfg)
    _, _, stages0 = got[0]["int8"]
    for i, b in enumerate(_batches()):
        st = stages0[i]
        p = _tree(st["params"], params)
        for rank in range(2):
            assert all(np.array_equal(got[rank]["int8"][2][i]["params"][k], st["params"][k])
                       for k in st["params"])
            want, _ = grad_fn(p, {"tokens": jnp.asarray(b[rank * 2:(rank + 1) * 2])})
            for path, w in _flat(want).items():
                g = got[rank]["int8"][2][i]["local"][path]
                e = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
                assert e <= 1e-4, (i, rank, path, e)
        local = [_tree(got[r]["int8"][2][i]["local"], params) for r in range(2)]
        stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *local)
        ref = _flat(jax.tree_util.tree_map(lambda x: x[0], sync(stacked)))
        for path, w in ref.items():
            x = np.stack([got[r]["int8"][2][i]["local"][path] for r in range(2)])
            level = _stage2_level(x, 2)
            for rank in range(2):
                mine = got[rank]["int8"][2][i]["synced"][path]
                assert np.abs(mine - w).max() <= level * (1 + 1e-6), (i, rank, path)
        opt = jax_optim.AdamWState(m=_tree(st["m"], params), v=_tree(st["v"], params),
                                   count=jnp.asarray(st["count"], jnp.int32))
        new, _ = update(_tree(st["synced"], params), opt, p, float(sched(i)))
        for path, w in _flat(new).items():
            e = np.abs(st["after"][path] - w).max() / max(np.abs(w).max(), 1e-30)
            assert e <= 1e-4, (i, path, e)
    for path in stages0[-1]["after"]:   # the ranks stay replicas, bit for bit
        np.testing.assert_array_equal(got[0]["int8"][1][path], got[1]["int8"][1][path])


def _reference_global(params):
    """The reference's step composed from its own functions on the global
    batch, STEPS steps on _batches() from the schedule's second step:
    jax.grad of make_loss_fn, clip_by_global_norm, adamw_update; after
    each, (loss, grad norm, lr, params, m, v)."""
    jcfg = jax_get_config(ARCH, smoke=True)
    grad_fn = jax.grad(jax_make_loss_fn(jax_build_model(jcfg), jcfg), has_aux=True)
    tcfg = TrainConfig(**TCFG)
    sched = linear_warmup_linear_decay(tcfg.peak_lr, tcfg.steps, tcfg.warmup_frac)

    @jax.jit
    def step(params, opt, tokens, lr):
        g, m = grad_fn(params, {"tokens": tokens})
        g, norm = jax_optim.clip_by_global_norm(g, tcfg.grad_clip)
        params, opt = jax_optim.adamw_update(g, opt, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                                             weight_decay=tcfg.weight_decay)
        return params, opt, m["loss"], norm

    opt, out = jax_optim.adamw_init(params), []
    for i, b in enumerate(_batches()):
        lr = float(sched(i + 1))
        params, opt, loss, norm = step(params, opt, jnp.asarray(b), lr)
        out.append((float(loss), float(norm), lr, _flat(params), _flat(opt.m), _flat(opt.v)))
    return out


@pytest.fixture(scope="module")
def reference_global(dp_run):
    return _reference_global(dp_run[0])


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_step_follows_the_reference_composition(dp_run, reference_global, mesh):
    """Every step moves the weights (lr > 0) and the clip scales every
    update (the SMOKE gradients' norm is 1.8-2.0 against the clip's 1.0),
    so a wrong mean over the data ranks, a wrong norm or a wrong clip
    shows in the grad norm, in m and v, and in the parameters."""
    _, got = dp_run
    want = reference_global
    for rank in range(2):
        for i, (mine, ref) in enumerate(zip(got[rank][(mesh, "steps")], want)):
            loss, norm, lr, *trees = mine
            assert lr == pytest.approx(ref[2], rel=1e-6) and lr > 0
            assert ref[1] > TrainConfig(**TCFG).grad_clip, "the clip does not act"
            np.testing.assert_allclose(loss, ref[0], rtol=0, atol=1e-4)
            np.testing.assert_allclose(norm, ref[1], rtol=1e-4)
            for what, tree, wtree in zip(("params", "m", "v"), trees, ref[3:]):
                assert sorted(tree) == sorted(wtree)
                for path, w in wtree.items():
                    e = np.abs(tree[path] - w).max() / max(np.abs(w).max(), 1e-30)
                    assert e <= 1e-4, (rank, i, what, path, e)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_training_follows_one_device_holding_only_blocks(dp_run, mesh):
    _, got = dp_run
    _, want = train_cli.run(CLI)
    sizes = dict(zip(("data", "model"), (int(x) for x in mesh.split(":")[0].split("x"))))
    model = build_model(get_config(ARCH, smoke=True), device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.lm.named_parameters()}
    axes = model.axes()
    sharded = 0
    for rank in range(2):
        losses, held, moments, empty, specs = got[rank][mesh]
        np.testing.assert_allclose(losses, want, rtol=0, atol=1e-4)
        assert empty, "the LM kept whole parameters between steps"
        for n, shape in shapes.items():
            spec = shd.spec_for(axes[n], shape, sizes)
            assert specs[n] == spec
            want_shape = tuple(
                dim // int(np.prod([sizes[a] for a in shd.spec_axes(
                    spec[d] if d < len(spec) else None)])) for d, dim in enumerate(shape))
            assert held[n] == want_shape and moments[n] == (want_shape, want_shape), n
            sharded += want_shape != shape
    assert sharded > 0, "no parameter is sharded on this mesh"


def test_mesh_refusals():
    with pytest.raises(SystemExit, match="sizes but"):
        train_cli.run(CLI + ["--mesh", "2x1:data"])
    with pytest.raises(SystemExit, match="--share-card shares a CUDA card"):
        train_cli.run(CLI + ["--mesh", "1x1:data,model", "--share-card"])
    with pytest.raises(ValueError, match="wants 2 ranks but 1 are running"):
        train_cli.run(CLI + ["--mesh", "2x1:data,model"])
    assert not dist.is_initialized()
