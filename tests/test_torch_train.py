"""The port's training path held to the JAX package on the CPU: B1's
backward (plain version against autograd, ops gradients against
jax.grad), the SMOKE loss gradients, 12 AdamW steps, the decay mask, the
schedules and optimizer functions, the synthetic data, checkpoints in both
directions, the CLI, and the gradient guards of B3 (no backward) and B2
(its autograd Function)."""
import os
import signal

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.checkpoint.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.optim.adamw import _wd_mask  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.bridge import (jax_path, named_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax, train_state_to_jax)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import DataIterator, synthetic  # noqa: E402
from repro_torch.distributed.fault import PreemptionGuard, StragglerDetector  # noqa: E402
from repro_torch.kernels import lt_mult as lt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import poly_flash as pf  # noqa: E402
from repro_torch.kernels import polysketch_causal as pc  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

ARCH = "gpt2s-polysketch"


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


def _port_model(params, cfg=None):
    cfg = cfg or get_config(ARCH, smoke=True)
    return build_model(cfg, device="cpu", trainable=True,
                       params=params_from_jax(_flat(params), cfg))


def _leaf_close(got: dict, want: dict, tol):
    """Every leaf within tol of its own max|.|."""
    assert sorted(got) == sorted(want)
    for path in want:
        w = np.asarray(want[path], np.float64)
        e = np.abs(np.asarray(got[path], np.float64) - w).max()
        assert e <= tol * max(np.abs(w).max(), 1e-30), (path, e, np.abs(w).max())


@pytest.fixture(scope="module")
def jax_pair():
    """(jax model, jax params) of SMOKE from PRNGKey(0)."""
    jm = jax_build_model(jax_get_config(ARCH, smoke=True))
    params, _ = jm.init(jax.random.PRNGKey(0))
    return jm, params


def _markov(batch, seq, step, seed=1, vocab=128):
    return synthetic.make_markov_lm(vocab, seed=seed)(batch, seq, step)


# ---------------------------------------------------------------------------
# B1's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [2, 4, 8])
@pytest.mark.parametrize("local_exact", [True, False])
@pytest.mark.parametrize("with_z0", [False, True])
def test_plain_backward_matches_autograd(degree, local_exact, with_z0):
    """polysketch_causal_backward_torch against torch.autograd of the plain
    forward, 3 blocks, within 1e-5 of each gradient's max|.|."""
    rng = np.random.default_rng(degree + 10 * local_exact)
    bh, n, r, h, blk = 3, 96, 8, 16, 32

    def leaf(*shape, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).requires_grad_(True)

    qm, km = leaf(bh, n, r, scale=0.5), leaf(bh, n, r, scale=0.5)
    q, k, v = leaf(bh, n, h, scale=0.5), leaf(bh, n, h, scale=0.5), leaf(bh, n, h)
    kw = dict(degree=degree, scale=1.0 / h, local_exact=local_exact, block_size=blk)
    zv0 = torch.zeros(bh, r, r * h)
    zd0 = torch.zeros(bh, r, r)
    if with_z0:   # the state a previous call of the same heads returned
        with torch.no_grad():
            _, zv0, zd0 = pc.polysketch_causal_torch(
                *(leaf(bh, n, x, scale=s).detach() for x, s in
                  ((r, 0.5), (r, 0.5), (h, 0.5), (h, 0.5), (h, 1.0))),
                return_state=True, **kw)
    zv0.requires_grad_(True)
    zd0.requires_grad_(True)
    ins = (qm, km, q, k, v, zv0, zd0)
    out = pc.polysketch_causal_torch(*ins, **kw)
    dout = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    want = torch.autograd.grad(out, ins, dout, allow_unused=True)
    with torch.no_grad():
        o, _, _, saved = pc.polysketch_causal_torch(*ins, return_saved=True, **kw)
        got = pc.polysketch_causal_backward_torch(dout, *ins[:5], o, saved, **kw)
    for name, g, w in zip(("qm", "km", "q", "k", "v", "zv0", "zd0"), got, want):
        w = torch.zeros_like(g) if w is None else w
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), name


@pytest.mark.parametrize("case", ["gqa_4_2", "unaligned_n77"])
def test_ops_gradients_match_jax(case):
    """ops.polysketch_attention's gradients (through the Function and the
    plain backward) against jax.grad of the JAX op on its XLA path."""
    rng = np.random.default_rng(3)
    if case == "gqa_4_2":
        b, hq, hkv, s, hd, r, blk = 2, 4, 2, 96, 16, 8, 32
    else:   # zero-padded to the block: padded rows must take no gradient
        b, hq, hkv, s, hd, r, blk = 1, 2, 2, 77, 16, 8, 32
    arrs = [rng.standard_normal(sh).astype(np.float32) * sc for sh, sc in (
        ((b, hq, s, r), 0.5), ((b, hkv, s, r), 0.5), ((b, hq, s, hd), 0.5),
        ((b, hkv, s, hd), 0.5), ((b, hkv, s, hd), 1.0))]
    dout = rng.standard_normal((b, hq, s, hd)).astype(np.float32)
    kw = dict(degree=4, scale=1.0 / hd, block_size=blk)

    def jloss(*xs):
        y = jax_ops.polysketch_attention(*xs, impl="xla", **kw)
        return jnp.sum(y * dout)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, arrs))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y = ops.polysketch_attention(*xs, **kw)
    (y * torch.from_numpy(dout)).sum().backward()
    for name, x, w in zip(("qm", "km", "q", "k", "v"), xs, want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.grad.numpy(), w, atol=1e-4 * np.abs(w).max(),
                                   rtol=1e-4, err_msg=name)


def test_gradient_reaches_z0_and_not_through_returned_state():
    rng = np.random.default_rng(4)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.5).requires_grad_(True)
    qm, km, q, k, v = t(1, 2, 64, 4), t(1, 2, 64, 4), t(1, 2, 64, 8), t(1, 2, 64, 8), t(1, 2, 64, 8)
    with torch.no_grad():
        _, z0 = ops.polysketch_attention(qm, km, q, k, v, degree=2, scale=0.125,
                                         block_size=16, return_state=True)
    z0.requires_grad_(True)
    out, z = ops.polysketch_attention(qm, km, q, k, v, degree=2, scale=0.125,
                                      block_size=16, z0=z0, return_state=True)
    out.sum().backward(retain_graph=True)
    assert z0.grad is not None and z0.grad.abs().max() > 0
    with pytest.raises(NotImplementedError, match="returned state"):
        z.sum().backward()


def test_bf16_gradient_raises():
    """bf16 trains through B1 (tests/test_torch_bf16.py) and, since B2's
    backward takes bf16 too, through B2 (tests/test_torch_b2_bf16.py);
    either gradient still raises where the types are mixed."""
    x = torch.zeros(1, 2, 32, 8, dtype=torch.bfloat16, requires_grad=True)
    y = torch.zeros(1, 2, 32, 8, requires_grad=True)
    out = ops.polysketch_attention(x, x, y, y, y, degree=4, scale=0.125, block_size=16)
    with pytest.raises(TypeError, match="one type"):
        out.sum().backward()
    with pytest.raises(TypeError, match="one dtype"):
        ops.poly_attention(x, y, y, degree=4).sum().backward()


def test_cuda_backward_refuses_cpu_tensors():
    x = torch.zeros(2, 32, 8)
    saved = (torch.zeros(2, 2, 8, 64), torch.zeros(2, 2, 8, 8), torch.ones(2, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pc.polysketch_causal_backward_cuda(x, x, x, x, x, x, x, saved, degree=4,
                                           scale=0.125, block_size=16)
    with pytest.raises(ValueError, match="r <= 32"):
        pc.check_backward_shapes(64, 64)


@pytest.mark.parametrize("op", ["poly_attention", "lt_mult"])
def test_kernels_without_backward_raise_on_grad(monkeypatch, op):
    """With the device pick forced to the kernels: a CUDA input that
    requires grad makes B3's wrapper raise before any launch (B3 has no
    backward); B2's goes through its autograd Function, one forward and,
    from the output's gradient, one backward (the kernels stood in for by
    counted plain versions)."""
    monkeypatch.setattr(ops, "_pick", lambda impl, x, cuda_fn, torch_fn: cuda_fn)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 32, 8))
                         .astype(np.float32)).requires_grad_(True)
    if op == "poly_attention":
        calls = []

        def counted(name, fn):
            def run(*a, **k):
                calls.append(name)
                return fn(*a, **k)
            return run
        monkeypatch.setattr(ops, "poly_flash_cuda", counted("fwd", pf.poly_flash_torch))
        monkeypatch.setattr(ops, "poly_flash_backward_cuda",
                            counted("bwd", pf.poly_flash_backward_torch))
        y = ops.poly_attention(x, x, x, degree=4)
        assert calls == ["fwd"] and y.requires_grad
        y.sum().backward()
        assert calls == ["fwd", "bwd"]
        assert x.grad is not None and x.grad.abs().max() > 0
        return
    before = (pf.poly_flash_cuda.launches, lt.lt_mult_cuda.launches)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.lt_mult(x, x, x, block_size=16)
    assert (pf.poly_flash_cuda.launches, lt.lt_mult_cuda.launches) == before


# ---------------------------------------------------------------------------
# the model: gradients and training steps against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [40, 64])
def test_smoke_loss_gradients_match_jax(jax_pair, seq):
    jm, params = jax_pair
    cfg = get_config(ARCH, smoke=True)
    toks = _markov(4, seq, 0)
    (want_loss, _), want = jax.value_and_grad(
        jax_make_loss_fn(jm, jax_get_config(ARCH, smoke=True)), has_aux=True)(
            params, {"tokens": jnp.asarray(toks)})
    model = _port_model(params, cfg)
    loss, _ = make_loss_fn(cfg)(model.lm, {"tokens": torch.from_numpy(toks.astype(np.int64))})
    loss.backward()
    got = named_to_jax({n: p.grad for n, p in model.lm.named_parameters()}, cfg)
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    _leaf_close(got, _flat(want), 1e-4)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_twelve_steps_match_jax(jax_pair, microbatches):
    """12 AdamW steps at lr 3e-3 from bridged params: the loss within 1e-4
    at every step, the params within 1e-4 of each leaf's max."""
    jm, params = jax_pair
    kw = dict(seq_len=40, global_batch=4, steps=12, peak_lr=3e-3,
              microbatches=microbatches)
    jcfg, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jstep = jax.jit(jax_make_train_step(jm, jcfg, JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(params)
    state = init_train_state(_port_model(params, cfg).lm)
    step = make_train_step(cfg, TrainConfig(**kw))
    for i in range(12):
        toks = _markov(4, 40, i)
        jstate, jm_ = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks.astype(np.int64))})
        assert abs(float(m["loss"]) - float(jm_["loss"])) <= 1e-4, i
        # jit may turn the schedule's division into a product: an ulp apart
        assert float(m["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-6), i
    assert state.step == int(jstate.step) == 12
    _leaf_close(params_to_jax(state.lm), _flat(jstate.params), 1e-4)


@pytest.mark.parametrize("learned", [True, False])
def test_decay_mask_is_the_reference_mask(learned):
    jcfg = jax_get_config(ARCH, smoke=True, learned_sketch=learned)
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    want = dict(zip(tree_paths(params), jax.tree_util.tree_leaves(_wd_mask(params))))
    cfg = get_config(ARCH, smoke=True, learned_sketch=learned)
    lm = build_model(cfg, device="cpu", trainable=True).lm
    got = optim.decay_mask(dict(lm.named_parameters()), cfg)
    assert {jax_path(n, cfg) for n in got} == set(want)
    for name, m in got.items():
        assert m == want[jax_path(name, cfg)], name
    assert got["final_norm.scale"] == 0.0 and got["layers.0.norm1.bias"] == 1.0


def test_trainable_model_freezes_only_the_random_sketch():
    cfg = get_config(ARCH, smoke=True, learned_sketch=False)
    lm = build_model(cfg, device="cpu", trainable=True).lm
    frozen = sorted(n for n, p in lm.named_parameters() if not p.requires_grad)
    assert frozen and all(n.endswith(".g") for n in frozen)
    assert lm.training
    served = build_model(cfg, device="cpu").lm
    assert not served.training
    assert not any(p.requires_grad for p in served.parameters())
    full = build_model(get_config(ARCH, smoke=True, remat="full"),
                       device="cpu", trainable=True)
    assert full.lm.training and full.cfg.remat == "full"
    with pytest.raises(ValueError, match="remat"):
        build_model(get_config(ARCH, smoke=True, remat="some"), device="cpu",
                    trainable=True)


# ---------------------------------------------------------------------------
# optimizer, schedules, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linear_warmup_linear_decay", "cosine_decay"])
def test_schedules_match_jax(name):
    want = getattr(jax_optim, name)(7e-4, 100, 0.1)
    got = getattr(optim, name)(7e-4, 100, 0.1)
    assert float(got(0)) == 0.0
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 120):
        np.testing.assert_allclose(float(got(s)), float(want(s)), rtol=1e-6, atol=0)


def _tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(0)
    p, g = _tree(rng), _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jst = jax_optim.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tst = optim.adamw_init(tp)
    for _ in range(3):
        jp, jst = jax_optim.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                         jst, jp, lr=1e-2)
        tst = optim.adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                 tst, tp, lr=1e-2, cfg=get_config(ARCH, smoke=True))
    assert int(tst.count) == int(jst.count) == 3
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.m[k].numpy(), np.asarray(jst.m[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.v[k].numpy(), np.asarray(jst.v[k]), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(1))
    jg, jn = jax_optim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                           max_norm)
    tg, tn = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                       max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(optim.global_norm(tg)),
                               min(max_norm, float(jn)), rtol=1e-5)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("task", ["markov", "selective_copying", "induction_heads"])
def test_synthetic_tokens_equal_jax(task):
    for step in (0, 3):
        if task == "markov":
            got = synthetic.make_markov_lm(32000, seed=1)(2, 64, step)
            want = jax_synthetic.make_markov_lm(32000, seed=1)(2, 64, step)
            np.testing.assert_array_equal(got, want)
        else:
            got = getattr(synthetic, task)(3, 48, step, seed=2)
            want = getattr(jax_synthetic, task)(3, 48, step, seed=2)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_data_iterator_tensors_and_restore():
    it = DataIterator(synthetic.selective_copying, 2, 32, seed=0)
    first = next(it)
    assert first["tokens"].dtype == torch.int64 and first["tokens"].shape == (2, 33)
    assert first["loss_mask"].dtype == torch.float32
    second = next(it)
    other = DataIterator(synthetic.selective_copying, 2, 32, seed=0)
    other.restore({"seed": 0, "step": 1})
    assert torch.equal(next(other)["tokens"], second["tokens"])
    with pytest.raises(ValueError, match="seed"):
        other.restore({"seed": 5, "step": 0})


def test_fault_utilities():
    det = StragglerDetector(window=50, z=3.0, min_steps=10)
    assert not any(det.observe(1.0 + 0.01 * (i % 3)) for i in range(20))
    assert det.observe(5.0) and det.flagged[-1][1] == 5.0
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

def _run_port(state, tcfg, steps, start=0):
    step = make_train_step(get_config(ARCH, smoke=True), tcfg)
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, {"tokens": torch.from_numpy(_markov(2, 24, i).astype(np.int64))})
        losses.append(float(m["loss"]))
    return state, losses


TCFG = dict(seq_len=24, global_batch=2, steps=6, peak_lr=3e-3)


def test_jax_checkpoint_restores_into_port_and_continues(jax_pair, tmp_path):
    jm, params = jax_pair
    jstep = jax.jit(jax_make_train_step(jm, jax_get_config(ARCH, smoke=True),
                                        JaxTrainConfig(**TCFG)))
    jstate = jax_init_train_state(params)
    for i in range(3):
        jstate, _ = jstep(jstate, {"tokens": jnp.asarray(_markov(2, 24, i))})
    JaxCheckpointManager(str(tmp_path), async_write=False).save(3, jstate)
    jlosses = []
    for i in range(3, 6):
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(_markov(2, 24, i))})
        jlosses.append(float(m["loss"]))

    lm = build_model(get_config(ARCH, smoke=True), device="cpu", seed=9,
                     trainable=True).lm
    step0, state, _ = CheckpointManager(str(tmp_path)).restore_latest(init_train_state(lm))
    assert step0 == 3 and state.step == 3 and int(state.opt.count) == 3
    state, losses = _run_port(state, TrainConfig(**TCFG), 3, start=3)
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    _leaf_close(params_to_jax(state.lm), _flat(jstate.params), 1e-4)


def test_port_checkpoint_restores_in_jax(jax_pair, tmp_path):
    jm, params = jax_pair
    state = init_train_state(_port_model(params).lm)
    state, _ = _run_port(state, TrainConfig(**TCFG), 2)
    writer = CheckpointManager(str(tmp_path))
    writer.save(2, state, extras={"k": 1})
    writer.wait()
    mgr = JaxCheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 2
    restored, extras = mgr.restore(2, jax_init_train_state(params))
    assert extras == {"k": 1}
    got = jax_flatten(restored)
    want = train_state_to_jax(state)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def test_resume_on_cpu_is_bit_identical(tmp_path):
    cfg = get_config(ARCH, smoke=True)
    tcfg = TrainConfig(**TCFG)
    straight, _ = _run_port(init_train_state(
        build_model(cfg, device="cpu", seed=2, trainable=True).lm), tcfg, 4)
    half, _ = _run_port(init_train_state(
        build_model(cfg, device="cpu", seed=2, trainable=True).lm), tcfg, 2)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(2, half)
    mgr.wait()
    fresh = init_train_state(build_model(cfg, device="cpu", seed=5, trainable=True).lm)
    _, resumed, _ = mgr.restore_latest(fresh)
    resumed, _ = _run_port(resumed, tcfg, 2, start=2)
    a, b = train_state_to_jax(straight), train_state_to_jax(resumed)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_cli_trains_on_cpu_and_resumes(tmp_path):
    args = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    state = train_cli.main(args)
    assert state.step == 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    again = train_cli.main(args[:4] + ["5"] + args[5:])   # resumes at 3
    assert again.step == 5


def test_cli_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--steps", "1"])
