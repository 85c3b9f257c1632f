"""Rematerialisation in the port (cfg.remat "dots" and "full") held to
"none" and to the JAX package on the CPU: one step's gradients bit for
bit against "none" and within 1e-4 of jax.grad of the JAX model with the
same policy, for the three mechanisms; 12 AdamW steps with "full" and
two microbatches against the JAX loss; what a forward keeps for the
backward under each policy; the kernels' launches when the forward runs
again in the backward; remat only in train mode with grad on; the CLI."""
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import named_to_jax, params_to_jax  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import poly_flash as pf  # noqa: E402
from repro_torch.kernels import polysketch_causal as pc  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

ARCH = "gpt2s-polysketch"
MECHS = ["polysketch", "polynomial", "softmax"]
POLICIES = ["dots", "full"]


def _flat(tree):
    return dict(zip(tree_paths(tree), map(np.asarray, jax.tree_util.tree_leaves(tree))))


@pytest.fixture(scope="module")
def pairs():
    """{mechanism: (JAX params, the port's state dict)}: the port's seeded
    SMOKE weights, and the same values as the JAX package's tree (remat
    does not change the parameters)."""
    out = {}
    for m in MECHS:
        cfg = get_config(ARCH, smoke=True, attention=m)
        lm = build_model(cfg, device="cpu").lm
        flat = params_to_jax(lm)
        jm = jax_build_model(jax_get_config(ARCH, smoke=True, attention=m))
        shapes = jax.eval_shape(lambda key: jm.init(key)[0], jax.random.PRNGKey(0))
        leaves = [jnp.asarray(flat[p]) for p in tree_paths(shapes)]
        out[m] = (jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), leaves),
                  {n: t.detach().clone() for n, t in lm.state_dict().items()})
    return out


def _model(state, mech, remat):
    cfg = get_config(ARCH, smoke=True, attention=mech, remat=remat)
    return build_model(cfg, device="cpu", trainable=True, params=state)


def _markov(batch, seq, step):
    return jax_synthetic.make_markov_lm(128, seed=1)(batch, seq, step)


def _grads(state, mech, remat, toks):
    model = _model(state, mech, remat)
    loss, _ = make_loss_fn(model.cfg)(model.lm, {"tokens": torch.from_numpy(toks)})
    loss.backward()
    return loss, {n: p.grad for n, p in model.lm.named_parameters()}


@pytest.fixture(scope="module")
def none_grads(pairs):
    toks = _markov(2, 40, 0).astype(np.int64)
    return toks, {m: _grads(pairs[m][1], m, "none", toks) for m in MECHS}


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("mech", MECHS)
def test_gradients_equal_none_and_follow_jax(pairs, none_grads, mech, remat):
    toks, base = none_grads
    params, state = pairs[mech]
    loss, got = _grads(state, mech, remat, toks)
    want_loss, want_grads = base[mech]
    assert torch.equal(loss, want_loss)
    assert sorted(got) == sorted(want_grads)
    for name, g in got.items():
        assert torch.equal(g, want_grads[name]), name
    jcfg = jax_get_config(ARCH, smoke=True, attention=mech, remat=remat)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jax_build_model(jcfg), jcfg), has_aux=True))(
            params, {"tokens": jnp.asarray(toks)})
    assert abs(loss.item() - float(jloss)) <= 1e-5
    jgrads = _flat(jgrads)
    got = named_to_jax(got, get_config(ARCH, smoke=True, attention=mech, remat=remat))
    assert sorted(got) == sorted(jgrads)
    for path, w in jgrads.items():
        w = np.asarray(w, np.float64)
        e = np.abs(np.asarray(got[path], np.float64) - w).max()
        assert e <= 1e-4 * max(np.abs(w).max(), 1e-30), (path, e)


def test_twelve_steps_full_remat_microbatches_match_jax(pairs):
    """12 AdamW steps with remat "full" and two microbatches: the loss
    within 1e-4 of the JAX package's (same remat) at every step."""
    kw = dict(seq_len=40, global_batch=4, steps=12, peak_lr=3e-3, microbatches=2)
    jcfg = jax_get_config(ARCH, smoke=True, remat="full")
    jm = jax_build_model(jcfg)
    jstep = jax.jit(jax_make_train_step(jm, jcfg, JaxTrainConfig(**kw)))
    jstate = jax_init_train_state(pairs["polysketch"][0])
    model = _model(pairs["polysketch"][1], "polysketch", "full")
    state = init_train_state(model.lm)
    step = make_train_step(model.cfg, TrainConfig(**kw))
    for i in range(12):
        toks = _markov(4, 40, i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, met = step(state, {"tokens": torch.from_numpy(toks.astype(np.int64))})
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-4, i


# ---------------------------------------------------------------------------
# what a forward keeps for the backward
# ---------------------------------------------------------------------------

class _Origins(TorchDispatchMode):
    """Every tensor an op returns: its storage (weakly), the op, and the
    block running then (None outside the blocks)."""

    def __init__(self):
        super().__init__()
        self.block = None
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.untyped_storage().nbytes():
                self.seen.append((weakref.ref(t.untyped_storage()), func, self.block))
        return out


def _kept(state, mech, remat, toks):
    """What a forward leaves alive for its backward: {address: (bytes, op,
    block)} of the storages ops made that outlive the forward (the
    creating op of each), the addresses of the blocks' outputs, and the
    block indices during which autograd's saved_tensors_hooks packed a
    tensor (outside a checkpoint's own hooks)."""
    model = _model(state, mech, remat)
    rec = _Origins()
    outs, packed = set(), set()

    def pre(i):
        def hook(mod, args):
            rec.block = i
        return hook

    def post(mod, args, out):
        outs.add(out[0].untyped_storage().data_ptr())
        rec.block = None

    hooks = [b.register_forward_pre_hook(pre(i)) for i, b in enumerate(model.lm.layers)]
    hooks += [b.register_forward_hook(post) for b in model.lm.layers]

    def pack(t):
        if rec.block is not None:
            packed.add(rec.block)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), rec:
        loss, _ = make_loss_fn(model.cfg)(model.lm, {"tokens": torch.from_numpy(toks)})
    for h in hooks:
        h.remove()
    gc.collect()
    skip = {p.untyped_storage().data_ptr() for p in model.lm.parameters()}
    skip.add(loss.untyped_storage().data_ptr())
    kept = {}
    for ref, op, block in rec.seen:
        s = ref()
        if s is not None and s.data_ptr() not in skip and s.data_ptr() not in kept:
            kept[s.data_ptr()] = (s.nbytes(), op, block)
    del loss
    return kept, outs, packed


@pytest.mark.parametrize("mech", MECHS)
def test_saved_bytes_order_and_dots_keeps_only_products(pairs, mech):
    """Bytes kept after the forward: none > dots > full. Under both
    policies autograd packs nothing while a block runs (the checkpoint
    keeps the block's input itself); what outlives the forward from inside
    a block is, under "full", only the blocks' outputs (the next block's
    input), and under "dots" those and the outputs of product ops."""
    toks = _markov(2, 48, 0).astype(np.int64)
    runs = {r: _kept(pairs[mech][1], mech, r, toks) for r in ("none", "dots", "full")}
    size = {r: sum(b for b, _, _ in kept.values()) for r, (kept, _, _) in runs.items()}
    assert size["none"] > size["dots"] > size["full"], size
    assert runs["none"][2] == {0, 1}
    for remat in POLICIES:
        kept, outs, packed = runs[remat]
        assert packed == set(), remat
        inside = [(op, sid) for sid, (_, op, block) in kept.items() if block is not None]
        assert inside
        for op, sid in inside:
            if remat == "full" or op not in transformer.PRODUCT_OPS:
                assert sid in outs, (remat, op)
    dots_products = [op for sid, (_, op, b) in runs["dots"][0].items()
                     if b is not None and sid not in runs["dots"][1]]
    assert dots_products and set(dots_products) <= transformer.PRODUCT_OPS


@pytest.mark.parametrize("mech", MECHS)
def test_product_ops_cover_what_a_forward_dispatches(pairs, mech):
    """Every matrix product a train-mode forward dispatches on the CPU is
    one that remat "dots" keeps."""
    rec = _Origins()
    model = _model(pairs[mech][1], mech, "none")
    with rec:
        model.lm(torch.from_numpy(_markov(2, 40, 0).astype(np.int64)), mode="train")
    products = {op for _, op, _ in rec.seen
                if any(k in str(op) for k in ("mm", "dot", "matmul", "linear", "einsum"))}
    assert products and products <= transformer.PRODUCT_OPS, products


# ---------------------------------------------------------------------------
# the kernels when the forward runs again; where remat applies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none"] + POLICIES)
@pytest.mark.parametrize("mech", ["polysketch", "polynomial"])
def test_kernel_launches_count_the_recompute(pairs, monkeypatch, mech, remat):
    """With the device pick forced to the kernels (stood in for by counted
    plain versions): one step launches the forward once a layer, and again
    in the backward under remat, and the backward once a layer; the
    gradients are those of "none" bit for bit."""
    calls = []

    def counted(name, fn):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run
    monkeypatch.setattr(ops, "_pick", lambda impl, x, cuda_fn, torch_fn: cuda_fn)
    for name, plain in (("polysketch_causal_cuda", pc.polysketch_causal_torch),
                        ("polysketch_causal_backward_cuda",
                         pc.polysketch_causal_backward_torch),
                        ("poly_flash_cuda", pf.poly_flash_torch),
                        ("poly_flash_backward_cuda", pf.poly_flash_backward_torch)):
        monkeypatch.setattr(ops, name, counted(name.endswith("backward_cuda"), plain))
    toks = _markov(2, 40, 0).astype(np.int64)
    _, got = _grads(pairs[mech][1], mech, remat, toks)
    layers = get_config(ARCH, smoke=True).n_layers
    fwd = layers * (1 if remat == "none" else 2)
    assert calls.count(False) == fwd and calls.count(True) == layers
    monkeypatch.undo()
    _, want = _grads(pairs[mech][1], mech, "none", toks)
    for name, g in got.items():
        assert torch.equal(g, want[name]), name


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_only_in_train_mode_with_grad(pairs, monkeypatch, remat):
    """Prefill, decode and a train-mode forward without grad run the blocks
    directly, and give the same logits as "none"."""
    seen = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    state = pairs["polysketch"][1]
    model, base = _model(state, "polysketch", remat), _model(state, "polysketch", "none")
    toks = torch.from_numpy(_markov(2, 20, 0).astype(np.int64))
    with torch.no_grad():
        got, _ = model.lm(toks, mode="train")
        want, _ = base.lm(toks, mode="train")
    assert torch.equal(got, want)
    got, cache = model.state.prefill(toks)
    want, wcache = base.state.prefill(toks)
    assert torch.equal(got, want)
    got, _ = model.state.decode_step(toks[:, :1], 20, cache)
    want, _ = base.state.decode_step(toks[:, :1], 20, wcache)
    assert torch.equal(got, want) and seen == []
    model.lm(toks, mode="train")
    assert len(seen) == model.cfg.n_layers


@pytest.mark.parametrize("remat", ["none"] + POLICIES + ["some"])
def test_build_accepts_the_reference_policies(remat):
    cfg = get_config(ARCH, smoke=True, remat=remat)
    if remat == "some":
        with pytest.raises(ValueError, match="remat"):
            build_model(cfg, device="meta")
        return
    assert build_model(cfg, device="meta", trainable=True).cfg.remat == remat


@pytest.mark.parametrize("remat", POLICIES)
def test_cli_trains_with_remat(remat, caplog):
    caplog.set_level("INFO", logger="repro_torch.train")
    state = train_cli.main(["--smoke", "--device", "cpu", "--set", f"remat={remat}",
                            "--steps", "2", "--batch", "2", "--seq", "32"])
    assert state.step == 2 and state.lm.cfg.remat == remat
    assert "peak device memory" in caplog.text
