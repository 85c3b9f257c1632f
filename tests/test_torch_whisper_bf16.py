"""Whisper served in bf16 on the CPU, beside the JAX package serving it:
SMOKE whisper-large-v3 at compute_dtype="bfloat16" on the same bridged
weights, frames and tokens, through each package's batch-dict
make_serve_fns (a prefill, then decode steps past the decoder's first
fold). Each package's served log-probabilities are held against its own
train-mode forward, and the port's distance must stay within twice the
reference's (plus a bf16 step of the log-probabilities' scale): the CPU
side of chip_smoke.py phase 12's Whisper gate."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import make_serve_fns as jax_make_serve_fns  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.engine import make_serve_fns  # noqa: E402

ARCH = "whisper-large-v3"
PROMPT, TOTAL = 10, 30       # decode steps at 10..29 cross the first fold at 16


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


def _logprobs(logits, nxt):
    """log_softmax(logits) (f32) of (B, L, V) at the tokens nxt (B, L)."""
    lp = jax.nn.log_softmax(jnp.asarray(logits, jnp.float32), -1)
    return np.asarray(jnp.take_along_axis(lp, jnp.asarray(nxt[..., None]), -1)[..., 0])


@pytest.fixture(scope="module")
def distances():
    cfg_kw = dict(smoke=True, compute_dtype="bfloat16")
    jm = jax_build_model(jax_get_config(ARCH, **cfg_kw))
    params, _ = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 128, size=(2, TOTAL)).astype(np.int32)
    frames = (rng.standard_normal((2, jm.cfg.encoder_len, jm.cfg.d_model)) * 0.5
              ).astype(np.float32)
    out = {}
    # the reference
    jpre, jdec = (jax.jit(f) for f in jax_make_serve_fns(jm, jm.cfg))
    last, cache = jpre(params, {"tokens": jnp.asarray(toks[:, :PROMPT]),
                                "frames": jnp.asarray(frames)})
    served = [last]
    for i in range(PROMPT, TOTAL - 1):
        last, cache = jdec(params, jnp.asarray(toks[:, i:i + 1]), cache, jnp.asarray([i]))
        served.append(last)
    train, _, _ = jax.jit(lambda p, b: jm.apply(p, b, mode="train"))(
        params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    want = _logprobs(train[:, PROMPT - 1:-1], toks[:, PROMPT:])
    got = _logprobs(jnp.stack(served, 1), toks[:, PROMPT:])
    out["jax"] = (float(np.abs(got - want).max()), float(np.abs(np.asarray(train)).max()))
    # the port, on the same bridged weights
    cfg = get_config(ARCH, **cfg_kw)
    model = build_model(cfg, device="cpu", params=params_from_jax(_flat(params), cfg))
    prefill, decode = make_serve_fns(model)
    last, cache = prefill({"tokens": toks[:, :PROMPT].astype(np.int64), "frames": frames})
    served = [last]
    for i in range(PROMPT, TOTAL - 1):
        last, cache = decode(torch.from_numpy(toks[:, i:i + 1].astype(np.int64)), cache, i)
        served.append(last)
    with torch.no_grad():
        train, _ = model.lm(torch.from_numpy(toks.astype(np.int64)),
                            frames=torch.from_numpy(frames), mode="train")
    want = _logprobs(train.float().numpy()[:, PROMPT - 1:-1], toks[:, PROMPT:])
    got = _logprobs(torch.stack(served, 1).float().numpy(), toks[:, PROMPT:])
    out["port"] = (float(np.abs(got - want).max()), float(train.float().abs().max()))
    return out


def test_served_bf16_logprobs_lie_from_train_mode_as_the_reference_does(distances):
    port, top = distances["port"]
    ref, _ = distances["jax"]
    print(f"served vs train-mode, bf16 (nats): port {port:.3e}, reference {ref:.3e}")
    step = 2.0 ** (np.floor(np.log2(top)) - 7)     # a bf16 step at max|logit|
    assert np.isfinite(port) and np.isfinite(ref)
    assert port <= 2 * ref + step, (port, ref, step)
