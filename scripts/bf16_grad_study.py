"""Tolerance study for bf16 training: how far bf16 gradients lie from the
float64 gradient, for the port's plain path and for jax.grad of the
reference, on SMOKE configs (CPU).

    PYTHONPATH=src python scripts/bf16_grad_study.py

For each arch (gpt2s-polysketch, qwen3-14b and the exact polynomial
mechanism, gpt2s-poly4 at head width 16 and 128, by default) and each of
a few token batches: the float64 gradient of the reference's loss (jax with
x64, every parameter and the compute type float64), the reference's
gradient at compute_dtype="bfloat16", and the port's (plain ops, the same
bridged parameters, bfloat16). Each gradient leaf's max|err| is taken as a
share of that leaf's max|.| in float64; the script prints the worst and
the median leaf of each, and their distance from each other, which is
what a test of port against reference can hold. The gates in
tests/test_torch_bf16.py and tests/test_torch_b2_bf16.py (and
chip_smoke.py's BF16_GRAD_TOL) are set from the worst of these. A
numerics study on the CPU: it times nothing.
"""
from __future__ import annotations

import argparse

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import named_to_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402


# names of the study for configs the registry reaches through overrides:
# the exact polynomial baseline (gpt2s-poly4's mechanism) on the SMOKE
# model, at its head width and at the dense models' 128
VARIANTS = {
    "gpt2s-poly4": ("gpt2s-polysketch", dict(attention="polynomial")),
    "gpt2s-poly4-h128": ("gpt2s-polysketch", dict(attention="polynomial", head_dim=128)),
}


def resolve(arch):
    """(registry name, overrides) of a study name."""
    return VARIANTS.get(arch, (arch, {}))


def flat(tree):
    return {p: np.asarray(x, np.float64) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


def jax_grads(arch, params, toks, dtype):
    name, over = resolve(arch)
    cfg = jax_get_config(name, smoke=True, compute_dtype=dtype, **over)
    jm = jax_build_model(cfg)
    if dtype == "float64":
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), params)
    grad = jax.grad(lambda p: jax_make_loss_fn(jm, cfg)(p, {"tokens": jnp.asarray(toks)})[0])
    return flat(grad(params))


def port_grads(arch, params, toks):
    name, over = resolve(arch)
    cfg = get_config(name, smoke=True, compute_dtype="bfloat16", **over)
    f32 = {k: np.asarray(v, np.float32) for k, v in flat(params).items()}
    model = build_model(cfg, device="cpu", trainable=True, params=params_from_jax(f32, cfg))
    loss, _ = make_loss_fn(cfg)(model.lm, {"tokens": torch.from_numpy(toks.astype(np.int64))})
    loss.backward()
    return {k: np.asarray(v, np.float64) for k, v in
            named_to_jax({n: p.grad for n, p in model.lm.named_parameters()}, cfg).items()}


def rel_errors(got, want):
    return {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
            for k in want}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=["gpt2s-polysketch", "qwen3-14b",
                                                   *VARIANTS])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seq", type=int, default=40)
    args = ap.parse_args(argv)
    for arch in args.archs:
        name, over = resolve(arch)
        jm = jax_build_model(jax_get_config(name, smoke=True, **over))
        params, _ = jm.init(jax.random.PRNGKey(0))
        data = synthetic.make_markov_lm(128, seed=1)
        worst = {"port": 0.0, "jax": 0.0, "port-jax": 0.0}
        for i in range(args.batches):
            toks = data(4, args.seq, i)
            g64 = jax_grads(arch, params, toks, "float64")
            gj = jax_grads(arch, params, toks, "bfloat16")
            gp = port_grads(arch, params, toks)
            for name, e in (("port", rel_errors(gp, g64)), ("jax", rel_errors(gj, g64)),
                            ("port-jax", rel_errors(gp, gj))):
                vals = np.array(list(e.values()))
                leaf = max(e, key=e.get)
                worst[name] = max(worst[name], vals.max())
                print(f"{arch} batch {i} {name:8s}: worst leaf {vals.max():.3e} ({leaf}), "
                      f"median {np.median(vals):.3e}, {len(vals)} leaves", flush=True)
        print(f"{arch} worst over batches: " +
              ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)


if __name__ == "__main__":
    main()
