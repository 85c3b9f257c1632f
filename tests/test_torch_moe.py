"""The port's mixture-of-experts FFN (``models/moe.py``) held to the JAX
package's ``models/moe.py`` on the SMOKE configs of dbrx-132b (4 experts,
top-2) and llama4-maverick-400b-a17b (8 experts, top-1), parameters drawn
by the reference's ``moe_init`` and bridged, inputs from a numpy seed:
the sort-based dispatch at capacity factors 8.0 (nothing drops), 1.25 and
0.25 (drops), with the same assignments kept and dropped as the
reference's rule, in 1, 2 and 4 dispatch groups (8.0 in 2 and 4 groups
on the card, tests/test_torch_gpu.py); ties in the router; the
dense oracle; both aux losses; gradients against jax.grad; f32 at 1e-5
(gradients 1e-4 of each leaf's max|.|, and 1e-5 absolute: a top-1
router's gate is p / p, whose gradient is rounding noise), bf16 at
5e-2."""
import math

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = 1e-5
ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
NAMES = ("router", "wi", "wg", "wo")
# the reference under jit (the config static): eager JAX dispatches each op
j_apply = jax.jit(jmoe.moe_apply, static_argnums=1)
j_oracle = jax.jit(jmoe.moe_apply_dense_oracle, static_argnums=1)


def _init(arch, seed=0, **over):
    """(jax cfg, jax params, the port's cfg, an MoE holding the same
    parameters)."""
    jcfg = jax_get_config(arch, smoke=True, **over)
    cfg = get_config(arch, smoke=True, **over)
    params, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    m = moe.MoE(cfg)
    with torch.no_grad():
        for n in NAMES:
            getattr(m, n).copy_(torch.from_numpy(np.array(params[n])))
    return jcfg, params, cfg, m


def _x(cfg, seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _reference_keep(jcfg, ids):
    """The reference's kept assignments in its sorted order (its lines of
    `moe_apply`), as (G, tg * k) bool."""
    e, k = jcfg.n_experts, jcfg.moe_top_k
    g = max(1, jcfg.moe_dispatch_groups)
    tg = ids.shape[0] // g
    mult = 256 if tg * k // e >= 256 else 8
    cap = int(math.ceil(tg * k / e * jcfg.capacity_factor / mult)) * mult
    flat_ids = ids.reshape(g, tg * k)
    order = jnp.argsort(flat_ids, axis=-1, stable=True)
    sorted_ids = jnp.take_along_axis(flat_ids, order, axis=-1)
    counts = jnp.zeros((g, e), jnp.int32).at[jnp.arange(g)[:, None], flat_ids].add(1)
    seg_start = jnp.cumsum(counts, axis=-1) - counts
    pos = jnp.arange(tg * k)[None] - jnp.take_along_axis(seg_start, sorted_ids, axis=-1)
    return np.asarray(pos < cap), cap


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,groups", [(8.0, 1), (1.25, 1), (0.25, 1), (0.25, 2),
                                       (1.25, 4), (0.25, 4)])
def test_dispatch_matches_the_reference(arch, cf, groups):
    """y and both aux losses within 1e-5 of the reference's moe_apply, over
    the capacity factors in one group and the dispatch groups with drops;
    the plan keeps exactly the reference's assignments (capacity, sorted
    order and drops), and at 0.25 some are dropped."""
    jcfg, params, cfg, m = _init(arch, capacity_factor=cf, moe_dispatch_groups=groups)
    x = _x(cfg, 1, (4, 64))
    want, jaux = j_apply(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe.moe_apply(m, cfg, torch.from_numpy(x))
        _, _, _, ids = moe.route(m, cfg, torch.from_numpy(x).reshape(-1, cfg.d_model))
        plan = moe.dispatch_plan(cfg, ids)
    _close(got, want)
    for k in ("load_balance", "router_z"):
        _close(aux[k], jaux[k])
    logits = jnp.asarray(x).reshape(-1, jcfg.d_model) @ params["router"]
    _, jids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe_top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    keep, cap = _reference_keep(jcfg, jids)
    assert plan.cap == cap
    np.testing.assert_array_equal(plan.keep.numpy(), keep)
    if cf == 0.25:
        assert not keep.all()
    if cf == 8.0:
        assert keep.all()


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_go_to_the_lower_expert_as_in_jax(arch):
    """Integer router weights and inputs make the logits exact integers,
    so many tokens tie between experts: the port picks the reference's
    experts (jax.lax.top_k, the lower index first) and its outputs."""
    jcfg, params, cfg, m = _init(arch, capacity_factor=1.25)
    rng = np.random.default_rng(9)
    router = rng.integers(-1, 2, size=(cfg.d_model, cfg.n_experts)).astype(np.float32)
    router[:, 1] = router[:, 0]                  # experts 0 and 1 always tie
    params = dict(params, router=jnp.asarray(router))
    with torch.no_grad():
        m.router.copy_(torch.from_numpy(router))
    x = rng.integers(-2, 3, size=(2, 24, cfg.d_model)).astype(np.float32)
    want, _ = j_apply(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, _ = moe.moe_apply(m, cfg, torch.from_numpy(x))
        _, _, _, ids = moe.route(m, cfg, torch.from_numpy(x).reshape(-1, cfg.d_model))
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model) @ params["router"], -1)
    _, jids = jax.lax.top_k(probs, jcfg.moe_top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (np.asarray(jids)[:, 0] == 0).any()   # the tie was the top, and went to 0
    _close(got, want)


def test_top_k_is_stable_among_equal_values():
    x = torch.tensor([[0.5, 0.5, 0.1, 0.5], [0.2, 0.3, 0.3, 0.3]])
    vals, idx = moe.top_k(x, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_oracle_matches_the_reference_and_the_dispatch(arch):
    jcfg, params, cfg, m = _init(arch, capacity_factor=8.0)
    x = _x(cfg, 2, (2, 16))
    want = j_oracle(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = moe.moe_apply_dense_oracle(m, cfg, torch.from_numpy(x))
        y, _ = moe.moe_apply(m, cfg, torch.from_numpy(x))
    _close(got, want)
    _close(y, got.numpy(), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_losses_match_the_reference(arch):
    """load_balance uses the density of each token's first choice only;
    router_z is the mean of logsumexp^2 (a wider input, 200 tokens)."""
    jcfg, params, cfg, m = _init(arch)
    x = _x(cfg, 3, (4, 50)) * 3.0
    _, jaux = j_apply(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        _, aux = moe.moe_apply(m, cfg, torch.from_numpy(x))
        none = moe.moe_apply(m, cfg, torch.from_numpy(x), with_aux=False)[1]
    assert sorted(aux) == sorted(jaux) and none == {}
    for k in aux:
        _close(aux[k], jaux[k])
    assert float(aux["load_balance"]) > 0 and float(aux["router_z"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_gradients_match_jax_grad(arch, cf):
    """d/d(x, router, wi, wg, wo) of sum(y * r) + 0.1 load_balance + 0.01
    router_z, against jax.grad at 1e-4 of each leaf's max|.|, with and
    without drops."""
    jcfg, params, cfg, m = _init(arch, capacity_factor=cf)
    x = _x(cfg, 4, (2, 32))
    r = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, jcfg, xx)
        return jnp.sum(y * r) + 0.1 * aux["load_balance"] + 0.01 * aux["router_z"]

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(m, cfg, xt)
    loss = (y * torch.from_numpy(r)).sum() + 0.1 * aux["load_balance"] \
        + 0.01 * aux["router_z"]
    loss.backward()
    pairs = [(xt.grad, want_x)] + [(getattr(m, n).grad, want_p[n]) for n in NAMES]
    for got, want in pairs:
        want = np.asarray(want)   # atol: top-1's router gradient is rounding noise
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max() + 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_the_reference(arch):
    """compute dtype bf16 (f32 weights cast on use, the router's softmax in
    f32): y within 5e-2 of the reference's bf16 moe_apply."""
    jcfg, params, cfg, m = _init(arch, capacity_factor=8.0)
    x = _x(cfg, 6, (2, 16))
    want, _ = j_apply(params, jcfg, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got, _ = moe.moe_apply(m, cfg, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 5e-2)


def test_expert_weights_are_cast_a_group_at_a_time(monkeypatch):
    """With CAST_BYTES below one expert weight's cast, the experts run in
    groups (of even size); the outputs equal the whole cast's bit for
    bit on the CPU."""
    jcfg, params, cfg, m = _init("llama4-maverick-400b-a17b", capacity_factor=8.0)
    x = torch.from_numpy(_x(cfg, 7, (2, 16))).to(torch.bfloat16)
    with torch.no_grad():
        whole, _ = moe.moe_apply(m, cfg, x)
        per = cfg.d_model * cfg.d_ff * 2
        calls = []
        bmm = torch.bmm
        monkeypatch.setattr(torch, "bmm", lambda a, b: calls.append(a.shape[0]) or bmm(a, b))
        monkeypatch.setattr(moe, "CAST_BYTES", 3 * per)
        grouped, _ = moe.moe_apply(m, cfg, x)
    assert calls == [3, 3, 3, 3, 3, 3, 2, 2, 2] and cfg.n_experts == 8
    assert torch.equal(grouped, whole)
