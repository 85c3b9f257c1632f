"""The recurrent families' building blocks in the port, held to the JAX
package on small seeded inputs (f32, 1e-4): the SSD scan in both of its
lowerings (with h0, return_state and a fixed grid) and its sequential
oracle; the chunked RG-LRU scan, its in-chunk parallel prefix and its
oracle; both causal convs with their state; the ring's decode step
wrapping the ring at per-row positions; the ring's prefill at GQA 4:1 and
2:2; ring_grid and the blocked sliding-window attention. Then the port
against itself, bit for bit: resumed SSD, RG-LRU and ring prefills equal
cold ones, and snapshots and restores of the new nodes never alias."""
import functools

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import decode as jdec  # noqa: E402
from repro.core.poly_attention import sliding_attention_blocked as jax_sliding  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import decode as dec  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402
from repro_torch.core.poly_attention import sliding_attention_blocked  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models.layers import causal_conv  # noqa: E402

TOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jit(fn, *args, **kw):
    """fn(*args, **kw) for the JAX side, compiled as one program (`kw`
    closed over): one compile costs less than eager dispatch's first use
    of every op."""
    return jax.jit(functools.partial(fn, **kw))(*args)


def _ssd_inputs(seed, bs=2, s=37, h=3, p=4, n=5):
    rng = _rng(seed)
    x = rng.standard_normal((bs, s, h, p)).astype(np.float32)
    b = rng.standard_normal((bs, s, n)).astype(np.float32)
    c = rng.standard_normal((bs, s, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    h0 = rng.standard_normal((bs, h, n, p)).astype(np.float32)
    return x, b, c, dt, a_log, h0


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(chunk=8),                                       # training lowering
    dict(chunk=64),                                      # one chunk: min(64, s)
    dict(chunk=16, return_state=True),
    dict(chunk=16, h0=True, return_state=True, fixed_grid=True),
    dict(chunk=64, fixed_grid=True),                     # s < chunk, pinned
], ids=["train8", "train64", "state", "h0-fixed", "fixed64"])
def test_ssd_chunked_matches_jax(kw):
    x, b, c, dt, a_log, h0 = _ssd_inputs(1)
    kw = dict(kw)
    use_h0 = kw.pop("h0", False)
    jout = _jit(jssm.ssd_chunked, *map(jnp.asarray, (x, b, c, dt, a_log)),
                h0=jnp.asarray(h0) if use_h0 else None, **kw)
    tout = ssm.ssd_chunked(*map(_t, (x, b, c, dt, a_log)),
                           h0=_t(h0) if use_h0 else None, **kw)
    if kw.get("return_state"):
        _close(tout[1], jout[1])
        jout, tout = jout[0], tout[0]
    _close(tout, jout)


def test_ssd_lowerings_agree_with_the_sequential_oracles():
    x, b, c, dt, a_log, _ = _ssd_inputs(2)
    want = ssm.ssd_sequential_ref(*map(_t, (x, b, c, dt, a_log)))
    _close(want, _jit(jssm.ssd_sequential_ref, *map(jnp.asarray, (x, b, c, dt, a_log))))
    for kw in (dict(chunk=8), dict(chunk=16, fixed_grid=True)):
        _close(ssm.ssd_chunked(*map(_t, (x, b, c, dt, a_log)), **kw), want.numpy())


def test_ssd_gradients_finite_through_the_mask():
    """The masked quadratic exp's its upper triangle only after masking:
    a gradient through the training lowering stays finite."""
    x, b, c, dt, a_log, _ = _ssd_inputs(3)
    ts = [_t(v).requires_grad_() for v in (x, b, c, dt)]
    ssm.ssd_chunked(*ts, _t(a_log), chunk=8).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in ts)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _ab(seed, bs=2, s=45, w=6):
    rng = _rng(seed)
    a = rng.uniform(0.5, 1.0, (bs, s, w)).astype(np.float32)
    b = rng.standard_normal((bs, s, w)).astype(np.float32)
    h0 = rng.standard_normal((bs, w)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_rglru_chunked_matches_jax_and_the_loop(chunk):
    a, b, h0 = _ab(4)
    jh, jlast = _jit(jrg._rglru_chunked, jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                     chunk=chunk)
    th, tlast = rglru.rglru_chunked(_t(a), _t(b), _t(h0), chunk)
    _close(th, jh)
    _close(tlast, jlast)
    h, loop = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    _close(th, np.stack(loop, 1))


def test_prefix_scan_matches_associative_scan():
    a, b, _ = _ab(5, s=37)
    ja, jb = _jit(lambda ab: jax.lax.associative_scan(jrg._combine, ab, axis=1),
                  (jnp.asarray(a), jnp.asarray(b)))
    ta, tb = rglru.prefix_scan(_t(a), _t(b))
    _close(ta, ja)
    _close(tb, jb)


def _rglru_pair(seed=6):
    """A JAX RG-LRU block's params at SMOKE width and the port's block
    holding them."""
    jcfg = jax_get_config("recurrentgemma-9b", smoke=True)
    params, _ = jrg.rglru_init(jax.random.PRNGKey(seed), jcfg)
    block = rglru.RGLRU(get_config("recurrentgemma-9b", smoke=True))
    block.load_state_dict({k: _t(np.array(v)) for k, v in params.items()})
    return jcfg, params, block


def test_rglru_block_oracle_matches_jax():
    jcfg, params, block = _rglru_pair()
    x = _rng(7).standard_normal((2, 29, jcfg.d_model)).astype(np.float32)
    want = _jit(lambda p, x: jrg.rglru_sequential_ref(p, jcfg, x), params, jnp.asarray(x))
    with torch.no_grad():
        got = rglru.rglru_sequential_ref(block, _t(x))
    _close(got, want)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_block_modes_match_jax(mode):
    jcfg, params, block = _rglru_pair(8)
    jcfg = jcfg.replace(lt_block_size=16)
    block.cfg = block.cfg.replace(lt_block_size=16)
    rng = _rng(9)
    s = 1 if mode == "decode" else 37
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    h = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    jcache = None if mode == "train" else jdec.RecurrentCache(jnp.asarray(h),
                                                             jnp.asarray(conv))
    tcache = None if mode == "train" else dec.RecurrentCache(_t(h), _t(conv))
    jy, jc = _jit(lambda p, x, c: jrg.rglru_apply(p, jcfg, x, mode=mode, cache=c),
                  params, jnp.asarray(x), jcache)
    with torch.no_grad():
        ty, tc = block(_t(x), mode=mode, cache=tcache)
    _close(ty, jy)
    if mode != "train":
        _close(tc.h, jc.h)
        _close(tc.conv, jc.conv)


# ---------------------------------------------------------------------------
# the convs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_convs_with_state_match_jax(with_state):
    """SSM's conv (silu after the bias, any width K) and RG-LRU's width-4
    conv, each with and without the previous call's trailing inputs."""
    rng = _rng(10)
    x = rng.standard_normal((2, 11, 7)).astype(np.float32)
    w = rng.standard_normal((4, 7)).astype(np.float32)
    cb = rng.standard_normal(7).astype(np.float32)
    st = rng.standard_normal((2, 3, 7)).astype(np.float32) if with_state else None
    jp = {"conv_w": jnp.asarray(w), "conv_b": jnp.asarray(cb)}
    jst_ = None if st is None else jnp.asarray(st)
    tst_ = None if st is None else _t(st)
    out, state = causal_conv(_t(w), _t(cb), _t(x), tst_)
    jout, jstate = jssm._conv(jp, jnp.asarray(x), jst_)
    _close(torch.nn.functional.silu(out), jout)
    _close(state, jstate)
    jout, jstate = jrg._conv4(jp, jnp.asarray(x), jst_)
    _close(out, jout)
    _close(state, jstate)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _qkv(seed, bs, hq, hkv, s, h=8):
    rng = _rng(seed)
    q = rng.standard_normal((bs, hq, s, h)).astype(np.float32)
    k = rng.standard_normal((bs, hkv, s, h)).astype(np.float32)
    v = rng.standard_normal((bs, hkv, s, h)).astype(np.float32)
    return q, k, v


def test_ring_decode_wraps_at_per_row_positions():
    """Two rows at their own depths (one before the ring fills, one well
    past a wrap), many steps: each row's outputs and ring equal the JAX
    step's at that row's scalar position."""
    w, hq, hkv, h = 8, 4, 2, 8
    rng = _rng(11)
    start = [3, 13]
    k0 = rng.standard_normal((2, hkv, w, h)).astype(np.float32)
    v0 = rng.standard_normal((2, hkv, w, h)).astype(np.float32)
    cache = dec.RingKVCache(_t(k0), _t(v0), torch.tensor(start))
    jc = [jdec.RingKVCache(jnp.asarray(k0[r:r + 1]), jnp.asarray(v0[r:r + 1]),
                           jnp.asarray(start[r], jnp.int32)) for r in range(2)]
    for step in range(11):
        q, k, v = (rng.standard_normal(sh).astype(np.float32)
                   for sh in ((2, hq, h), (2, hkv, h), (2, hkv, h)))
        out, cache = dec.kv_ring_decode_step(cache, _t(q), _t(k), _t(v),
                                             inplace=step % 2 == 1)
        for r in range(2):
            jout, jc[r] = jdec.kv_ring_decode_step(
                jc[r], jnp.asarray(q[r:r + 1]), jnp.asarray(k[r:r + 1]),
                jnp.asarray(v[r:r + 1]))
            _close(out[r:r + 1], jout)
            _close(cache.k[r:r + 1], jc[r].k)
            _close(cache.v[r:r + 1], jc[r].v)
    assert cache.pos.tolist() == [s + 11 for s in start]


def test_ring_decode_leaves_its_input_cache_unchanged():
    q, k, v = (_t(x[:, :, 0]) for x in _qkv(12, 1, 2, 1, 1))
    cache = dec.init_ring_cache(1, 1, 8, 4)
    before = cache.k.clone()
    _, new = dec.kv_ring_decode_step(cache, q, k, v)
    assert torch.equal(cache.k, before) and new.pos == 1 and cache.pos == 0


@pytest.mark.parametrize("hq,hkv", [(4, 1), (2, 2)])
@pytest.mark.parametrize("pos0,s,w,grid", [(0, 37, 16, 8), (16, 29, 16, 16),
                                           (8, 40, 12, 4)])
def test_ring_prefill_matches_jax(hq, hkv, pos0, s, w, grid):
    q, k, v = _qkv(13, 2, hq, hkv, s)
    rng = _rng(14)
    k0 = rng.standard_normal((2, hkv, w, 8)).astype(np.float32)
    v0 = rng.standard_normal((2, hkv, w, 8)).astype(np.float32)
    jout, jc = _jit(
        jdec.kv_ring_prefill,
        jdec.RingKVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(pos0, jnp.int32)),
        *map(jnp.asarray, (q, k, v)), grid=grid)
    tout, tc = dec.kv_ring_prefill(dec.RingKVCache(_t(k0), _t(v0), pos0),
                                   *map(_t, (q, k, v)), grid=grid)
    _close(tout, jout)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert tc.pos == int(jc.pos) == pos0 + s


@pytest.mark.parametrize("block,window", [(256, 2048), (16, 32), (16, 24),
                                          (256, 96), (12, 8)])
def test_ring_grid_matches_jax(block, window):
    assert dec.ring_grid(block, window) == jdec.ring_grid(block, window)


@pytest.mark.parametrize("s,window", [(64, 16), (40, 16), (12, 16), (48, 48)])
def test_sliding_attention_blocked_matches_jax(s, window):
    """The blocked band (s a multiple of the window) and the windowed full
    fallback (s <= w, or not a multiple)."""
    q, k, v = _qkv(15, 2, 3, 3, s)
    want = _jit(jax_sliding, *map(jnp.asarray, (q, k, v)), window=window)
    _close(sliding_attention_blocked(*map(_t, (q, k, v)), window=window), want)


# ---------------------------------------------------------------------------
# the port against itself: resume equals cold, snapshots never alias
# ---------------------------------------------------------------------------

def test_resumed_ssd_prefill_equals_cold_bit_for_bit():
    x, b, c, dt, a_log, _ = map(_t, _ssd_inputs(16, s=48))
    cold, h_cold = ssm.ssd_chunked(x, b, c, dt, a_log, chunk=16,
                                   return_state=True, fixed_grid=True)
    first, h1 = ssm.ssd_chunked(x[:, :32], b[:, :32], c[:, :32], dt[:, :32],
                                a_log, chunk=16, return_state=True, fixed_grid=True)
    rest, h2 = ssm.ssd_chunked(x[:, 32:], b[:, 32:], c[:, 32:], dt[:, 32:],
                               a_log, chunk=16, h0=h1, return_state=True,
                               fixed_grid=True)
    assert torch.equal(torch.cat([first, rest], 1), cold) and torch.equal(h2, h_cold)


def test_resumed_rglru_prefill_equals_cold_bit_for_bit():
    a, b, h0 = map(_t, _ab(17, s=45))
    cold, last = rglru.rglru_chunked(a, b, h0, 16)
    first, h1 = rglru.rglru_chunked(a[:, :32], b[:, :32], h0, 16)
    rest, h2 = rglru.rglru_chunked(a[:, 32:], b[:, 32:], h1, 16)
    assert torch.equal(torch.cat([first, rest], 1), cold) and torch.equal(h2, last)


def test_resumed_ring_prefill_equals_cold_bit_for_bit():
    q, k, v = map(_t, _qkv(18, 1, 4, 1, 80))
    fresh = dec.init_ring_cache(1, 1, 8, 32)
    cold, cc = dec.kv_ring_prefill(fresh, q, k, v, grid=16)
    first, c1 = dec.kv_ring_prefill(fresh, q[:, :, :48], k[:, :, :48],
                                    v[:, :, :48], grid=16)
    rest, c2 = dec.kv_ring_prefill(c1, q[:, :, 48:], k[:, :, 48:], v[:, :, 48:],
                                   grid=16)
    assert torch.equal(torch.cat([first, rest], 2), cold)
    assert torch.equal(c2.k, cc.k) and torch.equal(c2.v, cc.v) and c2.pos == 80
    with pytest.raises(ValueError, match="lattice"):
        dec.kv_ring_prefill(c1._replace(pos=40), q, k, v, grid=16)


@pytest.mark.parametrize("node", ["recurrent", "ring"])
def test_snapshots_and_restores_do_not_alias(node):
    if node == "recurrent":
        live = dec.RecurrentCache(torch.randn(1, 3, 2), torch.randn(1, 3, 5))
        fresh = dec.RecurrentCache(torch.zeros(1, 3, 2), torch.zeros(1, 3, 5))
    else:
        live = dec.RingKVCache(torch.randn(1, 1, 4, 2), torch.randn(1, 1, 4, 2), 6)
        fresh = dec.init_ring_cache(1, 1, 2, 4)
    (snap,) = tst.snapshot_state([live])
    kept = [x.clone() for x in tst.snapshot_tensors([snap])]
    for x in tst.snapshot_tensors([live]):
        x.add_(1.0)                               # the engine writes in place
    assert all(torch.equal(a, b) for a, b in zip(tst.snapshot_tensors([snap]), kept))
    (restored,) = tst.restore_state([fresh], [snap], 6)
    for x in tst.snapshot_tensors([restored]):
        x.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(tst.snapshot_tensors([snap]), kept))
    if node == "ring":
        assert restored.pos == 6 and snap.pos == 6
