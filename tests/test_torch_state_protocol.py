"""The port's DecodeState protocol: the kind registry and capabilities
against the JAX package's, bucket_chunks' edges and caps, snapshot ->
restore -> resume equal to a cold prefill (port against itself, bit for
bit), snapshots serialized by either package resumed by the other, the
partial-prefill carry, and the slot helpers with per-row decode."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import state as jst  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import state as tst  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ARCH = "gpt2s-polysketch"
MECHS = {"polysketch": "polysketch", "polynomial": "poly_kv",
         "softmax": "kv_full"}
TOL = 1e-4


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


def _tokens(seed, n, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, size=(1, n))


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) of SMOKE polysketch (block 16)."""
    jm = jax_build_model(jax_get_config(ARCH, smoke=True))
    params, _ = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True)
    tm = build_model(cfg, device="cpu", params=params_from_jax(_flat(params), cfg))
    return jm, params, tm


def _same_cache(a, b):
    return len(a) == len(b) and all(
        x.pos == y.pos and all(torch.equal(u, v) for u, v in zip(x[:-1], y[:-1]))
        for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# registry and capabilities
# ---------------------------------------------------------------------------

def test_registry_holds_the_ported_kinds_as_the_reference_declares_them():
    assert set(tst.REGISTRY) == set(MECHS.values()) | {"kv_ring", "ssd",
                                                       "rglru"}
    assert set(tst.REGISTRY) == set(jst.REGISTRY)
    for kind, spec in tst.REGISTRY.items():
        ref = jst.get_spec(kind)
        assert spec.kind == kind
        assert (spec.granularity, spec.resumable) == (ref.granularity,
                                                      ref.resumable)
        assert spec.node_type.__name__ == ref.node_type.__name__
    with pytest.raises(KeyError, match="registered"):
        tst.get_spec("nope")


@pytest.mark.parametrize("attention", list(MECHS))
def test_model_state_kinds_and_capabilities_match_jax(attention):
    jcfg = jax_get_config(ARCH, smoke=True, attention=attention)
    cfg = get_config(ARCH, smoke=True, attention=attention)
    st = build_model(cfg, device="cpu").state
    jstate = jax_build_model(jcfg).state
    assert st.kinds == jstate.kinds == (MECHS[attention],)
    assert st.kind == MECHS[attention]
    assert st.resumable == jstate.resumable
    assert st.snapshot_granularity == jstate.snapshot_granularity
    assert st.block_size == jstate.block_size == cfg.lt_block_size


def test_mixer_state_kind_and_composite_granularity_match_jax():
    for attention in MECHS:
        cfg = get_config(ARCH, smoke=True, attention=attention)
        jcfg = jax_get_config(ARCH, smoke=True, attention=attention)
        for mixer in ("attn", "local_attn", "ssd", "rglru"):
            assert tst.mixer_state_kind(cfg, mixer) == \
                jst.mixer_state_kind(jcfg, mixer)
        assert tst.mixer_state_kind(cfg) == MECHS[attention]
        assert tst.state_kinds(cfg) == jst.state_kinds(jcfg)
    with pytest.raises(ValueError, match="unknown mixer"):
        tst.mixer_state_kind(cfg, "conv")
    kinds = list(MECHS.values())
    for combo in ([], kinds[:1], kinds[1:], kinds, kinds[::-1]):
        assert tst.composite_granularity(combo) == \
            jst.composite_granularity(combo)


@pytest.mark.parametrize("blk", [1, 4, 16, 1024])
@pytest.mark.parametrize("cap", [None, 1, 2, 3, 5, 8])
def test_bucket_chunks_matches_reference(blk, cap):
    for pos0 in (0, blk, 3 * blk):
        for end in (pos0, pos0 + 1, pos0 + blk - 1, pos0 + blk, pos0 + 5 * blk,
                    pos0 + 7 * blk + 3, pos0 + 64 * blk + blk // 2):
            cuts = tst.bucket_chunks(pos0, end, blk, cap)
            assert cuts == jst.bucket_chunks(pos0, end, blk, cap)
            if end > pos0:
                assert cuts[-1] == end
                assert all(c % blk == 0 for c in cuts[:-1] if pos0 % blk == 0)
                sizes = np.diff([pos0] + cuts)
                if cap is not None:
                    lim = (1 << (max(1, cap).bit_length() - 1)) * blk
                    assert sizes.max() <= max(lim, blk)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split_blocks,total", [(1, 40), (2, 37), (2, 33), (1, 17)])
def test_snapshot_restore_resume_equals_cold_prefill_bit_for_bit(
        pair, split_blocks, total):
    _, _, tm = pair
    st = tm.state
    toks = torch.from_numpy(_tokens(total, total))
    cut = split_blocks * st.block_size
    cold_logits, cold = st.prefill(toks)
    _, part = st.prefill(toks[:, :cut])
    snap = st.snapshot(part)
    restored = st.restore(st.init_slot(), snap, cut)
    assert all(c.pos == cut for c in restored)
    got_logits, got = st.resume(toks[:, cut:], restored, cut)
    assert torch.equal(got_logits, cold_logits)
    assert _same_cache(got, cold)
    # serialize -> deserialize is exact too
    snap2, n = st.deserialize(st.serialize(snap, cut))
    assert n == cut and all(torch.equal(a, b) for a, b in zip(snap, snap2))


@pytest.mark.parametrize("attention", ["polynomial", "softmax"])
def test_kv_kinds_have_no_snapshot(attention):
    st = build_model(get_config(ARCH, smoke=True, attention=attention),
                     device="cpu").state
    with pytest.raises(ValueError, match="no constant-size snapshot"):
        st.snapshot(st.init_slot(32))
    with pytest.raises(ValueError, match="does not support"):
        tst.snapshot_state(st.init_slot(32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_from_either_package_resumes_in_the_other(pair, writer):
    """A snapshot of a 32-token prefill, serialized by one package and
    resumed by the other over 9 more tokens: logits within 1e-4 of the
    writer's own resume."""
    jm, params, tm = pair
    toks = _tokens(5, 41)
    cut = 2 * tm.state.block_size
    jtoks = jnp.asarray(toks, jnp.int32)
    _, jpart = jm.state.prefill(params, jtoks[:, :cut], max_len=64)
    jsnap = jm.state.snapshot(jpart)
    _, tpart = tm.state.prefill(torch.from_numpy(toks[:, :cut]))
    tsnap = tm.state.snapshot(tpart)
    if writer == "port":
        data = tm.state.serialize(tsnap, cut)
        snap, n = jm.state.deserialize(data)
        assert n == cut
        fresh = jm.state.init_slot(params, 64)
        got, _ = jm.state.resume(params, jtoks[:, cut:],
                                 jm.state.restore(fresh, snap, n), cut)
        want, _ = tm.state.resume(torch.from_numpy(toks[:, cut:]),
                                  tm.state.restore(tm.state.init_slot(), tsnap,
                                                   cut), cut)
        np.testing.assert_allclose(np.asarray(got), want.numpy(), atol=TOL,
                                   rtol=TOL)
    else:
        data = jm.state.serialize(jsnap, cut)
        snap, n = tm.state.deserialize(data)
        assert n == cut and snap[0].shape == tsnap[0].shape
        got, _ = tm.state.resume(torch.from_numpy(toks[:, cut:]),
                                 tm.state.restore(tm.state.init_slot(), snap,
                                                  n), cut)
        fresh = jm.state.init_slot(params, 64)
        want, _ = jm.state.resume(params, jtoks[:, cut:],
                                  jm.state.restore(fresh, jsnap, cut), cut)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_serialized_layout_is_the_references(pair):
    jm, params, tm = pair
    _, tpart = tm.state.prefill(torch.from_numpy(_tokens(1, 16)))
    data = tm.state.serialize(tm.state.snapshot(tpart), 16)
    import io
    with np.load(io.BytesIO(data)) as z:
        assert sorted(z.files) == ["leaf0", "n_tokens"]
        cfg = tm.cfg
        assert z["leaf0"].shape == (cfg.n_layers, 1, cfg.n_kv_heads,
                                    cfg.sketch_size ** 2,
                                    cfg.resolved_head_dim + 1)
    probe = jm.state.snapshot(jm.state.init_slot(params, 16))
    assert [x.shape for x in jax.tree_util.tree_leaves(probe)] == \
        [z_shape for z_shape in [(cfg.n_layers, 1, cfg.n_kv_heads,
                                  cfg.sketch_size ** 2,
                                  cfg.resolved_head_dim + 1)]]
    bad = tst.serialize_snapshot([torch.zeros(1, 2, 3)], 0, [("groups/block0", [0], True)])
    with pytest.raises(ValueError, match="do not fit"):
        tm.state.deserialize(bad)


def test_partial_prefill_snapshot_evict_restore_equals_cold(pair):
    _, _, tm = pair
    st = tm.state
    toks = torch.from_numpy(_tokens(8, 45))
    cold_logits, cold = st.prefill(toks)
    part = st.begin_partial()
    assert not part.started and part.n_tokens == 0
    part = st.advance_partial(toks[:, :16], part)
    part = st.advance_partial(toks[:, 16:32], part)
    assert part.started and part.n_tokens == 32
    snap, n = st.partial_snapshot(part)
    del part                                          # evicted
    part = st.partial_restore(snap, n)
    assert part.n_tokens == 32 and not part.started
    part = st.advance_partial(toks[:, 32:], part)
    assert torch.equal(part.logits, cold_logits) and _same_cache(part.state, cold)
    off = st.advance_partial(toks[:, :5], st.begin_partial())
    with pytest.raises(ValueError, match="off-grid"):
        st.partial_snapshot(off)


# ---------------------------------------------------------------------------
# slot helpers and per-row decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attention", list(MECHS))
def test_slot_helpers_round_trip_and_per_row_decode(attention):
    """Four slots at four depths (a polysketch row folding its block on
    this step among them) decode in one call exactly as four batch-1
    decodes do; rows that do not fold keep z bit for bit."""
    cfg = get_config(ARCH, smoke=True, attention=attention)
    st = build_model(cfg, device="cpu", seed=2).state
    max_len = 48
    lens = [5, 15, 16, 33]              # 15: this step fills the block of 16
    slots = st.broadcast_slots(st.init_slot(max_len), 4)
    assert all(torch.equal(n.pos, torch.zeros(4, dtype=torch.long))
               for n in slots)
    singles, feeds = [], []
    for si, n in enumerate(lens):
        toks = torch.from_numpy(_tokens(si, n))
        logits, cache = st.prefill(toks, st.init_slot(max_len))
        before = slots
        slots = st.slot_scatter(slots, cache, si)
        assert before is not slots and _same_cache(
            [c._replace(pos=0) for c in st.slot_gather(before, si)],
            [c._replace(pos=0) for c in st.init_slot(max_len)])
        back = st.slot_gather(slots, si)
        assert _same_cache(back, cache)
        singles.append(cache)
        feeds.append(logits.argmax(-1))
    tok = torch.stack(feeds)                          # (4, 1)
    pos = torch.tensor(lens)
    logits, stepped = st.decode_step(tok, pos, slots)
    assert torch.equal(stepped[0].pos, pos + 1)
    for si, n in enumerate(lens):
        want_logits, want = st.decode_step(tok[si:si + 1], n, singles[si])
        torch.testing.assert_close(logits[si:si + 1], want_logits,
                                   atol=1e-5, rtol=1e-5)
        got = st.slot_gather(stepped, si)
        for a, b in zip(got, want):
            assert a.pos == b.pos == n + 1
            for x, y in zip(a[:-1], b[:-1]):
                torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)
        if attention == "polysketch" and (n + 1) % cfg.lt_block_size:
            assert all(torch.equal(a.z, b.z)
                       for a, b in zip(got, st.slot_gather(slots, si)))
    if attention == "polysketch":          # the folding row's z did change
        assert not torch.equal(st.slot_gather(stepped, 1)[0].z,
                               singles[1][0].z)


def test_per_row_kv_write_past_the_cache_clamps_like_jax():
    """A free slot decoding along on stale state can pass max_len; its write
    lands on the last slot, as JAX's dynamic_update_index_in_dim clamps."""
    from repro_torch.core import decode as dec
    cache = dec.init_kv_cache(2, 1, 4, 3)
    cache = cache._replace(pos=torch.tensor([1, 5]))
    k = torch.ones(2, 1, 4)
    _, new = dec.kv_decode_step(cache, torch.ones(2, 1, 4), k, k)
    assert torch.equal(new.k[0, 0, 1], k[0, 0]) and torch.equal(
        new.k[1, 0, 2], k[1, 0])
    assert torch.equal(new.pos, torch.tensor([2, 6]))
    assert torch.equal(cache.k, torch.zeros_like(cache.k))   # a value
