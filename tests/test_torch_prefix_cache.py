"""The port's prefix-reuse snapshot cache and its scheduler paths, held to
the JAX package's on SMOKE (block 16) with parameters bridged from one JAX
init and the same numpy tokens: chain keys byte for byte, a scripted
sequence of plans, inserts and evictions with the same plans, victims and
stats, and a shared-prefix workload through ServeEngine with the JAX
engine's tokens (greedy and sampled), log-probabilities within 1e-4 and
the same hit, restore, coalescing and promote counts. Then the port
against itself: hits bit for bit equal to a cold run, the disk tier
across a restart and under corrupt, oversized and flaky files, foreign
params and KV states refused, and stored snapshots never aliased by live
state."""
import os

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.serve import PrefixCache as JaxPrefixCache  # noqa: E402
from repro.serve import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import decode as dec  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import (PrefixCache, SamplingParams,  # noqa: E402
                               ServeEngine, generate, params_fingerprint,
                               snapshot_nbytes)

ARCH = "gpt2s-polysketch"
BLK = 16
LP_TOL = 1e-4
MAX_LEN = 160
# the shared-prefix workload: a 4-block system prompt, then suffixes of
# 19-30 tokens that cross one more block boundary for the longer ones;
# every third request sampled
SHARED, N_REQ, GEN = 4 * BLK, 6, 5
SAMPLED = dict(temperature=0.8, top_k=12, top_p=0.9)
# the JAX run's scheduling, under which the counts are compared
SLOTS, BUDGET = 3, BLK


def _flat(tree):
    return {p: np.asarray(x) for p, x in
            zip(tree_paths(tree), jax.tree_util.tree_leaves(tree))}


def _workload(seed=5):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 128, SHARED)
    prompts = [np.concatenate([shared, rng.integers(0, 128, 19 + 2 * i)])
               for i in range(N_REQ)]
    samp = [dict(SAMPLED, seed=40 + i) if i % 3 == 2 else {}
            for i in range(N_REQ)]
    return prompts, samp


def _port_run(tm, *, prefix_cache=None, slots=SLOTS, overlap=True,
              budget=BUDGET, order=None, **kw):
    eng = ServeEngine(tm, slots=slots, max_len=MAX_LEN, logprobs=True,
                      overlap=overlap, prefill_budget=budget,
                      prefix_cache=prefix_cache, **kw)
    prompts, samp = _workload()
    order = range(N_REQ) if order is None else order
    rid_of = {eng.submit(prompts[i], GEN,
                         sampling=SamplingParams(**samp[i])): i
              for i in order}
    outs = {rid_of[o.rid]: o for o in eng.run()}
    return outs, eng


@pytest.fixture(scope="module")
def bridged():
    """(port SMOKE model bridged from a JAX init, the JAX engine's outputs
    by request index and its stats) for the shared-prefix workload."""
    jm = jax_build_model(jax_get_config(ARCH, smoke=True))
    params, _ = jm.init(jax.random.PRNGKey(2))
    cfg = get_config(ARCH, smoke=True)
    tm = build_model(cfg, device="cpu",
                     params=params_from_jax(_flat(params), cfg))
    jeng = JaxServeEngine(jm, jm.cfg, params, slots=SLOTS, max_len=MAX_LEN,
                          logprobs=True, overlap=True, prefill_budget=BUDGET,
                          prefix_cache=JaxPrefixCache(8 << 20))
    prompts, samp = _workload()
    for p, sp in zip(prompts, samp):
        jeng.submit(jnp.asarray(p, jnp.int32), GEN,
                    sampling=JaxSamplingParams(**sp))
    want = {o.rid: o for o in jeng.run()}
    return tm, want, jeng.stats()


@pytest.fixture(scope="module")
def smoke_model():
    return build_model(get_config(ARCH, smoke=True), device="cpu", seed=6)


# ---------------------------------------------------------------------------
# the store against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blk,n", [(4, 37), (16, 100), (1024, 4100)])
def test_chain_keys_equal_jax_bytes(blk, n):
    toks = np.random.default_rng(n).integers(0, 50_000, n)
    got = PrefixCache(1, block_size=blk).chain_keys(toks, n // blk)
    want = JaxPrefixCache(1, block_size=blk).chain_keys(
        jnp.asarray(toks, jnp.int32), n // blk)
    assert len(got) == n // blk and got == want
    # the prompt's dtype does not matter: int64 and int32 hash alike
    assert PrefixCache(1, block_size=blk).chain_keys(
        toks.astype(np.int32), n // blk) == got


def _script(pc, snap, np_mod, min_blocks):
    """Plans, inserts and lookups over a 2-block-shared workload, under a
    budget of three entries; returns what each step saw."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 100, 8)                 # 2 blocks of 4
    prompts = [np.concatenate([prefix, rng.integers(0, 100, s)])
               for s in (6, 6, 6, 9, 2, 13)]
    prompts += [prompts[0], np.arange(12), np.arange(12), prompts[3]]
    seen = []
    for i, p in enumerate(prompts):
        plan = pc.plan(np_mod(p), min_blocks=min_blocks)
        for key, n in ((plan.promote_key, plan.n_promote),
                       (plan.trunc_key, plan.n_trunc)):
            if key and n and n > plan.n_restore:
                pc.insert(key, n, snap)
        seen.append(((plan.n_restore, plan.snapshot is not None,
                      plan.n_promote, plan.promote_key, plan.n_trunc,
                      plan.trunc_key), list(pc._entries), pc.stats()))
    pc.insert(b"one-off", 4, snap)                   # evicts the least hit
    seen.append((None, list(pc._entries), pc.stats()))
    return seen


@pytest.mark.parametrize("min_blocks", [1, 2])
def test_scripted_plans_evictions_and_stats_match_jax(min_blocks):
    port = PrefixCache(3 * 256 * 4, block_size=4)
    ref = JaxPrefixCache(3 * 256 * 4, block_size=4)
    got = _script(port, [torch.zeros(256)], np.asarray, min_blocks)
    want = _script(ref, {"z": jnp.zeros((256,), jnp.float32)},
                   lambda p: jnp.asarray(p, jnp.int32), min_blocks)
    assert got == want
    st = port.stats()
    assert st["evictions"] >= 2 and st["hits"] >= 2 and st["entries"] == 3


def test_plan_promotes_a_shared_boundary_then_hits():
    pc = PrefixCache(1 << 20, block_size=4)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 100, 8)
    mk = lambda s: np.concatenate([prefix, rng.integers(0, 100, s)])  # noqa: E731
    plan1 = pc.plan(mk(6))
    assert (plan1.n_restore, plan1.n_promote, plan1.n_trunc) == (0, None, 12)
    pc.insert(plan1.trunc_key, 12, [torch.zeros(8)])
    plan2 = pc.plan(mk(6))
    assert plan2.n_restore == 0 and plan2.n_promote == 8
    pc.insert(plan2.promote_key, 8, [torch.zeros(8)])
    plan3 = pc.plan(mk(6))
    assert plan3.n_restore == 8 and plan3.n_promote is None
    # a snapshot covering the whole block-aligned prompt is no usable match
    toks = np.arange(8)
    pc.insert(pc.plan(toks).trunc_key, 8, [torch.zeros(8)])
    assert pc.plan(toks).n_restore <= 7


def test_block_size_binding_and_budget_checks():
    pc = PrefixCache(1 << 20, block_size=32)
    with pytest.raises(ValueError, match="block_size"):
        pc.bind_block_size(16)
    pc.bind_block_size(32)
    with pytest.raises(ValueError, match="positive"):
        PrefixCache(0)
    assert snapshot_nbytes([torch.zeros(3, 5), {"a": torch.zeros(2, dtype=torch.int64)}]) == 76


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_matches_jax_tokens_hits_and_coalescing(bridged):
    tm, want, jst = bridged
    pc = PrefixCache(8 << 20)
    got, eng = _port_run(tm, prefix_cache=pc)
    assert sorted(got) == sorted(want)
    for i, w in want.items():
        np.testing.assert_array_equal(got[i].tokens, w.tokens)
        np.testing.assert_allclose(got[i].logprobs, w.logprobs, atol=LP_TOL,
                                   rtol=LP_TOL)
    st = eng.stats()
    for k in ("lookups", "hits", "misses", "hit_tokens", "inserts",
              "evictions", "entries", "bytes"):
        assert st["prefix_cache"][k] == jst["prefix_cache"][k], k
    for k in ("coalesced", "promote_splits", "chunks", "chunk_tokens"):
        assert st["scheduler"][k] == jst["scheduler"][k], k
    assert st["prefix_cache"]["hits"] >= 3
    assert st["scheduler"]["coalesced"] >= 1
    assert st["scheduler"]["promote_splits"] == 1


@pytest.mark.parametrize("slots,overlap,budget", [(1, False, None),
                                                  (4, False, 32),
                                                  (2, True, 16)])
def test_engine_tokens_match_jax_under_other_scheduling(bridged, slots,
                                                        overlap, budget):
    tm, want, _ = bridged
    got, eng = _port_run(tm, prefix_cache=PrefixCache(8 << 20), slots=slots,
                         overlap=overlap, budget=budget)
    for i, w in want.items():
        np.testing.assert_array_equal(got[i].tokens, w.tokens)
    assert eng.stats()["prefix_cache"]["hits"] >= 2


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

def test_hits_equal_a_cold_run_bit_for_bit(smoke_model):
    cold, _ = _port_run(smoke_model)
    warm, eng = _port_run(smoke_model, prefix_cache=PrefixCache(8 << 20),
                          order=range(N_REQ - 1, -1, -1))
    assert eng.stats()["prefix_cache"]["hit_tokens"] >= 3 * SHARED
    for i in range(N_REQ):
        assert np.array_equal(warm[i].tokens, cold[i].tokens)
        assert np.array_equal(warm[i].logprobs, cold[i].logprobs)
    prompts, _ = _workload()
    ref = generate(smoke_model, prompts[0][None], GEN, max_len=MAX_LEN)
    np.testing.assert_array_equal(warm[0].tokens, ref.tokens[0].numpy())


@pytest.mark.parametrize("suffix", [BLK, BLK + 5, 7])
def test_restored_resume_equals_a_cold_prefill_bit_for_bit(smoke_model,
                                                           suffix):
    st = smoke_model.state
    prompt = torch.from_numpy(np.random.default_rng(suffix).integers(
        0, 128, (1, 3 * BLK + suffix)))
    logits, cache = st.prefill(prompt, max_len=MAX_LEN)
    _, pfx = st.prefill(prompt[:, :3 * BLK], max_len=MAX_LEN)
    restored = st.restore(st.init_slot(MAX_LEN), st.snapshot(pfx), 3 * BLK)
    got, rcache = st.resume(prompt[:, 3 * BLK:], restored, 3 * BLK)
    assert torch.equal(got, logits)
    for a, b in zip(rcache, cache):
        assert a.pos == b.pos
        assert all(torch.equal(u, v) for u, v in zip(a[:-1], b[:-1]))


def test_min_snapshot_blocks_floor(smoke_model):
    pc = PrefixCache(8 << 20)
    eng = ServeEngine(smoke_model, slots=1, max_len=MAX_LEN,
                      prefix_cache=pc, min_snapshot_blocks=2)
    shallow = np.arange(BLK + 4) % 128
    for _ in range(3):
        eng.submit(shallow, 3)
    eng.run()
    assert len(pc) == 0 and pc.inserts == 0
    deep = np.arange(2 * BLK + 4) % 128
    eng.submit(deep, 3)
    eng.run()
    assert len(pc) == 1
    eng.submit(deep, 3)
    eng.run()
    assert pc.hits == 1


def test_resumed_chunk_lengths_stay_bounded(smoke_model):
    pc = PrefixCache(8 << 20)
    eng = ServeEngine(smoke_model, slots=2, max_len=256, prefix_cache=pc)
    rng = np.random.default_rng(8)
    shared = rng.integers(0, 128, 2 * BLK)
    for i in range(10):
        eng.submit(np.concatenate([shared, rng.integers(0, 128, 3 + 7 * i)]),
                   2)
    eng.run()
    assert pc.hits >= 1
    bound = (BLK - 1) + int(np.log2(256 // BLK)) + 1
    assert len(eng._resume_lens) <= bound
    for n in eng._resume_lens:
        assert n < BLK or (n % BLK == 0 and (n // BLK).bit_count() == 1), n


# ---------------------------------------------------------------------------
# the disk tier
# ---------------------------------------------------------------------------

def _serve_once(model, pc, prompt, gen=3):
    eng = ServeEngine(model, slots=1, max_len=MAX_LEN, prefix_cache=pc,
                      logprobs=True)
    eng.submit(prompt, gen)
    return eng.run()[0]


def _npz_files(root):
    return [os.path.join(r, f) for r, _, fs in os.walk(root) for f in fs
            if f.endswith(".npz")]


@pytest.fixture
def persisted(smoke_model, tmp_path):
    """A cacheable prompt served once through a disk-backed cache: (prompt,
    its output, the persisted files)."""
    prompt = np.random.default_rng(12).integers(0, 128, 3 * BLK + 5)
    pc = PrefixCache(8 << 20, save_dir=str(tmp_path))
    ref = _serve_once(smoke_model, pc, prompt)
    assert pc.stats()["disk_writes"] >= 1
    files = _npz_files(tmp_path)
    assert files
    return prompt, ref, files


def test_disk_tier_persists_across_a_restart(smoke_model, tmp_path, persisted):
    prompt, ref, _ = persisted
    pc = PrefixCache(8 << 20, save_dir=str(tmp_path))
    out = _serve_once(smoke_model, pc, prompt)
    assert np.array_equal(out.tokens, ref.tokens)
    assert np.array_equal(out.logprobs, ref.logprobs)
    st = pc.stats()
    assert st["disk_loads"] == 1 and st["hits"] == 1
    assert st["disk_writes"] == 0          # persisted keys are not rewritten


def test_corrupt_file_is_quarantined_and_counted(smoke_model, tmp_path,
                                                 persisted):
    prompt, ref, files = persisted
    for p in files:                        # truncated mid-payload
        with open(p, "r+b") as fh:
            data = fh.read()
            fh.seek(0)
            fh.truncate()
            fh.write(data[:len(data) // 2])
    pc = PrefixCache(8 << 20, save_dir=str(tmp_path))
    out = _serve_once(smoke_model, pc, prompt)
    assert np.array_equal(out.tokens, ref.tokens)
    st = pc.stats()
    assert st["disk_loads"] == 0 and st["disk_corrupt"] >= 1
    quarantined = [p for p in files if os.path.exists(p + ".bad")]
    assert len(quarantined) == st["disk_corrupt"]
    assert st["disk_writes"] >= 1          # the cold serve re-persists
    skips = len(pc._disk_skip)
    _serve_once(smoke_model, pc, prompt)
    assert len(pc._disk_skip) == skips     # never probed again


def test_oversized_file_is_read_once_then_skipped(smoke_model, tmp_path,
                                                  persisted):
    prompt, ref, _ = persisted
    pc = PrefixCache(64, save_dir=str(tmp_path))     # budget < a snapshot
    assert np.array_equal(_serve_once(smoke_model, pc, prompt).tokens,
                          ref.tokens)
    assert pc.stats()["disk_loads"] == 0 and len(pc) == 0
    skips = len(pc._disk_skip)
    assert skips >= 1
    _serve_once(smoke_model, pc, prompt)
    assert len(pc._disk_skip) == skips


def test_transient_io_fault_is_absorbed(smoke_model, tmp_path, persisted):
    prompt, ref, _ = persisted
    pc = PrefixCache(8 << 20, save_dir=str(tmp_path))
    flakes = {"left": 2}                   # the retry budget

    def fault(op):
        if op == "read" and flakes["left"] > 0:
            flakes["left"] -= 1
            raise OSError("injected flake")
    pc.io_fault = fault
    assert np.array_equal(_serve_once(smoke_model, pc, prompt).tokens,
                          ref.tokens)
    st = pc.stats()
    assert st["disk_loads"] == 1 and st["disk_retries"] == 2
    assert st["disk_corrupt"] == 0


def test_persistent_io_fault_degrades_to_a_miss(smoke_model, tmp_path,
                                                persisted):
    prompt, ref, files = persisted
    pc = PrefixCache(8 << 20, save_dir=str(tmp_path))

    def down(op):
        raise OSError("store down")
    pc.io_fault = down
    assert np.array_equal(_serve_once(smoke_model, pc, prompt).tokens,
                          ref.tokens)
    st = pc.stats()
    assert st["disk_loads"] == 0 and st["disk_corrupt"] == 0
    assert st["disk_retries"] == 2
    assert all(os.path.exists(p) for p in files)     # nothing quarantined
    # a write to a down store is retried, then swallowed
    _serve_once(smoke_model, pc, np.arange(2 * BLK + 3) % 128)
    st = pc.stats()
    assert st["disk_writes"] == 0 and st["disk_retries"] == 4
    assert pc.inserts == 2                # the memory tier holds both


# ---------------------------------------------------------------------------
# refusals and aliasing
# ---------------------------------------------------------------------------

def test_foreign_params_are_refused(smoke_model):
    pc = PrefixCache(1 << 20)
    ServeEngine(smoke_model, slots=1, max_len=32, prefix_cache=pc)
    ServeEngine(smoke_model, slots=1, max_len=32, prefix_cache=pc)
    other = build_model(get_config(ARCH, smoke=True), device="cpu", seed=7)
    with pytest.raises(ValueError, match="different model weights"):
        ServeEngine(other, slots=1, max_len=32, prefix_cache=pc)
    # an edit deep inside one parameter moves the fingerprint
    fp = params_fingerprint(smoke_model.lm)
    w = next(p for p in other.lm.parameters() if p.numel() > 64)
    other.lm.load_state_dict(smoke_model.lm.state_dict())
    assert params_fingerprint(other.lm) == fp
    with torch.no_grad():
        w.view(-1)[w.numel() // 2] += 1.0
    assert params_fingerprint(other.lm) != fp


@pytest.mark.parametrize("attention,kind", [("polynomial", "poly_kv"),
                                            ("softmax", "kv_full")])
def test_kv_states_are_refused(attention, kind):
    model = build_model(get_config(ARCH, smoke=True, attention=attention),
                        device="cpu")
    assert model.state.snapshot_granularity is None
    with pytest.raises(ValueError, match="snapshot-capable"):
        ServeEngine(model, slots=1, max_len=32,
                    prefix_cache=PrefixCache(1 << 20))
    with pytest.raises(ValueError, match=kind):
        model.state.snapshot(model.state.init_slot(32))


def test_snapshots_and_restores_never_share_storage(smoke_model):
    st = smoke_model.state
    prompt = torch.from_numpy(np.arange(2 * BLK + 3)[None] % 128)
    _, cache = st.prefill(prompt, max_len=MAX_LEN)
    snap = st.snapshot(cache)
    keep = [z.clone() for z in snap]
    restored = st.restore(st.init_slot(MAX_LEN), snap, 2 * BLK)
    ptrs = {z.untyped_storage().data_ptr() for z in snap}
    for node in list(cache) + list(restored):
        assert node.z.untyped_storage().data_ptr() not in ptrs
    # in-place writes into both live caches leave the snapshot's bits
    for live in (cache, restored):
        for node in live:
            node.z.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(snap, keep))


def test_stored_snapshots_keep_their_bytes_through_serving(smoke_model):
    pc = PrefixCache(8 << 20)
    prompts, _ = _workload()
    eng = ServeEngine(smoke_model, slots=2, max_len=MAX_LEN, prefix_cache=pc)
    for p in prompts[:2]:
        eng.submit(p, 2)
    eng.run()
    keep = {k: [z.clone() for z in e.snapshot] for k, e in pc._entries.items()}
    assert keep
    for p in prompts[2:]:                  # restores into slots, then decodes
        eng.submit(p, 3 * BLK)             # past two block folds
    eng.run()
    assert pc.stats()["hits"] >= 3
    for k, zs in keep.items():
        assert all(torch.equal(a, b) for a, b in zip(pc._entries[k].snapshot,
                                                     zs))
    ptrs = {z.untyped_storage().data_ptr() for e in pc._entries.values()
            for z in e.snapshot}
    for node in eng._caches:
        assert node.z.untyped_storage().data_ptr() not in ptrs
    assert isinstance(eng._caches[0], dec.PolysketchCache)


def test_checkpoint_side_store(smoke_model, tmp_path):
    """put_ckpt keeps a tag's two deepest positions as the codec's bytes,
    get_ckpt returns the deepest at or below a cap (corrupt ones dropped
    and counted), drop_ckpt releases a tag, and flush_ckpts_to_disk writes
    each tag's deepest under the store's directory. Checkpoints never
    serve as prefix hits."""
    st = smoke_model.state
    pc = PrefixCache(8 << 20, save_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="bind_codec"):
        pc.put_ckpt(b"t", 16, [])
    ServeEngine(smoke_model, slots=1, max_len=64, prefix_cache=pc)
    prompt = torch.from_numpy(np.arange(3 * BLK + 2)[None] % 128)
    snaps = {}
    for n in (BLK, 2 * BLK, 3 * BLK):
        _, cache = st.prefill(prompt[:, :n], max_len=64)
        snaps[n] = st.snapshot(cache)
        pc.put_ckpt(b"req", n, snaps[n])
    assert pc.stats()["checkpoints"]["puts"] == 3 and len(pc._ckpts[b"req"]) == 2
    got, n = pc.get_ckpt(b"req")
    assert n == 3 * BLK and all(torch.equal(a, b) for a, b in zip(got, snaps[n]))
    assert pc.get_ckpt(b"req", max_tokens=2 * BLK)[1] == 2 * BLK
    assert pc.get_ckpt(b"req", max_tokens=BLK) is None
    assert pc.plan(prompt[0].numpy()).n_restore == 0   # not a prefix hit
    paths = pc.flush_ckpts_to_disk()
    assert len(paths) == 1 and os.path.exists(paths[0])
    old = pc._ckpts[b"req"][-1][1]           # bit rot in the deepest
    pc._ckpts[b"req"][-1] = (3 * BLK, b"garbage")
    pc.ckpt_bytes += len(b"garbage") - len(old)
    assert pc.get_ckpt(b"req")[1] == 2 * BLK
    pc.drop_ckpt(b"req")
    ck = pc.stats()["checkpoints"]
    assert (ck["tags"], ck["bytes"], ck["corrupt"], ck["drops"]) == (0, 0, 1, 1)
    assert (ck["hits"], ck["misses"]) == (3, 1)
