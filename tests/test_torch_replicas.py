"""The port's replicated serving (serve/chaos.py, serve/plan.py,
serve/replicas.py, the engine's recovery): the chaos schedule and the
rule tables against the JAX package's; failover bit for bit against the
port's own fault-free fleet (tokens and log-probabilities) across kill
ticks, without a cache and under dropped checkpoints, for polysketch and
SSD; the hang, slow-tick, shedding, stats and drain mechanics; and the
slice as a whole against the JAX package's ReplicaSet under one chaos
schedule with bridged weights."""
import os
import signal

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import serve as ref  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import state as ref_state  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.utils import tree_paths  # noqa: E402

from repro_torch.bridge import params_to_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import state as port_state  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve import (PARAM_RULES, SERVING_RULES,  # noqa: E402
                               ChaosInjector, ChaosSpec, Overloaded,
                               PrefixCache, RecoveredRequest, ReplicaKilled,
                               ReplicaSet, SamplingParams, ServeEngine,
                               ServePlan, parse_chaos, replica_plans)

LP_TOL = 1e-4
STEPS = 20
SAMPLING = [dict(), dict(temperature=0.8, top_k=40, seed=7),
            dict(temperature=1.0, top_p=0.9, seed=11)]

# -- the chaos schedule (host only) ---------------------------------------


def test_parse_chaos_specs_match_the_reference():
    text = "kill@12, hang@8:r1:s0.4, slow-tick@5:x8"
    specs = parse_chaos(text)
    assert [s.kind for s in specs] == ["kill", "hang", "slow-tick"]
    assert specs[1] == ChaosSpec("hang", 8, replica=1, seconds=0.4)
    assert specs[2].count == 8 and specs[0].replica is None
    assert parse_chaos("none") == [] == parse_chaos("")
    assert ([s.describe() for s in specs]
            == [s.describe() for s in ref.parse_chaos(text)])
    for text in ("kill@12:r0", "hang@8:r1:x2:s0.4", "disk-flake@0:r1:x2"):
        (spec,) = parse_chaos(text)
        assert parse_chaos(spec.describe()) == [spec]
        assert spec.describe() == ref.parse_chaos(text)[0].describe()


@pytest.mark.parametrize("bad", ["kill", "kill@x", "frob@3", "kill@-1",
                                 "kill@3:q7"])
def test_parse_chaos_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_chaos(bad)
    with pytest.raises(ValueError):
        ref.parse_chaos(bad)


@pytest.mark.parametrize("seed", range(5))
def test_arm_picks_the_reference_victims(seed):
    text = "kill@5,hang@3,slow-tick@1:x2,drop-snapshot@0"
    for n in (2, 3, 8):
        port = [s.describe() for s in ChaosInjector(text, seed=seed).arm(n)]
        want = [s.describe() for s in ref.ChaosInjector(text, seed=seed).arm(n)]
        assert port == want
    with pytest.raises(ValueError):
        ChaosInjector("kill@5:r3", seed=seed).arm(2)


def test_injector_fires_kill_drop_window_and_io_faults():
    inj = ChaosInjector("kill@5:r1")
    inj.arm(2)
    inj.before_tick(1, 4)
    inj.before_tick(0, 5)
    with pytest.raises(ReplicaKilled):
        inj.before_tick(1, 5)
    assert inj.fired == ["kill@5:r1"]
    inj = ChaosInjector("drop-snapshot@4:r0:x3")
    inj.arm(2)
    assert [inj.drops_snapshot(0, t) for t in range(3, 8)] == [
        False, True, True, True, False]
    assert not inj.drops_snapshot(1, 5)
    inj = ChaosInjector("disk-flake@0:x2")
    inj.arm(1)
    hook = inj.io_fault_hook()
    for _ in range(2):
        with pytest.raises(OSError):
            hook("write")
    hook("write")
    assert ChaosInjector("kill@3").io_fault_hook() is None


# -- plans, rules and shard axes --------------------------------------------


def test_replica_plans_fall_back_to_one_device(monkeypatch):
    plans = replica_plans(3, device="cpu")
    assert len(plans) == 3
    assert all(p.device == torch.device("cpu") and p.n_devices == 1
               and p.describe() == "1x1" for p in plans)
    # cards enough for every replica spread a model on a card over them,
    # and never move a model on the CPU there
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert ([p.device for p in replica_plans(2, device="cuda:0")]
            == [torch.device("cuda", 0), torch.device("cuda", 1)])
    assert all(p.device == torch.device("cpu")
               for p in replica_plans(2, device="cpu"))


def test_rule_tables_equal_the_reference():
    from repro.serve import plan as ref_plan
    assert SERVING_RULES == ref_plan.SERVING_RULES
    assert PARAM_RULES == ref_plan.PARAM_RULES


def _kind_cfgs():
    """(kind, port config, reference config) for each state kind at SMOKE."""
    over = {"polysketch": ("gpt2s-polysketch", {}),
            "poly_kv": ("gpt2s-polysketch", {"attention": "polynomial"}),
            "kv_full": ("gpt2s-polysketch", {"attention": "softmax"}),
            "kv_ring": ("recurrentgemma-9b", {}),
            "rglru": ("recurrentgemma-9b", {}),
            "ssd": ("mamba2-780m", {})}
    return [(k, get_config(a, smoke=True, **o), jax_get_config(a, smoke=True, **o))
            for k, (a, o) in over.items()]


@pytest.mark.parametrize("kind,cfg,jcfg", _kind_cfgs(),
                         ids=[k for k, _, _ in _kind_cfgs()])
def test_state_shard_axes_equal_the_reference(kind, cfg, jcfg):
    """Plain: one layer's node of each kind, field by field. Slot-stacked:
    the reference's form has a slot axis over batch-1 caches (two leading
    names), the port's stacks the slots on the batch axis, so its names are
    the reference's without the inner batch-1 dim's."""
    spec, jspec = port_state.get_spec(kind), ref_state.get_spec(kind)
    node = spec.init(cfg, 1, 64, torch.float32, "cpu")
    jnode = jspec.init(jcfg, 1, 64, jax.numpy.float32)
    assert (port_state.state_shard_axes([node])[0]
            == tuple(ref_state.state_shard_axes(jnode)))
    slots = 3
    stacked = port_state.DecodeState.broadcast_slots([node], slots)
    jstacked = jax.tree_util.tree_map(
        lambda x: jax.numpy.broadcast_to(x, (slots,) + x.shape), jnode)
    want = ref_state.state_shard_axes(jstacked, slot_stacked=True)
    got = port_state.state_shard_axes(stacked)[0]
    for field, names in zip(got._fields, got):
        w = getattr(want, field)
        assert names == (w[:1] + w[2:] if len(w) > 1 else w), field


def test_serve_plan_specs_on_one_device():
    cfg = get_config("gpt2s-polysketch", smoke=True)
    model = build_model(cfg, device="cpu")
    plan = ServePlan.single_device("cpu")
    assert plan.describe() == "1x1" and plan.n_devices == 1
    assert set(plan.param_specs(model).values()) == {()}
    caches = model.state.broadcast_slots(model.state.init_slot(64), 2)
    specs = plan.state_specs(caches)[0]
    assert specs.z == ("data", "model") and specs.pos == ("data",)
    assert plan.slot_spec(torch.zeros(2, 1)) == ("data",)
    tp = ServePlan({"data": 1, "model": 2}, torch.device("cpu"),
                   shard_model=True).param_specs(model)
    assert any(s and "model" in s for s in tp.values())
    assert plan.place(model) is model


# -- failover bit for bit against the port's own fault-free fleet ----------

_FAMILIES = {"polysketch": ("gpt2s-polysketch", {}),
             "ssd": ("mamba2-780m", {"lt_block_size": 16})}


def _workload(cfg):
    blk = cfg.lt_block_size
    rng = np.random.default_rng(0)
    prompts = [np.asarray(rng.integers(0, cfg.vocab_size, n), np.int32)
               for n in (2 * blk + 5, 7, blk + 3)]
    return prompts, [SamplingParams(**s) for s in SAMPLING]


@pytest.fixture(scope="module", params=sorted(_FAMILIES))
def family(request):
    arch, over = _FAMILIES[request.param]
    cfg = get_config(arch, smoke=True, **over)
    model = build_model(cfg, device="cpu", seed=0)
    return (request.param, model) + tuple(_workload(cfg))


def _run_fleet(family, chaos=None, cache=True, **kw):
    _, model, prompts, sps = family
    pc = PrefixCache(1 << 28) if cache else None
    rs = ReplicaSet(model, n_replicas=2, slots=2, max_len=512,
                    prefix_cache=pc, logprobs=True, overlap=True,
                    chaos=chaos, **kw)
    gids = [rs.submit(p, STEPS, sampling=sp) for p, sp in zip(prompts, sps)]
    outs = {o.rid: o for o in rs.run()}
    return gids, outs, rs


@pytest.fixture(scope="module")
def baseline(family):
    gids, outs, rs = _run_fleet(family)
    assert set(gids) == set(outs) and rs.stats()["deaths"] == {}
    return gids, outs


def _assert_bit_identical(gids, outs, gids0, outs0, ctx):
    assert set(gids) == set(outs), ctx
    for g, g0 in zip(gids, gids0):
        a, b = outs[g], outs0[g0]
        assert np.array_equal(a.tokens, b.tokens), (ctx, g)
        assert np.array_equal(a.logprobs, b.logprobs), (ctx, g)


@pytest.mark.parametrize("kill_tick", [2, 5, 9])
def test_failover_bit_identical(family, baseline, kill_tick):
    gids, outs, rs = _run_fleet(family,
                                chaos=ChaosInjector(f"kill@{kill_tick}:r0"))
    st = rs.stats()
    assert st["deaths"] == {"kill": 1} and st["failovers"] >= 1
    assert st["duplicate_outputs"] == 0 and st["recovered_installs"] >= 1
    assert st["checkpoints"] >= 1 and st["unarmed_deaths"] == []
    _assert_bit_identical(gids, outs, *baseline, (family[0], kill_tick))


def test_failover_without_checkpoints(family, baseline):
    """No cache: a cold prompt prefill and a full replay, still bit for bit."""
    gids, outs, rs = _run_fleet(family, chaos=ChaosInjector("kill@5:r0"),
                                cache=False)
    st = rs.stats()
    assert st["checkpoints"] == 0 and st["failovers"] >= 1
    _assert_bit_identical(gids, outs, *baseline, (family[0], "no cache"))


def test_drop_snapshot_fault_still_bit_identical(family, baseline):
    """Replica 0's checkpoint writes are suppressed; the kill at tick 14
    recovers from further back, with the same tokens."""
    gids, outs, rs = _run_fleet(
        family, chaos=ChaosInjector("drop-snapshot@0:r0,kill@14:r0"))
    st = rs.stats()
    assert st["checkpoints_dropped"] >= 1 and st["deaths"] == {"kill": 1}
    _assert_bit_identical(gids, outs, *baseline, (family[0], "drop+kill"))


# -- the remaining fault kinds and the fleet's mechanics (polysketch) ------


@pytest.fixture(scope="module")
def psk():
    cfg = get_config("gpt2s-polysketch", smoke=True)
    return ("polysketch", build_model(cfg, device="cpu", seed=0)) + tuple(
        _workload(cfg))


@pytest.fixture(scope="module")
def psk_baseline(psk):
    gids, outs, _ = _run_fleet(psk)
    return gids, outs


def test_hang_timeout_declares_death_and_fails_over(psk, psk_baseline):
    # tick 10 is past the fleet's first signatures (a tick that meets a
    # new one is exempt from the deadline)
    gids, outs, rs = _run_fleet(psk, chaos=ChaosInjector("hang@10:r0:s1.6"),
                                hang_timeout_s=0.8)
    assert rs.stats()["deaths"] == {"hang": 1}
    _assert_bit_identical(gids, outs, *psk_baseline, "hang@10")


def test_slow_tick_is_straggler_not_death(psk, psk_baseline):
    chaos = ChaosInjector("slow-tick@3:r0:x6:s0.05")
    gids, outs, rs = _run_fleet(psk, chaos=chaos)
    st = rs.stats()
    assert st["deaths"] == {} and st["failovers"] == 0
    assert any(f.startswith("slow-tick") for f in chaos.fired)
    _assert_bit_identical(gids, outs, *psk_baseline, "slow-tick")


def test_straggler_eviction_fails_over_bit_identical(psk, psk_baseline,
                                                     monkeypatch):
    """With `evict_after_flags`, a tick the straggler detector flags ends
    its replica (cause `straggler`), and the failover keeps the stream's
    bits. The coordinator's tick clock is a virtual one here: every tick
    takes 5 ms and the injected slow tick 1 s more, so exactly that tick
    is flagged whatever the host's load."""
    import types
    from repro_torch.serve import chaos as chaos_mod
    from repro_torch.serve import replicas as replicas_mod
    clock = [0.0]

    def perf_counter():
        clock[0] += 0.0025
        return clock[0]

    def sleep(seconds):
        clock[0] += seconds
    monkeypatch.setattr(replicas_mod, "time", types.SimpleNamespace(
        perf_counter=perf_counter, monotonic=replicas_mod.time.monotonic))
    monkeypatch.setattr(chaos_mod, "time", types.SimpleNamespace(sleep=sleep))
    chaos = ChaosInjector("slow-tick@16:r0:x1:s1.0")
    gids, outs, rs = _run_fleet(psk, chaos=chaos, evict_after_flags=1)
    st = rs.stats()
    assert chaos.fired == ["slow-tick@16:r0:x1:s1"]
    assert st["deaths"] == {"straggler": 1} and st["unarmed_deaths"] == []
    assert st["alive"] == 1 and st["failovers"] >= 1
    assert st["duplicate_outputs"] == 0
    _assert_bit_identical(gids, outs, *psk_baseline, "straggler")


def test_crash_fails_over_and_is_an_unarmed_death(psk, psk_baseline):
    """An error raised in a replica's tick (no chaos) is a death too: its
    requests fail over bit for bit, and the error is kept in
    `unarmed_deaths`, which a drill holds empty."""
    _, model, prompts, sps = psk
    rs = ReplicaSet(model, n_replicas=2, slots=2, max_len=512,
                    prefix_cache=PrefixCache(1 << 28), logprobs=True,
                    overlap=True)
    gids = [rs.submit(p, STEPS, sampling=sp) for p, sp in zip(prompts, sps)]
    step, n = rs.engines[1].step, [0]

    def failing():
        n[0] += 1
        if n[0] == 7:
            raise RuntimeError("device fault")
        return step()
    rs.engines[1].step = failing
    outs = {o.rid: o for o in rs.run()}
    st = rs.stats()
    assert st["deaths"] == {"crash": 1} and len(st["unarmed_deaths"]) == 1
    assert "device fault" in st["unarmed_deaths"][0]
    _assert_bit_identical(gids, outs, *psk_baseline, "crash")


def test_shed_above_raises_overloaded(psk):
    _, model, prompts, _ = psk
    rs = ReplicaSet(model, n_replicas=2, slots=2, max_len=512, shed_above=1)
    for p in prompts[:2]:
        rs.submit(p, 4)
    with pytest.raises(Overloaded):
        rs.submit(prompts[2], 4)
    assert rs.stats()["shed"] == 1
    assert len(rs.run()) == 2
    rs.submit(prompts[2], 4)
    assert len(rs.run()) == 1


def test_stats_surface_and_trace(psk):
    from repro_torch.serve import Telemetry, validate_trace
    tel = Telemetry(trace=True)
    gids, outs, rs = _run_fleet(psk, chaos=ChaosInjector("kill@5:r1"),
                                telemetry=tel)
    st = rs.stats()
    assert st["replicas"] == 2 and st["alive"] == 1
    assert st["failovers"] >= 1 and set(st["engines"]) == {0}
    assert st["requests"] == len(outs) == len(gids)
    assert st["retraces"] == 0 and len(st["heartbeat_age_s"]) == 2
    assert st["engines"][0]["recovered"] == st["recovered_installs"] >= 1
    reg = tel.registry
    assert reg.get("serve_replica_deaths_total").value == 1
    assert reg.get("serve_replicas_alive").value == 1
    trace = tel.export_trace()
    assert validate_trace(trace) == []
    names = {ev["name"] for ev in trace["traceEvents"]}
    assert {"replica", "recover", "replica_dead", "failover",
            "checkpoint"} <= names


def test_drain_checkpoints_persists_to_disk(tmp_path, psk):
    _, model, prompts, _ = psk
    pc = PrefixCache(1 << 28, save_dir=str(tmp_path))
    rs = ReplicaSet(model, n_replicas=2, slots=2, max_len=512,
                    prefix_cache=pc)
    for p in prompts:
        rs.submit(p, 64)
    for _ in range(3):
        rs.step()
    paths = rs.drain_checkpoints()
    assert paths and all(os.path.exists(p) for p in paths)


def test_pending_recovery_parks_and_cancels(psk):
    """With no free slot a recovered request parks ahead of the queue;
    cancel withdraws it, and live_requests shows its mirrored tokens."""
    _, model, prompts, _ = psk
    eng = ServeEngine(model, slots=1, max_len=128)
    eng.submit(prompts[0], 8)
    eng.step()
    rec = RecoveredRequest(prompt=prompts[1], emitted=[3, 4], lps=[0.0, 0.0],
                           max_new_tokens=8, eos_id=None,
                           sampling=SamplingParams(), submit_time=0.0)
    rid = eng.admit_recovered(rec)
    phases = {e["rid"]: (e["phase"], e["emitted"]) for e in eng.live_requests()}
    assert phases[rid] == ("queued", [3, 4]) and eng.busy
    assert eng.cancel(rid).rid == rid and not eng._recover_pending
    assert eng.stats()["recovered"] == 0
    eng.run()


def test_serve_cli_sigterm_drains_and_exits_cleanly(tmp_path, capsys,
                                                     monkeypatch):
    """A SIGTERM after the `serving:` line (here sent by the process to
    itself on the sixth tick) stops admissions, drains each decoding slot
    to a checkpoint file under --prefix-cache-dir and returns."""
    from repro_torch.launch import serve as cli
    simulate = cli.simulate

    def sim(engine, arrivals, **kw):
        step, n = engine.step, [0]

        def stepped():
            n[0] += 1
            if n[0] == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            return step()
        engine.step = stepped
        return simulate(engine, arrivals, **kw)
    monkeypatch.setattr(cli, "simulate", sim)
    cli.main(["--smoke", "--device", "cpu", "--requests", "4", "--slots",
              "2", "--prompt-len", "32", "--gen", "200", "--prefix-cache-mb",
              "8", "--prefix-cache-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "SIGTERM: drained 2 decoding slot(s)" in out, out
    assert "2 checkpoint file(s) persisted" in out, out
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs
             if f.startswith("ckpt-")]
    assert len(files) == 2


# -- the slice against the JAX package ------------------------------------


def test_kill_fleet_matches_the_reference_replica_set():
    """The port's kill@5:r0 polysketch fleet against the reference's
    ReplicaSet, one seeded port init bridged to the reference's tree (one
    layer: the reference compiles every entry point once per engine):
    tokens equal, log-probabilities within 1e-4, and the same deaths,
    failovers, checkpoints and recovered installs."""
    cfg = get_config("gpt2s-polysketch", smoke=True, n_layers=1)
    tm = build_model(cfg, device="cpu", seed=0)
    jcfg = jax_get_config("gpt2s-polysketch", smoke=True, n_layers=1)
    jm = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))[0])
    flat = params_to_jax(tm.lm)
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jax.numpy.asarray(np.array(flat[p])) for p in tree_paths(shapes)])
    prompts, _ = _workload(cfg)
    kw = dict(n_replicas=2, slots=2, max_len=128, logprobs=True,
              overlap=True)
    jrs = ref.ReplicaSet(jm, jcfg, params, prefix_cache=ref.PrefixCache(1 << 28),
                         chaos=ref.ChaosInjector("kill@5:r0"), **kw)
    jg = [jrs.submit(p, STEPS, sampling=ref.SamplingParams(**s))
          for p, s in zip(prompts, SAMPLING)]
    jouts = {o.rid: o for o in jrs.run()}
    rs = ReplicaSet(tm, prefix_cache=PrefixCache(1 << 28),
                    chaos=ChaosInjector("kill@5:r0"), **kw)
    g = [rs.submit(p, STEPS, sampling=SamplingParams(**s))
         for p, s in zip(prompts, SAMPLING)]
    outs = {o.rid: o for o in rs.run()}
    for a, b in zip(g, jg):
        assert np.array_equal(outs[a].tokens, jouts[b].tokens), a
        np.testing.assert_allclose(outs[a].logprobs, jouts[b].logprobs,
                                   atol=LP_TOL, rtol=0)
    st, jst = rs.stats(), jrs.stats()
    for key in ("deaths", "failovers", "checkpoints", "recovered_installs",
                "checkpoints_dropped", "duplicate_outputs"):
        assert st[key] == jst[key], key
    assert st["deaths"] == {"kill": 1} and st["checkpoints"] >= 1
