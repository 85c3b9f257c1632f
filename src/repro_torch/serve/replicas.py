"""Replicated serving: N ServeEngines behind one coordinator, with
checkpointed failover that is bit-identical to the fault-free run.

The port of the JAX package's ``serve/replicas.py``. The paper's
constant-size decode state is what makes replica failover cheap enough to
run synchronously: a slot's whole state is a snapshot of fixed size
(r^2 x (h+1) per kv head for polysketch, the recurrent state for SSD and
RG-LRU), so the coordinator checkpoints every decoding slot at block
boundaries into the shared ``PrefixCache``'s side store for one small
device-to-host copy: no paged KV migration, no O(context) transfer. When a
replica dies, each of its in-flight requests moves to a survivor, which
restores the deepest usable checkpoint, replays the few tokens past it
through the live tick's decode step and continues; the stream is the bits
the dead replica would have emitted (``ServeEngine._install_recovery``
holds that contract, tests/test_torch_replicas.py checks it per state
family). A state with no snapshot (the KV caches of exact polynomial and
softmax attention) recovers from a cold prefill and a full replay.

The coordinator:
  - routes `submit()` to the least-loaded live replica (global request
    ids; a replica's own rid is internal),
  - keeps a host mirror of every live request's token stream, the
    recovery's source of truth, advanced only on a replica's SUCCESSFUL
    tick: a dying tick's outputs are dropped whole (no token is reported
    twice, none is lost),
  - checkpoints decoding slots on the block grid (x `checkpoint_blocks`),
  - watches each replica's ticks: a `StragglerDetector` each (z-score
    flags, eviction after `evict_after_flags`), an optional hang timeout,
    heartbeats,
  - sheds load: `submit()` raises `Overloaded` past
    `shed_above x live replicas` outstanding requests,
  - arms a `ChaosInjector` (serve/chaos.py) for fault drills.

Each replica runs on its own ServePlan (`replica_plans`): its own card
when there are as many as replicas, else all on one device, where the
replicas are fault-isolation units of the coordinator's bookkeeping.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace

import numpy as np
import torch

from repro_torch.distributed.fault import StragglerDetector
from repro_torch.serve.chaos import ChaosInjector, ReplicaKilled
from repro_torch.serve.engine import (RecoveredRequest, RequestOutput,
                                      ServeEngine)
from repro_torch.serve.plan import ServePlan, default_device
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.telemetry import Telemetry


class Overloaded(RuntimeError):
    """submit() refused: the fleet is past its load-shedding threshold."""


def replica_plans(n_replicas: int, *, device=None) -> list[ServePlan]:
    """One single-device ServePlan per replica. A model on a card (`device`
    a CUDA device; default: the current card, else the CPU) spreads its
    replicas over `cuda:0..n-1` when there are at least as many cards as
    replicas, each a fault domain of its own; otherwise, and always for a
    model on the CPU, every replica serves on `device`."""
    device = default_device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_replicas:
        return [ServePlan.single_device(torch.device("cuda", i))
                for i in range(n_replicas)]
    return [ServePlan.single_device(device) for _ in range(n_replicas)]


@dataclass
class _GReq:
    """The coordinator's mirror of one live request: what re-creates it on
    a survivor, advanced only on successful ticks."""
    grid: int
    prompt: np.ndarray
    max_new: int
    eos: int | None
    sampling: SamplingParams
    submit_time: float
    replica: int
    lrid: int                       # its rid on its current engine
    emitted: list[int] = field(default_factory=list)
    lps: list[float] = field(default_factory=list)
    ttft_s: float = 0.0
    ckpt_pos: int = 0               # deepest checkpointed stream depth
    recovered: int = 0              # failovers survived


class ReplicaSet:
    """N replicated ServeEngines of one model, one shared PrefixCache,
    bit-exact failover (module docstring). The surface is a single
    engine's: `submit` / `step` / `run` / `busy` / `stats` /
    `reset_stats`, with global request ids. `model` is a model_zoo.Model;
    a replica whose plan names another device serves a copy of it there."""

    def __init__(self, model, *, n_replicas: int = 2, slots: int = 4,
                 max_len: int = 4096,
                 prefix_cache: PrefixCache | None = None,
                 min_snapshot_blocks: int = 1,
                 logprobs: bool = False,
                 prefill_budget: int | None = None,
                 overlap: bool = False,
                 checkpoint_blocks: int = 1,
                 hang_timeout_s: float | None = None,
                 shed_above: int | None = None,
                 evict_after_flags: int | None = None,
                 chaos: ChaosInjector | None = None,
                 telemetry: Telemetry | None = None):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        if checkpoint_blocks < 1:
            raise ValueError("checkpoint_blocks must be >= 1")
        self.n = n_replicas
        self.cache = prefix_cache
        self.checkpoint_blocks = checkpoint_blocks
        self.hang_timeout_s = hang_timeout_s
        self.shed_above = shed_above
        self.evict_after_flags = evict_after_flags
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.chaos = chaos
        plans = replica_plans(n_replicas, device=model.device)
        self.engines: list[ServeEngine | None] = [
            ServeEngine(model, slots=slots, max_len=max_len,
                        prefix_cache=prefix_cache,
                        min_snapshot_blocks=min_snapshot_blocks,
                        logprobs=logprobs, prefill_budget=prefill_budget,
                        overlap=overlap, plan=plan)
            for plan in plans]
        self._alive = [True] * n_replicas
        self._ticks = [0] * n_replicas
        self._beats = [time.monotonic()] * n_replicas
        self._stragglers = [StragglerDetector() for _ in range(n_replicas)]
        # a survivor's next tick after a recovery install may meet new
        # signatures (a kernel library's first load on its card): that one
        # tick is exempt from the hang deadline and the straggler window,
        # or one failover could cascade through the fleet
        self._grace: set[int] = set()
        self._live: dict[int, _GReq] = {}            # grid -> mirror
        self._rmap: dict[tuple[int, int], int] = {}  # (replica, lrid) -> grid
        self._done: set[int] = set()
        self._next_grid = 0
        self.finished: list[RequestOutput] = []
        self._deaths: dict[str, int] = {}
        self._n_failovers = 0
        self._n_ckpts = 0
        self._n_ckpt_dropped = 0
        self._n_shed = 0
        self._n_dups = 0               # dedup guard trips (must stay 0)
        self._n_sampled = 0
        # "replica i tick t: cause" of every death in a tick where the
        # chaos schedule fired nothing (a crash, with its error, or a real
        # hang or straggler): what a drill must not see
        self.unarmed_deaths: list[str] = []

        if chaos is not None:
            chaos.arm(n_replicas)
            hook = chaos.io_fault_hook()
            if hook is not None and prefix_cache is not None:
                prefix_cache.io_fault = hook

        reg = self.telemetry.registry
        reg.counter("serve_replica_deaths_total", "replica deaths",
                    fn=lambda: float(sum(self._deaths.values())))
        reg.counter("serve_replica_failovers_total",
                    "requests re-homed after a replica death",
                    fn=lambda: float(self._n_failovers))
        reg.counter("serve_replica_checkpoints_total",
                    "slot checkpoints written to the shared cache",
                    fn=lambda: float(self._n_ckpts))
        reg.counter("serve_replica_shed_total",
                    "submissions refused by the load-shedding gate",
                    fn=lambda: float(self._n_shed))
        reg.gauge("serve_replicas_alive", "live replicas",
                  fn=lambda: float(sum(self._alive)))
        reg.gauge("serve_replica_outstanding", "live requests fleet-wide",
                  fn=lambda: float(len(self._live)))
        tr = self.telemetry.tracer
        if tr:
            for i in range(n_replicas):
                # lifetime span: open while the replica lives (export tags
                # it `unterminated`), ended at its death
                tr.begin(f"replica{i}", "replica", mesh=plans[i].describe(),
                         device=str(plans[i].device))

    # -- routing -----------------------------------------------------------

    def _outstanding(self, i: int) -> int:
        return sum(g.replica == i for g in self._live.values())

    def _least_loaded(self) -> int:
        cands = [i for i in range(self.n) if self._alive[i]]
        if not cands:
            raise RuntimeError("all replicas dead")
        return min(cands, key=lambda i: (self._outstanding(i), i))

    def submit(self, prompt, max_new_tokens: int, eos_id: int | None = None,
               sampling: SamplingParams | None = None) -> int:
        """Enqueue on the least-loaded live replica; returns the GLOBAL
        request id. Raises `Overloaded` past the shedding threshold (the
        caller owns backpressure: retry later, or refuse upstream)."""
        if self.shed_above is not None:
            limit = self.shed_above * sum(self._alive)
            if len(self._live) >= limit:
                self._n_shed += 1
                tr = self.telemetry.tracer
                if tr:
                    tr.instant("queue", "shed", outstanding=len(self._live),
                               limit=limit)
                raise Overloaded(
                    f"{len(self._live)} outstanding >= shed limit {limit} "
                    f"({self.shed_above} x {sum(self._alive)} live replicas)")
        i = self._least_loaded()
        if torch.is_tensor(prompt):
            prompt = prompt.detach().cpu().numpy()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        sp = sampling or SamplingParams()
        lrid = self.engines[i].submit(prompt, max_new_tokens, eos_id, sp)
        grid = self._next_grid
        self._next_grid += 1
        self._n_sampled += sp.temperature > 0
        self._live[grid] = _GReq(grid=grid, prompt=prompt,
                                 max_new=max_new_tokens, eos=eos_id,
                                 sampling=sp,
                                 submit_time=time.perf_counter(), replica=i,
                                 lrid=lrid)
        self._rmap[(i, lrid)] = grid
        return grid

    # -- checkpointing -----------------------------------------------------

    @staticmethod
    def _tag(grid: int) -> bytes:
        # failover checkpoints are keyed per REQUEST, never by content: a
        # decode-produced state is not bitwise a prefill-produced one, so
        # they stay out of the content-addressed prefix keyspace (the
        # PrefixCache's side store)
        return hashlib.sha256(b"psk-ckpt:%d" % grid).digest()

    def _checkpoint(self, i: int, tick: int):
        eng = self.engines[i]
        if self.cache is None or eng.state.snapshot_granularity is None:
            return
        grid_step = eng.state.block_size * self.checkpoint_blocks
        for si, slot in enumerate(eng._slots):
            if not slot.decoding:
                continue
            grid = self._rmap.get((i, slot.request.rid))
            g = self._live.get(grid) if grid is not None else None
            if g is None:
                continue
            covered = eng.slot_covered(si)
            if covered % grid_step != 0 or covered <= g.ckpt_pos:
                continue
            if self.chaos is not None and self.chaos.drops_snapshot(i, tick):
                self._n_ckpt_dropped += 1
                continue
            snap = eng.snapshot_slot(si)
            if snap is None:
                continue
            self.cache.put_ckpt(self._tag(g.grid), covered, snap[0])
            g.ckpt_pos = covered
            self._n_ckpts += 1
            tr = self.telemetry.tracer
            if tr:
                tr.instant(f"replica{i}", "checkpoint", grid=g.grid,
                           n_tokens=covered, tick=tick)

    # -- failure handling --------------------------------------------------

    def _fail(self, i: int, cause: str):
        """Replica i is dead: drop it whole (its unmirrored tick never
        happened) and re-home every request it owned onto the survivors."""
        self._alive[i] = False
        self._beats[i] = time.monotonic()
        self._deaths[cause] = self._deaths.get(cause, 0) + 1
        tr = self.telemetry.tracer
        if tr:
            tr.instant(f"replica{i}", "replica_dead", cause=cause)
            tr.end(f"replica{i}", cause=cause)  # the lifetime span
        victims = sorted((g for g in self._live.values() if g.replica == i),
                         key=lambda g: g.grid)
        # release the dead engine's device state before recovery prefills
        self.engines[i] = None
        if not any(self._alive):
            raise RuntimeError(
                f"all {self.n} replicas dead (last cause: {cause}); "
                f"{len(victims)} requests unrecoverable")
        for g in victims:
            self._rmap.pop((i, g.lrid), None)
            j = self._least_loaded()
            k = len(g.emitted)
            ckpt, ck_n = None, 0
            if self.cache is not None and k > 0:
                got = self.cache.get_ckpt(
                    self._tag(g.grid),
                    max_tokens=int(g.prompt.shape[0]) + k - 1)
                if got is not None:
                    ckpt, ck_n = got
            rec = RecoveredRequest(
                prompt=g.prompt, emitted=list(g.emitted), lps=list(g.lps),
                max_new_tokens=g.max_new, eos_id=g.eos, sampling=g.sampling,
                submit_time=g.submit_time, ttft_s=g.ttft_s,
                snapshot=ckpt, snap_tokens=ck_n)
            if tr:
                tr.begin(f"replica{j}", "recover", grid=g.grid,
                         emitted=k, from_ckpt=ck_n)
            lrid = self.engines[j].admit_recovered(rec)
            if tr:
                tr.end(f"replica{j}")
                tr.instant(f"replica{j}", "failover", grid=g.grid,
                           from_replica=i)
            g.replica, g.lrid = j, lrid
            g.recovered += 1
            self._rmap[(j, lrid)] = g.grid
            self._n_failovers += 1
            self._grace.add(j)

    # -- the coordinator tick ----------------------------------------------

    def step(self) -> list[RequestOutput]:
        """One tick of every live replica. A replica that raises, hangs
        past `hang_timeout_s`, or trips the straggler eviction dies HERE,
        and its requests fail over before the method returns: the caller
        never sees a lost request, only (in time) its outputs under their
        global ids."""
        done: list[RequestOutput] = []
        for i in range(self.n):
            if not self._alive[i]:
                continue
            eng = self.engines[i]
            tick = self._ticks[i]
            seen = sum(eng.telemetry.watchdog.cache_sizes().values())
            fired = len(self.chaos.fired) if self.chaos is not None else 0
            t0 = time.perf_counter()
            try:
                if self.chaos is not None:
                    self.chaos.before_tick(i, tick)
                outs = eng.step()
            except Exception as e:  # noqa: BLE001 -- any tick failure is a death
                if not isinstance(e, ReplicaKilled):
                    self.unarmed_deaths.append(
                        f"replica {i} tick {tick}: crash {e!r}")
                self._fail(i, "kill" if isinstance(e, ReplicaKilled)
                           else "crash")
                continue
            dt = time.perf_counter() - t0
            injected = (self.chaos is not None
                        and len(self.chaos.fired) > fired)
            self._ticks[i] += 1
            # a tick that met a new signature or built a kernel library
            # spent its time on that: a cold start is not a hang and must
            # not poison the straggler window
            grew = sum(eng.telemetry.watchdog.cache_sizes().values()) > seen
            graced = (i in self._grace) or grew
            self._grace.discard(i)
            if (self.hang_timeout_s is not None and not graced
                    and dt > self.hang_timeout_s):
                # the tick finished but blew the deadline: a hang death;
                # its outputs are dropped (the mirror was not advanced, so
                # recovery regenerates exactly these tokens)
                if not injected:
                    self.unarmed_deaths.append(
                        f"replica {i} tick {tick}: hang {dt:.3f} s")
                self._fail(i, "hang")
                continue
            slow = False if graced else self._stragglers[i].observe(dt)
            if (slow and self.evict_after_flags is not None
                    and len(self._stragglers[i].flagged)
                    >= self.evict_after_flags):
                if not injected:
                    self.unarmed_deaths.append(
                        f"replica {i} tick {tick}: straggler {dt:.3f} s")
                self._fail(i, "straggler")
                continue
            self._beats[i] = time.monotonic()
            # SUCCESS: advance the mirror (the engine's host view is never
            # behind it: a recovered slot starts from the mirror's tokens),
            # checkpoint, then report finished requests by global id
            for entry in eng.live_requests():
                grid = self._rmap.get((i, entry["rid"]))
                g = self._live.get(grid) if grid is not None else None
                if g is None or len(entry["emitted"]) < len(g.emitted):
                    continue
                g.emitted = entry["emitted"]
                g.lps = entry["lps"]
                if entry["ttft_s"]:
                    g.ttft_s = entry["ttft_s"]
            self._checkpoint(i, tick)
            for o in outs:
                grid = self._rmap.pop((i, o.rid), None)
                if grid is None or grid in self._done:
                    self._n_dups += 1
                    continue
                self._live.pop(grid, None)
                self._done.add(grid)
                if self.cache is not None:
                    self.cache.drop_ckpt(self._tag(grid))
                out = dc_replace(o, rid=grid)
                self.finished.append(out)
                done.append(out)
        self.telemetry.on_tick()
        return done

    @property
    def busy(self) -> bool:
        return bool(self._live) or any(
            self._alive[i] and self.engines[i].busy for i in range(self.n))

    def run(self) -> list[RequestOutput]:
        out = []
        while self.busy:
            out.extend(self.step())
        return out

    # -- drain / accounting ------------------------------------------------

    def drain_checkpoints(self) -> list[str]:
        """Graceful-shutdown persistence (the SIGTERM path): each live
        replica stops admissions and runs at most one block of extra ticks
        so that every decoding slot reaches a snapshot boundary
        (ServeEngine.drain_checkpoints); the shared side store is then
        flushed to the cache's disk tier once. Returns the paths written."""
        for i in range(self.n):
            if self._alive[i]:
                self.engines[i].drain_checkpoints(
                    tag_ns=b"psk-drain:%d" % i, flush=False)
        if self.cache is not None and self.cache.save_dir is not None:
            return self.cache.flush_ckpts_to_disk()
        return []

    def reset_stats(self):
        """Zero the accounting after a warm-up, as ServeEngine.reset_stats
        does (each live engine's watchdog arms)."""
        self.finished = []
        self._done = set()
        self._deaths = {}
        self._n_failovers = self._n_ckpts = self._n_ckpt_dropped = 0
        self._n_shed = self._n_dups = self._n_sampled = 0
        self.telemetry.reset()
        for i in range(self.n):
            if self._alive[i]:
                self.engines[i].reset_stats()

    @property
    def n_active(self) -> int:
        """Decoding slots across the live replicas."""
        return sum(self.engines[i].n_active
                   for i in range(self.n) if self._alive[i])

    def stats(self) -> dict:
        """A single engine's stats keys, for the fleet, then the replica
        keys. Request counts, tokens and TTFT come from the coordinator
        (they survive a death); rates, ITL and scheduler counts from the
        live replicas; `tick_gap_ms` is the live replica's whose p95 is the
        most times its median (a stall gate on it holds every replica)."""
        live = [i for i in range(self.n) if self._alive[i]]
        engs = {i: self.engines[i].stats() for i in live}
        gen_tokens = (sum(len(o.tokens) for o in self.finished)
                      + sum(len(g.emitted) for g in self._live.values()))
        itl = [v for i in live for v in self.engines[i].telemetry.registry
               .get("serve_itl_ms").window]
        ttft = [o.ttft_s * 1e3 for o in self.finished]

        def pcts(xs):
            return {f"p{p}": float(np.percentile(xs, p)) if xs else 0.0
                    for p in (50, 95, 99)}

        def stall(e):
            gap = e["tick_gap_ms"]
            return gap["p95"] / gap["median"] if gap["median"] > 0 else 0.0
        gaps = {i: e["tick_gap_ms"] for i, e in engs.items()}
        worst = max(live, key=lambda i: stall(engs[i]), default=None)
        sched = [e["scheduler"] for e in engs.values()]
        sigs = [e["signatures"] for e in engs.values()]
        return {
            "requests": len(self.finished),
            "active_requests": len(self._live),
            "generated_tokens": gen_tokens,
            "sampled_requests": self._n_sampled,
            "decode_tok_per_s": sum(e["decode_tok_per_s"]
                                    for e in engs.values()),
            "itl_ms": pcts(itl),
            "ttft_ms": pcts(ttft),
            "tick_gap_ms": (gaps[worst] if worst is not None else
                            {**pcts([]), "median": 0.0, "max": 0.0}),
            # mid-serve retraces on the SURVIVORS (a recovery re-arms its
            # engine's baseline, so growth here is a real hot-path retrace)
            "retraces": sum(e["retraces"] for e in engs.values()),
            "signatures": {k: sum(d.get(k, 0) for d in sigs)
                           for k in sorted({k for d in sigs for k in d})},
            "scheduler": {k: sum(d[k] for d in sched)
                          for k in (sched[0] if sched else ())},
            # the fleet
            "replicas": self.n,
            "alive": len(live),
            "deaths": dict(self._deaths),
            "unarmed_deaths": list(self.unarmed_deaths),
            "failovers": self._n_failovers,
            "checkpoints": self._n_ckpts,
            "checkpoints_dropped": self._n_ckpt_dropped,
            "shed": self._n_shed,
            "duplicate_outputs": self._n_dups,  # must stay 0
            "recovered_installs": sum(e["recovered"] for e in engs.values()),
            "straggler_flags": [len(self._stragglers[i].flagged)
                                for i in range(self.n)],
            "heartbeat_age_s": [round(time.monotonic() - b, 3)
                                for b in self._beats],
            "tick_gaps_ms": gaps,
            "engines": engs,
        }


__all__ = ["Overloaded", "ReplicaSet", "replica_plans"]
