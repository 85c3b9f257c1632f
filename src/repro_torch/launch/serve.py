"""Serving CLI of the port: continuous batching under timed arrivals.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2s-polysketch \
        --requests 8 --slots 4 --prompt-len 2048 --gen 32 --rate 4
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --requests 6 --slots 2 --prompt-len 40 --gen 12 --rate 10 --eos-id 8

Port of the JAX package's ``launch/serve.py`` (``simulate`` and ``main``)
for the flags the port covers. The model is built from the port's seeded
init (`--seed`); `--requests` prompts are drawn with numpy from `--seed`,
their lengths from three buckets (prompt-len / 2, 3/4 and 1), and arrive
as a Poisson process of `--rate` a second (0: all at t = 0). Each request
is served by ``serve.engine.ServeEngine``; the run prints one line a
request (tokens, finish reason, TTFT, latency) and the aggregate
throughput and TTFT / latency percentiles.

Sampled workload (temperature / top-k / top-p; with --seed-per-request
request i samples with seed --seed + i):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --temperature 0.8 --top-k 40 --top-p 0.95 --seed-per-request

Overlapped chunked admission: --overlap --prefill-budget 64 (with
--max-tick-gap-ratio R the run fails if the decode tick gap's p95 passes
R times its median).

Shared-system-prompt workload (every request shares an N-token prefix
and diverges after it) through the prefix-reuse snapshot cache, persisted
under a directory (a second run with --expect-disk-hits warms from it):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --requests 8 --prompt-len 96 --shared-prefix 64 --prefix-cache-mb 8 \
        --prefix-cache-dir /tmp/psk-cache

Observability (serve/telemetry.py): --trace-out writes a schema-validated
Chrome trace of the run (tick phases, per-slot request timelines, cache
events; open at ui.perfetto.dev), --metrics-out the Prometheus text of
the engine's registry, --log-events prints every event as recorded.
--warm serves warm-up requests first and arms the retrace watchdog;
--expect-no-retraces then fails the run if an entry point met a new call
signature (or a kernel library was built) mid-serve:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --requests 8 --overlap --prefill-budget 64 --warm \
        --trace-out /tmp/serve-trace.json --metrics-out /tmp/serve.prom \
        --expect-no-retraces

The registry's dense polysketch models (head width 128, bf16):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --draw-on-device --prompt-len 4096 --gen 16 --slots 2 --requests 4

(`--layers N` cuts the depth, as yi-34b needs on one 80 GB card.)

Replicated serving (serve/replicas.py): --replicas N engines behind one
coordinator with checkpointed failover, a seeded --chaos schedule (kill,
hang, slow-tick, drop-snapshot, disk-flake; serve/chaos.py), load
shedding (--shed-above), a hang deadline (--hang-timeout) and the
checkpoint grid (--checkpoint-blocks). The failover gate: a run under
chaos writes the fault-free run's --tokens-out file exactly:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --replicas 2 --logprobs --tokens-out /tmp/a.json
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --replicas 2 --chaos kill@6 --logprobs --tokens-out /tmp/b.json

A SIGTERM after the flushed `serving:` line stops admissions, drains
every decoding slot to a checkpoint (written under --prefix-cache-dir)
and exits 0.

The recurrent families (mamba2's SSD; recurrentgemma's RG-LRU and
sliding-window attention, bf16), with or without the prefix cache:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --smoke \
        --device cpu --shared-prefix 24 --prefix-cache-mb 8 --block-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --draw-on-device --prompt-len 4096 --gen 16 --slots 2 --requests 4

The mixture-of-experts models (bf16, f32 weights cast on use), dbrx cut
to the 5 of its 40 layers and llama4-maverick to the one (GLU, MoE)
cycle of its 48 that an 80 GB card holds:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b --smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
        --draw-on-device --layers 5 --prompt-len 4096 --gen 16 --slots 2 --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-maverick-400b-a17b --draw-on-device --layers 2

Serving over a D x M mesh (--mesh DxM, one process a rank started by
torchrun, which sets the ranks): the slots split over "data", the heads
over "model", with --shard-model the weights PARAM_RULES names too
(serve/plan.py). Every rank runs the same loop over the same arrivals
(rank 0 decides when each arrives); rank 0 prints and writes
--tokens-out, whose tokens and log-probabilities a 1x1 run's file should
match. On a one-card machine --share-card runs the ranks on that card
over gloo (a test harness, never chosen on its own):

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --smoke \
        --device cpu --mesh 2x2 --shard-model --logprobs --tokens-out /tmp/m.json
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 1x2 \
        --shard-model --share-card --prompt-len 2048 --gen 16
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.fault import PreemptionGuard
from repro_torch.launch.mesh import init_ranks, make_serving_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.chaos import ChaosInjector
from repro_torch.serve.engine import ServeEngine, generate
from repro_torch.serve.plan import ServePlan
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.replicas import Overloaded, ReplicaSet
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.telemetry import Telemetry, format_event, validate_trace

def _percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else 0.0


def control_group():
    """A gloo group over every rank for the host loop's agreements: the
    default group when it is gloo already (the CPU, ranks sharing a card),
    else a new one beside NCCL. Every rank calls it at the same point."""
    return None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")


def agree(values: list[int], group) -> list[int]:
    """The largest of each of `values` over every rank: one all-reduce of
    host integers (no device sync)."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def simulate(engine, arrivals, *, quiet=False, guard=None):
    """Drive the engine under timed arrivals.

    arrivals: list of (arrival_s, prompt, max_new_tokens, eos_id, sampling)
    sorted by arrival time. A request is submitted when the wall clock
    passes its arrival offset and admitted at the next engine tick; live
    slots are never re-prefilled or reset by an admission. `engine` may be
    a ReplicaSet (the same surface): a shed submission (Overloaded) is
    retried shortly later, so every request is served. With a
    PreemptionGuard, a SIGTERM stops admissions and ends the loop (the
    caller drains). On a multi-device plan every rank runs this loop:
    while arrivals remain, the ranks agree each tick on how many to
    submit (the most any rank's clock has passed) and on whether any rank
    was preempted, in one all-reduce of host integers (`agree`), so every
    rank submits the same requests at the same tick and stops at the same
    tick. After the last admission the loop takes no collective of its
    own and the guard is left to the caller (`agree` again), which keeps
    the engine's one host sync a tick. Returns (outputs in completion
    order, wall seconds)."""
    pending = list(arrivals)
    outs = []
    plan = getattr(engine, "plan", None)
    spmd = plan is not None and plan.n_devices > 1
    group = control_group() if spmd else None
    t0 = time.perf_counter()
    while pending or engine.busy:
        now = time.perf_counter() - t0
        stop = guard is not None and guard.preempted
        if spmd and pending:
            due, stop = agree([sum(1 for a in pending if a[0] <= now), stop], group)
            if not stop:
                for _ in range(due):
                    _, prompt, gen, eos, sampling = pending.pop(0)
                    engine.submit(prompt, gen, eos, sampling=sampling)
        elif spmd:
            stop = False
        if stop:
            guard.preempted = True   # agreed: a rank that saw no SIGTERM drains too
            pending.clear()
            break
        while not spmd and pending and pending[0][0] <= now:
            item = pending[0]
            _, prompt, gen, eos, sampling = item
            try:
                engine.submit(prompt, gen, eos, sampling=sampling)
            except Overloaded:
                # load shed: back off and retry this arrival shortly
                pending[0] = (now + 0.05,) + tuple(item[1:])
                pending.sort(key=lambda x: x[0])
                break
            pending.pop(0)
        if engine.busy:
            for out in engine.step():
                outs.append(out)
                if not quiet:
                    print(f"  req{out.rid}: len={out.prompt_len} "
                          f"+{len(out.tokens)} tok ({out.finish_reason}) "
                          f"ttft={out.ttft_s * 1e3:.0f}ms "
                          f"latency={out.latency_s * 1e3:.0f}ms")
        elif pending:
            time.sleep(min(0.005, max(0.0, pending[0][0] - now)))
    return outs, time.perf_counter() - t0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2s-polysketch",
                    help="a registered config: gpt2s-polysketch, deepseek-7b, "
                         "starcoder2-3b, qwen3-14b, yi-34b, mamba2-780m, "
                         "recurrentgemma-9b, dbrx-132b, "
                         "llama4-maverick-400b-a17b, llava-next-mistral-7b "
                         "(token-only prompts); the engine refuses "
                         "whisper-large-v3 (no decode state, as in the "
                         "reference)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (for the CPU)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's)")
    ap.add_argument("--draw-on-device", action="store_true",
                    help="draw the seeded weights on the device (seconds for "
                         "billions of weights; other values than the CPU draw)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="mean request arrivals per second (Poisson); "
                         "0 = all requests queued at t=0")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop generation at this token id (-1 = never)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling threshold (1.0 = off)")
    ap.add_argument("--seed-per-request", action="store_true",
                    help="request i samples with seed --seed+i; default: "
                         "all share --seed")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of a prompt prefix shared by all requests "
                         "(system-prompt workload); 0 = independent prompts")
    ap.add_argument("--prefix-cache-mb", type=float, default=0.0,
                    help="prefix-reuse snapshot cache budget in MiB "
                         "(0 = cache off)")
    ap.add_argument("--prefix-cache-dir", default=None,
                    help="persist prefix-cache snapshots under this "
                         "directory (survives restarts)")
    ap.add_argument("--min-snapshot-blocks", type=int, default=1,
                    help="prefix-cache admission floor: only snapshot "
                         "prefixes of at least this many blocks")
    ap.add_argument("--expect-disk-hits", action="store_true",
                    help="exit non-zero unless at least one snapshot was "
                         "loaded from --prefix-cache-dir (restart smoke)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="override cfg.lt_block_size (the resumed-prefill "
                         "grid); 0 = config default")
    ap.add_argument("--overlap", action="store_true",
                    help="pipeline admission prefill with the decode tick "
                         "(tokens read one tick late; the same tokens)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max admission-prefill tokens dispatched per "
                         "decode tick (0 = unlimited)")
    ap.add_argument("--max-tick-gap-ratio", type=float, default=0.0,
                    help="exit non-zero if the decode tick gap's p95 passes "
                         "this multiple of its median (0 = no gate)")
    ap.add_argument("--logprobs", action="store_true",
                    help="report per-token log-probabilities of the "
                         "emitted tokens (computed in the decode tick)")
    ap.add_argument("--tokens-out", default=None,
                    help="write every request's emitted tokens (and "
                         "logprobs with --logprobs) as JSON keyed by rid")
    ap.add_argument("--trace-out", default=None,
                    help="write a schema-validated Chrome trace of the run "
                         "(open at ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine's metrics as Prometheus text")
    ap.add_argument("--log-events", action="store_true",
                    help="print every telemetry event as it is recorded "
                         "(implies tracing; verbose)")
    ap.add_argument("--warm", action="store_true",
                    help="serve warm-up requests of the workload's shapes "
                         "and reset the stats before the timed run: the "
                         "retrace watchdog arms")
    ap.add_argument("--expect-no-retraces", action="store_true",
                    help="exit non-zero if an entry point met a new call "
                         "signature, or a kernel library was built, "
                         "mid-serve (needs --warm)")
    ap.add_argument("--mesh", default="1x1", metavar="DxM",
                    help="serving mesh as data x model device counts, one "
                         "process a rank (torchrun sets the ranks)")
    ap.add_argument("--shard-model", action="store_true",
                    help="tensor-parallel parameters over the mesh's 'model' "
                         "axis (the weights PARAM_RULES names)")
    ap.add_argument("--share-card", action="store_true",
                    help="with --mesh beyond 1x1 on CUDA: every rank on one card "
                         "over gloo (a test harness; never chosen on its own)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through N replicated engines behind one "
                         "coordinator with checkpointed bit-exact failover "
                         "(0 = one engine); each replica on its own card "
                         "when there are enough")
    ap.add_argument("--chaos", default="none", metavar="SPEC",
                    help="fault schedule for --replicas, e.g. kill@12, "
                         "hang@8:r1:s0.6, slow-tick@5:x8, drop-snapshot@0, "
                         "disk-flake@0:x2; comma-joined; 'none' disables "
                         "(see serve/chaos.py)")
    ap.add_argument("--shed-above", type=int, default=0,
                    help="refuse submissions past this many outstanding "
                         "requests a live replica (0 = off); shed arrivals "
                         "are retried, so every request is still served")
    ap.add_argument("--hang-timeout", type=float, default=0.0,
                    help="declare a replica dead when a tick takes longer "
                         "than this many seconds (0 = off); the tick is "
                         "dropped and its requests fail over")
    ap.add_argument("--checkpoint-blocks", type=int, default=1,
                    help="checkpoint decoding slots every N state blocks "
                         "(the failover's restore grid)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.expect_no_retraces and not args.warm:
        raise SystemExit("--expect-no-retraces requires --warm (without a "
                         "warm-up every signature is new, so the gate would "
                         "be vacuous)")
    replica_mode = args.replicas > 0
    if args.chaos not in ("", "none") and not replica_mode:
        raise SystemExit("--chaos needs --replicas (faults are injected "
                         "per replica)")
    if replica_mode and (args.mesh != "1x1" or args.shard_model):
        raise SystemExit("--replicas places each replica itself; drop "
                         f"--mesh/--shard-model (replicas on a multi-device "
                         f"plan: {tp.REFUSALS_ITEM})")
    try:
        mesh_d, mesh_m = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DxM (e.g. 1x1), got {args.mesh!r}")
    if mesh_d * mesh_m == 1:
        if args.share_card:
            raise SystemExit("--share-card goes with --mesh beyond 1x1")
        return _serve(args, argv, None, args.device)
    device, owned = init_ranks(args.device, share_card=args.share_card)
    try:
        try:
            mesh = make_serving_mesh(mesh_d * mesh_m, mesh_m, device.type)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from None
        plan = ServePlan.from_mesh(mesh, shard_model=args.shard_model, device=device)
        # rank 0 prints; the others run silent
        quiet = (contextlib.redirect_stdout(io.StringIO()) if dist.get_rank()
                 else contextlib.nullcontext())
        with quiet:
            return _serve(args, argv, plan, device)
    finally:
        if owned:
            dist.destroy_process_group()


def _serve(args, argv, plan, device):
    """main's run on `plan` (None: one device) on `device`."""
    replica_mode = args.replicas > 0
    overrides = {"lt_block_size": args.block_size} if args.block_size else {}
    if args.layers:
        overrides["n_layers"] = args.layers
    cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    model = build_model(cfg, device=device, seed=args.seed,
                        draw_on_device=args.draw_on_device)
    cache_dir = args.prefix_cache_dir
    if cache_dir and plan is not None:
        # every rank holds the same whole snapshots: a directory each
        cache_dir = os.path.join(cache_dir, f"rank{dist.get_rank()}")
    prefix_cache = (PrefixCache(int(args.prefix_cache_mb * 2 ** 20),
                                save_dir=cache_dir)
                    if args.prefix_cache_mb > 0 else None)
    if args.expect_disk_hits and (prefix_cache is None
                                  or args.prefix_cache_dir is None):
        raise SystemExit("--expect-disk-hits needs --prefix-cache-mb and "
                         "--prefix-cache-dir")
    trace_on = bool(args.trace_out or args.log_events)
    telemetry = Telemetry(
        trace=trace_on, memory=bool(trace_on or args.metrics_out),
        on_event=(lambda ev: print(format_event(ev))) if args.log_events
        else None)
    common = dict(slots=args.slots, max_len=args.prompt_len + args.gen,
                  prefix_cache=prefix_cache,
                  min_snapshot_blocks=args.min_snapshot_blocks,
                  logprobs=args.logprobs,
                  prefill_budget=args.prefill_budget or None,
                  overlap=args.overlap, telemetry=telemetry)
    if replica_mode:
        chaos = (ChaosInjector(args.chaos, seed=args.seed)
                 if args.chaos not in ("", "none") else None)
        engine = ReplicaSet(model, n_replicas=args.replicas,
                            checkpoint_blocks=args.checkpoint_blocks,
                            hang_timeout_s=args.hang_timeout or None,
                            shed_above=args.shed_above or None,
                            chaos=chaos, **common)
        armed = (", ".join(s.describe() for s in chaos.armed) if chaos
                 else "none")
        print(f"replicas: {args.replicas} x {args.slots} slots on "
              + ", ".join(sorted({str(e.device) for e in engine.engines}))
              + f" (checkpoint every {args.checkpoint_blocks} block(s), "
              f"shed_above={args.shed_above or 'off'}, "
              f"hang_timeout={args.hang_timeout or 'off'}, chaos: {armed})")
    else:
        engine = ServeEngine(model, plan=plan, **common)
        if plan is not None:
            print(f"mesh: {plan.describe()} ({plan.n_devices} ranks, params "
                  f"{'sharded' if args.shard_model else 'replicated'} over 'model'"
                  + (", sharing one card over gloo" if args.share_card else "") + ")")
    rng = np.random.default_rng(args.seed)
    eos = None if args.eos_id < 0 else args.eos_id
    # a few fixed prompt-length buckets (not a continuum): mixed-length
    # admission with a bounded set of prefill shapes
    buckets = sorted({max(1, args.prompt_len // 2),
                      max(1, 3 * args.prompt_len // 4), args.prompt_len})

    def random_prompt(gen, plen):
        return gen.integers(0, cfg.vocab_size, size=plen).astype(np.int32)

    if args.shared_prefix:
        if not 0 < args.shared_prefix < args.prompt_len:
            raise SystemExit("--shared-prefix must be in (0, prompt_len)")
        shared = rng.integers(0, cfg.vocab_size, size=args.shared_prefix)

        def make_prompt():
            sfx = rng.integers(0, cfg.vocab_size,
                               size=args.prompt_len - args.shared_prefix)
            return np.concatenate([shared, sfx]).astype(np.int32)
    else:
        def make_prompt():
            return random_prompt(rng, int(rng.choice(buckets)))

    sampled = args.temperature > 0
    if not sampled and (args.top_k != 0 or args.top_p != 1.0
                        or args.seed_per_request):
        # temperature 0 is greedy and would silently drop the filters
        raise SystemExit("--top-k/--top-p/--seed-per-request require "
                         "--temperature > 0 (temperature 0 is greedy)")

    def make_sampling(rid):
        return SamplingParams(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed + rid if args.seed_per_request else args.seed)

    if args.warm:
        # warm-up requests of the workload's shapes, from a stream of their
        # own (the workload's prompts are the same with and without
        # --warm); the stats reset after it marks the entry points steady.
        # A shared-prefix workload warms with three requests sharing a
        # warm-only prefix of the same length, so that the promote split
        # and a restore from the cache run too (the JAX CLI warms with one
        # request there and counts the first restore as a retrace)
        wrng = np.random.default_rng(args.seed + 104729)

        def warm_prompts():
            if args.shared_prefix:
                wshared = random_prompt(wrng, args.shared_prefix)
                return [np.concatenate([wshared, random_prompt(
                    wrng, args.prompt_len - args.shared_prefix)])
                    for _ in range(3)]
            return [random_prompt(wrng, n) for n in buckets]

        # each replica warms its own entry points, directly (the
        # coordinator's chaos tick count does not advance), on prompts of
        # its own (the replicas share the prefix cache)
        for eng in (engine.engines if replica_mode else [engine]):
            warm = warm_prompts()
            for p in warm:
                eng.submit(p, min(4, args.gen), None)
            eng.run()
        engine.reset_stats()
        print(f"warm-up: {len(warm)} requests (lengths "
              f"{sorted({len(p) for p in warm})}), watchdog armed")

    t = 0.0
    arrivals = []
    for rid in range(args.requests):
        if args.rate > 0:
            t += float(rng.exponential(1.0 / args.rate))
        arrivals.append((t, make_prompt(), args.gen, eos, make_sampling(rid)))

    dev = model.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def flush_observability():
        if args.trace_out:
            trace = telemetry.export_trace()
            errs = validate_trace(trace)
            if errs:
                raise SystemExit("trace schema violations:\n  "
                                 + "\n  ".join(errs[:10]))
            with open(args.trace_out, "w") as f:
                json.dump(trace, f)
            print(f"trace: {len(trace['traceEvents'])} events -> "
                  f"{args.trace_out} (schema valid; open at ui.perfetto.dev)")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(telemetry.render_prometheus())
            print(f"metrics: {len(telemetry.registry.names())} series -> "
                  f"{args.metrics_out}")

    guard = PreemptionGuard().install()
    # flushed: from this line on a SIGTERM is caught and drains cleanly
    print(f"serving: {cfg.name} on {name}, {args.requests} requests, "
          f"{args.slots} slots, rate={args.rate}/s", flush=True)
    try:
        outs, wall = simulate(engine, arrivals, guard=guard)
    finally:
        guard.uninstall()
    if plan is not None and plan.n_devices > 1:   # every rank drains, or none
        guard.preempted = bool(agree([guard.preempted], control_group())[0])
    if guard.preempted:
        # admissions stopped inside simulate(); persist every decoding
        # slot's state to the disk tier and exit 0 (the SIGTERM contract)
        decoding = engine.n_active
        paths = engine.drain_checkpoints()
        print(f"SIGTERM: drained {decoding} decoding slot(s), {len(outs)} "
              f"requests served, {len(paths)} checkpoint file(s) persisted; "
              "exiting cleanly", flush=True)
        flush_observability()
        return outs
    # a ReplicaSet's stats carry a single engine's keys for the fleet
    stats = engine.stats()
    ttfts = [o.ttft_s for o in outs]
    lats = [o.latency_s for o in outs]
    print(f"served {stats['requests']} requests, "
          f"{stats['generated_tokens']} tokens in {wall:.2f}s "
          f"({stats['generated_tokens'] / wall:.1f} generated tok/s wall, "
          f"{stats['decode_tok_per_s']:.1f} tok/s decode)")
    if replica_mode:
        print(f"fleet: {stats['alive']}/{stats['replicas']} replicas alive, "
              f"deaths={stats['deaths']} "
              f"failovers={stats['failovers']} "
              f"checkpoints={stats['checkpoints']}"
              f"(+{stats['checkpoints_dropped']} chaos-dropped) "
              f"shed={stats['shed']} "
              f"recovered={stats['recovered_installs']} "
              f"straggler_flags={stats['straggler_flags']}")
        # a death the schedule did not cause is a real fault that failover
        # hid: the run fails though every request was served
        if stats["unarmed_deaths"]:
            raise SystemExit("replica deaths the chaos schedule did not "
                             "cause: " + "; ".join(stats["unarmed_deaths"]))
        # across deaths, failovers and shedding, every arrival is served
        # exactly once
        rids = [o.rid for o in outs]
        if (len(outs) != args.requests or len(set(rids)) != len(rids)
                or stats["duplicate_outputs"]):
            raise SystemExit(
                f"lost/duplicated requests: served {len(outs)} of "
                f"{args.requests} (duplicate outputs: "
                f"{stats['duplicate_outputs']})")
    print(f"ttft    p50={_percentile(ttfts, 50) * 1e3:.0f}ms "
          f"p95={_percentile(ttfts, 95) * 1e3:.0f}ms "
          f"p99={_percentile(ttfts, 99) * 1e3:.0f}ms")
    print(f"latency p50={_percentile(lats, 50) * 1e3:.0f}ms "
          f"p95={_percentile(lats, 95) * 1e3:.0f}ms "
          f"p99={_percentile(lats, 99) * 1e3:.0f}ms")
    itl, gap = stats["itl_ms"], stats["tick_gap_ms"]
    print(f"itl     p50={itl['p50']:.1f}ms p95={itl['p95']:.1f}ms "
          f"p99={itl['p99']:.1f}ms")
    sch = stats["scheduler"]
    print(f"tick gap median={gap['median']:.1f}ms p95={gap['p95']:.1f}ms "
          f"max={gap['max']:.1f}ms | scheduler: {sch['chunks']} chunks, "
          f"{sch['coalesced']} coalesced, {sch['promote_splits']} "
          "promote splits")
    if (args.max_tick_gap_ratio > 0 and gap["median"] > 0
            and gap["p95"] > args.max_tick_gap_ratio * gap["median"]):
        raise SystemExit(
            f"decode stalled: tick-gap p95 {gap['p95']:.1f}ms > "
            f"{args.max_tick_gap_ratio:.1f}x median {gap['median']:.1f}ms")
    if sampled:
        seed_desc = (f"{args.seed}+rid" if args.seed_per_request
                     else str(args.seed))
        print(f"sampling: temperature={args.temperature} top_k={args.top_k} "
              f"top_p={args.top_p} seed={seed_desc} "
              f"({stats['sampled_requests']}/{stats['requests']} requests "
              "sampled)")
        bad = [o.rid for o in outs
               if len(o.tokens) == 0 or np.any(o.tokens < 0)
               or np.any(o.tokens >= cfg.vocab_size)]
        if bad:
            raise SystemExit(f"sampled run produced empty/out-of-range "
                             f"outputs for requests {bad}")
        probe = generate(model, arrivals[0][1][None], 2,
                         sampling=make_sampling(0))
        if not torch.isfinite(probe.logits_last).all():
            raise SystemExit("sampled run hit NaN/Inf logits")
    if args.logprobs:
        lps = np.concatenate([o.logprobs for o in outs])
        print(f"logprobs: mean={lps.mean():.3f} min={lps.min():.3f} "
              f"({lps.size} tokens)")
        if not (np.all(np.isfinite(lps)) and np.all(lps <= 0.0)):
            raise SystemExit("logprobs outside (-inf, 0]")
    if args.tokens_out and (plan is None or dist.get_rank() == 0):
        # float(np.float32) goes through float64, which JSON round-trips
        # exactly: diffing two files compares tokens and logprobs bit for bit
        payload = {
            str(o.rid): {
                "tokens": [int(t) for t in o.tokens],
                "prompt_len": o.prompt_len,
                "finish_reason": o.finish_reason,
                **({"logprobs": [float(x) for x in o.logprobs]}
                   if o.logprobs is not None else {}),
            } for o in outs}
        with open(args.tokens_out, "w") as f:
            # "mesh" names the placement; the tokens must not depend on it
            json.dump({"mesh": (f"replicas={args.replicas}" if replica_mode
                                else args.mesh),
                       "arch": args.arch, "outputs": payload}, f,
                      sort_keys=True)
        print(f"tokens: {len(payload)} requests -> {args.tokens_out}")
    if prefix_cache is not None:
        pc = prefix_cache.stats()
        print(f"prefix cache: {pc['hits']}/{pc['lookups']} hits, "
              f"{pc['hit_tokens']} prompt tokens restored, "
              f"{pc['entries']} entries / {pc['bytes'] / 2**20:.2f} MiB "
              f"({pc['evictions']} evictions, {pc['disk_loads']} disk "
              f"loads, {pc['disk_writes']} disk writes)")
        if (args.shared_prefix >= cfg.lt_block_size and args.requests >= 3
                and pc["hits"] == 0):
            # requests 3+ of a shared-prefix workload hit (request 2
            # promotes the shared boundary)
            raise SystemExit("prefix cache: expected hits in a "
                             "shared-prefix workload, got none")
        if args.expect_disk_hits and pc["disk_loads"] == 0:
            raise SystemExit("prefix cache: expected disk loads from "
                             f"{args.prefix_cache_dir}, got none")
    flush_observability()
    if telemetry.memory is not None:
        reg = telemetry.registry
        rss = reg.get("serve_host_rss_peak_bytes").value / 2**20
        dev_mb = reg.get("serve_device_peak_bytes").value / 2**20
        print(f"memory: host rss peak {rss:.0f} MiB"
              + (f", device peak {dev_mb:.0f} MiB" if dev.type == "cuda"
                 else " (no device allocator on the CPU)"))
    if args.warm:
        # a fleet's: its survivors' (a recovery re-arms its engine's
        # baseline, so what counts here is a hot-path retrace)
        retr = stats["retraces"]
        print(f"retraces: {retr} mid-serve (call signatures: "
              + ", ".join(f"{k}={v}" for k, v in
                          stats["signatures"].items()) + ")")
        if args.expect_no_retraces and retr > 0:
            raise SystemExit(
                f"{retr} entry-point signatures (or kernel builds) appeared "
                "mid-serve, after the warm-up baseline")
    return outs


if __name__ == "__main__":
    main()
