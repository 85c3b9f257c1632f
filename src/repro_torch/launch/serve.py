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

Overlapped chunked admission: --overlap --prefill-budget 64.

The registry's dense polysketch models (head width 128, bf16):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --smoke \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --draw-on-device --prompt-len 4096 --gen 16 --slots 2 --requests 4

(`--layers N` cuts the depth, as yi-34b needs on one 80 GB card.)
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build_model
from repro_torch.serve.engine import ServeEngine, generate
from repro_torch.serve.sampling import SamplingParams

# flags of the reference's CLI that later slices port, with their ROADMAP item
UNPORTED_FLAGS = {
    "--shared-prefix": "A.7 (prefix cache)",
    "--prefix-cache-mb": "A.7 (prefix cache)",
    "--prefix-cache-dir": "A.7 (prefix cache)",
    "--min-snapshot-blocks": "A.7 (prefix cache)",
    "--expect-disk-hits": "A.7 (prefix cache)",
    "--max-tick-gap-ratio": "A.7 (telemetry)",
    "--trace-out": "A.7 (telemetry tracer)",
    "--metrics-out": "A.7 (telemetry)",
    "--log-events": "A.7 (telemetry tracer)",
    "--warm": "A.7 (telemetry retrace watchdog)",
    "--expect-no-retraces": "A.7 (telemetry retrace watchdog)",
    "--mesh": "A.9 (scale-out)",
    "--shard-model": "A.9 (scale-out)",
    "--replicas": "A.9 (scale-out: replicas)",
    "--chaos": "A.9 (scale-out: chaos)",
    "--shed-above": "A.9 (scale-out: replicas)",
    "--hang-timeout": "A.9 (scale-out: replicas)",
    "--checkpoint-blocks": "A.7 (recovery and failover)",
}


def _percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else 0.0


def simulate(engine: ServeEngine, arrivals, *, quiet=False):
    """Drive the engine under timed arrivals.

    arrivals: list of (arrival_s, prompt, max_new_tokens, eos_id, sampling)
    sorted by arrival time. A request is submitted when the wall clock
    passes its arrival offset and admitted at the next engine tick; live
    slots are never re-prefilled or reset by an admission. Returns
    (outputs in completion order, wall seconds)."""
    pending = list(arrivals)
    outs = []
    t0 = time.perf_counter()
    while pending or engine.busy:
        now = time.perf_counter() - t0
        while pending and pending[0][0] <= now:
            _, prompt, gen, eos, sampling = pending.pop(0)
            engine.submit(prompt, gen, eos, sampling=sampling)
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


def _reject_unported(argv):
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            raise SystemExit(f"{flag} is not ported yet (ROADMAP "
                             f"{UNPORTED_FLAGS[flag]})")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    _reject_unported(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2s-polysketch",
                    help="a registered config: gpt2s-polysketch, deepseek-7b, "
                         "starcoder2-3b, qwen3-14b, yi-34b")
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
    ap.add_argument("--block-size", type=int, default=0,
                    help="override cfg.lt_block_size (the resumed-prefill "
                         "grid); 0 = config default")
    ap.add_argument("--overlap", action="store_true",
                    help="pipeline admission prefill with the decode tick "
                         "(tokens read one tick late; the same tokens)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max admission-prefill tokens dispatched per "
                         "decode tick (0 = unlimited)")
    ap.add_argument("--logprobs", action="store_true",
                    help="report per-token log-probabilities of the "
                         "emitted tokens (computed in the decode tick)")
    ap.add_argument("--tokens-out", default=None,
                    help="write every request's emitted tokens (and "
                         "logprobs with --logprobs) as JSON keyed by rid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    overrides = {"lt_block_size": args.block_size} if args.block_size else {}
    if args.layers:
        overrides["n_layers"] = args.layers
    cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    model = build_model(cfg, device=args.device, seed=args.seed,
                        draw_on_device=args.draw_on_device)
    engine = ServeEngine(model, slots=args.slots,
                         max_len=args.prompt_len + args.gen,
                         logprobs=args.logprobs,
                         prefill_budget=args.prefill_budget or None,
                         overlap=args.overlap)
    rng = np.random.default_rng(args.seed)
    eos = None if args.eos_id < 0 else args.eos_id
    # a few fixed prompt-length buckets (not a continuum): mixed-length
    # admission with a bounded set of prefill shapes
    buckets = sorted({max(1, args.prompt_len // 2),
                      max(1, 3 * args.prompt_len // 4), args.prompt_len})

    def make_prompt():
        plen = int(rng.choice(buckets))
        return rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)

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

    t = 0.0
    arrivals = []
    for rid in range(args.requests):
        if args.rate > 0:
            t += float(rng.exponential(1.0 / args.rate))
        arrivals.append((t, make_prompt(), args.gen, eos, make_sampling(rid)))

    dev = model.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"serving: {cfg.name} on {name}, {args.requests} requests, "
          f"{args.slots} slots, rate={args.rate}/s", flush=True)
    outs, wall = simulate(engine, arrivals)
    stats = engine.stats()
    ttfts = [o.ttft_s for o in outs]
    lats = [o.latency_s for o in outs]
    print(f"served {stats['requests']} requests, "
          f"{stats['generated_tokens']} tokens in {wall:.2f}s "
          f"({stats['generated_tokens'] / wall:.1f} generated tok/s wall, "
          f"{stats['decode_tok_per_s']:.1f} tok/s decode)")
    print(f"ttft    p50={_percentile(ttfts, 50) * 1e3:.0f}ms "
          f"p95={_percentile(ttfts, 95) * 1e3:.0f}ms "
          f"p99={_percentile(ttfts, 99) * 1e3:.0f}ms")
    print(f"latency p50={_percentile(lats, 50) * 1e3:.0f}ms "
          f"p95={_percentile(lats, 95) * 1e3:.0f}ms "
          f"p99={_percentile(lats, 99) * 1e3:.0f}ms")
    itl, gap = stats["itl_ms"], stats["tick_gap_ms"]
    print(f"itl     p50={itl['p50']:.1f}ms p95={itl['p95']:.1f}ms "
          f"p99={itl['p99']:.1f}ms")
    print(f"tick gap median={gap['median']:.1f}ms p95={gap['p95']:.1f}ms "
          f"max={gap['max']:.1f}ms | scheduler: "
          f"{stats['scheduler']['chunks']} chunks")
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
    if args.tokens_out:
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
            json.dump({"arch": args.arch, "outputs": payload}, f,
                      sort_keys=True)
        print(f"tokens: {len(payload)} requests -> {args.tokens_out}")
    return outs


if __name__ == "__main__":
    main()
