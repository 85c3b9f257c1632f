"""Chip smoke of the PyTorch port: build its kernels, hold each against its
plain version on the card, serve gpt2s-polysketch, gpt2s-poly4 and
gpt2s-softmax and train all three at full width, at 2 x 4096 and at
32,768 tokens a step from 4k to 32k context, serve the registry's four
dense polysketch models (head width 128, bf16) at their published widths
and train starcoder2-3b in bf16, serve a shared system prompt through the
prefix cache with tracing on, serve and train the two recurrent families
(mamba2-780m, recurrentgemma-9b) and the two mixture-of-experts models
(dbrx-132b, llama4-maverick-400b-a17b, depth cut to one card) in bf16,
serve and train the VLM (llava-next-mistral-7b, with image embeddings)
and the encoder-decoder (whisper-large-v3) in bf16, train exact
polynomial attention in bf16 (gpt2s-poly4, and starcoder2-3b at h 128),
run the data-parallel training steps at world 1 on NCCL, serve
gpt2s-polysketch and gpt2s-poly4 through two replicas with seeded faults
and bit-exact failover, serve and train them over a "model" (and "data")
mesh axis as two ranks sharing the card, train dbrx with its experts
split over two such ranks, and check the port against itself.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, or without the repo's
`src/repro_torch` beside this file). Phases, each raising on failure:

  1. the B1 kernel (polysketch_causal) against its plain PyTorch version
     through ops.polysketch_attention, over the grid of the reference's
     kernel tests, at the slice's shape, and in the two calls each layer
     of a full-width 2040-token prefill makes (a 1024 block returning its
     state, then the 1016-token tail seeded with it); then the B2 kernel
     (poly_flash) through ops.poly_attention and the B3 kernel (lt_mult)
     through ops.lt_mult, over their reference grids and at the shapes
     their paths give them (B3 also bit for bit: two runs, and one bh
     row alone against the batch); B1's backward kernel against its plain
     version (the gradients of ops.polysketch_attention with and without
     the kernels) over degree 2/4/8 x local_exact, GQA 4:2, n 77, a seeded
     z0, the forward's mma tile shapes and the training shape, two calls
     bit for bit, and the forward's outputs with and without the saved
     den; B2's backward kernel likewise (the gradients of
     ops.poly_attention) over degree 1 (|q|, |k|)/2/4/8 x n 64/77/200/
     2040/4096, GQA 4:2, h 16 and the training shape, two calls bit for
     bit, and B2's forward with and without den_out bit for bit; B2's
     backward in bf16 at h 64 and 128 and in f32 at h 128 (5e-2 and 1e-4
     of each gradient's max) over p 1/2/4/8 x n 77/200/2040, GQA 4:2 and
     the training shape 2 x 12 x 4096, two calls bit for bit, f32 at h 128
     also against float64, with each instantiation's registers, spills,
     occupancy and time there beside its plain version's and its bound
     (the JSON line's B2-backward row, `bf16_h128`); B1 and
     B2, forward and backward, at the 32k training shape (bh 12, n 32768,
     h 64; B1 at r 32, b 1024) against their plain versions, and the
     forwards and B2's gradients there against float64 plain versions
     beside PR 20's errors (C.1: B2's gradients within half of PR 20's
     5.40e-5); B1 and its backward at h 128 in f32 (1e-4) and bf16 (5e-2)
     over GQA 12:1, GQA 5:1 at a ragged n, MHA without local_exact and a
     seeded z0, a bf16 prefill resumed at a block boundary equal to a
     cold one and two bf16 backward calls equal, bit for bit; B1 and its
     backward at phase 12's shapes (Whisper's decoder, 20 heads of 64:
     bf16 at a ragged 228-token block and at 448 tokens padded to 512,
     and f32 at the latter; llava's 32 query heads of 128 over 8 kv
     heads at 4 x 2048, b 256, bf16); and one
     line of tolerance study: the plain B1, B2 and B3 with single-pass
     TF32 matmuls against full f32, beside the kernels' (3xTF32) errors;
  2. full-width serving: `generate`, greedy, 4 requests x 2040 prompt
     tokens + 16 new ones, of gpt2s-polysketch (the decode fold at
     position 2047 runs), of gpt2s-poly4 (exact polynomial attention,
     one prefill call into a KV cache of 2056) and of gpt2s-softmax
     (plain ops: no port kernel may launch), with every kernel's
     launches counted over exactly each run; B3's own path, ops.lt_mult
     at the kernel benchmark's shapes, likewise; training of the three
     at batch 2 x 4096 (1 warm-up + 4 timed steps, launches counted: B1
     13 + 13 a step, B2 12 + 12, softmax none; step time, tokens/s, peak
     memory, a profiled step);
  3. self-checks: a polysketch prefill resumed at a block boundary equals
     a cold one bit for bit; a train-mode forward at full width launches
     its kernel once per layer and agrees with the plain path, for both
     polynomial models; the poly4 prefill's logits, kernel vs plain; the
     softmax prefill + decode logits against its train-mode logits; SMOKE
     greedy tokens on the card equal those on the CPU, for the three
     mechanisms; one training step's gradients through the kernels
     against the plain path's (polysketch and poly4); 2 steps +
     checkpoint save/restore + 2 steps equal 4 straight steps, and two
     runs equal, bit for bit (under torch.use_deterministic_algorithms,
     CUBLAS_WORKSPACE_CONFIG=:4096:8); and for each of the three models at
     1 x 4096, one step's gradients and two steps' losses with remat
     "dots" and "full" equal remat "none"'s bit for bit (same setting);
  4. each kernel's time at its path's shapes beside its plain version's
     and its bounds (B1 also at the two calls a prefill's layer makes);
     B3's device time per pass (torch.profiler) and host time per call;
     B1's and B2's backward kernels' registers, spills, shared memory and
     CTAs an SM, and their time at the training shape, per pass; the
     four training kernels at the 32k training shape (bh 12, n 32768);
     B1 in bf16 at phase 12's shapes (llava's prefill block and bh 128,
     n 2048; Whisper's decoder in training, bh 80, n 512, its backward
     too);
     and B1 and its backward at h 128 (bh 24, n 4096, b 256, bf16 and
     f32), with the backward's occupancy there;
  5. the continuous-batching ServeEngine (run after each model's phase-3
     checks): each of the three models at full width and depth serves 8
     requests on 4 slots (prompts 600-4096 tokens, 16 new tokens, greedy
     and sampled, prefill budget 2048, overlap on), with TTFT, time a
     decode tick, generated tokens/s, B1 / B2 launches (one a layer per
     prefill chunk, no plain-version call) and the host syncs of a decode
     tick (torch.profiler's CUDA runtime calls: at most the one token
     copy and its event); checked against train-mode log-probabilities
     (1e-3), batch-1 generate for the greedy requests, and the same
     requests in reverse order (bit for bit). Each kernel row of the
     JSON line also gives its `engine_launches`;
  6. long-context training: each of the three models at 32,768 tokens a
     step and contexts 4096 and 32768 (LONG_CONTEXTS; batch 32768 /
     context, one row a microbatch), remat "full", f32, 1 warm-up + 1
     timed step (LONG_STEPS): step time, tokens/s, peak memory and launches a step
     (B1 2 x 13 + 13 a microbatch, B2 2 x 12 + 12, softmax none; no
     plain-version call). A pair whose peak, reckoned from the shapes
     before the run (reckon_full_remat_gib), passes 90 % of the card's
     memory is logged with its reckoning and not run. The rows of B1 and
     B2 in the JSON line carry their 32k time and phase 6's launches under
     `long_context`. `--profile-long-context` profiles one more step at
     each model's shortest and longest context that run (~3 min more);
  7. the registry's dense polysketch models (deepseek-7b, starcoder2-3b,
     qwen3-14b, yi-34b) and llava-next-mistral-7b's backbone (token-only
     prompts, the reference's DecodeState path) at their published widths
     in bf16, seeded
     weights drawn on the card, each at 8 layers (serve_depth: the
     most whose f32 weights fit, at most DENSE_SERVE_LAYERS), served
     through ServeEngine: 4 requests on 2 slots (prompts 1024-4096
     tokens, 16 new, two greedy and two sampled), B1 once a layer per
     prefill block and nothing else, TTFT, ms a tick, tokens/s and peak
     memory, the served log-probabilities against a blocked plain bf16
     forward (1e-2 nats) and the train-mode logits through B1 against it
     (2e-2 of max|logit|), and a profile of starcoder2-3b's decode ticks;
  8. starcoder2-3b trained at its published width in bf16 with remat
     "dots", 1 x 4096 tokens a step, at the depth that fits (train_depth),
     at most DENSE_TRAIN_LAYERS (16 of 30):
     one step's gradients through B1 and its backward against the plain
     path's leaf by leaf (twice the reference's bf16 distance from float64
     in scripts/bf16_grad_study.py: worst leaf 0.38, median 0.095), step time,
     tokens/s and peak memory over 3 timed steps (B1 twice and its
     backward once a layer a step), and two runs bit for bit. The rows of
     B1 and its backward in the JSON line carry their h 128 bf16 time and
     these phases' launches under `h128_bf16`;
  9. the prefix-reuse snapshot cache and the serving telemetry (run after
     phase 5): gpt2s-polysketch at full width and depth, f32, serves 8
     requests on 4 slots, each a 3072-token shared system prompt and its
     own 256-1023-token suffix (16 new tokens, greedy and sampled, budget
     2048, overlap on) with no prefix cache (A), with a PrefixCache of 512
     MiB and a disk tier under build/ plus tracing and memory sampling
     after a warm-up and reset_stats() (B), and through a new engine and
     a fresh cache on the same directory (C): tokens and log-probabilities
     bit for bit across the three, hits in B and disk loads in C, B1 once
     a layer per prefilled block (A every block, B and C the suffix's),
     B's decode ticks at one host sync and one device-to-host copy with
     tracing on, B's trace valid, no retrace after the warm-up, and one
     snapshot's bytes as reckoned (41,533,440). The row of B1 in the JSON
     line carries the three runs' launches under `prefix_cache_launches`.
 10. the recurrent families (after phase 8; plain ops, no port kernel on
     their paths): mamba2-780m (48 SSD layers) and recurrentgemma-9b (20
     of 38 layers, REC_SERVE_LAYERS: six groups of rglru, rglru,
     local_attn and its 2-layer tail) at their published widths in bf16,
     seeded weights drawn on the card, each served through ServeEngine (4 requests on 2 slots,
     prompts 4096 / 1024 / 3072 / 2048, the 4096 one wrapping the
     2048-slot ring; 16 new, two greedy and two sampled): no port-kernel
     launch and no plain-version call, the served log-probabilities
     against a train-mode forward (the same weights served in f32: 1e-3
     nats; bf16: a fixed limit for each model, REC_BF16_LIMITS), the
     4096-token request's whole logit rows served through DecodeState
     (the prefill's every row, then teacher-forced decode steps) against
     the train-mode forward's, max|diff| / max|logit| and every next
     token's log-probability (f32: 1e-4 and 1e-3 nats; bf16: the fixed
     limits, which a control with its recurrent states rounded to
     float8_e5m2 must fail), at most one host sync and one device-to-host
     copy a profiled decode tick; prefix reuse at token granularity (4 requests sharing a
     2048-token system prompt, 300-700-token suffixes, no cache vs a 512
     MiB memory tier after a warm-up): bit for bit, hits, snapshots of
     76,455,936 / 26,230,784 B, a resume at 2048 equal to the cold
     prefill; SMOKE greedy tokens card = CPU (f32); training at 1 x 4096
     Markov tokens, bf16 (mamba2 at 6 of 48 layers, remat "dots", 1 + 3
     steps; recurrentgemma at the most whole groups that fit, at most 2
     (REC_TRAIN_LAYERS), remat "full", 1 + 2): step ms, tokens/s, peak GiB, no port kernel, two
     runs bit for bit, and at one group one step's gradients and two
     steps' losses under "dots" and "full" equal "none"'s bit for bit.
 11. the mixture-of-experts family (after phase 10): one dbrx MoE layer at
     its published width on 1 x 2048 tokens, capacity factor 8.0 (no
     drops), the sort-based dispatch against the dense oracle in f32
     (1e-4 of max|y|) and bf16 (5e-2) in 1, 2 and 4 dispatch groups, and
     twice bit for bit; dbrx-132b (16 experts top-4, every layer) at the
     most layers whose f32 weights fit, at most MOE_SERVE_LAYERS (2 of 40) and
     llama4-maverick-400b-a17b (128 experts top-1, every second layer) at
     its first (GLU, MoE) cycle, bf16, seeded weights drawn on the card,
     served through ServeEngine at the published capacity factor 1.25 (4
     requests on 2 slots, prompts 4096 / 1024 / 3072 / 2048, 16 new, two
     greedy and two sampled, budget 2048): TTFT, ms a tick, tokens/s, peak
     GiB, B1 once a layer a prefill block and nothing else, a second run
     bit for bit with the share of routed assignments dropped in each
     prefill call of the first MoE layer, a profile of 4 decode ticks and
     of one 2048-token prefill call split into router, sort/dispatch,
     expert GEMMs, the experts' bf16 casts, combine and B1; the served
     logic in f32 at 2 layers and capacity factor 8.0 (nothing drops, which
     the run checks) against a train-mode forward (1e-3 nats); SMOKE greedy
     tokens card = CPU; dbrx trained at 1 of 40 layers, 1 x 4096, bf16,
     remat "full", 1 + 4 steps (step ms, peak GiB, finite aux metrics, B1
     twice and its backward once a layer a step); B1's time at dbrx's
     attention shape (bh 48, n 2048, h 128, b 256, bf16), in the JSON
     line's B1 row under `moe_bf16`.
 12. the VLM and the encoder-decoder (after phase 11): llava-next-mistral-7b
     (32 layers, GQA 4:1 at h 128) and whisper-large-v3 (32 encoder + 32
     decoder layers, h 64) at their published widths, served at 12 layers
     (Whisper 12 encoder + 12 decoder; XM_SERVE_LAYERS), bf16,
     seeded weights drawn on the card, served greedily through the
     batch-dict make_serve_fns (llava 4 x (576 image rows + 1472 text
     tokens), 16 new; Whisper 4 x (1500 frames, a 228-token prompt), 32
     new, so the decode crosses position 255 and the decoder's state
     folds a block): TTFT of the prefill call, ms a decode step, tokens/s,
     peak GiB, Whisper's encoder alone, B1 once a layer per prefill block
     and nothing else; llava's served log-probabilities against a blocked
     plain bf16 forward (1e-2 nats); Whisper's, which no gate holds
     (ROADMAP.md §C, known limits), logged against the f32 twin's
     train-mode forward beside the bf16 train-mode forward's, a control's
     with the decode state and cross-attention memory in float8, and the
     same serving path through B1's plain version; the
     train-mode logits through B1 against a blocked plain forward (2e-2 of
     max|logit|); in f32 (the same weights) served against a
     train-mode forward with the image rows or frames (1e-3 nats);
     llava's logits move with image_embeds + 1; ServeEngine and generate
     refuse Whisper. Training: llava 1 x 4096 tokens (576 image rows),
     remat "full", at the depth that fits (train_depth), at most 4 layers
     (VLM_TRAIN_LAYERS); Whisper 4 x 448 tokens over 1500 frames at 8
     encoder + 8 decoder layers (AUDIO_TRAIN_LAYERS), remat "dots" (a full
     rematerialisation, as the reference's plain jax.checkpoint): one
     step's f32 gradients through B1 and its backward against the plain
     path's (1e-4 of each leaf's max), 1 + 3 timed bf16 steps (step ms,
     tokens/s, peak GiB, B1 twice and its backward once a decoder layer a
     step), two runs bit for bit. The JSON line's B1 rows carry phase
     12's times and launches under `vlm_audio`;
 13. training what the JAX package trains (after phase 12): gpt2s-poly4 in
     bf16 at full width and depth (2 x 4096) and starcoder2-3b with
     attention "polynomial" in bf16 at its published width (h 128, GQA
     12:1; POLY_STARCODER_LAYERS of 30 layers, 1 x 4096, remat "dots"),
     through B2's forward and backward kernels: one step's gradients
     against the plain path's (the polynomial bf16 gates, 0.084 / 0.043),
     1 + 3 timed steps (step ms, tokens/s, peak GiB; B2's forward once a
     layer a step, twice under remat, its backward once, no plain
     version); then data parallelism at
     world 1 on NCCL (deterministic algorithms on), gpt2s-polysketch at
     full width, 2 x 4096: the manual-DP step with the mean all-reduce
     gives make_train_step's parameters bit for bit after 2 steps, with
     the int8 all-reduce each synced gradient element within the two
     roundings' half levels of the unsynced one and two runs bit for bit,
     and launch/train.py --mesh 1x1:data,model the losses of the run
     without --mesh (3 steps). The JSON line's B2 rows carry these runs'
     launches under `train_bf16_launches`.
 14. replicated serving with bit-exact failover (after phase 13):
     gpt2s-polysketch at full width and depth, f32, seed-0 weights drawn on
     the card, served by a ReplicaSet of 2 replicas x 4 slots on one card
     (a 512 MiB PrefixCache, log-probabilities, overlap, budget 2048): 6
     requests of 600-3070 tokens, four of whose streams cross a 1024-token
     block boundary in their first decode ticks, 24 new tokens, greedy and
     sampled, each run after a warm-up of every engine: A fault-free; B
     kill@K:r0, K two ticks after replica 0's first checkpoint in A; C
     drop-snapshot@0:r0 and that kill (a cold prefill and a full replay); D
     a hang on replica 1 past a limit of 4 x A's slowest tick. Gates: B, C
     and D give A's tokens and log-probabilities bit for bit request by
     request; deaths exactly the schedule's (a death it did not arm, a
     crash, fails the phase); failovers, checkpoints in B, dropped ones in
     C, recovered installs, no duplicate, no retrace on the survivors; B1
     launched in every run, no plain-version call; A's profiled ticks at
     one host sync a replica tick and one more a checkpoint. Logged: ms a
     coordinator tick, TTFT p50, the recovery's wall ms (death to the first
     recovered token), each checkpoint call's ms and bytes. gpt2s-poly4 (a
     KV state, no snapshot) in runs A and B without a cache: bit for bit,
     B2 launched more in B (the recovery's cold prefill). launch/serve.py
     at full width with --replicas 2 --chaos kill@6 --logprobs writes the
     fault-free run's --tokens-out file exactly, each run's fleet line
     names exactly its schedule's deaths (the CLI itself exits non-zero on
     a death its schedule did not cause), and a SMOKE run under
     SIGTERM after its `serving:` line exits 0 with one checkpoint file a
     decoding slot. The JSON line's B1 and B2 rows carry these runs'
     launches under `replica_launches`.
 15. compute over the "model" mesh axis (after phase 14): two ranks
     share the card over gloo (launch.mesh.init_ranks(share_card=True);
     collectives staged through the host, so its times are no multi-card
     speed), gpt2s-polysketch at full width and depth in f32. B1 and B2
     at one rank's share of the heads (6 of 12) against their plain
     versions (F32_TOL): B1 at the prefill's call and, with its backward
     (gradients within F32_TOL of their max), at the 1x2 training step's
     (bh 2 x 6, n 1024, block 1024); each kernel's error goes into the
     JSON line's `tp_max_abs_err`. launch/serve.py (4 greedy requests of 1024-2048
     prompt tokens + 16 on 4 slots, --logprobs) at --mesh 1x2
     --shard-model and at --mesh 2x1 against the 1x1 run's --tokens-out:
     tokens equal, log-probabilities within F32_TOL (the bit-equal ones
     counted); each rank launches B1 as often as 1x1 at 1x2, and the two
     data ranks split 1x1's launches at 2x1. gpt2s-poly4 through
     ServeEngine on ServePlan.build(1, 2, shard_model=True): tokens equal
     to 1x1's, log-probabilities within F32_TOL, B2 launched on each rank
     as often as at 1x1. launch/train.py --mesh 1x2:data,model (3 steps of
     2 x 1024) against the run without --mesh: losses within F32_TOL, each
     rank launching B1 and its backward as often as 1x1, and holding wq
     as 768 x 6 x 64; a checkpoint of the sharded state timed. No plain
     version is called. Logged: ms a tick, ms a step, a checkpoint call's
     ms; the JSON line's B1, B1 backward and B2 rows carry each rank's
     launches under `tp_launches_a_rank`.
 16. the MoE family over a device mesh (after phase 15): dbrx-132b at its
     published width, 1 of 40 layers, f32 (ep_cfg says why), remat
     "full", 3 steps of 2 x 1024 Markov tokens through
     make_sharded_train_step on a (1, 2) mesh, two ranks sharing the card
     over gloo, each holding and running 8 of the 16 experts (wi block 8 x
     6144 x 10752), against make_train_step at 1x1 on the same weights
     (drawn on the card from seed 0) and batches: losses and both aux
     metrics within F32_TOL of 1x1's, the dispatch plans' digests equal on
     both ranks, B1 twice and its backward once a layer a step on each
     rank as at 1x1, no plain version. B1 and its backward held against
     their plain versions at a rank's call (bh 2 x 24, n 1024, h 128, f32);
     the JSON line's B1 rows carry each rank's launches
     (`ep_launches_a_rank`) and that error (`ep_max_abs_err`). Logged: ms a
     step, each rank's peak GiB and expert bytes, and the bytes gathered
     over "model" a step.

Prints the card's name and power limit, one `{"kernels": [...]}` line, and
as its last line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import gc
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from typing import NamedTuple
from unittest import mock

# cuBLAS reads this when it starts; phase 3's bit-for-bit training checks
# run under torch.use_deterministic_algorithms, which needs it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.bridge import train_state_to_jax  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, effective_pattern, get_config  # noqa: E402
from repro_torch.configs.gpt2_paper import GPT2_SMALL_POLY4, GPT2_SMALL_SOFTMAX  # noqa: E402
from repro_torch.core import decode as dec  # noqa: E402
from repro_torch.data import DataIterator, make_markov_lm  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.kernels import lt_mult as lt  # noqa: E402
from repro_torch.kernels import poly_flash as pf  # noqa: E402
from repro_torch.kernels import polysketch_causal as pc  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.serve.chaos import ChaosInjector  # noqa: E402
from repro_torch.serve.engine import ServeEngine, generate, make_serve_fns  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache, snapshot_nbytes  # noqa: E402
from repro_torch.serve.replicas import ReplicaSet  # noqa: E402
from repro_torch.serve.sampling import SamplingParams, sample_step  # noqa: E402
from repro_torch.serve.telemetry import Telemetry, validate_trace  # noqa: E402
from repro_torch.train import init_train_state, make_loss_fn, make_train_step  # noqa: E402

F32_TOL, BF16_TOL = 1e-4, 5e-2      # the reference's kernel-sweep tolerances
LT_F32_TOL, LT_BF16_TOL = 2e-3, 2e-2  # lt_mult's: atol tol * n, rtol tol
LT_BENCH_REL_TOL = 1e-5             # and max|err| / max|out| at kernel_bench's shapes
H100_F32_FLOPS = 67e12              # f32 outside the tensor cores (data sheet)
H100_TF32_FLOPS = 495e12            # TF32 on the tensor cores, dense (data sheet)
H100_BF16_FLOPS = 989e12            # bf16 on the tensor cores, dense (data sheet)
# a product of two bf16 operands runs on the bf16 tensor cores (f32
# accumulator): counted as this share of a TF32 pass
BF16_PASS = H100_TF32_FLOPS / H100_BF16_FLOPS
H100_BYTES_PER_S = 3.35e12          # HBM3 (data sheet)
KERNELS = {"polysketch_causal": pc.polysketch_causal_cuda,
           "polysketch_causal_backward": pc.polysketch_causal_backward_cuda,
           "poly_flash": pf.poly_flash_cuda,
           "poly_flash_backward": pf.poly_flash_backward_cuda, "lt_mult": lt.lt_mult_cuda}
NO_LIBRARY = "none: no single PyTorch call computes this function"
TRAIN_BATCH, TRAIN_SEQ = 2, 4096    # phase 2's training traffic: 4 blocks a row


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def seeded(seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to("cuda", dtype)
    return rnd


def err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name, got, tol):
    status = "ok" if got <= tol else "FAIL"
    log(f"  {name:58s} max|err| {got:.3e}  tol {tol:.1e}  {status}")
    if got > tol:
        raise AssertionError(f"{name}: max error {got} > {tol}")


def check_close(name, got, want, atol, rtol):
    """allclose(got, want, atol, rtol), as the reference's lt_mult tests
    hold it; returns the max abs error."""
    e = err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    log(f"  {name:58s} max|err| {e:.3e}  atol {atol:.1e} rtol {rtol:.0e}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: not within atol {atol}, rtol {rtol}")
    return e


def zero_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 1: B1 against its plain version
# ---------------------------------------------------------------------------

def phase_kernel_grid():
    log("phase 1: polysketch_causal kernel vs plain PyTorch (ops.polysketch_attention)")
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for degree in (2, 4, 8):
            for local_exact in (True, False):
                rnd = seeded(degree)
                B, Hq, Hkv, S, hd, r, blk = 2, 4, 2, 96, 16, 8, 32
                qm = rnd(B, Hq, S, r, scale=0.5, dtype=dt)
                km = rnd(B, Hkv, S, r, scale=0.5, dtype=dt)
                q, k, v = (rnd(B, h_, S, hd, dtype=dt) for h_ in (Hq, Hkv, Hkv))
                kw = dict(degree=degree, scale=1.0 / hd, local_exact=local_exact,
                          block_size=blk)
                got = ops.polysketch_attention(qm, km, q, k, v, **kw)
                want = ops.polysketch_attention(qm, km, q, k, v, impl="torch", **kw)
                torch.cuda.synchronize()
                e = err(got, want)
                check(f"{str(dt)[6:]} p={degree} local_exact={local_exact} GQA 4:2", e, tol)
                if dt == torch.float32:
                    worst = max(worst, e)

    rnd = seeded(0)
    qm, km = rnd(1, 2, 77, 8), rnd(1, 2, 77, 8)
    q, k, v = rnd(1, 2, 77, 16), rnd(1, 2, 77, 16), rnd(1, 2, 77, 16)
    kw = dict(degree=4, scale=1.0 / 16, block_size=32)
    e = err(ops.polysketch_attention(qm, km, q, k, v, **kw),
            ops.polysketch_attention(qm, km, q, k, v, impl="torch", **kw))
    check("f32 unaligned n=77 (zero-padded to the block)", e, F32_TOL)
    worst = max(worst, e)

    for hq, hkv in ((2, 2), (4, 2)):
        rnd = seeded(7)
        B, S, hd, r, blk, cut = 2, 96, 16, 8, 32, 64
        qm, km = rnd(B, hq, S, r, scale=0.5), rnd(B, hkv, S, r, scale=0.5)
        q, k, v = rnd(B, hq, S, hd), rnd(B, hkv, S, hd), rnd(B, hkv, S, hd)
        kw = dict(degree=4, scale=1.0 / hd, block_size=blk, return_state=True)
        c = lambda x: x[..., :cut, :].contiguous()   # noqa: E731
        s = lambda x: x[..., cut:, :].contiguous()   # noqa: E731
        o_full, z_full = ops.polysketch_attention(qm, km, q, k, v, **kw)
        o1, z1 = ops.polysketch_attention(*map(c, (qm, km, q, k, v)), **kw)
        o2, z2 = ops.polysketch_attention(*map(s, (qm, km, q, k, v)), z0=z1, **kw)
        p2, pz2 = ops.polysketch_attention(*map(s, (qm, km, q, k, v)), z0=z1,
                                           impl="torch", **kw)
        torch.cuda.synchronize()
        e = max(err(o2, p2), err(z2, pz2) / pz2.abs().max().item())
        check(f"f32 resume at cut 64 with z0, {hq}:{hkv} heads (vs plain)", e, F32_TOL)
        worst = max(worst, err(o2, p2))
        same = torch.equal(torch.cat([o1, o2], -2), o_full) and torch.equal(z2, z_full)
        log(f"  resumed == one-shot, bit for bit ({hq}:{hkv} heads): {same}")
        if not same:
            raise AssertionError("kernel: resumed run differs from the one-shot run")

    rnd = seeded(1)
    qm, km = rnd(1, 3, 64, 4), rnd(1, 3, 64, 4)
    q, k, v = rnd(1, 3, 64, 8), rnd(1, 3, 64, 8), rnd(1, 3, 64, 8)
    kw = dict(degree=4, scale=1.0 / 8, block_size=16)
    full = ops.polysketch_attention(qm, km, q, k, v, **kw)
    solo = ops.polysketch_attention(*(x[:, 2:].contiguous() for x in (qm, km, q, k, v)), **kw)
    torch.cuda.synchronize()
    check("f32 per-head state reset (head 2 alone vs in the batch)",
          err(full[:, 2:], solo), 0.0)

    inputs = slice_inputs()
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024, return_state=True)
    o, z = ops.polysketch_attention(*inputs, **kw)
    po, pz = ops.polysketch_attention(*inputs, impl="torch", **kw)
    torch.cuda.synchronize()
    e = err(o, po)
    check("f32 slice shape bh=4*12 n=2048 r=32 h=64 b=1024 (out)", e, F32_TOL)
    check("f32 slice shape, returned state (relative to max|z|)",
          err(z, pz) / pz.abs().max().item(), F32_TOL)
    worst = max(worst, e)

    # The two calls a full-width prefill of 2040 tokens makes per layer:
    # one full block that returns its state, then the 1016-token tail as a
    # block of its own length (partial tiles), seeded with that state.
    head = [x[..., :1024, :] for x in inputs]
    tail = [x[..., 1024:2040, :] for x in inputs]
    kw = dict(degree=4, scale=1.0 / 64, return_state=True)
    o1, z1 = ops.polysketch_attention(*head, block_size=1024, **kw)
    p1, pz1 = ops.polysketch_attention(*head, block_size=1024, impl="torch", **kw)
    o2, z2 = ops.polysketch_attention(*tail, block_size=1016, z0=z1, **kw)
    p2, pz2 = ops.polysketch_attention(*tail, block_size=1016, z0=z1,
                                       impl="torch", **kw)
    torch.cuda.synchronize()
    for name, (o, po, z, pz) in (("block n=b=1024", (o1, p1, z1, pz1)),
                                 ("tail n=b=1016 + z0", (o2, p2, z2, pz2))):
        e = err(o, po)
        check(f"f32 prefill {name}, bh=48 r=32 h=64 (out)", e, F32_TOL)
        check(f"f32 prefill {name}, bh=48 (state, rel.)",
              err(z, pz) / pz.abs().max().item(), F32_TOL)
        worst = max(worst, e)
    return worst


# ---------------------------------------------------------------------------
# phase 1: B1's backward against its plain version
# ---------------------------------------------------------------------------

GRADS = ("qm", "km", "q", "k", "v", "z0")


def grads_of(fn, xs, dout):
    """Gradients of sum(fn(*xs) * dout) with respect to xs (fresh leaves)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in xs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, dout)


def grad_err(got, want):
    """The worst gradient's max|err| as a share of its own max|.|."""
    return max(err(g, w) / max(w.abs().max().item(), 1e-30) for g, w in zip(got, want))


def check_grads(name, fn, xs, dout, kernel=pc.polysketch_causal_backward_cuda, tol=F32_TOL,
                **kw):
    """The kernel path's gradients (an ops entry point through a forward
    kernel and the backward `kernel`) against the plain path's, each within
    `tol` of its own max|.|; returns (relative error, absolute error,
    kernel gradients, plain gradients)."""
    before = kernel.launches
    got = grads_of(lambda *a: fn(*a, **kw), xs, dout)
    launched = kernel.launches - before
    want = grads_of(lambda *a: fn(*a, impl="torch", **kw), xs, dout)
    torch.cuda.synchronize()
    if launched != 1 or kernel.launches != before + 1:
        raise AssertionError(f"{name}: the kernel path launched the backward "
                             f"{launched} times, or the plain path launched it")
    e = grad_err(got, want)
    check(f"{name} (grads, rel.)", e, tol)
    return e, max(err(g, w) for g, w in zip(got, want)), got, want


def phase_b1_backward_grid():
    """Returns the worst max|err| of any gradient over the grid."""
    log("phase 1: polysketch_causal backward kernel vs plain PyTorch (gradients of "
        "ops.polysketch_attention)")
    worst, worst_rel = 0.0, 0.0
    for degree in (2, 4, 8):
        for local_exact in (True, False):
            rnd = seeded(100 + degree)
            B, Hq, Hkv, S, hd, r, blk = 2, 4, 2, 96, 16, 8, 32
            xs = (rnd(B, Hq, S, r, scale=0.5), rnd(B, Hkv, S, r, scale=0.5),
                  rnd(B, Hq, S, hd), rnd(B, Hkv, S, hd), rnd(B, Hkv, S, hd))
            kw = dict(degree=degree, scale=1.0 / hd, local_exact=local_exact,
                      block_size=blk)
            rel, e, _, _ = check_grads(f"f32 p={degree} local_exact={local_exact} GQA 4:2",
                                    ops.polysketch_attention, xs, rnd(B, Hq, S, hd), **kw)
            worst, worst_rel = max(worst, e), max(worst_rel, rel)
    rnd = seeded(101)
    xs = (rnd(1, 2, 77, 8), rnd(1, 2, 77, 8), rnd(1, 2, 77, 16), rnd(1, 2, 77, 16),
          rnd(1, 2, 77, 16))
    rel, e, _, _ = check_grads("f32 unaligned n=77 (zero-padded)", ops.polysketch_attention,
                            xs, rnd(1, 2, 77, 16), degree=4, scale=1.0 / 16, block_size=32)
    worst, worst_rel = max(worst, e), max(worst_rel, rel)
    # a seeded z0 (the state a previous call returned), its gradient included
    rnd = seeded(102)
    B, H, S, hd, r, blk = 2, 2, 96, 16, 8, 32
    prev = [rnd(B, H, S, d, scale=0.5) for d in (r, r, hd, hd, hd)]
    _, z0 = ops.polysketch_attention(*prev, degree=4, scale=1.0 / hd, block_size=blk,
                                     return_state=True)
    xs = (rnd(B, H, S, r, scale=0.5), rnd(B, H, S, r, scale=0.5), rnd(B, H, S, hd),
          rnd(B, H, S, hd), rnd(B, H, S, hd), z0)

    def with_z0(qm, km, q, k, v, z, **kw):
        return ops.polysketch_attention(qm, km, q, k, v, z0=z, **kw)
    rel, e, _, _ = check_grads("f32 with a seeded z0 (its gradient too)", with_z0, xs,
                            rnd(B, H, S, hd), degree=4, scale=1.0 / hd, block_size=blk)
    worst, worst_rel = max(worst, e), max(worst_rel, rel)
    # the forward's mma tile shapes (a ragged last tile; widths below a tile)
    for n, r, h, blk in ((1016, 32, 64, 1016), (64, 4, 8, 16)):
        rnd = seeded(n + r)
        xs = (rnd(1, 2, n, r, scale=0.5), rnd(1, 2, n, r, scale=0.5), rnd(1, 2, n, h),
              rnd(1, 2, n, h), rnd(1, 2, n, h))
        rel, e, _, _ = check_grads(f"f32 n={n} r={r} h={h} b={blk}", ops.polysketch_attention,
                                xs, rnd(1, 2, n, h), degree=4, scale=1.0 / h, block_size=blk)
        worst, worst_rel = max(worst, e), max(worst_rel, rel)
    # the training shape, and two calls bit for bit
    xs, dout = train_attention_inputs()
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    rel, e, got, _ = check_grads("f32 training shape B=2 H=12 n=4096 r=32 h=64 b=1024",
                              ops.polysketch_attention, xs, dout, **kw)
    worst, worst_rel = max(worst, e), max(worst_rel, rel)
    again = grads_of(lambda *a: ops.polysketch_attention(*a, **kw), xs, dout)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  training shape: two backward calls equal bit for bit: {same}")
    if not same:
        raise AssertionError("B1 backward: two calls differ")
    # the forward with and without den_out (what training saves) bit for bit
    flat = [x.reshape(24, 4096, -1).contiguous() for x in xs]
    out_a, zv_a, zd_a = pc.polysketch_causal_cuda(*flat, return_state=True, **kw)
    out_b, zv_b, zd_b, _ = pc.polysketch_causal_cuda(*flat, return_saved=True, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in ((out_a, out_b), (zv_a, zv_b), (zd_a, zd_b)))
    log(f"  B1 forward with den_out on and off: outputs and state equal bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("B1 forward: den_out changed the outputs")
    log(f"  backward grid: worst gradient error {worst_rel:.3e} of its max|.|, "
        f"{worst:.3e} absolute")
    return worst


def train_attention_inputs():
    """(qm, km, q, k, v) and dout at the training shape (B 2, H 12, n 4096,
    r 32, h 64), scaled like the model's."""
    rnd = seeded(16)
    B, H, n, r, h = 2, 12, 4096, 32, 64
    return ((rnd(B, H, n, r, scale=0.5), rnd(B, H, n, r, scale=0.5), rnd(B, H, n, h),
             rnd(B, H, n, h), rnd(B, H, n, h)), rnd(B, H, n, h))


def b2_grad_inputs(seed, b, hq, hkv, n, h, degree):
    """q, k, v and dout for B2's backward, LayerNorm'd like the model's q
    and k; at odd degree |q| and |k|, so that 1 + den stays >= 1 (with
    signed inputs it can cross zero, in either version)."""
    rnd = seeded(seed)
    ln = lambda x: torch.nn.functional.layer_norm(x, (h,), eps=1e-6)  # noqa: E731
    q, k, v = ln(rnd(b, hq, n, h)), ln(rnd(b, hkv, n, h)), rnd(b, hkv, n, h)
    if degree % 2:
        q, k = q.abs(), k.abs()
    return (q, k, v), rnd(b, hq, n, h)


def phase_b2_backward_grid():
    """B2's backward kernel against its plain version, through the
    gradients of ops.poly_attention with and without the kernels. Returns
    the worst max|err| of any gradient over the grid."""
    log("phase 1: poly_flash backward kernel vs plain PyTorch (gradients of "
        "ops.poly_attention)")
    kernel = pf.poly_flash_backward_cuda
    worst, worst_rel = 0.0, 0.0
    for degree in (1, 2, 4, 8):
        for n in (64, 77, 200, 2040, 4096):
            xs, dout = b2_grad_inputs(200 + degree + n, 1, 2, 2, n, 64, degree)
            rel, e, _, _ = check_grads(f"f32 p={degree} bh=2 n={n} h=64", ops.poly_attention,
                                    xs, dout, kernel=kernel, degree=degree, scale=1.0 / 64)
            worst, worst_rel = max(worst, e), max(worst_rel, rel)
    for name, shape in (("GQA 4:2, n=200 h=64", (2, 4, 2, 200, 64)),
                        ("h=16 n=77 (widths below a tile)", (1, 2, 2, 77, 16))):
        xs, dout = b2_grad_inputs(17, *shape, 4)
        rel, e, _, _ = check_grads(f"f32 p=4 {name}", ops.poly_attention, xs, dout,
                                kernel=kernel, degree=4, scale=1.0 / shape[-1])
        worst, worst_rel = max(worst, e), max(worst_rel, rel)
    # the training shape, and two calls bit for bit
    xs, dout = b2_grad_inputs(16, 2, 12, 12, TRAIN_SEQ, 64, 4)
    kw = dict(degree=4, scale=1.0 / 64)
    rel, e, got, _ = check_grads(f"f32 training shape B=2 H=12 n={TRAIN_SEQ} h=64 p=4",
                              ops.poly_attention, xs, dout, kernel=kernel, **kw)
    worst, worst_rel = max(worst, e), max(worst_rel, rel)
    again = grads_of(lambda *a: ops.poly_attention(*a, **kw), xs, dout)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  training shape: two backward calls equal bit for bit: {same}")
    if not same:
        raise AssertionError("B2 backward: two calls differ")
    flat = [x.reshape(24, TRAIN_SEQ, 64).contiguous() for x in xs]
    out_a = pf.poly_flash_cuda(*flat, **kw)
    out_b, den = pf.poly_flash_cuda(*flat, return_den=True, **kw)
    _, want_den = pf.poly_flash_torch(*flat, return_den=True, **kw)
    torch.cuda.synchronize()
    same = torch.equal(out_a, out_b)
    log(f"  B2 forward with den_out on and off: outputs equal bit for bit: {same}")
    if not same:
        raise AssertionError("B2 forward: den_out changed the outputs")
    check("B2 forward's den_out D = 1 + den vs plain (rel.)",
          err(den, want_den) / want_den.abs().max().item(), F32_TOL)
    log(f"  backward grid: worst gradient error {worst_rel:.3e} of its max|.|, "
        f"{worst:.3e} absolute")
    return worst


# B2's backward instantiations besides f32 at h 64 (phase_b2_backward_grid):
# (dtype, h) as the kernel takes them
B2_BWD_WIDE = ((torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 128))


# the key-tile kernel's template arguments as ptxas -v names them, for
# kernel_occupancy's spill column
B2_BWD_INST = {("float32", 64): "Li64Ef", ("float32", 128): "Li128Ef",
               ("bfloat16", 64): "Li64E13__nv_bfloat16",
               ("bfloat16", 128): "Li128E13__nv_bfloat16"}


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def phase_b2_backward_wide(ptxas):
    """B2's backward kernel in bf16 at h 64 and 128 and in f32 at h 128
    against its plain version, through the gradients of ops.poly_attention:
    p 1, 2, 4, 8 at n 77, 200 and 2040 (ragged), GQA 4:2, and the training
    shape 2 x 12 x 4096 (bh 24), where two calls must give the same bits;
    bf16 within BF16_TOL of each gradient's max, f32 within F32_TOL, and
    f32 at h 128 also against float64 there. Then each instantiation's
    registers, spills and occupancy, and its CUDA-event time at the training
    shape beside its plain version's and its bound. Returns {(dtype name,
    h): {"rel", "abs", "ms", "plain_ms", "bound"}}."""
    log("phase 1: poly_flash backward kernel in bf16 (h 64, 128) and f32 at h 128 vs "
        "plain PyTorch (gradients of ops.poly_attention)")
    kernel = pf.poly_flash_backward_cuda
    out = {}
    for dt, h in B2_BWD_WIDE:
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        tag = f"{dtype_name(dt)} h={h}"
        worst, worst_rel = 0.0, 0.0

        def case(name, seed, shape, degree):
            nonlocal worst, worst_rel
            xs, dout = b2_grad_inputs(seed, *shape, h, degree)
            xs, dout = tuple(x.to(dt) for x in xs), dout.to(dt)
            rel, e, got, want = check_grads(f"{tag} {name}", ops.poly_attention, xs, dout,
                                            kernel=kernel, tol=tol, degree=degree,
                                            scale=1.0 / h)
            worst, worst_rel = max(worst, e), max(worst_rel, rel)
            return xs, dout, got
        for degree in (1, 2, 4, 8):
            for n in (77, 200, 2040):
                case(f"p={degree} bh=2 n={n}", 300 + h + degree + n, (1, 2, 2, n), degree)
        case("p=4 GQA 4:2 n=200", 17 + h, (2, 4, 2, 200), 4)
        xs, dout, got = case(f"p=4 training shape B=2 H=12 n={TRAIN_SEQ}", 16 + h,
                             (2, 12, 12, TRAIN_SEQ), 4)
        kw = dict(degree=4, scale=1.0 / h)
        again = grads_of(lambda *a: ops.poly_attention(*a, **kw), xs, dout)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"  {tag} training shape: two backward calls equal bit for bit: {same}")
        if not same:
            raise AssertionError(f"B2 backward {tag}: two calls differ")
        del again
        flat = [x.reshape(24, TRAIN_SEQ, h).contiguous() for x in (*xs, dout)]
        if dt == torch.float32:
            f64 = [x.double() for x in flat]
            with torch.no_grad():
                out64, den64 = pf.poly_flash_torch(*f64[:3], return_den=True, **kw)
                ref = pf.poly_flash_backward_torch(f64[3], *f64[:3], out64, den64, **kw)
            ref = [r.reshape(g.shape) for r, g in zip(ref, got)]
            e64 = grad_err(got, ref)
            log(f"  {tag} training shape vs float64: kernels {e64:.3e} of each gradient's max")
            check(f"{tag} training shape, kernels vs float64 (rel.)", e64, F32_TOL)
            del f64, out64, den64, ref
        del got
        kernel_occupancy(f"B2 backward kernels on the card ({tag})",
                         pf.backward_occupancy(h, dt), ptxas.get("poly_flash_bwd", {}),
                         B2_BWD_HEAVY, inst=B2_BWD_INST[(dtype_name(dt), h)])
        before = counts()
        q, k, v, do = flat
        o, den = pf.poly_flash_cuda(q, k, v, return_den=True, **kw)
        run = lambda: pf.poly_flash_backward_cuda(do, q, k, v, o, den, **kw)  # noqa: E731
        ms = event_ms(run)
        plain_ms = event_ms(lambda: pf.poly_flash_backward_torch(do, q, k, v, o, den, **kw),
                            iters=3, warmup=1)
        ms2 = event_ms(run)
        for name, fn in KERNELS.items():   # timing launches do not count
            fn.launches = before[name]
        bd = b2_bwd_bound(24, TRAIN_SEQ, h, 4, itemsize=2 if dt == torch.bfloat16 else 4)
        best = min(ms, ms2)
        log(f"  B2 backward {tag} bh=24 n={TRAIN_SEQ} p=4: kernel {best:.3f} ms (runs "
            f"{ms:.3f}, {ms2:.3f}), plain PyTorch {plain_ms:.3f} ms; bound {bd.tc_ms:.3f} ms "
            f"by {bd.tc_by} on the tensor cores ({bd.flops / 1e9:.1f} GFLOP, "
            f"{bd.nbytes / 1e6:.1f} MB), {bd.tc_ms / best:.1%} of it; library call: "
            f"{NO_LIBRARY}")
        log(f"  {tag}: worst gradient error {worst_rel:.3e} of its max|.|, {worst:.3e} "
            f"absolute")
        out[(dtype_name(dt), h)] = {"rel": worst_rel, "abs": worst, "ms": best,
                                    "plain_ms": plain_ms, "bound": bd}
        del xs, dout, flat, q, k, v, do, o, den
        torch.cuda.empty_cache()
    return out


def phase_poly_flash_grid():
    log("phase 1: poly_flash kernel vs plain PyTorch (ops.poly_attention)")
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for degree in (4, 8):
            for causal in (True, False):
                rnd = seeded(degree + causal)
                q, k, v = (rnd(2, 2, 128, 16, dtype=dt) for _ in range(3))
                kw = dict(degree=degree, scale=1.0 / 16, causal=causal)
                got = ops.poly_attention(q, k, v, **kw)
                want = ops.poly_attention(q, k, v, impl="torch", **kw)
                torch.cuda.synchronize()
                e = err(got, want)
                check(f"{str(dt)[6:]} p={degree} causal={causal} B=2 H=2 S=128 hd=16",
                      e, tol)
                if dt == torch.float32:
                    worst = max(worst, e)
    rnd = seeded(5)
    cases = (("f32 GQA 4:2, S=128", (2, 4, 128, 16), (2, 2, 128, 16), True),
             ("f32 unaligned n=77 (ragged tile, no padding)", (1, 2, 77, 16),
              (1, 2, 77, 16), True),
             ("f32 non-causal n=100, t=77, h=64", (2, 2, 100, 64), (2, 2, 77, 64),
              False),
             ("f32 non-causal n=64, t=96, hd=16", (2, 2, 64, 16), (2, 2, 96, 16),
              False))
    for name, sq, skv, causal in cases:
        q, k, v = rnd(*sq), rnd(*skv), rnd(*skv)
        kw = dict(degree=4, causal=causal)
        e = err(ops.poly_attention(q, k, v, **kw),
                ops.poly_attention(q, k, v, impl="torch", **kw))
        check(name, e, F32_TOL)
        worst = max(worst, e)
    for degree in (4, 8):
        q, k, v = poly_slice_inputs(2040)
        kw = dict(degree=degree, scale=1.0 / 64)
        e = err(ops.poly_attention(q, k, v, **kw),
                ops.poly_attention(q, k, v, impl="torch", **kw))
        torch.cuda.synchronize()
        check(f"f32 slice shape bh=4*12 n=2040 h=64 p={degree}", e, F32_TOL)
        worst = max(worst, e)
    return worst


def poly_slice_inputs(n):
    """q, k, v (4, 12, n, 64) as the poly4 prefill gives them: q and k
    LayerNorm'd (zero mean, unit variance per row), v O(1)."""
    rnd = seeded(12)
    q, k, v = rnd(4, 12, n, 64), rnd(4, 12, n, 64), rnd(4, 12, n, 64)
    ln = lambda x: torch.nn.functional.layer_norm(x, (64,), eps=1e-6)  # noqa: E731
    return ln(q), ln(k), v


LT_BENCH = dict(bh=4, m=32, k=64, blk=256)        # benchmarks/kernel_bench.py


def lt_bench_inputs(n):
    rnd = seeded(13)
    bh, m, k = LT_BENCH["bh"], LT_BENCH["m"], LT_BENCH["k"]
    return rnd(bh, n, m), rnd(bh, n, m), rnd(bh, n, k)


def phase_lt_mult_grid():
    log("phase 1: lt_mult kernel vs plain PyTorch (ops.lt_mult)")
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tol = LT_F32_TOL if dt == torch.float32 else LT_BF16_TOL
        for n, m, k, blk in ((64, 8, 16, 16), (128, 32, 8, 32), (96, 16, 16, 32),
                             (256, 64, 64, 64)):
            rnd = seeded(n + m)
            a, b, c = rnd(2, n, m, dtype=dt), rnd(2, n, m, dtype=dt), rnd(2, n, k, dtype=dt)
            got = ops.lt_mult(a, b, c, block_size=blk)
            want = ops.lt_mult(a, b, c, block_size=blk, impl="torch")
            torch.cuda.synchronize()
            e = check_close(f"{str(dt)[6:]} n={n} m={m} k={k} block={blk}", got, want,
                            tol * n, tol)
            if dt == torch.float32:
                worst = max(worst, e)
    for n in (32, 64, 96):
        for blk in (16, 32):
            for seed in (0, 271, 828):
                rnd = seeded(seed)
                a, b, c = rnd(1, n, 8), rnd(1, n, 8), rnd(1, n, 4)
                got = ops.lt_mult(a, b, c, block_size=blk)
                want = ops.lt_mult(a, b, c, block_size=blk, impl="torch")
                e = err(got, want)
                if not torch.allclose(got, want, atol=1e-3, rtol=1e-3):
                    raise AssertionError(f"lt_mult property n={n} block={blk} "
                                         f"seed={seed}: max error {e}")
                worst = max(worst, e)
    log(f"  property grid (n 32/64/96 x block 16/32 x 3 seeds, m=8, k=4): all within "
        f"1e-3, worst max|err| so far {worst:.3e}")
    kw = dict(block_size=LT_BENCH["blk"])
    for n in (2048, 16384):
        a, b, c = lt_bench_inputs(n)
        got = ops.lt_mult(a, b, c, **kw)
        want = ops.lt_mult(a, b, c, impl="torch", **kw)
        torch.cuda.synchronize()
        e = check_close(f"f32 kernel_bench shape bh=4 m=32 k=64 block=256 n={n}",
                        got, want, LT_F32_TOL * n, LT_F32_TOL)
        # At n = 16384 the reference's atol (2e-3 * n) is ~33 against outputs
        # of a few hundred: hold the error to max|out| as well, so that a
        # wrong tile term (~|a.b| |c|) fails at this shape too.
        rel = e / want.abs().max().item()
        log(f"    (relative to max|out| {want.abs().max().item():.1f}: {rel:.2e}, "
            f"limit {LT_BENCH_REL_TOL:.0e})")
        if not rel <= LT_BENCH_REL_TOL:
            raise AssertionError(f"lt_mult kernel_bench shape n={n}: max error "
                                 f"{e} is {rel:.2e} of max|out|, above "
                                 f"{LT_BENCH_REL_TOL:.0e}")
        worst = max(worst, e)
    # b 384: 3 query tiles a block, on a paired grid (bh 4, 66 blocks), so
    # that the middle CTA of each block takes its one tile alone.
    rnd = seeded(15)
    pa, pb, pc_ = rnd(4, 384 * 66, 32), rnd(4, 384 * 66, 32), rnd(4, 384 * 66, 64)
    got_p = ops.lt_mult(pa, pb, pc_, block_size=384)
    want_p = ops.lt_mult(pa, pb, pc_, block_size=384, impl="torch")
    torch.cuda.synchronize()
    e = check_close("f32 paired, odd tiles bh=4 m=32 k=64 block=384 n=25344",
                    got_p, want_p, LT_F32_TOL * 384 * 66, LT_F32_TOL)
    rel = e / want_p.abs().max().item()
    log(f"    (relative to max|out|: {rel:.2e}, limit {LT_BENCH_REL_TOL:.0e})")
    if not rel <= LT_BENCH_REL_TOL:
        raise AssertionError(f"lt_mult paired grid b=384: max error {e} is {rel:.2e} of "
                             f"max|out|, above {LT_BENCH_REL_TOL:.0e}")
    # Bit for bit at n = 16384: a second run, and bh row 2 computed alone
    # (the batch runs paired query tiles, the row alone unpaired).
    again = ops.lt_mult(a, b, c, **kw)
    solo = ops.lt_mult(*(x[2:3].contiguous() for x in (a, b, c)), **kw)
    torch.cuda.synchronize()
    same, alone = torch.equal(again, got), torch.equal(solo[0], got[2])
    log(f"  f32 kernel_bench shape n=16384: two runs equal bit for bit: {same}; bh row 2 "
        f"alone equals it in the batch of 4, bit for bit: {alone}")
    if not (same and alone):
        raise AssertionError("lt_mult: not bit-stable across runs or across the batch")
    return worst


def phase_tolerance_study():
    """Why the kernels take three TF32 products per f32 product: at the
    slices' shapes (B3: kernel_bench's, n = 16384), the plain versions with
    single-pass TF32 matmuls (PyTorch's allow_tf32, never on the main path;
    set back to False after) and the kernels (3xTF32), each against the
    plain full-f32 result. B3's errors are shares of max|out|, as its gate
    holds them."""
    b1_in = slice_inputs()
    b1_kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    b2_in = poly_slice_inputs(2040)
    b2_kw = dict(degree=4, scale=1.0 / 64)
    b3_in = lt_bench_inputs(16384)
    b3_kw = dict(block_size=LT_BENCH["blk"])

    def plain():
        return (ops.polysketch_attention(*b1_in, impl="torch", **b1_kw),
                ops.poly_attention(*b2_in, impl="torch", **b2_kw),
                ops.lt_mult(*b3_in, impl="torch", **b3_kw))
    f32 = plain()
    kernel = (ops.polysketch_attention(*b1_in, **b1_kw), ops.poly_attention(*b2_in, **b2_kw),
              ops.lt_mult(*b3_in, **b3_kw))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    b3_max = f32[2].abs().max().item()
    log(f"  tolerance study (f32 slice shapes, max|err| against the plain full-f32 "
        f"result): one TF32 product (plain, allow_tf32) B1 {err(tf32[0], f32[0]):.3e}, "
        f"B2 {err(tf32[1], f32[1]):.3e}; 3xTF32 kernels B1 {err(kernel[0], f32[0]):.3e}, "
        f"B2 {err(kernel[1], f32[1]):.3e}; gate {F32_TOL:.0e}. B3 bh=4 n=16384, as a share "
        f"of max|out| {b3_max:.1f}: one TF32 product {err(tf32[2], f32[2]) / b3_max:.2e}, "
        f"3xTF32 kernel {err(kernel[2], f32[2]) / b3_max:.2e}; gate {LT_BENCH_REL_TOL:.0e}")


def slice_inputs():
    """Inputs at the slice's shape, scaled like the model's: q, k are
    LayerNorm'd (unit variance per row), the sketches are O(1)."""
    rnd = seeded(11)
    B, H, n, r, h = 4, 12, 2048, 32, 64
    return (rnd(B, H, n, r, scale=0.5), rnd(B, H, n, r, scale=0.5),
            rnd(B, H, n, h), rnd(B, H, n, h), rnd(B, H, n, h))


# ---------------------------------------------------------------------------
# phase 2: full-width serving through generate
# ---------------------------------------------------------------------------

def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(model):
    log("phase 2: gpt2s-polysketch full width, greedy generate, 4 x (2040 + 16)")
    cfg = model.cfg
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(4, 2040))
    generate(model, prompts[:, :64], 2)            # warm-up (allocator, cuBLAS)
    zero_counts()
    res, dt = timed(lambda: generate(model, prompts, 16))
    run_counts = counts()
    launches = run_counts["polysketch_causal"]
    toks = res.tokens.cpu().numpy()
    if toks.shape != (4, 16) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} [{toks.min()}, {toks.max()}]")
    if not torch.isfinite(res.logits_last).all():
        raise AssertionError("non-finite logits")
    log(f"  layers {cfg.n_layers} x d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, block {cfg.lt_block_size}, r {cfg.sketch_size}")
    log(f"  generate: {dt * 1e3:.1f} ms for 4 x 16 tokens; B1 launches in the run: "
        f"{launches} (all kernels: {run_counts})")
    if launches <= 0:
        raise AssertionError("the main path never launched the B1 kernel")
    _, t_pre = timed(lambda: generate(model, prompts, 0))
    _, t_all = timed(lambda: generate(model, prompts, 16))
    decode_ms = (t_all - t_pre) * 1e3 / 16
    log(f"  prefill (generate, 0 new tokens): {t_pre * 1e3:.1f} ms; decode "
        f"{decode_ms:.2f} ms/token-step; {4 * 16 / t_all:.1f} generated tok/s "
        f"({4 * (2040 + 16) / t_all:.0f} tok/s prompt included)")
    for i, row in enumerate(toks):
        log(f"  req{i}: {' '.join(map(str, row.tolist()))}")
    profile_generate(model, prompts)
    return launches, prompts


def device_rows(prof):
    """The device-side rows of a torch.profiler run's key_averages()."""
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def profile_generate(model, prompts):
    """Device busy share and the top device kernels of one prefill and of
    the 16 decode steps, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, steps in (("prefill", 0), ("prefill+decode16", 16)):
        with profile(activities=acts) as prof:
            _, wall = timed(lambda: generate(model, prompts, steps))
        rows = device_rows(prof)
        busy = sum(dev_us(e) for e in rows) / 1e6
        log(f"  profile {label}: wall {wall * 1e3:.1f} ms (profiler on), device "
            f"busy {busy * 1e3:.1f} ms = {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
        for e in sorted(rows, key=dev_us, reverse=True)[:6]:
            log(f"    {dev_us(e) / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 3: the port against itself
# ---------------------------------------------------------------------------

def phase_self_checks(model, prompts):
    log("phase 3: port self-checks")
    st = model.state
    tokens = torch.from_numpy(prompts).cuda()
    with torch.inference_mode():
        cold_logits, cold = st.prefill(tokens)
        _, part = st.prefill(tokens[:, :1024])
        res_logits, res = st.resume(tokens[:, 1024:], part, 1024)
    torch.cuda.synchronize()
    same = torch.equal(cold_logits, res_logits) and all(
        a.pos == b.pos and all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
        for a, b in zip(cold, res))
    log(f"  prefill 1024 + resume 1016 == cold prefill 2040, bit for bit "
        f"(logits and all {len(cold)} layer caches): {same}")
    if not same:
        raise AssertionError("resumed prefill differs from the cold prefill")

    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, size=(2, 2048))).cuda()
    with torch.inference_mode():
        pc.polysketch_causal_cuda.launches = 0
        got, _ = model.lm(x, mode="train")
        launches = pc.polysketch_causal_cuda.launches
        plain = functools.partial(ops.polysketch_attention, impl="torch")
        with mock.patch.object(ops, "polysketch_attention", plain):
            want, _ = model.lm(x, mode="train")
    torch.cuda.synchronize()
    log(f"  train forward B=2 S=2048: B1 launches {launches} "
        f"(one per layer: {model.cfg.n_layers}); plain run: "
        f"{pc.polysketch_causal_cuda.launches - launches}")
    if launches != model.cfg.n_layers or pc.polysketch_causal_cuda.launches != launches:
        raise AssertionError("the train forward did not run B1 once per layer, "
                             "or the plain run launched it")
    rel = err(got, want) / want.abs().max().item()
    check("train forward B=2 S=2048 full width: kernel vs plain (rel. logits)",
          rel, F32_TOL)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite train logits")

    cfg = get_config("gpt2s-polysketch", smoke=True)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 13))
    on_card = generate(build_model(cfg, device="cuda", seed=3), prompt, 8)
    on_cpu = generate(build_model(cfg, device="cpu", seed=3), prompt, 8)
    same = torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
    check("SMOKE generate logits, card (kernel) vs CPU (plain)",
          err(on_card.logits_last.cpu(), on_cpu.logits_last), F32_TOL)
    log(f"  SMOKE greedy tokens (13-token prompt, 8 steps, crosses a fold) equal "
        f"on card and CPU: {same}")
    if not same:
        raise AssertionError("SMOKE greedy tokens differ between card and CPU")


def phase_serve_kv(model, prompts, kernel=None):
    """A model with a full KV cache served as phase 2 serves polysketch:
    gpt2s-poly4 (kernel "poly_flash": B2 launched once per layer by the one
    prefill call; decode timed with and without the KV cache's copy per
    step), or gpt2s-softmax (kernel None: plain ops, no port kernel
    launched)."""
    cfg = model.cfg
    steps, max_len = 16, prompts.shape[1] + 16
    log(f"phase 2: {cfg.name} full width, greedy generate, 4 x ({prompts.shape[1]} + "
        f"{steps}), KV cache of {max_len}")
    gen = lambda n_new: generate(model, prompts, n_new, max_len=max_len)  # noqa: E731
    generate(model, prompts[:, :64], 2)            # warm-up (allocator, cuBLAS)
    zero_counts()
    res, dt = timed(lambda: gen(steps))
    run_counts = counts()
    launches = run_counts[kernel] if kernel else 0
    toks = res.tokens.cpu().numpy()
    if toks.shape != (4, steps) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} [{toks.min()}, {toks.max()}]")
    if not torch.isfinite(res.logits_last).all():
        raise AssertionError("non-finite logits")
    mech = (f"exact polynomial attention p={cfg.poly_degree}"
            if cfg.attention == "polynomial" else f"{cfg.attention} attention")
    log(f"  layers {cfg.n_layers} x d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, {mech}")
    expected = {name: cfg.n_layers if name == kernel else 0 for name in KERNELS}
    log(f"  generate: {dt * 1e3:.1f} ms for 4 x {steps} tokens; launches in the run: "
        f"{run_counts} (expected {expected})")
    if run_counts != expected:
        raise AssertionError(f"the {cfg.name} generate did not launch "
                             f"{kernel or 'no port kernel'} exactly as expected")
    _, t_pre = timed(lambda: gen(0))
    _, t_all = timed(lambda: gen(steps))
    log(f"  prefill (generate, 0 new tokens): {t_pre * 1e3:.1f} ms; decode "
        f"{(t_all - t_pre) * 1e3 / steps:.2f} ms/token-step; {4 * steps / t_all:.1f} "
        f"generated tok/s ({4 * (prompts.shape[1] + steps) / t_all:.0f} tok/s prompt "
        f"included)")
    if kernel:
        decode_copy_cost(model, prompts, steps, max_len)
    for i, row in enumerate(toks):
        log(f"  req{i}: {' '.join(map(str, row.tolist()))}")
    profile_generate(model, prompts)
    return launches


def decode_copy_cost(model, prompts, steps, max_len):
    """What the KV cache's copy per decode step (caches are values) costs:
    16 decode steps from one prefill, timed with the copy and with the
    buffers written in place, in turns; and the device time of the copies
    alone (both buffers of every layer)."""
    st = model.state
    tokens = torch.from_numpy(prompts).cuda()
    s0 = prompts.shape[1]
    with torch.inference_mode():
        last, cache = st.prefill(tokens, max_len=max_len)
        tok = torch.argmax(last, dim=-1)[:, None]

        def run():
            c = cache
            for i in range(steps):
                _, c = st.decode_step(tok, s0 + i, c)
        in_place = lambda: mock.patch.object(dec, "_writable",  # noqa: E731
                                             lambda x, inplace=False: x)
        ms = {"copy": [], "in place": []}
        for label in ("copy", "in place", "in place", "copy", "copy", "in place"):
            if label == "copy":
                dt = timed(run)[1]
            else:
                with in_place():
                    dt = timed(run)[1]
            ms[label].append(dt * 1e3 / steps)
        copy_ms = event_ms(lambda: [dec._writable(x) for c in cache for x in (c.k, c.v)])
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"  decode step, KV cache copied (as shipped): median {med['copy']:.2f} ms "
        f"{[round(x, 2) for x in ms['copy']]}; written in place: median "
        f"{med['in place']:.2f} ms {[round(x, 2) for x in ms['in place']]} "
        f"(16 steps a run, host clock with sync, runs in turns); difference "
        f"{med['copy'] - med['in place']:.2f} ms/step")
    nbytes = sum(x.numel() * x.element_size() for c in cache for x in (c.k, c.v))
    log(f"  device time of the copies alone: {copy_ms:.3f} ms/step "
        f"({2 * nbytes / 1e6:.0f} MB read and written, CUDA events)")


def phase_poly_self_checks(model, prompts):
    log("phase 3: gpt2s-poly4 self-checks")
    cfg = model.cfg
    plain = mock.patch.object(ops, "poly_attention",
                              functools.partial(ops.poly_attention, impl="torch"))
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 2048))).cuda()
    with torch.inference_mode():
        zero_counts()
        got, _ = model.lm(x, mode="train")
        launches = pf.poly_flash_cuda.launches
        with plain:
            want, _ = model.lm(x, mode="train")
    torch.cuda.synchronize()
    log(f"  train forward B=2 S=2048: B2 launches {launches} (one per layer: "
        f"{cfg.n_layers}); plain run: {pf.poly_flash_cuda.launches - launches}")
    if launches != cfg.n_layers or pf.poly_flash_cuda.launches != launches:
        raise AssertionError("the train forward did not run B2 once per layer, "
                             "or the plain run launched it")
    check("train forward B=2 S=2048 full width: kernel vs plain (rel. logits)",
          err(got, want) / want.abs().max().item(), F32_TOL)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite train logits")

    tokens = torch.from_numpy(prompts).cuda()
    max_len = prompts.shape[1] + 16
    with torch.inference_mode():
        got, _ = model.state.prefill(tokens, max_len=max_len)
        with plain:
            want, _ = model.state.prefill(tokens, max_len=max_len)
    torch.cuda.synchronize()
    check(f"prefill 4 x {prompts.shape[1]}: last-position logits, kernel vs plain (rel.)",
          err(got, want) / want.abs().max().item(), F32_TOL)

    for degree in (4, 8):
        smoke = get_config("gpt2s-polysketch", smoke=True, attention="polynomial",
                           poly_degree=degree)
        prompt = np.random.default_rng(2).integers(0, smoke.vocab_size, size=(2, 13))
        on_card = generate(build_model(smoke, device="cuda", seed=3), prompt, 8)
        on_cpu = generate(build_model(smoke, device="cpu", seed=3), prompt, 8)
        same = torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
        check(f"SMOKE-polynomial p={degree} generate logits, card (kernel) vs CPU (plain)",
              err(on_card.logits_last.cpu(), on_cpu.logits_last), F32_TOL)
        log(f"  SMOKE-polynomial p={degree} greedy tokens (13-token prompt, 8 steps) "
            f"equal on card and CPU: {same}")
        if not same:
            raise AssertionError("SMOKE-polynomial greedy tokens differ between card "
                                 "and CPU")


def phase_softmax_self_checks(model):
    """gpt2s-softmax at full width: a prefill of 2040 tokens and 8 decode
    steps fed the true next tokens give the train-mode logits at the same
    positions; SMOKE-softmax greedy tokens on the card equal the CPU's."""
    log("phase 3: gpt2s-softmax self-checks")
    cfg = model.cfg
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, 2048))).cuda()
    s0 = 2040
    with torch.inference_mode():
        want, _ = model.lm(x, mode="train")
        last, cache = model.state.prefill(x[:, :s0], max_len=2048)
        got = [last]
        for pos in range(s0, 2047):
            last, cache = model.state.decode_step(x[:, pos:pos + 1], pos, cache)
            got.append(last)
    torch.cuda.synchronize()
    got, want = torch.stack(got, 1), want[:, s0 - 1:2047]
    check("prefill 2 x 2040 + 7 decode steps vs train-mode logits (rel.)",
          err(got, want) / want.abs().max().item(), F32_TOL)
    smoke = get_config("gpt2s-polysketch", smoke=True, attention="softmax")
    prompt = np.random.default_rng(2).integers(0, smoke.vocab_size, size=(2, 13))
    on_card = generate(build_model(smoke, device="cuda", seed=3), prompt, 8)
    on_cpu = generate(build_model(smoke, device="cpu", seed=3), prompt, 8)
    same = torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
    check("SMOKE-softmax generate logits, card vs CPU",
          err(on_card.logits_last.cpu(), on_cpu.logits_last), F32_TOL)
    log(f"  SMOKE-softmax greedy tokens (13-token prompt, 8 steps) equal on card and "
        f"CPU: {same}")
    if not same:
        raise AssertionError("SMOKE-softmax greedy tokens differ between card and CPU")


# ---------------------------------------------------------------------------
# phase 5: the continuous-batching ServeEngine at full width
# ---------------------------------------------------------------------------

ENGINE_LENS = (600, 1024, 1500, 2048, 2600, 3072, 3500, 4096)
# 16 new tokens a request (cut from 32 to make room for phase 14)
ENGINE_SLOTS, ENGINE_GEN, ENGINE_BUDGET = 4, 16, 2048
ENGINE_SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
ENGINE_LP_TOL = 1e-3
# the CUDA runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def engine_workload(vocab):
    """8 requests: prompt lengths a seeded permutation of ENGINE_LENS (so
    slots sit at different depths, and polysketch prefills run whole blocks
    and tails), requests 0-3 greedy and 4-7 sampled with a seed each."""
    rng = np.random.default_rng(7)
    lens = rng.permutation(ENGINE_LENS)
    prompts = [rng.integers(0, vocab, size=int(n)) for n in lens]
    samp = [SamplingParams() if i < 4 else
            SamplingParams(seed=100 + i, **ENGINE_SAMPLED) for i in range(8)]
    return prompts, samp


def new_engine(model, **kw):
    """phase 5's engine: ENGINE_SLOTS slots, log-probabilities, prefill
    budget ENGINE_BUDGET, overlap on; `kw` adds a prefix cache, telemetry."""
    return ServeEngine(model, slots=ENGINE_SLOTS, max_len=max(ENGINE_LENS) + ENGINE_GEN,
                       logprobs=True, prefill_budget=ENGINE_BUDGET, overlap=True, **kw)


def engine_serve(eng, prompts, samp, order):
    """Serve the requests in `order` (all submitted at t = 0) through `eng`.
    Returns ({request index: RequestOutput}, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid_of = {eng.submit(prompts[i], ENGINE_GEN, sampling=samp[i]): i for i in order}
    outs = eng.run()
    torch.cuda.synchronize()
    return {rid_of[o.rid]: o for o in outs}, time.perf_counter() - t0


def engine_run(model, prompts, samp, order, **kw):
    """Serve the requests in `order` through a new engine. Returns
    ({request index: RequestOutput}, engine, wall s)."""
    eng = new_engine(model, **kw)
    outs, wall = engine_serve(eng, prompts, samp, order)
    return outs, eng, wall


def profile_engine_ticks(model, prompts, samp, ticks=8, eng=None, cut=600):
    """The CUDA runtime calls and device memory copies of `ticks` decode
    ticks with every slot decoding (four sampled requests, the first `cut`
    tokens of prompts 4-7, and no admission in flight), from
    torch.profiler, less what the profiler makes around an empty region:
    returns ({runtime call: count a tick}, {copy kind: count a tick},
    kernel launches of one sample_step over the slots), copy kinds "DtoH",
    "HtoD", "DtoD". `eng`: the engine to profile (default a new one)."""
    from torch.profiler import ProfilerActivity, profile
    eng = eng or new_engine(model)
    for i in range(4, 8):                        # long enough for the window
        eng.submit(prompts[i][:cut], ticks + 8, sampling=samp[i])
    while eng.n_active < ENGINE_SLOTS or eng.scheduler.active:
        eng.step()
    eng.step()                                   # the pipeline holds a tick
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])

    def tally(run):
        with profile(activities=acts) as prof:
            run()
        calls, copies = {}, {}
        for e in prof.key_averages():
            if e.key.startswith("cuda"):
                calls[e.key] = e.count
            elif e.key.startswith("Memcpy"):
                kind = next((k for k in ("DtoH", "HtoD", "DtoD") if k in e.key), e.key)
                copies[kind] = copies.get(kind, 0) + e.count
        return calls, copies

    base_calls, _ = tally(lambda: None)          # the profiler's own calls
    calls, copies = tally(lambda: [eng.step() for _ in range(ticks)])
    logits = torch.zeros((ENGINE_SLOTS, model.cfg.vocab_size), device=eng.device)
    with torch.inference_mode():
        sampler, _ = tally(lambda: sample_step(eng._keys, logits, *eng._samp))
    eng.run()
    calls = {k: (v - base_calls.get(k, 0)) / ticks for k, v in sorted(calls.items())}
    launches = sum(v - base_calls.get(k, 0) for k, v in sampler.items()
                   if k.startswith("cudaLaunchKernel"))
    return calls, {k: v / ticks for k, v in sorted(copies.items())}, launches


def phase_engine(model, kernel=None):
    """gpt2s-polysketch / gpt2s-poly4 / gpt2s-softmax at full width and
    depth served through ServeEngine: 8 requests on 4 slots (prompts of
    600-4096 tokens, 16 new tokens each, requests 0-3 greedy, 4-7 sampled
    at temperature 0.8, top-k 40, top-p 0.95), prefill budget 2048 tokens a
    tick, overlap on, all submitted at t = 0. The run is made twice: in
    reverse order first (it also warms the allocator and cuBLAS), then in
    order with every kernel's launches and the plain versions' calls
    counted. Checks: (a) each request's log-probabilities equal
    log_softmax of a train-mode forward over prompt + emitted tokens
    within 1e-3; (b) the greedy requests' tokens equal a batch-1
    generate's; (c) the two runs' tokens are the same bits. `kernel`: the
    kernel the model's prefill runs (None for softmax). Returns the
    kernel's launches in the counted run."""
    cfg = model.cfg
    t_phase = time.perf_counter()
    log(f"phase 5: {cfg.name} full width and depth ({cfg.n_layers} layers) through "
        f"ServeEngine: 8 requests, {ENGINE_SLOTS} slots, prompts {list(ENGINE_LENS)}, "
        f"{ENGINE_GEN} new tokens, requests 0-3 greedy, 4-7 sampled {ENGINE_SAMPLED}, "
        f"prefill budget {ENGINE_BUDGET}, overlap on, all at t = 0")
    prompts, samp = engine_workload(cfg.vocab_size)
    rev, _, _ = engine_run(model, prompts, samp, range(7, -1, -1))
    zero_counts()
    with PlainCalls() as plain:
        outs, eng, wall = engine_run(model, prompts, samp, range(8))
    run_counts = counts()
    st = eng.stats()
    if cfg.attention == "polysketch":      # one B1 call a layer per block-grid chunk
        chunks = sum(-(-len(p) // cfg.lt_block_size) for p in prompts)
    else:                                  # one whole-prompt prefill each
        chunks = len(prompts) if kernel else 0
    expected = {name: cfg.n_layers * chunks if name == kernel else 0 for name in KERNELS}
    ttft = np.array([o.ttft_s for o in outs.values()]) * 1e3
    gen = sum(len(o.tokens) for o in outs.values())
    log(f"  run: {wall * 1e3:.1f} ms for {gen} generated tokens = {gen / wall:.1f} "
        f"generated tok/s (prompts {sum(map(len, prompts))} tokens); TTFT p50 "
        f"{np.percentile(ttft, 50):.1f} ms, p99 {np.percentile(ttft, 99):.1f} ms; "
        f"{st['decode_steps']} decode ticks, {st['decode_s'] * 1e3 / st['decode_steps']:.2f} "
        f"ms a tick (decode pipeline wall / ticks), tick gap median "
        f"{st['tick_gap_ms']['median']:.2f} ms, p95 {st['tick_gap_ms']['p95']:.2f} ms; "
        f"{st['scheduler']['chunks']} prefill chunks")
    log(f"  launches in the run: {run_counts} (expected {expected}); plain-version "
        f"calls: {plain.calls}")
    if run_counts != expected or plain.calls:
        raise AssertionError(f"the {cfg.name} engine run did not launch "
                             f"{kernel or 'no port kernel'} once a layer per prefill "
                             "chunk and nothing else, or called a plain version")
    calls, copies, sampler = profile_engine_ticks(model, prompts, samp)
    syncs = sum(v for k, v in calls.items() if k in SYNC_CALLS)
    d2h = copies.get("DtoH", 0)
    log(f"  CUDA runtime calls a decode tick (4 slots decoding, sampled; the "
        f"profiler's own subtracted): " + ", ".join(f"{k} {v:g}" for k, v in calls.items()))
    log(f"  host syncs a tick: {syncs:g} (stream, device and event syncs and blocking "
        f"copies; the one allowed is the wait for the token copy's event); device "
        f"memory copies a tick: {copies}; kernel launches of one sample_step over the "
        f"{ENGINE_SLOTS} slots (the sampler of a tick with a sampled slot): {sampler:g}")
    if syncs > 1 or d2h > 1:
        raise AssertionError(f"the decode tick syncs the host {syncs:g} times and copies "
                             f"device to host {d2h:g} times a tick; one of each is "
                             "allowed")

    worst = 0.0
    for i, o in outs.items():
        if len(o.tokens) != ENGINE_GEN or o.finish_reason != "length":
            raise AssertionError(f"request {i}: {len(o.tokens)} tokens, {o.finish_reason}")
        if o.tokens.min() < 0 or o.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {i}: token out of range")
        seq = np.concatenate([prompts[i], o.tokens[:-1]])
        with torch.inference_mode():
            logits, _ = model.lm(torch.from_numpy(seq)[None].cuda(), mode="train")
            lsm = torch.log_softmax(logits[0, len(prompts[i]) - 1:].float(), dim=-1)
            want = lsm.gather(1, torch.from_numpy(o.tokens.astype(np.int64)).cuda()[:, None])
        e = float(np.abs(want[:, 0].cpu().numpy() - o.logprobs).max())
        worst = max(worst, e)
    check("(a) engine logprobs vs log_softmax of a train-mode forward", worst,
          ENGINE_LP_TOL)
    for i in range(4):
        ref = generate(model, prompts[i][None], ENGINE_GEN,
                       max_len=len(prompts[i]) + ENGINE_GEN)
        same = np.array_equal(ref.tokens[0].cpu().numpy(), outs[i].tokens)
        log(f"  (b) request {i} (greedy, {len(prompts[i])} tokens): engine tokens == "
            f"batch-1 generate's: {same}")
        if not same:
            raise AssertionError(f"request {i}: engine tokens differ from generate's")
    same = all(np.array_equal(outs[i].tokens, rev[i].tokens) for i in range(8))
    log(f"  (c) the 8 requests submitted in reverse order give the same tokens, bit for "
        f"bit: {same}")
    if not same:
        raise AssertionError("engine tokens depend on submission order")
    for i in (0, 4):
        log(f"  req{i}: {' '.join(map(str, outs[i].tokens[:16].tolist()))} ...")
    log(f"  phase 5 for {cfg.name}: {time.perf_counter() - t_phase:.1f} s")
    return run_counts.get(kernel, 0) if kernel else 0


# ---------------------------------------------------------------------------
# phase 9: the prefix-reuse snapshot cache and the serving telemetry
# ---------------------------------------------------------------------------

PREFIX_SHARED = 3072                # the shared system prompt: 3 blocks of 1024
PREFIX_SUFFIX = (256, 1024)         # each request's own suffix: 256-1023 tokens
PREFIX_CACHE_BYTES = 512 << 20
PREFIX_DIR = os.path.join(ROOT, "build", "prefix_cache")   # git-ignored


def reckon_snapshot_bytes(cfg) -> int:
    """One prefix snapshot: the folded state z of every layer, (kv heads,
    r^2, h + 1) in f32, whatever the prefix's length."""
    return (cfg.n_layers * cfg.n_kv_heads * cfg.sketch_size ** 2
            * (cfg.resolved_head_dim + 1) * 4)


def prefix_workload(vocab):
    """8 requests: one 3072-token shared system prompt, then a seeded suffix
    each (lengths in PREFIX_SUFFIX), requests 0-3 greedy and 4-7 sampled as
    in phase 5. Also 8 warm-up prompts: the same system prompt and suffix
    lengths, other suffix tokens. Returns (prompts, warm prompts, samp)."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, vocab, PREFIX_SHARED)
    lens = rng.integers(*PREFIX_SUFFIX, size=8)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)]) for n in lens]
    warm = [np.concatenate([shared, rng.integers(0, vocab, n)]) for n in lens]
    _, samp = engine_workload(vocab)
    return prompts, warm, samp


def prefix_run(label, eng, prompts, samp, blk):
    """One counted run of the workload through `eng`: B1's launches, the
    peaks of host RSS and device memory (the engine's memory sampler), and
    a summary line. Returns (outputs by request, its row for the JSON line)."""
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with PlainCalls() as plain:
        outs, wall = engine_serve(eng, prompts, samp, range(8))
    eng.telemetry.memory.sample()
    launched = counts()
    st = eng.stats()
    reg = eng.telemetry.registry
    pcs = st.get("prefix_cache", {})
    ttft = np.array([o.ttft_s for o in outs.values()]) * 1e3
    gen = sum(len(o.tokens) for o in outs.values())
    row = {"run": label, "wall_ms": wall * 1e3, "ttft_p50_ms": np.percentile(ttft, 50),
           "ttft_p99_ms": np.percentile(ttft, 99),
           "ms_a_tick": st["decode_s"] * 1e3 / st["decode_steps"],
           "generated_tok_s": gen / wall, "prefill_host_ms": st["prefill_s"] * 1e3,
           "b1_launches": launched["polysketch_causal"], "plain_calls": plain.calls,
           "hits": pcs.get("hits", 0), "restored_tokens": pcs.get("hit_tokens", 0),
           "disk_loads": pcs.get("disk_loads", 0), "disk_writes": pcs.get("disk_writes", 0),
           "cache_bytes": pcs.get("bytes", 0), "coalesced": st["scheduler"]["coalesced"],
           "promote_splits": st["scheduler"]["promote_splits"],
           "retraces": st["retraces"],
           "host_peak_gib": reg.get("serve_host_rss_peak_bytes").value / 2**30,
           "device_peak_gib": reg.get("serve_device_peak_bytes").value / 2**30}
    log(f"  run {label}: {wall * 1e3:.1f} ms, TTFT p50 {row['ttft_p50_ms']:.1f} ms, p99 "
        f"{row['ttft_p99_ms']:.1f} ms; {row['ms_a_tick']:.2f} ms a tick; "
        f"{row['generated_tok_s']:.1f} generated tok/s; prefill host dispatch "
        f"{row['prefill_host_ms']:.1f} ms; B1 launches {row['b1_launches']} (expected "
        f"{blk}); hits {row['hits']}, restored tokens {row['restored_tokens']}, disk "
        f"loads {row['disk_loads']}, writes {row['disk_writes']}, cache "
        f"{row['cache_bytes']} B; coalesced {row['coalesced']}, promote splits "
        f"{row['promote_splits']}; retraces {row['retraces']}; peak host "
        f"{row['host_peak_gib']:.2f} GiB, device {row['device_peak_gib']:.2f} GiB")
    expected = {name: blk if name == "polysketch_causal" else 0 for name in KERNELS}
    if launched != expected or plain.calls:
        raise AssertionError(f"run {label}: launches {launched} (B1 expected {blk}, no "
                             f"other kernel) and {plain.calls} plain-version calls")
    return outs, row


def phase_prefix_cache(model, card):
    """gpt2s-polysketch at full width and depth, f32, serving a shared
    system prompt through the prefix cache: 8 requests on 4 slots, each a
    3072-token system prompt and its own 256-1023-token suffix, 16 new
    tokens, requests 0-3 greedy and 4-7 sampled, prefill budget 2048,
    overlap on, all at t = 0, in three runs: A with no prefix cache; B
    with PrefixCache(512 MiB, save_dir) and Telemetry(trace, memory),
    after a warm-up run of the same system prompt with other suffixes and
    reset_stats(); C a new engine with a fresh PrefixCache on the same
    save_dir, warming from the disk. Gates: tokens and log-probabilities
    equal bit for bit across A, B, C; B hits, C loads from the disk; B1
    launches once a layer per block of what is prefilled (A: every block
    of every prompt; B and C: the suffix's block); B's decode ticks with
    tracing on keep phase 5's one host sync and one device-to-host copy;
    B's trace is valid; no retrace in B; one snapshot's bytes equal
    reckon_snapshot_bytes. Returns {run: B1 launches}."""
    cfg = model.cfg
    blk = cfg.lt_block_size
    t_phase = time.perf_counter()
    log(f"phase 9: {cfg.name} full width and depth ({cfg.n_layers} layers), f32, prefix "
        f"cache: 8 requests, {ENGINE_SLOTS} slots, a {PREFIX_SHARED}-token shared system "
        f"prompt + suffixes of {PREFIX_SUFFIX[0]}-{PREFIX_SUFFIX[1] - 1} tokens, "
        f"{ENGINE_GEN} new tokens, requests 0-3 greedy, 4-7 sampled {ENGINE_SAMPLED}, "
        f"prefill budget {ENGINE_BUDGET}, overlap on, all at t = 0; card {card}")
    prompts, warm, samp = prefix_workload(cfg.vocab_size)
    per_layer = cfg.n_layers
    cold_blocks = per_layer * sum(-(-len(p) // blk) for p in prompts)
    hit_blocks = per_layer * sum(-(-(len(p) - PREFIX_SHARED) // blk) for p in prompts)
    shutil.rmtree(PREFIX_DIR, ignore_errors=True)
    rows, outs = {}, {}

    outs["A"], rows["A"] = prefix_run("A (no prefix cache)", new_engine(
        model, telemetry=Telemetry(memory=True)), prompts, samp, cold_blocks)
    tel = Telemetry(trace=True, memory=True)
    pc = PrefixCache(PREFIX_CACHE_BYTES, save_dir=PREFIX_DIR)
    eng_b = new_engine(model, prefix_cache=pc, telemetry=tel)
    engine_serve(eng_b, warm, samp, range(8))
    warm_sch = eng_b.stats()["scheduler"]
    warm_pc = pc.stats()
    log(f"  B's warm-up (the system prompt, other suffixes): hits {warm_pc['hits']}, "
        f"inserts {warm_pc['inserts']}, disk writes {warm_pc['disk_writes']} (the "
        f"admission ticks that insert: each write copies a snapshot to the host), "
        f"coalesced {warm_sch['coalesced']}, promote splits {warm_sch['promote_splits']}")
    eng_b.reset_stats()
    outs["B"], rows["B"] = prefix_run("B (memory tier, tracing on)", eng_b, prompts, samp,
                                      hit_blocks)
    gc.collect()
    outs["C"], rows["C"] = prefix_run("C (a new engine, the disk tier)", new_engine(
        model, prefix_cache=PrefixCache(PREFIX_CACHE_BYTES, save_dir=PREFIX_DIR),
        telemetry=Telemetry(memory=True)), prompts, samp, hit_blocks)

    for run in ("B", "C"):
        for i, o in outs["A"].items():
            got = outs[run][i]
            if not (np.array_equal(got.tokens, o.tokens)
                    and np.array_equal(got.logprobs, o.logprobs)):
                raise AssertionError(f"request {i}: run {run}'s tokens or log-probabilities "
                                     "differ from run A's")
    log("  tokens and log-probabilities of the 8 requests equal bit for bit across A, B "
        "and C: True")
    b, c = rows["B"], rows["C"]
    if not (b["hits"] > 0 and b["restored_tokens"] > 0 and c["disk_loads"] > 0):
        raise AssertionError(f"B hits {b['hits']}, restored {b['restored_tokens']}; C disk "
                             f"loads {c['disk_loads']}")
    if not b["b1_launches"] < rows["A"]["b1_launches"] > c["b1_launches"]:
        raise AssertionError("B1 launched no fewer times with the prefix cache")
    if b["retraces"]:
        raise AssertionError(f"B: {b['retraces']} retraces after the warm-up "
                             f"({tel.watchdog.cache_sizes()})")
    trace = tel.export_trace()
    errs = validate_trace(trace)
    log(f"  B's trace: {len(trace['traceEvents'])} events, validate_trace: "
        f"{errs[:3] or 'valid'}; entry-point signatures {tel.watchdog.cache_sizes()}")
    if errs:
        raise AssertionError(f"B's trace is not valid: {errs[:5]}")
    nbytes = [snapshot_nbytes(e.snapshot) for e in pc._entries.values()]
    want = reckon_snapshot_bytes(cfg)
    log(f"  snapshot bytes: {nbytes} (reckoned {want} = {cfg.n_layers} layers x "
        f"{cfg.n_kv_heads} kv heads x {cfg.sketch_size}^2 x {cfg.resolved_head_dim + 1} x 4)")
    if not nbytes or any(n != want for n in nbytes):
        raise AssertionError(f"snapshot bytes {nbytes} != {want}")

    calls, copies, _ = profile_engine_ticks(model, prompts, samp, eng=eng_b,
                                            cut=None)
    syncs = sum(v for k, v in calls.items() if k in SYNC_CALLS)
    d2h = copies.get("DtoH", 0)
    log(f"  B's decode ticks with tracing and the memory sampler on (4 slots decoding, "
        f"sampled, restored from the cache; no insert, so no disk write): host syncs "
        f"{syncs:g}, device memory copies {copies} a tick; CUDA runtime calls: "
        + ", ".join(f"{k} {v:g}" for k, v in calls.items()))
    if syncs > 1 or d2h > 1:
        raise AssertionError(f"B's decode tick syncs the host {syncs:g} times and copies "
                             f"device to host {d2h:g} times; one of each is allowed")
    rows["B"]["tick_syncs"], rows["B"]["tick_d2h"] = syncs, d2h
    for run in rows.values():
        run["card"] = card
    log(json.dumps({"prefix_cache": list(rows.values()), "snapshot_bytes": want,
                    "warm_up": {"scheduler": warm_sch, "prefix_cache": warm_pc}},
                   default=float))
    shutil.rmtree(PREFIX_DIR, ignore_errors=True)
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
    return {run: row["b1_launches"] for run, row in rows.items()}


def phase_lt_mult_path():
    """B3's path: its public entry point ops.lt_mult, called as a user (or
    benchmarks/kernel_bench.py) calls it, at the benchmark's shapes."""
    log("phase 2: B3's path, ops.lt_mult at kernel_bench's shapes "
        "(bh 4, m 32, k 64, block 256, n 2048 and 16384)")
    inputs = [lt_bench_inputs(n) for n in (2048, 16384)]
    zero_counts()
    outs = [ops.lt_mult(a, b, c, block_size=LT_BENCH["blk"]) for a, b, c in inputs]
    torch.cuda.synchronize()
    run_counts = counts()
    log(f"  launches in the run: {run_counts}")
    if run_counts["lt_mult"] != len(inputs):
        raise AssertionError("ops.lt_mult did not launch B3 once per call")
    for (_, _, c), out in zip(inputs, outs):
        if out.shape != c.shape or not torch.isfinite(out).all():
            raise AssertionError(f"bad lt_mult output {tuple(out.shape)}")
    return run_counts["lt_mult"]


# ---------------------------------------------------------------------------
# phase 2 and 3: full-width training through B1 and its backward
# ---------------------------------------------------------------------------

def train_batches(cfg, count, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """`count` batches of batch x seq tokens of the Markov stream (seed 1),
    made up front."""
    it = DataIterator(make_markov_lm(cfg.vocab_size, seed=1), batch, seq, seed=0,
                      device="cuda")
    return [next(it) for _ in range(count)]


def train_setup(cfg, seed=0, lm=None, microbatches=1):
    """A fresh train state (AdamW zeros, step 0) and its step function, on
    a new seeded model or on `lm`."""
    if lm is None:
        lm = build_model(cfg, device="cuda", seed=seed, trainable=True).lm
    tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=100,
                       peak_lr=3e-3, microbatches=microbatches)
    return init_train_state(lm), make_train_step(cfg, tcfg)


# the plain versions ops picks on the CPU or with impl="torch"
PLAIN_FNS = ("polysketch_causal_torch", "polysketch_causal_backward_torch",
             "poly_flash_torch", "poly_flash_backward_torch", "lt_mult_torch")


class PlainCalls:
    """Counts calls of the kernels' plain versions through ops while active."""

    def __enter__(self):
        self.calls = 0

        def counted(fn):
            def wrapper(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return wrapper
        self._patches = [mock.patch.object(ops, name, counted(getattr(ops, name)))
                         for name in PLAIN_FNS]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()


def phase_train(cfg, batches, kernels=()):
    """The training path: a warm-up step, then 4 timed steps with every
    kernel's launches counted over exactly those steps: each of `kernels`
    (names in KERNELS) once per layer a step, every other kernel never, and
    no plain version. Returns (the last of `kernels`' launches, median step
    seconds, peak GiB)."""
    steps = len(batches) - 1
    log(f"phase 2: {cfg.name} training, full width and depth ({cfg.n_layers} layers), "
        f"seed 0, f32, Markov data (vocab {cfg.vocab_size}), batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, 1 warm-up + {steps} timed steps")
    torch.cuda.reset_peak_memory_stats()
    state, step = train_setup(cfg)
    state, _ = step(state, batches[0])               # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    zero_counts()
    losses, times = [], []
    with PlainCalls() as plain:
        for batch in batches[1:]:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))     # waits for the step
            times.append(time.perf_counter() - t0)
    run_counts = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  losses: {[round(x, 4) for x in losses]}; lr at the last step "
        f"{float(metrics['lr']):.2e}, grad norm {float(metrics['grad_norm']):.3f}")
    log(f"  step time: median {np.median(times) * 1e3:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times]} (host clock, synchronised by the loss); "
        f"{TRAIN_BATCH * TRAIN_SEQ / np.median(times):.0f} tokens/s; peak device memory "
        f"{peak:.2f} GiB")
    expected = {name: cfg.n_layers * steps if name in kernels else 0 for name in KERNELS}
    log(f"  launches over the {steps} steps: {run_counts} (expected {expected}); "
        f"plain-version calls: {plain.calls}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if run_counts != expected or plain.calls:
        raise AssertionError(f"a {cfg.name} training step did not launch "
                             f"{', '.join(kernels) or 'no port kernel'} exactly once per "
                             "layer and nothing else, or called a plain version")
    profile_train_step(step, state, batches[-1])
    return (run_counts[kernels[-1]] if kernels else 0), float(np.median(times)), peak


# (group, substrings of a kernel's name) for the split of a training step;
# no backward kernel's name holds a forward kernel's (fold_kernel,
# prefix_kernel, output_kernel)
STEP_GROUPS = (
    ("B2 backward (2 kernels)", pf.BWD_KERNELS),
    ("B2 forward", ("poly_flash_kernel",)),
    ("B1 backward (all 7 kernels)", pc.BWD_KERNELS),
    ("B1 forward (prefix, outputs)", ("output_kernel", "prefix_kernel")),
    ("B1 forward fold", ("fold_kernel",)),
    ("GEMMs (cuBLAS)", ("gemm", "Gemm", "GEMM", "xmma", "cutlass")),
    ("softmax and log-softmax (PyTorch)", ("softmax", "SoftMax")),
    ("other (elementwise, reductions, copies)", ("",)),
)


def profile_train_step(step, state, batch):
    """Device busy share, the split by kernel group, the top kernels and
    the operators whose kernels take the most device time, of one training
    step, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (state, metrics), wall = timed(lambda: step(state, batch))
    rows = device_rows(prof)
    busy = sum(dev_us(e) for e in rows) / 1e6
    log(f"  profile of one step: wall {wall * 1e3:.1f} ms (profiler on), device busy "
        f"{busy * 1e3:.1f} ms = {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
    groups = {name: [0.0, 0] for name, _ in STEP_GROUPS}
    for e in rows:
        name = next(g for g, keys in STEP_GROUPS if any(k in e.key for k in keys))
        groups[name][0] += dev_us(e) / 1e3
        groups[name][1] += e.count
    for name, (ms, n) in groups.items():
        share = ms / (busy * 1e3) if busy else 0.0
        log(f"    {ms:9.2f} ms  {share:6.1%}  x{n:<6d} {name}")
    for e in sorted(rows, key=dev_us, reverse=True)[:8]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")
    ops_rows = [e for e in prof.key_averages()
                if not str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    log("  operators by the device time of the kernels they launch themselves:")
    for e in sorted(ops_rows, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:80]}")


def phase_train_checks(cfg, batches, entry="polysketch_attention"):
    """One step's gradients through the kernels against the plain path's
    (ops.`entry` with impl="torch"), per leaf; and bit-for-bit resume and
    repeat of 4 steps."""
    log(f"phase 3: {cfg.name} training self-checks")
    state, step = train_setup(cfg)
    lm, loss_fn = state.lm, make_loss_fn(cfg)

    def grads():
        for p in lm.parameters():
            p.grad = None
        loss, _ = loss_fn(lm, batches[0])
        loss.backward()
        out = {n: p.grad.clone() for n, p in lm.named_parameters() if p.grad is not None}
        for p in lm.parameters():
            p.grad = None
        return out

    got = grads()
    plain = functools.partial(getattr(ops, entry), impl="torch")
    with mock.patch.object(ops, entry, plain):
        want = grads()
    torch.cuda.synchronize()
    worst = max((err(got[n], want[n]) / max(want[n].abs().max().item(), 1e-30), n)
                for n in want)
    check(f"one step's gradients, kernels vs plain, per leaf (rel.; worst {worst[1]})",
          worst[0], F32_TOL)
    del state, step, lm, got, want

    torch.use_deterministic_algorithms(True)
    try:
        def run(resume):
            state, step = train_setup(cfg)
            for i, batch in enumerate(batches[:4]):
                if resume and i == 2:
                    path = os.path.join(ROOT, "build", f"chip_smoke_ckpt_{os.getpid()}")
                    mgr = CheckpointManager(path, keep=1)
                    mgr.save(2, state)
                    mgr.wait()
                    fresh, _ = train_setup(cfg, seed=7)
                    _, state, _ = mgr.restore_latest(fresh)
                    shutil.rmtree(path)
                state, _ = step(state, batch)
            return train_state_to_jax(state)

        straight, resumed, again = run(False), run(True), run(False)
    finally:
        torch.use_deterministic_algorithms(False)
    same = lambda a, b: all(np.array_equal(a[k], b[k]) for k in a)  # noqa: E731
    ok_resume, ok_repeat = same(straight, resumed), same(straight, again)
    log(f"  (deterministic algorithms on) 2 steps + checkpoint save/restore + 2 steps == 4 "
        f"straight steps, bit for bit (params, m, v, count, step): {ok_resume}; two runs "
        f"equal bit for bit: {ok_repeat}")
    if not (ok_resume and ok_repeat):
        raise AssertionError("training is not bit-reproducible on the card")


# ---------------------------------------------------------------------------
# phase 3: rematerialisation against none; phase 6: long-context training
# ---------------------------------------------------------------------------

REMAT_SEQ = 4096                    # the remat gate's batch: 1 x 4096, fits without remat
LONG_TOKENS = 32768                 # phase 6: tokens a step, the paper's 32k context
# the two ends of the paper's context sweep (8192 and 16384 were dropped to
# make room for phase 13: PERF.md §5 keeps their last rows)
LONG_CONTEXTS = (4096, 32768)
# timed steps a pair, after one warm-up: one since phase 13 came in (two
# before; each saved step is ~29 s of the script's time over the 11 pairs)
LONG_STEPS = 1
LONG_FIT_SHARE = 0.9                # run a pair whose reckoned peak is within this share


def phase_remat_gate(cfg):
    """Under torch.use_deterministic_algorithms, at 1 x 4096: one step's
    gradients and two AdamW steps' losses with remat "dots" and "full"
    equal remat "none"'s bit for bit (each from the same seeded model)."""
    log(f"phase 3: {cfg.name} remat gate at 1 x {REMAT_SEQ}: dots and full against none, "
        "bit for bit (deterministic algorithms on)")
    batches = train_batches(cfg, 2, batch=1, seq=REMAT_SEQ)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for remat in ("none", "dots", "full"):
            c = cfg.replace(remat=remat)
            state, step = train_setup(c)
            loss, _ = make_loss_fn(c)(state.lm, batches[0])
            loss.backward()
            grads = {n: p.grad.clone() for n, p in state.lm.named_parameters()}
            losses = []
            for batch in batches:
                state, metrics = step(state, batch)
                losses.append(metrics["loss"].clone())
            runs[remat] = grads, torch.stack(losses)
            del state, step, loss, grads
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    grads0, losses0 = runs["none"]
    for remat in ("dots", "full"):
        grads, losses = runs[remat]
        same_g = all(torch.equal(grads[n], grads0[n]) for n in grads0)
        same_l = torch.equal(losses, losses0)
        log(f"  remat={remat}: one step's gradients equal none's bit for bit: {same_g}; "
            f"two steps' losses {losses.tolist()} equal none's {losses0.tolist()}: {same_l}")
        if not (same_g and same_l):
            raise AssertionError(f"{cfg.name}: remat={remat} changed the training bits")


def s2_gib(rows, heads, seq, itemsize=4) -> float:
    """One (rows, heads, seq, seq) tensor, as the plain softmax path forms
    its scores and weights, in GiB."""
    return rows * heads * seq * seq * itemsize / 2**30


def reckon_full_remat_gib(cfg, seq) -> float:
    """The peak device memory (GiB) of one f32 training step under remat
    "full" with microbatches of one row of `seq` tokens, reckoned from the
    shapes alone: the parameters with their gradients, AdamW's moments and
    the update's new ones (7 copies); the blocks' inputs the checkpoints
    keep; the head (the log-softmax output, its gradient and the logits'
    gradient, each seq x vocab); one block recomputed and differentiated
    (tensors of seq x d_ff and seq x d_model); and for softmax attention
    that block's (1, heads, seq, seq) tensors: four f32 (its backward
    holds the weights, their gradient and the scores' gradient at once,
    and one more passes through the caching allocator: an H100 measured
    51.37 GiB at 16384, where three of them reckon 49.4) and three
    (seq, seq) bool masks."""
    n_params = sum(p.numel() for p in build_model(cfg, device="meta").lm.parameters())
    f = 4
    nbytes = (7 * n_params * f + cfg.n_layers * seq * cfg.d_model * f
              + 3 * seq * cfg.vocab_size * f
              + (8 * cfg.d_ff + 24 * cfg.d_model) * seq * f)
    gib = nbytes / 2**30
    if cfg.attention == "softmax":
        gib += 4 * s2_gib(1, cfg.n_heads, seq) + 3 * seq * seq / 2**30
    return gib


def phase_long_context(cfg, kernels=(), profile=False):
    """Training at LONG_TOKENS tokens a step and each of LONG_CONTEXTS:
    batch LONG_TOKENS / context, one row a microbatch, remat "full", f32,
    1 warm-up + LONG_STEPS timed steps. Each of `kernels` (forward,
    backward) launches 2 x layers and layers a microbatch a step (the
    forward again in the backward's recompute), no other kernel and no
    plain version. A pair whose reckoned peak passes LONG_FIT_SHARE of the
    card's memory is not run. With `profile`, one more step of the
    shortest and of the longest context that run goes through
    torch.profiler. Returns {context: row} and the launches."""
    have = torch.cuda.get_device_properties(0).total_memory / 2**30
    log(f"phase 6: {cfg.name} long-context training, {LONG_TOKENS} tokens a step, remat "
        f"full, f32, seed 0, Markov data, one row a microbatch, 1 warm-up + {LONG_STEPS} "
        f"timed steps; card memory {have:.2f} GiB")
    cfg = cfg.replace(remat="full")
    lm = None
    rows, launched = {}, dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    need = {seq: reckon_full_remat_gib(cfg, seq) for seq in LONG_CONTEXTS}
    fits = [seq for seq in LONG_CONTEXTS if need[seq] <= LONG_FIT_SHARE * have]
    for seq in LONG_CONTEXTS:
        batch = LONG_TOKENS // seq
        if seq not in fits:
            s2 = f", of it (1, {cfg.n_heads}, {seq}, {seq}) f32 {s2_gib(1, cfg.n_heads, seq):.1f} GiB each" \
                if cfg.attention == "softmax" else ""
            log(f"  context {seq} (batch {batch}): not run: reckoned peak {need[seq]:.1f} GiB "
                f"> {LONG_FIT_SHARE:.0%} of {have:.1f} GiB{s2}")
            rows[seq] = {"run": False, "reckoned_gib": need[seq]}
            continue
        if lm is None:
            lm = build_model(cfg, device="cuda", seed=0, trainable=True).lm
        batches = train_batches(cfg, 1 + LONG_STEPS, batch=batch, seq=seq)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step = train_setup(cfg, lm=lm, microbatches=batch)
        state, _ = step(state, batches[0])             # warm-up
        torch.cuda.synchronize()
        zero_counts()
        losses, times = [], []
        with PlainCalls() as plain:
            for b in batches[1:]:
                t1 = time.perf_counter()
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))    # waits for the step
                times.append(time.perf_counter() - t1)
        run_counts = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = float(np.median(times)) * 1e3
        per_step = {k: v // LONG_STEPS for k, v in run_counts.items() if v}
        log(f"  context {seq} (batch {batch}, {batch} microbatches): step {ms:.1f} ms "
            f"{[round(t * 1e3, 1) for t in times]}, {LONG_TOKENS / ms * 1e3:.0f} tokens/s, "
            f"peak {peak:.2f} GiB (reckoned {need[seq]:.1f}), launches a step {per_step}, "
            f"losses {[round(x, 4) for x in losses]}")
        layers = cfg.n_layers * batch * LONG_STEPS
        expected = dict.fromkeys(KERNELS, 0)
        if kernels:
            expected[kernels[0]], expected[kernels[1]] = 2 * layers, layers
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{cfg.name} at {seq}: non-finite loss {losses}")
        if run_counts != expected or plain.calls:
            raise AssertionError(f"{cfg.name} at {seq}: launches {run_counts}, expected "
                                 f"{expected}; plain-version calls {plain.calls}")
        if peak > have:
            raise AssertionError(f"{cfg.name} at {seq}: peak {peak:.2f} GiB > the card's")
        for k, v in run_counts.items():
            launched[k] += v
        rows[seq] = {"run": True, "step_ms": ms, "tokens_per_s": LONG_TOKENS / ms * 1e3,
                     "peak_gib": peak, "reckoned_gib": need[seq],
                     "launches_per_step": per_step}
        if profile and seq in (fits[0], fits[-1]):
            profile_train_step(step, state, batches[-1])
        del state, step, batches
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 6 {cfg.name}: {time.perf_counter() - t0:.1f} s")
    return rows, launched


def long_kernel_inputs():
    """B1's inputs (qm, km, q, k, v) and dout at the 32k training shape
    (B 1, H 12, n 32768, r 32, h 64), scaled like the model's."""
    rnd = seeded(32)
    B, H, n, r, h = 1, 12, LONG_TOKENS, 32, 64
    return ((rnd(B, H, n, r, scale=0.5), rnd(B, H, n, r, scale=0.5), rnd(B, H, n, h),
             rnd(B, H, n, h), rnd(B, H, n, h)), rnd(B, H, n, h))


# C.1 (ROADMAP): PR 20's errors at this shape, the forwards accumulating
# W V in place on the tensor cores; the repair must halve B2's gradients'.
C1_BEFORE = {"B1": 2.98e-6, "B2": 1.90e-5, "B2 backward": 5.40e-5}
C1_B2_BWD_GATE = C1_BEFORE["B2 backward"] / 2


def phase_long_kernels():
    """B1 and B2, forward and backward, at the 32k training shape (bh 12,
    n 32768; B1 at b 1024, r 32) against their plain versions (B2's plain
    versions go 256 queries at a time, so they fit at bh 12), and the C.1
    check: the forwards and B2's gradients against float64 plain versions,
    beside PR 20's errors, B2's gradients within half of PR 20's. Returns
    the worst forward and gradient errors {kernel: max|err|}."""
    log(f"phase 1: B1 and B2, forward and backward, at bh 12 n {LONG_TOKENS} h 64 vs plain "
        f"(and the C.1 check against float64); {card_line()}")
    t_phase = time.perf_counter()
    xs, dout = long_kernel_inputs()
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    with torch.no_grad():
        got = ops.polysketch_attention(*xs, **kw)
        plain = ops.polysketch_attention(*xs, impl="torch", **kw)
        ref = ops.polysketch_attention(*(x.double() for x in xs), impl="torch", **kw)
    e1 = err(got, plain)
    check(f"B1 f32 B=1 H=12 n={LONG_TOKENS} r=32 h=64 b=1024", e1, F32_TOL)
    c1_line("B1 forward", got, plain, ref, C1_BEFORE["B1"])
    del got, plain, ref
    _, e1b, _, _ = check_grads(f"B1 backward B=1 H=12 n={LONG_TOKENS} r=32 h=64 b=1024",
                               ops.polysketch_attention, xs, dout, **kw)
    del xs, dout
    xs, dout = b2_grad_inputs(32, 1, 12, 12, LONG_TOKENS, 64, 4)
    kw = dict(degree=4, scale=1.0 / 64)
    with torch.no_grad():
        got = ops.poly_attention(*xs, **kw)
        plain = ops.poly_attention(*xs, impl="torch", **kw)
        ref = ops.poly_attention(*(x.double() for x in xs), impl="torch", **kw)
    e2 = err(got, plain)
    check(f"B2 f32 causal B=1 H=12 n={LONG_TOKENS} h=64 p=4", e2, F32_TOL)
    c1_line("B2 forward", got, plain, ref, C1_BEFORE["B2"])
    del got, plain, ref
    rel2b, e2b, got, want = check_grads(f"B2 backward B=1 H=12 n={LONG_TOKENS} h=64 p=4",
                                        ops.poly_attention, xs, dout,
                                        kernel=pf.poly_flash_backward_cuda, **kw)
    flat = [x.reshape(12, LONG_TOKENS, 64).double() for x in (*xs, dout)]
    with torch.no_grad():
        out64, den64 = pf.poly_flash_torch(*flat[:3], return_den=True, **kw)
        ref = pf.poly_flash_backward_torch(flat[3], *flat[:3], out64, den64, **kw)
    del flat, out64, den64
    ref = [r.reshape(g.shape) for r, g in zip(ref, got)]
    log(f"  C.1 B2 backward: kernels vs plain f32 {rel2b:.3e} of the gradients' max (PR 20: "
        f"{C1_BEFORE['B2 backward']:.2e}); vs float64: kernels {grad_err(got, ref):.3e}, "
        f"plain f32 {grad_err(want, ref):.3e}")
    check("C.1 B2 backward kernels vs plain f32 (rel.), half of PR 20's", rel2b,
          C1_B2_BWD_GATE)
    log(f"  phase 1 at n {LONG_TOKENS}: {time.perf_counter() - t_phase:.1f} s")
    del got, want, ref
    torch.cuda.empty_cache()
    return {"polysketch_causal": e1, "polysketch_causal_backward": e1b,
            "poly_flash": e2, "poly_flash_backward": e2b}


def c1_line(name, got, plain, ref, before):
    """Log a forward's error against its plain f32 version (absolute, as
    PR 20 logged it) and, as a share of max|out|, both against float64."""
    top = ref.abs().max().item()
    log(f"  C.1 {name}: kernel vs plain f32 {err(got, plain):.3e} (PR 20: {before:.2e}); vs "
        f"float64, relative to max|out| {top:.3f}: kernel {err(got, ref) / top:.3e}, "
        f"plain f32 {err(plain, ref) / top:.3e}")


def phase_b1_h128_grid(card):
    """B1's forward and backward at head width 128 (the dense models'),
    f32 and bf16, against their plain versions through
    ops.polysketch_attention: GQA 12:1 (starcoder2-3b's heads) over two
    blocks, GQA 5:1 (qwen3-14b's) at a ragged n zero-padded to the block,
    MHA with local_exact off, and a seeded z0; then, in bf16, a prefill
    resumed at a block boundary equals a cold one and two backward calls
    give the same gradients, bit for bit. Returns the worst f32 forward and
    gradient errors, and the worst bf16 ones."""
    log("phase 1: B1 forward and backward at h 128 vs plain (f32 gate 1e-4, bf16 gate "
        f"{BF16_TOL:.0e}, gradients relative to their max|.|); {card}")
    t_phase, before = time.perf_counter(), counts()
    torch.cuda.reset_peak_memory_stats()
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    cases = (("GQA 12:1 B=1 Hq=24 n=2048 b=1024", 1, 24, 2, 2048, 1024, True, False),
             ("GQA 5:1 B=1 Hq=10 ragged n=1500 b=512", 1, 10, 2, 1500, 512, True, False),
             ("MHA B=2 H=4 n=1024 b=256 local_exact=False", 2, 4, 4, 1024, 256, False, False),
             ("GQA 4:2 B=1 n=768 b=256 seeded z0", 1, 4, 2, 768, 256, True, True))
    for dt in (torch.float32, torch.bfloat16):
        name_dt, tol = str(dt)[6:], F32_TOL if dt == torch.float32 else BF16_TOL
        for i, (name, B, hq, hkv, n, blk, le, z0) in enumerate(cases):
            rnd = seeded(128 + i)
            xs = [rnd(B, hq, n, 32, scale=0.5, dtype=dt), rnd(B, hkv, n, 32, scale=0.5, dtype=dt),
                  rnd(B, hq, n, 128, dtype=dt), rnd(B, hkv, n, 128, dtype=dt),
                  rnd(B, hkv, n, 128, dtype=dt)]
            dout = rnd(B, hq, n, 128, dtype=dt)
            kw = dict(degree=4, scale=1.0 / 128, local_exact=le, block_size=blk)
            fn = ops.polysketch_attention
            if z0:   # the state of a previous call, its gradient taken too
                with torch.no_grad():
                    _, zs = ops.polysketch_attention(*xs, return_state=True, **kw)
                xs.append(zs * 0.5)

                def fn(qm, km, q, k, v, z, impl=None, **kw):
                    return ops.polysketch_attention(qm, km, q, k, v, z0=z, impl=impl, **kw)
            with torch.no_grad():
                e = err(fn(*xs, **kw), fn(*xs, impl="torch", **kw))
            check(f"{name_dt} h=128 {name} (out)", e, tol)
            rel, _, _, _ = check_grads(f"{name_dt} h=128 {name}", fn, xs, dout, tol=tol, **kw)
            worst[name_dt] = [max(worst[name_dt][0], e), max(worst[name_dt][1], rel)]
    rnd = seeded(129)
    dt = torch.bfloat16
    xs = [rnd(1, 24, 1024, 32, scale=0.5, dtype=dt), rnd(1, 2, 1024, 32, scale=0.5, dtype=dt)]
    xs += [rnd(1, h_, 1024, 128, dtype=dt) for h_ in (24, 2, 2)]
    kw = dict(degree=4, scale=1.0 / 128, block_size=256, return_state=True)
    with torch.no_grad():
        o_full, z_full = ops.polysketch_attention(*xs, **kw)
        o1, z1 = ops.polysketch_attention(*(x[..., :512, :] for x in xs), **kw)
        o2, z2 = ops.polysketch_attention(*(x[..., 512:, :] for x in xs), z0=z1, **kw)
    torch.cuda.synchronize()
    same = torch.equal(torch.cat([o1, o2], -2), o_full) and torch.equal(z2, z_full)
    log(f"  bf16 h=128 GQA 12:1: resumed at token 512 == cold, bit for bit: {same}")
    if not same:
        raise AssertionError("B1 h 128 bf16: a resumed prefill differs from a cold one")
    dout = rnd(1, 24, 1024, 128, dtype=dt)
    kw.pop("return_state")
    g1 = grads_of(lambda *a: ops.polysketch_attention(*a, **kw), xs, dout)
    g2 = grads_of(lambda *a: ops.polysketch_attention(*a, **kw), xs, dout)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    log(f"  bf16 h=128 GQA 12:1: two backward calls equal bit for bit: {same}")
    if not same:
        raise AssertionError("B1 backward h 128 bf16: two calls differ")
    launched = {k: v - before[k] for k, v in counts().items() if v > before[k]}
    log(f"  launches in the phase: {launched}; {time.perf_counter() - t_phase:.1f} s, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return worst


def phase_b1_xm_grid(card):
    """B1's forward and backward at phase 12's shapes against their plain
    versions through ops.polysketch_attention: Whisper's decoder (20 heads
    of 64, MHA) in bf16 at a ragged 228-token prefill (one block of 228)
    and at training's 448 tokens zero-padded to two blocks of 256, and in
    f32 at the latter; llava's (32 query heads of 128 over 8 kv heads, GQA
    4:1) in bf16 at 4 x 2048, b 256. Returns the worst f32 and bf16
    forward and gradient errors."""
    log("phase 1: B1 forward and backward at phase 12's shapes vs plain (bf16 gate "
        f"{BF16_TOL:.0e}, f32 {F32_TOL:.0e}; gradients relative to their max|.|); {card}")
    t_phase, before = time.perf_counter(), counts()
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    cases = (("whisper prefill B=4 H=20 ragged n=228 h=64", torch.bfloat16, 4, 20, 20, 228, 64),
             ("whisper train B=4 H=20 n=448 (padded to 512) h=64", torch.bfloat16, 4, 20, 20,
              448, 64),
             ("whisper train B=4 H=20 n=448 (padded to 512) h=64", torch.float32, 4, 20, 20,
              448, 64),
             ("llava GQA 4:1 B=4 Hq=32 n=2048 h=128", torch.bfloat16, 4, 32, 8, 2048, 128))
    for i, (name, dt, B, hq, hkv, n, h) in enumerate(cases):
        name_dt, tol = str(dt)[6:], F32_TOL if dt == torch.float32 else BF16_TOL
        rnd = seeded(160 + i)
        xs = [rnd(B, hq, n, 32, scale=0.5, dtype=dt), rnd(B, hkv, n, 32, scale=0.5, dtype=dt),
              rnd(B, hq, n, h, dtype=dt), rnd(B, hkv, n, h, dtype=dt), rnd(B, hkv, n, h, dtype=dt)]
        dout = rnd(B, hq, n, h, dtype=dt)
        kw = dict(degree=4, scale=1.0 / h, block_size=256)
        with torch.no_grad():
            e = err(ops.polysketch_attention(*xs, **kw),
                    ops.polysketch_attention(*xs, impl="torch", **kw))
        check(f"{name_dt} {name} (out)", e, tol)
        rel, _, _, _ = check_grads(f"{name_dt} {name}", ops.polysketch_attention, xs, dout,
                                   tol=tol, **kw)
        worst[name_dt] = [max(worst[name_dt][0], e), max(worst[name_dt][1], rel)]
        del xs, dout
    launched = {k: v - before[k] for k, v in counts().items() if v > before[k]}
    log(f"  launches in the phase: {launched}; {time.perf_counter() - t_phase:.1f} s")
    for name, fn in KERNELS.items():   # checking launches do not count
        fn.launches = before[name]
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# phases 7 and 8: the registry's dense polysketch models (head width 128,
# bf16) served and trained at their published widths
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("deepseek-7b", "starcoder2-3b", "qwen3-14b", "yi-34b",
               "llava-next-mistral-7b")
DENSE_LENS = (4096, 1024, 3072, 2048)     # requests 0, 1 greedy; 2, 3 sampled
DENSE_SLOTS, DENSE_GEN, DENSE_BUDGET = 2, 16, 2048
DENSE_SHARE = 0.9              # of the card's memory the reckoning may plan for
# phase 7's depth cap: its engine ticks are host-bound (~12.5 ms a layer),
# and the script must stay well inside its time limit (1036 s in all with
# the four at up to 40 layers, NVIDIA H100 80GB HBM3, 700 W)
DENSE_SERVE_LAYERS = 8
DENSE_SERVE_RESERVE_GIB = 12   # beside the f32 weights: casts, states, logits, the check
DENSE_TRAIN_RESERVE_GIB = 14   # beside 16 B a parameter: logits, casts, the gradient check
DENSE_TRAIN_ACT_GIB = 0.5      # a layer's kept activations at 1 x 4096 under remat "dots"
# phase 8's training depth, cut to make room for phase 16 (train_depth's 22
# of 30 before: 35.4 s of the phase, NVIDIA H100 80GB HBM3, 700.00 W)
DENSE_TRAIN_LAYERS = 16
DENSE_TRAIN_SEQ, DENSE_TRAIN_STEPS = 4096, 3
# bf16 gradient gates (scripts/bf16_grad_study.py on SMOKE, CPU): the
# reference's own bf16 gradients lie up to 0.189 of a leaf's max|.| from
# float64, the median leaf up to 0.0474 (the port's 0.125 and 0.0279); two
# paths each that far from float64 may differ by twice it
BF16_GRAD_TOL, BF16_GRAD_MEDIAN = 0.38, 0.095
# kernels vs a blocked plain forward, both bf16, over the same tokens: the
# served log-probabilities (nats) and the train-mode logits (relative to
# max|logit|). Both compute attention in f32 from the same bf16 operands
# and round its output to bf16 (2^-8 of it), so they differ where a
# rounding flips and the layers carry the flip on: a few bf16 steps
DENSE_LP_TOL, DENSE_LOGIT_TOL = 1e-2, 2e-2


def card_gib() -> float:
    return torch.cuda.get_device_properties(0).total_memory / 2**30


def param_split(cfg):
    """(parameters of one block, the rest: embedding and final norm),
    counted on the meta device."""
    lm = build_model(cfg.replace(n_layers=1), device="meta").lm
    block = sum(p.numel() for p in lm.layers[0].parameters())
    return block, sum(p.numel() for p in lm.parameters()) - block


def serve_depth(cfg) -> int:
    """The most layers whose f32 weights fit in DENSE_SHARE of the card
    beside DENSE_SERVE_RESERVE_GIB, at most DENSE_SERVE_LAYERS (and the
    published depth)."""
    block, rest = param_split(cfg)
    room = DENSE_SHARE * card_gib() - DENSE_SERVE_RESERVE_GIB - 4 * rest / 2**30
    return min(cfg.n_layers, DENSE_SERVE_LAYERS, int(room // (4 * block / 2**30)))


def train_depth(cfg) -> int:
    """The most layers that train at 16 bytes a parameter (f32 weights,
    gradients and AdamW's m and v) plus DENSE_TRAIN_ACT_GIB a layer, in
    DENSE_SHARE of the card beside DENSE_TRAIN_RESERVE_GIB."""
    block, rest = param_split(cfg)
    room = DENSE_SHARE * card_gib() - DENSE_TRAIN_RESERVE_GIB - 16 * rest / 2**30
    return min(cfg.n_layers, int(room // (16 * block / 2**30 + DENSE_TRAIN_ACT_GIB)))


def plain_ops():
    """ops' B1 entry point with its plain version, whatever the device."""
    return mock.patch.object(ops, "polysketch_attention",
                             functools.partial(ops.polysketch_attention, impl="torch"))


def phase_dense_serve(arch, card, profile=False):
    """One of the registry's dense polysketch models at its published
    width, bf16, seeded weights drawn on the card, its depth the most that
    fits (serve_depth), served through ServeEngine: 4 requests on 2 slots
    (prompts of 1024-4096 tokens, 16 new tokens, 0 and 1 greedy, 2 and 3
    sampled), prefill budget 2048, overlap on. B1 launches once a layer per
    prefill block and nothing else runs (no plain version, no backward);
    the served log-probabilities of a greedy and a sampled request against
    a plain-ops forward (B1's blocked plain version) over prompt + emitted
    tokens, bf16, within DENSE_LP_TOL, and a train-mode forward's logits
    through B1 against that forward's within DENSE_LOGIT_TOL of max|logit|
    (with random weights a model mostly repeats its input token, so the
    chosen tokens' log-probabilities lie near 0); with `profile`, a
    profile of four decode ticks (profile_dense_ticks). Returns a row of
    the numbers."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    depth = serve_depth(full)
    cfg = full.replace(n_layers=depth)
    reduced = f"reduced: {depth} of {full.n_layers} layers" if depth < full.n_layers \
        else "full depth"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, t_build = timed(lambda: build_model(cfg, device="cuda", seed=0,
                                               draw_on_device=True))
    weights = sum(p.numel() for p in model.lm.parameters())
    log(f"phase 7: {arch} serving, bf16, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim} ({cfg.n_kv_heads} kv), d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {depth} layers ({reduced}); {weights / 1e9:.2f}B parameters, "
        f"{4 * weights / 2**30:.1f} GiB f32 weights drawn on the card (seed 0) in "
        f"{t_build:.1f} s; {card}")
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in DENSE_LENS]
    samp = [SamplingParams() if i < 2 else SamplingParams(seed=100 + i, **ENGINE_SAMPLED)
            for i in range(len(prompts))]

    def engine():
        return ServeEngine(model, slots=DENSE_SLOTS, max_len=max(DENSE_LENS) + DENSE_GEN,
                           logprobs=True, prefill_budget=DENSE_BUDGET, overlap=True)
    warm = engine()                               # allocator, cuBLAS
    warm.submit(prompts[1][:512], 2)
    warm.run()
    del warm
    gc.collect()
    torch.cuda.synchronize()
    eng = engine()
    zero_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        rid_of = {eng.submit(p, DENSE_GEN, sampling=sp): i
                  for i, (p, sp) in enumerate(zip(prompts, samp))}
        outs = {rid_of[o.rid]: o for o in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    run_counts = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = eng.stats()
    blocks = sum(-(-len(p) // cfg.lt_block_size) for p in prompts)
    expected = {k: depth * blocks if k == "polysketch_causal" else 0 for k in KERNELS}
    ttft = np.array([o.ttft_s for o in outs.values()]) * 1e3
    gen = sum(len(o.tokens) for o in outs.values())
    tick_ms = st["decode_s"] * 1e3 / st["decode_steps"]
    log(f"  run: {wall * 1e3:.1f} ms for {gen} generated tokens = {gen / wall:.1f} generated "
        f"tok/s (prompts {sum(map(len, prompts))} tokens); TTFT p50 "
        f"{np.percentile(ttft, 50):.1f} ms, p99 {np.percentile(ttft, 99):.1f} ms; "
        f"{st['decode_steps']} decode ticks, {tick_ms:.2f} ms a tick; peak device memory "
        f"{peak:.2f} GiB")
    log(f"  launches in the run: {run_counts} (expected {expected}: one B1 a layer per "
        f"{cfg.lt_block_size}-token block of each prompt); plain-version calls: "
        f"{plain.calls}")
    if run_counts != expected or plain.calls:
        raise AssertionError(f"{arch}: the engine did not launch B1 once a layer per "
                             "prefill block and nothing else, or called a plain version")
    for i, o in outs.items():
        if len(o.tokens) != DENSE_GEN or o.tokens.min() < 0 \
                or o.tokens.max() >= cfg.vocab_size or not np.isfinite(o.logprobs).all():
            raise AssertionError(f"{arch} request {i}: bad output {o.tokens}, {o.logprobs}")
    worst, worst_logit = 0.0, 0.0
    for i in (1, 2):
        seq = torch.from_numpy(np.concatenate([prompts[i], outs[i].tokens[:-1]]))[None].cuda()
        with torch.inference_mode():
            got, _ = model.lm(seq, mode="train")
            with plain_ops():
                logits, _ = model.lm(seq, mode="train")
            worst_logit = max(worst_logit, err(got, logits) / logits.float().abs().max().item())
            lsm = torch.log_softmax(logits[0, len(prompts[i]) - 1:].float(), dim=-1)
            want = lsm.gather(1, torch.from_numpy(outs[i].tokens.astype(np.int64)).cuda()[:, None])
        worst = max(worst, float(np.abs(want[:, 0].cpu().numpy() - outs[i].logprobs).max()))
        del got, logits, lsm
    check(f"{arch}: served logprobs (B1) vs a blocked plain bf16 forward (nats)", worst,
          DENSE_LP_TOL)
    check(f"{arch}: train-mode logits, B1 vs blocked plain, bf16 (rel. to max)", worst_logit,
          DENSE_LOGIT_TOL)
    log(f"  req0: {' '.join(map(str, outs[0].tokens.tolist()))}")
    prof = profile_dense_ticks(model) if profile else (None, None, None)
    row = {"arch": arch, "layers": depth, "published_layers": full.n_layers,
           "params_b": round(weights / 1e9, 3), "tick_ms": round(tick_ms, 2),
           "ttft_p50_ms": round(float(np.percentile(ttft, 50)), 1),
           "ttft_p99_ms": round(float(np.percentile(ttft, 99)), 1),
           "gen_tok_s": round(gen / wall, 1), "peak_gib": round(peak, 2),
           "logprob_err": worst, "logit_rel_err": worst_logit,
           "b1_launches": run_counts["polysketch_causal"],
           "profiled_tick_ms": prof[0], "profiled_busy_ms": prof[1],
           "kernels_a_tick": prof[2]}
    del model, eng, outs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 7 {arch}: {time.perf_counter() - t_phase:.1f} s")
    return row


def profile_dense_ticks(model, ticks=4):
    """Wall and device time of `ticks` decode ticks with both slots decoding
    (256-token prompts, no admission in flight), kernels a tick and the
    kernels that take the most device time, from torch.profiler. Returns
    (ms a tick, device-busy ms a tick, kernels a tick)."""
    from torch.profiler import ProfilerActivity, profile
    eng = ServeEngine(model, slots=DENSE_SLOTS, max_len=256 + ticks + 8,
                      prefill_budget=DENSE_BUDGET, overlap=True)
    rng = np.random.default_rng(5)
    for _ in range(DENSE_SLOTS):
        eng.submit(rng.integers(0, model.cfg.vocab_size, size=256), ticks + 8)
    while eng.n_active < DENSE_SLOTS or eng.scheduler.active:
        eng.step()
    eng.step()                                   # the pipeline holds a tick
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: [eng.step() for _ in range(ticks)])
    rows = device_rows(prof)
    busy = sum(dev_us(e) for e in rows) / 1e3 / ticks
    kernels = sum(e.count for e in rows) / ticks
    log(f"  profile of {ticks} decode ticks (2 slots decoding): {wall * 1e3 / ticks:.1f} ms a "
        f"tick (profiler on), device busy {busy:.1f} ms a tick = "
        f"{busy / (wall * 1e3 / ticks):.1%}, {kernels:.0f} kernels a tick; the top kernels:")
    for e in sorted(rows, key=dev_us, reverse=True)[:6]:
        log(f"    {dev_us(e) / 1e3 / ticks:9.3f} ms a tick  x{e.count // ticks:<5d} {e.key[:80]}")
    eng.run()
    del eng
    gc.collect()
    return wall * 1e3 / ticks, busy, kernels


def leaf_errors(got, want):
    """Each leaf's max|err| as a share of its max|.|, sorted."""
    return sorted((err(got[n], want[n]) / max(want[n].abs().max().item(), 1e-30), n)
                  for n in want)


def phase_dense_train(card, arch="starcoder2-3b"):
    """starcoder2-3b trained at its published width, bf16, remat "dots" as
    published, 1 x 4096 tokens a step, its depth the most that trains
    (train_depth), at most DENSE_TRAIN_LAYERS, seeded weights drawn on the
    card: (1) one step's gradients through B1 and its backward against the
    plain path's, leaf by leaf, within the bf16 gates; (2) a warm-up and DENSE_TRAIN_STEPS timed
    steps (step ms, tokens/s, peak GiB), B1 launched twice a layer a step
    (remat runs the forward again) and its backward once, no plain
    version; (3) two runs of 2 steps from the seed give the same
    parameters bit for bit (deterministic algorithms on). Returns a row
    with the launches."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    depth = min(train_depth(full), DENSE_TRAIN_LAYERS)
    cfg = full.replace(n_layers=depth)
    block, rest = param_split(full)
    log(f"phase 8: {arch} training, bf16, remat {cfg.remat!r}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim} ({cfg.n_kv_heads} kv), 1 x "
        f"{DENSE_TRAIN_SEQ} tokens a step, {depth} of {full.n_layers} layers (at most "
        f"DENSE_TRAIN_LAYERS; reckoned: "
        f"{16 * block / 2**30:.2f} GiB a layer at 16 B a parameter + "
        f"{DENSE_TRAIN_ACT_GIB} GiB of activations, {16 * rest / 2**30:.2f} GiB for the "
        f"embedding, {DENSE_TRAIN_RESERVE_GIB} GiB reserve, in {DENSE_SHARE:.0%} of "
        f"{card_gib():.1f} GiB); {card}")
    it = DataIterator(make_markov_lm(cfg.vocab_size, seed=1), 1, DENSE_TRAIN_SEQ, seed=0,
                      device="cuda")
    batches = [next(it) for _ in range(DENSE_TRAIN_STEPS + 1)]
    tcfg = TrainConfig(seq_len=DENSE_TRAIN_SEQ, global_batch=1, steps=100, peak_lr=3e-3)

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        return build_model(cfg, device="cuda", seed=0, trainable=True,
                           draw_on_device=True).lm

    lm = fresh()
    loss_fn = make_loss_fn(cfg)

    def grads():
        for p in lm.parameters():
            p.grad = None
        loss, _ = loss_fn(lm, batches[0])
        loss.backward()
        out = {n: p.grad.clone() for n, p in lm.named_parameters() if p.grad is not None}
        for p in lm.parameters():
            p.grad = None
        return out

    got = grads()
    with plain_ops():
        want = grads()
    errs = leaf_errors(got, want)
    median = float(np.median([e for e, _ in errs]))
    log(f"  one step's gradients, kernels vs plain ({len(errs)} leaves, rel. to each leaf's "
        f"max|.|): worst {errs[-1][0]:.3e} ({errs[-1][1]}), median {median:.3e}")
    check(f"{arch} gradients kernels vs plain, worst leaf", errs[-1][0], BF16_GRAD_TOL)
    check(f"{arch} gradients kernels vs plain, median leaf", median, BF16_GRAD_MEDIAN)
    del got, want

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(lm)
    step = make_train_step(cfg, tcfg)
    state, _ = step(state, batches[0])            # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times, losses = [], []
    with PlainCalls() as plain:
        for batch in batches[1:]:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
    run_counts = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(times)
    expected = {k: 0 for k in KERNELS}
    expected["polysketch_causal"] = 2 * depth * n
    expected["polysketch_causal_backward"] = depth * n
    step_ms = float(np.median(times)) * 1e3
    log(f"  losses {[round(x, 4) for x in losses]}; step time median {step_ms:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times]}; {DENSE_TRAIN_SEQ / np.median(times):.0f} "
        f"tokens/s; peak device memory {peak:.2f} GiB")
    log(f"  launches over the {n} steps: {run_counts} (expected {expected}); plain-version "
        f"calls: {plain.calls}")
    if not all(np.isfinite(losses)) or run_counts != expected or plain.calls:
        raise AssertionError(f"{arch} training: non-finite loss, or not B1 twice and its "
                             "backward once a layer a step, or a plain version called")
    del state, step, lm

    torch.use_deterministic_algorithms(True)
    try:
        def run():
            lm = fresh()
            state, step = init_train_state(lm), make_train_step(cfg, tcfg)
            for batch in batches[:2]:
                state, _ = step(state, batch)
            return [p.detach().cpu() for p in lm.parameters()]
        first = run()
        second = run()
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"  (deterministic algorithms on) two runs of 2 steps from seed 0: parameters equal "
        f"bit for bit: {same}")
    if not same:
        raise AssertionError(f"{arch} training is not bit-reproducible on the card")
    del first, second
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")
    return {"arch": arch, "layers": depth, "published_layers": full.n_layers,
            "step_ms": round(step_ms, 1),
            "tokens_s": round(DENSE_TRAIN_SEQ / float(np.median(times))),
            "peak_gib": round(peak, 2), "grad_worst": errs[-1][0], "grad_median": median,
            "launches": {k: run_counts[k] for k in ("polysketch_causal",
                                                    "polysketch_causal_backward")}}


# ---------------------------------------------------------------------------
# phase 10: the recurrent families (mamba2-780m's SSD; recurrentgemma-9b's
# RG-LRU and sliding-window ring attention) served and trained at their
# published widths, bf16, in plain PyTorch ops (no port kernel on the path)
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("mamba2-780m", "recurrentgemma-9b")
REC_LENS = (4096, 1024, 3072, 2048)       # requests 0, 1 greedy; 2, 3 sampled
REC_SLOTS, REC_GEN, REC_BUDGET = 2, 16, 2048
# Phase 10's cuts of depth, to make room for phase 12 in the script's time
# (phase 10 took 179.3 s in one run at full serving depth, NVIDIA H100
# 80GB HBM3, 700 W): recurrentgemma serves at 20 of 38 layers (six whole
# (rglru, rglru, local_attn) groups and its 2-layer tail), mamba2 trains
# at 12 of 48 (24 until phase 13 came in: 21.6 s of the phase against
# 12.2 s at 12). mamba2 serves at full depth: at 24 layers its float8 state
# control lies too near the sound run to fail a limit between them
# (request 0's rows 1.64e-2 of max|logit| against 1.55e-2, the same
# next-token log-probabilities; PERF.md §6)
REC_SERVE_LAYERS = {"recurrentgemma-9b": 20}
# and, to make room for phase 16, mamba2 trains at 6 of 48 (10.4 s at 12)
# and recurrentgemma at 2 of its 3 fitting groups (21.1 s at 3; NVIDIA
# H100 80GB HBM3, 700.00 W)
REC_TRAIN_LAYERS = {"mamba2-780m": 6, "recurrentgemma-9b": 6}
# The served path against a train-mode forward of the same weights, as
# phases 5 and 7 hold theirs: the engine's log-probabilities of the emitted
# tokens (nats), and (rec_rows) whole logit rows of the 4096-token request
# served through DecodeState's own steps (a prefill on the block grid, every
# row kept, wrapping recurrentgemma's ring, then teacher-forced decode
# steps past the wrap) against the train-mode forward's rows: max|diff|
# over max|logit| (phase 7's measure) and the log-probability of every next
# token, the prompt's included (with random weights a model mostly repeats
# its input token, so an emitted token's log-probability lies near 0 while
# a prompt token's does not). In f32 within REC_LP_TOL and F32_TOL.
REC_LP_TOL = ENGINE_LP_TOL
# In bf16, the published dtype, every layer rounds its output to bf16 and
# the logits are bf16 (spacing 2^-5 at |logit| 4-8, 2^-3 at 16-32), so the
# two lowerings part by whole bf16 steps that the layers carry on. The
# limits, (engine log-probabilities in nats, rows' max|diff| / max|logit|,
# rows' next-token log-probabilities in nats) for each model, are fixed
# numbers set from this phase's readings on the H100 (PERF.md §6):
# above the sound run's, and failed by a control computed in lower
# precision (every recurrent state rounded to float8_e5m2 after each
# prefill block and decode step), which runs here and must fail a row
# limit; the bf16 train-mode forward against the f32 one is read beside
# them. Readings:
# mamba2 engine 0.0627 (train-mode bf16 vs f32 at those tokens 0.122), rows
# 2.92e-2 / 0.117 (train-mode bf16 vs f32 3.87e-2 / 0.138, the control
# 3.11e-2 / 0.137); recurrentgemma at 20 of 38 layers (REC_SERVE_LAYERS;
# at 38, 0.234 and its limit 0.26) engine 0, rows 6.80e-3 / 0.328
# (train-mode bf16 vs f32 5.11e-3 / 0.224, the control 2.91e-2 / 0.328).
# recurrentgemma's engine log-probabilities meet the f32 limit;
# mamba2's do not meet 1e-2 nats in bf16 (in f32 they lie within 2.1e-5).
REC_BF16_LIMITS = {"mamba2-780m": (0.09, 0.034, 0.127),
                   "recurrentgemma-9b": (REC_LP_TOL, 2e-2, 0.36)}
REC_SHARED, REC_SUFFIX = 2048, (300, 701)  # the shared system prompt, suffix lengths
REC_TRAIN_SEQ = 4096
REC_TRAIN_STEPS = {"mamba2-780m": 3, "recurrentgemma-9b": 2}


def reckon_recurrent_snapshot_bytes(cfg, max_len) -> int:
    """One slot's decode state, the whole of a recurrent model's snapshot:
    per SSD layer h (heads, N, P) f32 and the conv window (K-1, d_inner+2N);
    per RG-LRU layer h (w,) f32 and its 3-token conv window (3, w); per
    local-attention layer the ring's k and v, (kv heads, min(W, max_len),
    h) each; windows and rings in the compute dtype."""
    item = torch.tensor([], dtype=getattr(torch, cfg.compute_dtype)).element_size()
    d_inner = cfg.ssm_expand * cfg.d_model
    w = cfg.rglru_width or cfg.d_model
    per = {"ssd": 4 * d_inner * cfg.ssm_state
           + item * (cfg.ssm_conv - 1) * (d_inner + 2 * cfg.ssm_state),
           "rglru": 4 * w + item * 3 * w,
           "local_attn": 2 * item * cfg.n_kv_heads * min(cfg.sliding_window, max_len)
           * cfg.resolved_head_dim}
    g = len(cfg.block_pattern)
    return sum(per[cfg.block_pattern[i % g]] for i in range(cfg.n_layers))


def group_split(cfg):
    """(parameters of one pattern group, the rest: embedding and final
    norm), counted on the meta device."""
    lm = build_model(cfg.replace(n_layers=len(cfg.block_pattern)), device="meta").lm
    group = sum(p.numel() for layer in lm.layers for p in layer.parameters())
    return group, sum(p.numel() for p in lm.parameters()) - group


def rec_train_groups(cfg) -> int:
    """The most whole pattern groups (at least one, at most the published
    depth's) that train at 16 bytes a parameter (f32 weights, gradients and
    AdamW's m and v) plus DENSE_TRAIN_ACT_GIB a layer, in DENSE_SHARE of
    the card beside DENSE_TRAIN_RESERVE_GIB (logits, casts, the clipped
    gradients' copy)."""
    group, rest = group_split(cfg)
    g = len(cfg.block_pattern)
    room = DENSE_SHARE * card_gib() - DENSE_TRAIN_RESERVE_GIB - 16 * rest / 2**30
    fit = int(room // (16 * group / 2**30 + g * DENSE_TRAIN_ACT_GIB))
    return max(1, min(cfg.n_layers // len(cfg.block_pattern), fit))


def rec_model(cfg, **kw):
    gc.collect()
    torch.cuda.empty_cache()
    return build_model(cfg, device="cuda", seed=0, draw_on_device=True, **kw)


def rec_engine(model, max_len, **kw):
    return ServeEngine(model, slots=REC_SLOTS, max_len=max_len, logprobs=True,
                       prefill_budget=REC_BUDGET, overlap=True, **kw)


def rec_samp():
    return [SamplingParams() if i < 2 else SamplingParams(seed=100 + i, **ENGINE_SAMPLED)
            for i in range(4)]


def rec_serve_run(eng, prompts, samp):
    """Serve the 4 requests through `eng` (all at t = 0), with every
    kernel's launches and the plain versions' calls counted over exactly
    the run. Returns ({request: RequestOutput}, wall s, launches, plain
    calls)."""
    torch.cuda.synchronize()
    zero_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        rid_of = {eng.submit(p, REC_GEN, sampling=sp): i
                  for i, (p, sp) in enumerate(zip(prompts, samp))}
        outs = {rid_of[o.rid]: o for o in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return outs, wall, counts(), plain.calls


def twin(model, dtype):
    """The same weights (shared, not copied) under another compute dtype."""
    cfg = model.cfg.replace(compute_dtype=dtype)
    other = build_model(cfg, device="meta")
    other.lm.load_state_dict(model.lm.state_dict(), assign=True)
    return other


def train_logprobs(model, prompt, tokens):
    """log_softmax of a train-mode forward over prompt + tokens[:-1], at each
    emitted token (f32, numpy)."""
    seq = torch.from_numpy(np.concatenate([prompt, tokens[:-1]]))[None].cuda()
    with torch.inference_mode():
        logits, _ = model.lm(seq, mode="train")
        rows = logits[0, len(prompt) - 1:].float()
        lp = torch.log_softmax(rows, dim=-1).gather(
            1, torch.from_numpy(tokens.astype(np.int64)).cuda()[:, None])[:, 0]
        return lp.cpu().numpy()


def row_errs(rows, want, nxt, chunk=512):
    """(max|rows - want|, the largest |difference| of log_softmax at each
    row's next token `nxt`), over rows (n, V) and want (n, V), in f32 a
    chunk of rows at a time."""
    diff = lp = 0.0
    for s in range(0, rows.shape[0], chunk):
        r, w = rows[s:s + chunk].float(), want[s:s + chunk].float()
        t = nxt[s:s + chunk, None]
        diff = max(diff, (r - w).abs().max().item())
        d = torch.log_softmax(r, -1).gather(1, t) - torch.log_softmax(w, -1).gather(1, t)
        lp = max(lp, d.abs().max().item())
    return diff, lp


def train_rows(model, seq):
    """A train-mode forward's logits over seq[:-1], (len(seq) - 1, V)."""
    with torch.inference_mode():
        return model.lm(seq[None, :-1], mode="train")[0][0]


def rec_rows(model, seq, plen, want, state_dtype=None):
    """The serving path over seq[:-1] (a prompt of `plen` tokens, then the
    emitted ones), through DecodeState's own steps: the prefill on the
    block grid with every row of each block kept, then teacher-forced
    decode steps; each row against `want` (train_rows). With a
    `state_dtype`, every f32 recurrent state h is rounded to it after each
    block and step: the caches' precision dropped. Returns (max|diff| over
    max|want|, the largest |log-probability difference| of a next token,
    nats)."""
    st, top = model.state, want.float().abs().max().item()
    diff = lp = 0.0

    def hold(rows, at, state):
        nonlocal diff, lp
        d, p = row_errs(rows, want[at:at + rows.shape[0]], seq[at + 1:at + 1 + rows.shape[0]])
        diff, lp = max(diff, d), max(lp, p)
        if state_dtype is not None:
            for node in state:
                if isinstance(node, dec.RecurrentCache):
                    node.h.copy_(node.h.to(state_dtype))

    state = st.init(1, len(seq))
    with torch.inference_mode():
        for s in range(0, plen, st.block_size):
            e = min(plen, s + st.block_size)
            logits, state = model.lm(seq[None, s:e], mode="prefill", cache=state,
                                     positions=torch.arange(s, e, device=seq.device))
            hold(logits[0], s, state)
        for pos in range(plen, len(seq) - 1):
            logits, state = st.decode_step(seq[None, pos:pos + 1], pos, state)
            hold(logits, pos, state)
    return diff / top, lp


def rec_no_kernels(label, launched, plain_calls):
    if any(launched.values()) or plain_calls:
        raise AssertionError(f"{label}: port kernels launched {launched} or plain versions "
                             f"called {plain_calls} times on a path that has none")


def profile_rec_ticks(model, ticks=4):
    """`ticks` decode ticks with both slots decoding (a greedy and a sampled
    request, 256-token prompts, no admission in flight), from torch.profiler
    with CPU and CUDA activities: host syncs and device-to-host copies a
    tick (less what the profiler makes around an empty region), kernels a
    tick, device-busy and wall ms a tick, the device ms a tick of each
    mixer kind (every kernel its modules launch: projections, conv,
    recurrence or attention, norm; through a record_function range hooked
    around each mixer), and the kernels that take the most device time.
    Returns a dict."""
    from torch.profiler import ProfilerActivity, profile, record_function
    eng = rec_engine(model, 256 + ticks + 8)
    rng = np.random.default_rng(5)
    for sp in (SamplingParams(), SamplingParams(seed=3, **ENGINE_SAMPLED)):
        eng.submit(rng.integers(0, model.cfg.vocab_size, size=256), ticks + 8, sampling=sp)
    while eng.n_active < REC_SLOTS or eng.scheduler.active:
        eng.step()
    eng.step()                                   # the pipeline holds a tick
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def tally(run):
        with profile(activities=acts) as prof:
            out = timed(run)[1]
        calls, copies = {}, {}
        for e in prof.key_averages():
            if e.key.startswith("cuda"):
                calls[e.key] = e.count
            elif e.key.startswith("Memcpy"):
                kind = next((k for k in ("DtoH", "HtoD", "DtoD") if k in e.key), e.key)
                copies[kind] = copies.get(kind, 0) + e.count
        return prof, out, calls, copies

    _, _, base, _ = tally(lambda: None)
    ranges, hooks = [], []
    for block in model.lm.layers:
        def enter(mod, args, label=f"mixer {block.kind}"):
            ranges.append(record_function(label))
            ranges[-1].__enter__()

        def leave(mod, args, out):
            ranges.pop().__exit__(None, None, None)
        hooks += [block.mixer.register_forward_pre_hook(enter),
                  block.mixer.register_forward_hook(leave)]
    try:
        prof, wall, calls, copies = tally(lambda: [eng.step() for _ in range(ticks)])
    finally:
        for h in hooks:
            h.remove()
    syncs = sum(v - base.get(k, 0) for k, v in calls.items() if k in SYNC_CALLS) / ticks
    # the ranges also appear as device rows, spanning their kernels and the
    # idle gaps between them: kernels only count toward busy time
    rows = [e for e in device_rows(prof) if not e.key.startswith("mixer ")]
    busy = sum(dev_us(e) for e in rows) / 1e3 / ticks
    kernels = sum(e.count for e in rows) / ticks
    top = sorted(rows, key=dev_us, reverse=True)[:6]
    mixers = {}
    for e in prof.events():       # host-side ranges: the kernels their ops launch
        if e.name.startswith("mixer ") and str(e.device_type).endswith("CPU"):
            mixers[e.name] = mixers.get(e.name, 0.0) + e.device_time_total / 1e3 / ticks
    eng.run()
    del eng
    gc.collect()
    return {"syncs": syncs, "d2h": copies.get("DtoH", 0) / ticks,
            "copies": {k: v / ticks for k, v in sorted(copies.items())},
            "ms": wall * 1e3 / ticks, "busy_ms": busy, "kernels": kernels,
            "mixers_ms": mixers,
            "top": [(dev_us(e) / 1e3 / ticks, e.count // ticks, e.key[:80]) for e in top]}


def phase_rec_serve(arch, card):
    """One recurrent model at its published width and the depth of
    REC_SERVE_LAYERS (the published one by default), bf16, seeded weights
    drawn on the card, served through ServeEngine: 4 requests on 2
    slots (prompts of 1024-4096 tokens: the 4096-token prompt wraps
    recurrentgemma's 2048-slot ring; 16 new tokens, 0 and 1 greedy, 2 and
    3 sampled), prefill budget 2048, overlap on. Gates: no port kernel
    launches and no plain version is called; every output in range and
    finite; the served log-probabilities of every request against
    log_softmax of a train-mode forward over prompt + emitted tokens,
    and request 0's logit rows served through DecodeState (rec_rows)
    against the train-mode forward's, each within its REC_BF16_LIMITS (and
    within REC_LP_TOL and F32_TOL when the same weights serve in f32), with
    the lower-precision control failing a bf16 row limit; at most one host sync and one device-to-host copy a decode
    tick (profile_rec_ticks). Returns (model, row)."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(n_layers=REC_SERVE_LAYERS.get(arch, full.n_layers))
    torch.cuda.reset_peak_memory_stats()
    model, t_build = timed(lambda: rec_model(cfg))
    weights = sum(p.numel() for p in model.lm.parameters())
    log(f"phase 10: {arch} serving, bf16, published width, {cfg.n_layers} of "
        f"{full.n_layers} layers (REC_SERVE_LAYERS) of {'/'.join(cfg.block_pattern)} "
        f"(d_model {cfg.d_model}, vocab {cfg.vocab_size}); "
        f"{weights / 1e9:.3f}B parameters, {4 * weights / 2**30:.1f} GiB f32 weights drawn "
        f"on the card (seed 0) in {t_build:.1f} s; {card}")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in REC_LENS]
    samp = rec_samp()
    max_len = max(REC_LENS) + REC_GEN
    warm = rec_engine(model, max_len)             # allocator, cuBLAS
    warm.submit(prompts[1][:512], 2)
    warm.run()
    del warm
    gc.collect()
    eng = rec_engine(model, max_len)
    outs, wall, launched, plain = rec_serve_run(eng, prompts, samp)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = eng.stats()
    ttft = np.array([o.ttft_s for o in outs.values()]) * 1e3
    gen = sum(len(o.tokens) for o in outs.values())
    tick_ms = st["decode_s"] * 1e3 / st["decode_steps"]
    log(f"  run: {wall * 1e3:.1f} ms for {gen} generated tokens = {gen / wall:.1f} generated "
        f"tok/s (prompts {sum(map(len, prompts))} tokens); TTFT p50 "
        f"{np.percentile(ttft, 50):.1f} ms, p99 {np.percentile(ttft, 99):.1f} ms; "
        f"{st['decode_steps']} decode ticks, {tick_ms:.2f} ms a tick; "
        f"{st['scheduler']['chunks']} prefill chunks; peak device memory {peak:.2f} GiB")
    log(f"  launches in the run: {launched}; plain-version calls: {plain}")
    rec_no_kernels(f"{arch} serving", launched, plain)
    for i, o in outs.items():
        if len(o.tokens) != REC_GEN or o.tokens.min() < 0 \
                or o.tokens.max() >= cfg.vocab_size or not np.isfinite(o.logprobs).all():
            raise AssertionError(f"{arch} request {i}: bad output {o.tokens}, {o.logprobs}")
    f32 = twin(model, "float32")                  # the same weights, f32 compute
    lim_lp, lim_rel, lim_rows_lp = REC_BF16_LIMITS[arch]
    worst = max(float(np.abs(o.logprobs - train_logprobs(model, prompts[i], o.tokens)).max())
                for i, o in outs.items())
    check(f"{arch}: engine logprobs vs train-mode forward, bf16 (nats)", worst, lim_lp)
    outs32, _, launched, plain = rec_serve_run(rec_engine(f32, max_len), prompts, samp)
    rec_no_kernels(f"{arch} serving in f32", launched, plain)
    worst32 = max(float(np.abs(o.logprobs - train_logprobs(f32, prompts[i], o.tokens)).max())
                  for i, o in outs32.items())
    check(f"{arch}: engine logprobs vs train-mode forward, f32 (nats)", worst32, REC_LP_TOL)
    seq = torch.from_numpy(np.concatenate([prompts[0], outs[0].tokens]).astype(np.int64)).cuda()
    plen = len(prompts[0])
    want16, want32 = train_rows(model, seq), train_rows(f32, seq)
    top = want32.float().abs().max().item()
    d, p = row_errs(want16, want32, seq[1:])
    rows = {"bf16": rec_rows(model, seq, plen, want16),
            "f32": rec_rows(f32, seq, plen, want32),
            "states rounded to bf16": rec_rows(model, seq, plen, want16, torch.bfloat16),
            "train-mode bf16 vs f32": (d / top, p),
            "control: states rounded to float8_e5m2": rec_rows(model, seq, plen, want16,
                                                              torch.float8_e5m2)}
    log(f"  request 0 ({plen} prompt tokens + {REC_GEN - 1} decode steps): served logit rows "
        f"vs the train-mode forward's, max|diff| / max|logit| (max|logit| {top:.3f}) and "
        f"every next token's log-probability (nats): " + "; ".join(
            f"{k} {r[0]:.4e}, {r[1]:.4e}" for k, r in rows.items()))
    check(f"{arch}: served logit rows vs train-mode, f32 (rel. to max)", rows["f32"][0],
          F32_TOL)
    check(f"{arch}: served rows' next-token logprobs vs train-mode, f32 (nats)",
          rows["f32"][1], REC_LP_TOL)
    check(f"{arch}: served logit rows vs train-mode, bf16 (rel. to max)", rows["bf16"][0],
          lim_rel)
    check(f"{arch}: served rows' next-token logprobs vs train-mode, bf16 (nats)",
          rows["bf16"][1], lim_rows_lp)
    ctl = rows["control: states rounded to float8_e5m2"]
    caught = ctl[0] > lim_rel or ctl[1] > lim_rows_lp
    log(f"  the control (recurrent states rounded to float8_e5m2) fails a bf16 row limit: "
        f"{caught}")
    if not caught:
        raise AssertionError(f"{arch}: the lower-precision control passes the bf16 row limits")
    del f32, outs32, want16, want32
    for i in (0, 2):
        log(f"  req{i}: {' '.join(map(str, outs[i].tokens.tolist()))}")
    del eng, outs
    prof = profile_rec_ticks(model)
    log(f"  profile of 4 decode ticks (2 slots decoding, one sampled): {prof['ms']:.2f} ms a "
        f"tick (profiler on), device busy {prof['busy_ms']:.2f} ms a tick = "
        f"{prof['busy_ms'] / prof['ms']:.1%}, {prof['kernels']:.0f} kernel launches a tick; "
        f"host syncs {prof['syncs']:g} and device memory copies {prof['copies']} a tick; "
        f"device ms a tick in the mixers (all their kernels): "
        + ", ".join(f"{k[6:]} {v:.3f} ({v / prof['busy_ms']:.1%} of busy)"
                    for k, v in prof["mixers_ms"].items()) + "; the top kernels:")
    for ms, n, key in prof["top"]:
        log(f"    {ms:9.3f} ms a tick  x{n:<5d} {key}")
    if prof["syncs"] > 1 or prof["d2h"] > 1:
        raise AssertionError(f"{arch}: the decode tick syncs the host {prof['syncs']:g} times "
                             f"and copies device to host {prof['d2h']:g} times")
    log(f"  phase 10 {arch} serving: {time.perf_counter() - t_phase:.1f} s")
    return model, {"arch": arch, "layers": cfg.n_layers, "params_b": round(weights / 1e9, 3),
                   "tick_ms": tick_ms, "ttft_p50_ms": float(np.percentile(ttft, 50)),
                   "ttft_p99_ms": float(np.percentile(ttft, 99)), "gen_tok_s": gen / wall,
                   "peak_gib": peak, "logprob_err_bf16": worst, "logprob_err_f32": worst32,
                   "rows": rows, "profiled_tick_ms": prof["ms"],
                   "profiled_busy_ms": prof["busy_ms"],
                   "kernels_a_tick": prof["kernels"], "mixers_ms": prof["mixers_ms"],
                   "tick_syncs": prof["syncs"],
                   "tick_d2h": prof["d2h"], "card": card}


def phase_rec_prefix(model, card):
    """The token-granularity prefix reuse: 4 requests sharing a 2048-token
    system prompt, each with its own 300-700-token suffix (not block-
    aligned, so the scheduler splits each prefill at its truncation), 16
    new tokens, 0 and 1 greedy, 2 and 3 sampled, through run A (no prefix
    cache) and run B (a 512 MiB memory-tier PrefixCache after a warm-up of
    the same system prompt with other suffixes and reset_stats()). Gates:
    tokens and log-probabilities equal bit for bit across A and B; B hits;
    no port kernel and no plain version; every snapshot's bytes equal
    reckon_recurrent_snapshot_bytes; and a prefill resumed at the 2048
    block boundary equals the cold prefill of the first request's prompt
    bit for bit (logits and every layer's state). Returns a row."""
    t_phase = time.perf_counter()
    cfg = model.cfg
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, REC_SHARED)
    lens = rng.integers(*REC_SUFFIX, size=4)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)]) for n in lens]
    warm = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)]) for n in lens]
    samp = rec_samp()
    max_len = REC_SHARED + REC_SUFFIX[1] + REC_GEN
    log(f"phase 10: {cfg.name} prefix reuse, token granularity: 4 requests, a "
        f"{REC_SHARED}-token shared system prompt + suffixes of {lens.tolist()} tokens, "
        f"{REC_GEN} new, 2 greedy + 2 sampled; A no cache, B a "
        f"{PREFIX_CACHE_BYTES >> 20} MiB memory tier after a warm-up; {card}")
    rows = {}
    outs_a, wall_a, launched, plain = rec_serve_run(rec_engine(model, max_len), prompts, samp)
    rec_no_kernels(f"{cfg.name} run A", launched, plain)
    pc = PrefixCache(PREFIX_CACHE_BYTES)
    eng = rec_engine(model, max_len, prefix_cache=pc)
    for p, sp in zip(warm, samp):
        eng.submit(p, REC_GEN, sampling=sp)
    eng.run()
    eng.reset_stats()
    outs_b, wall_b, launched, plain = rec_serve_run(eng, prompts, samp)
    rec_no_kernels(f"{cfg.name} run B", launched, plain)
    for label, outs, wall, e in (("A", outs_a, wall_a, None), ("B", outs_b, wall_b, eng)):
        ttft = np.array([o.ttft_s for o in outs.values()]) * 1e3
        rows[label] = {"wall_ms": wall * 1e3, "ttft_p50_ms": float(np.percentile(ttft, 50)),
                       "ttft_p99_ms": float(np.percentile(ttft, 99))}
    st = eng.stats()
    pcs = st["prefix_cache"]
    rows["B"].update(hits=pcs["hits"], restored_tokens=pcs["hit_tokens"],
                     inserts=pcs["inserts"], evictions=pcs["evictions"],
                     promote_splits=st["scheduler"]["promote_splits"],
                     coalesced=st["scheduler"]["coalesced"])
    for label in ("A", "B"):
        r = rows[label]
        log(f"  run {label}: {r['wall_ms']:.1f} ms, TTFT p50 {r['ttft_p50_ms']:.1f} ms, p99 "
            f"{r['ttft_p99_ms']:.1f} ms" + ("" if label == "A" else
            f"; hits {r['hits']}, restored tokens {r['restored_tokens']}, inserts "
            f"{r['inserts']}, evictions {r['evictions']}, promote splits "
            f"{r['promote_splits']}, coalesced {r['coalesced']}"))
    same = all(np.array_equal(outs_a[i].tokens, outs_b[i].tokens)
               and np.array_equal(outs_a[i].logprobs, outs_b[i].logprobs) for i in outs_a)
    log(f"  tokens and log-probabilities equal bit for bit across A and B: {same}")
    if not same:
        raise AssertionError(f"{cfg.name}: run B's tokens or log-probabilities differ from A's")
    if not (rows["B"]["hits"] > 0 and rows["B"]["restored_tokens"] > 0):
        raise AssertionError(f"{cfg.name}: run B has no prefix-cache hit")
    nbytes = sorted({snapshot_nbytes(e.snapshot) for e in pc._entries.values()})
    want = reckon_recurrent_snapshot_bytes(cfg, max_len)
    log(f"  snapshot bytes: {nbytes} (reckoned {want})")
    if nbytes != [want]:
        raise AssertionError(f"{cfg.name}: snapshot bytes {nbytes} != {want}")
    del eng, pc
    gc.collect()
    st_ = model.state
    tokens = torch.from_numpy(prompts[0][None]).cuda()
    with torch.inference_mode():
        cold_logits, cold = st_.prefill(tokens, max_len=max_len)
        _, part = st_.prefill(tokens[:, :REC_SHARED], max_len=max_len)
        res_logits, res = st_.resume(tokens[:, REC_SHARED:], part, REC_SHARED)
    same = torch.equal(cold_logits, res_logits) and all(
        all(torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b))
        for a, b in zip(cold, res))
    log(f"  prefill {REC_SHARED} + resume {len(prompts[0]) - REC_SHARED} == cold prefill "
        f"{len(prompts[0])}, bit for bit (logits and all {len(cold)} layer states): {same}")
    if not same:
        raise AssertionError(f"{cfg.name}: the resumed prefill differs from the cold one")
    log(f"  phase 10 {cfg.name} prefix reuse: {time.perf_counter() - t_phase:.1f} s")
    return {"arch": cfg.name, "snapshot_bytes": want, "runs": rows, "card": card}


def phase_rec_cross_device(archs=RECURRENT_ARCHS):
    """SMOKE greedy tokens on the card equal those on the CPU (f32, weights
    from one CPU seed), for both recurrent configs (or `archs`): a
    40-token prompt and 8 steps (past recurrentgemma SMOKE's 32-token
    window, and SMOKE's 16-token block)."""
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 40))
        on_card = generate(build_model(cfg, device="cuda", seed=3), prompt, 8)
        on_cpu = generate(build_model(cfg, device="cpu", seed=3), prompt, 8)
        same = torch.equal(on_card.tokens.cpu(), on_cpu.tokens)
        check(f"{arch} SMOKE generate logits, card vs CPU",
              err(on_card.logits_last.cpu(), on_cpu.logits_last), F32_TOL)
        log(f"  {arch} SMOKE greedy tokens equal on card and CPU: {same}")
        if not same:
            raise AssertionError(f"{arch}: SMOKE greedy tokens differ between card and CPU")


def rec_remat_gate(full):
    """At 1 x REC_TRAIN_SEQ and one pattern group (mamba2: 3 layers, as
    its SMOKE), bf16, under torch.use_deterministic_algorithms: one step's
    gradients and two AdamW steps' losses with remat "dots" and "full"
    equal remat "none"'s bit for bit."""
    g = len(full.block_pattern)
    depth = g if g > 1 else 3
    cfg = full.replace(n_layers=depth)
    it = DataIterator(make_markov_lm(cfg.vocab_size, seed=1), 1, REC_TRAIN_SEQ, seed=0,
                      device="cuda")
    batches = [next(it) for _ in range(2)]
    tcfg = TrainConfig(seq_len=REC_TRAIN_SEQ, global_batch=1, steps=100, peak_lr=3e-3)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for remat in ("none", "dots", "full"):
            c = cfg.replace(remat=remat)
            lm = rec_model(c, trainable=True).lm
            loss, _ = make_loss_fn(c)(lm, batches[0])
            loss.backward()
            grads = {n: p.grad.clone() for n, p in lm.named_parameters()}
            state, step = init_train_state(lm), make_train_step(c, tcfg)
            losses = []
            for batch in batches:
                state, metrics = step(state, batch)
                losses.append(metrics["loss"].clone())
            runs[remat] = grads, torch.stack(losses)
            del state, step, loss, grads, lm
    finally:
        torch.use_deterministic_algorithms(False)
    grads0, losses0 = runs["none"]
    for remat in ("dots", "full"):
        grads, losses = runs[remat]
        same_g = all(torch.equal(grads[n], grads0[n]) for n in grads0)
        same_l = torch.equal(losses, losses0)
        log(f"  remat gate, {depth} layers at 1 x {REC_TRAIN_SEQ}: remat={remat}: one step's "
            f"gradients equal none's bit for bit: {same_g}; two steps' losses "
            f"{losses.tolist()} equal none's {losses0.tolist()}: {same_l}")
        if not (same_g and same_l):
            raise AssertionError(f"{cfg.name}: remat={remat} changed the training bits")
    del runs
    gc.collect()
    torch.cuda.empty_cache()


def phase_rec_train(arch, card):
    """One recurrent model trained at its published width, bf16, with its
    published remat (mamba2 "dots", recurrentgemma "full"), 1 x 4096
    Markov tokens a step, at the most whole pattern groups that fit
    (rec_train_groups), at most REC_TRAIN_LAYERS (mamba2 at 6 of 48,
    recurrentgemma at 2 groups),
    seeded weights drawn on the
    card: a warm-up and REC_TRAIN_STEPS timed steps (step ms, tokens/s,
    peak GiB) with no port kernel and no plain version; two runs of 2 steps
    from the seed give the same parameters bit for bit (deterministic
    algorithms on); and the remat gate (rec_remat_gate). Returns a row."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    g = len(full.block_pattern)
    groups = min(rec_train_groups(full), REC_TRAIN_LAYERS.get(arch, full.n_layers) // g)
    cfg = full.replace(n_layers=groups * g)
    group, rest = group_split(full)
    reckon = {k: round(16 * (rest + k * group) / 1e9, 1) for k in (1, 3, 4)}
    log(f"phase 10: {arch} training, bf16, remat {cfg.remat!r}, 1 x {REC_TRAIN_SEQ} Markov "
        f"tokens a step, {cfg.n_layers} of {full.n_layers} layers ({groups} whole groups of "
        f"{g}; reckoned at 16 B a parameter: {group / 1e6:.0f}M a group, "
        f"{rest / 1e6:.0f}M embedding, GB for 1/3/4 groups {reckon}, + "
        f"{DENSE_TRAIN_ACT_GIB} GiB a layer and {DENSE_TRAIN_RESERVE_GIB} GiB reserve in "
        f"{DENSE_SHARE:.0%} of {card_gib():.1f} GiB); {card}")
    steps = REC_TRAIN_STEPS[arch]
    it = DataIterator(make_markov_lm(cfg.vocab_size, seed=1), 1, REC_TRAIN_SEQ, seed=0,
                      device="cuda")
    batches = [next(it) for _ in range(steps + 1)]
    tcfg = TrainConfig(seq_len=REC_TRAIN_SEQ, global_batch=1, steps=100, peak_lr=3e-3)
    lm = rec_model(cfg, trainable=True).lm
    torch.cuda.reset_peak_memory_stats()
    state, step = init_train_state(lm), make_train_step(cfg, tcfg)
    state, _ = step(state, batches[0])            # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times, losses = [], []
    with PlainCalls() as plain:
        for batch in batches[1:]:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median(times)) * 1e3
    log(f"  losses {[round(x, 4) for x in losses]}; step time median {step_ms:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times]}; {REC_TRAIN_SEQ / np.median(times):.0f} "
        f"tokens/s; peak device memory {peak:.2f} GiB; launches {launched}, plain-version "
        f"calls {plain.calls}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} training: non-finite loss {losses}")
    rec_no_kernels(f"{arch} training", launched, plain.calls)
    del state, step, lm

    torch.use_deterministic_algorithms(True)
    try:
        def run():
            lm = rec_model(cfg, trainable=True).lm
            state, step = init_train_state(lm), make_train_step(cfg, tcfg)
            for batch in batches[:2]:
                state, _ = step(state, batch)
            return [p.detach().cpu() for p in lm.parameters()]
        first = run()
        second = run()
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"  (deterministic algorithms on) two runs of 2 steps from seed 0: parameters equal "
        f"bit for bit: {same}")
    if not same:
        raise AssertionError(f"{arch} training is not bit-reproducible on the card")
    del first, second
    rec_remat_gate(full)
    log(f"  phase 10 {arch} training: {time.perf_counter() - t_phase:.1f} s")
    return {"arch": arch, "layers": cfg.n_layers, "published_layers": full.n_layers,
            "groups": groups, "remat": cfg.remat, "step_ms": step_ms,
            "tokens_s": REC_TRAIN_SEQ / float(np.median(times)), "peak_gib": peak,
            "losses": losses, "card": card}


def phase_recurrent(card):
    """Phase 10 for both recurrent models: serving and prefix reuse at
    REC_SERVE_LAYERS, the cross-device check, training. Returns its rows."""
    t0 = time.perf_counter()
    rows = {"serve": [], "prefix": [], "train": []}
    for arch in RECURRENT_ARCHS:
        model, row = phase_rec_serve(arch, card)
        rows["serve"].append(row)
        rows["prefix"].append(phase_rec_prefix(model, card))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    phase_rec_cross_device()
    for arch in RECURRENT_ARCHS:
        rows["train"].append(phase_rec_train(arch, card))
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"recurrent": rows}, default=float))
    return rows


# ---------------------------------------------------------------------------
# phase 11: the mixture-of-experts family (dbrx-132b: 16 experts top-4 in
# every layer; llama4-maverick-400b-a17b: 128 experts top-1 in every second
# layer) served and trained at their published widths, bf16
# ---------------------------------------------------------------------------

MOE_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
# beside the f32 weights: one expert weight's bf16 cast (moe.CAST_BYTES, 2
# GiB), the slots' states, a chunk's activations and logits, the checks'
# train-mode forward
MOE_SERVE_RESERVE_GIB = 8
# dbrx serves at most this many of the 5 layers that fit, to make room for
# phases 14 and 15 (3 from phase 14 to phase 15: 27.2 s; in whole cycles:
# maverick keeps its first (GLU, MoE) pair)
MOE_SERVE_LAYERS = 2
# beside 16 B a parameter: the layer's bf16 expert casts kept for its
# recomputed backward (6 GiB for dbrx), their gradients, logits
MOE_TRAIN_RESERVE_GIB = 12
MOE_NO_DROP = 8.0              # the logic gates' capacity factor (the reference's oracle test)
MOE_DISPATCH_TOKENS = 2048     # the dispatch gate: one dbrx MoE layer on 1 x 2048
MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4096, 4
# the dispatch against the dense oracle (max|err| / max|y|), f32 and bf16
MOE_F32_TOL, MOE_BF16_TOL = 1e-4, 5e-2


def cycle_split(cfg):
    """(parameters of one cycle of the effective pattern, its layers, the
    rest: embedding and final norm), counted on the meta device."""
    g = len(effective_pattern(cfg))
    lm = build_model(cfg.replace(n_layers=g), device="meta").lm
    cycle = sum(p.numel() for layer in lm.layers for p in layer.parameters())
    return cycle, g, sum(p.numel() for p in lm.parameters()) - cycle


def moe_depth(cfg, bytes_a_param, reserve_gib) -> int:
    """The most layers, in whole cycles of the effective pattern (at least
    one: never below the first MoE layer; at most the published depth),
    whose `bytes_a_param` fit in DENSE_SHARE of the card beside
    reserve_gib."""
    cycle, g, rest = cycle_split(cfg)
    room = DENSE_SHARE * card_gib() - reserve_gib - bytes_a_param * rest / 2**30
    fit = int(room // (bytes_a_param * cycle / 2**30))
    return g * max(1, min(cfg.n_layers // g, fit))


def moe_drops(layer, cfg, x):
    """(assignments dropped, assignments routed) by an MoE call on x (B, S,
    D), as 0-d tensors (no host sync): its router and the capacity of that
    call, recomputed."""
    _, _, _, ids = moe.route(layer, cfg, x.reshape(-1, x.shape[-1]))
    keep = moe.dispatch_plan(cfg, ids).keep
    return (~keep).sum(), keep.numel()


def first_moe(lm):
    return next(b.ffn for b in lm.layers if b.ffn_kind == "moe")


def record_drops(lm, calls):
    """A forward pre-hook on the first MoE layer that appends (tokens,
    dropped, routed) of each call of more than one token (a prefill chunk
    or a train-mode forward) to `calls`, as 0-d tensors (no host sync).
    Returns its handle."""
    def pre(mod, args):
        x = args[0]
        if x.shape[1] > 1:
            calls.append((x.shape[1],) + moe_drops(mod, mod.cfg, x))
    return first_moe(lm).register_forward_pre_hook(pre)


def drop_shares(calls):
    return [(int(n), int(d) / r) for n, d, r in calls]


def card_moe_layer(cfg):
    """An MoE layer with seed-0 weights drawn on the card, frozen."""
    return moe.MoE(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                   device="cuda").requires_grad_(False)


def phase_moe_dispatch():
    """One dbrx MoE layer at its published width (16 experts of 6144 x
    10752, top-4), seed-0 weights drawn on the card, on 1 x 2048 tokens at
    capacity factor 8.0 (nothing drops, as the reference's own test):
    moe_apply against moe_apply_dense_oracle in f32 (1e-4 of max|y|) and
    bf16 (5e-2), in 1, 2 and 4 dispatch groups, and the bf16 dispatch
    twice bit for bit. Returns its errors."""
    t0 = time.perf_counter()
    cfg = get_config("dbrx-132b").replace(capacity_factor=MOE_NO_DROP)
    gc.collect()
    torch.cuda.empty_cache()
    layer = card_moe_layer(cfg)
    x32 = seeded(31)(1, MOE_DISPATCH_TOKENS, cfg.d_model)
    log(f"phase 11: one dbrx-132b MoE layer ({cfg.n_experts} experts of {cfg.d_model} x "
        f"{cfg.d_ff}, top-{cfg.moe_top_k}) on 1 x {MOE_DISPATCH_TOKENS} tokens, capacity "
        f"factor {MOE_NO_DROP} (no drops): the sort-based dispatch against the dense oracle")
    errs = {}
    with torch.inference_mode():
        for dt, tol in ((torch.float32, MOE_F32_TOL), (torch.bfloat16, MOE_BF16_TOL)):
            x = x32.to(dt)
            want = moe.moe_apply_dense_oracle(layer, cfg, x)
            top = want.float().abs().max().item()
            name = str(dt)[6:]
            for groups in (1, 2, 4):
                c = cfg.replace(moe_dispatch_groups=groups)
                dropped, routed = moe_drops(layer, c, x)
                got, _ = moe.moe_apply(layer, c, x)
                e = err(got, want) / top
                errs[(name, groups)] = e
                check(f"dbrx MoE dispatch vs dense oracle, {name}, {groups} group(s), "
                      f"cap {moe.capacity(c, MOE_DISPATCH_TOKENS // groups)} (rel.)", e, tol)
                if int(dropped):
                    raise AssertionError(f"{int(dropped)} of {routed} assignments dropped "
                                         f"at capacity factor {MOE_NO_DROP}")
                del got
            if dt == torch.bfloat16:
                a, _ = moe.moe_apply(layer, cfg, x)
                b, _ = moe.moe_apply(layer, cfg, x)
                same = torch.equal(a, b)
                log(f"  bf16 dispatch twice, bit for bit: {same}")
                if not same:
                    raise AssertionError("the bf16 MoE dispatch is not bit-reproducible")
                del a, b
            del want
    del layer, x32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 11 dispatch: {time.perf_counter() - t0:.1f} s")
    return errs


MOE_RANGES = (("router", "route"), ("sort/dispatch", "dispatch_plan"),
              ("sort/dispatch", "dispatch"), ("experts", "expert_glu"),
              ("casts", "cast_experts"), ("combine", "combine"))


def profile_moe(model, ticks=4):
    """torch.profiler over `ticks` decode ticks with both slots decoding (a
    greedy and a sampled request, 256-token prompts) and over one
    2048-token prefill call (model.state.prefill): wall and device-busy ms,
    kernel launches, and the device ms of each MoE stage (router,
    sort/dispatch, expert GEMMs and their elementwise work, the experts'
    bf16 casts, combine; through record_function ranges around moe's
    functions), of every cast or copy kernel, and of B1's kernels. Returns
    {"tick": {...}, "prefill": {...}}."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(label, fn):
        def run(*a, **k):
            with record_function(f"moe {label}"):
                return fn(*a, **k)
        return run

    def split(prof, wall, n):
        rows = [e for e in device_rows(prof) if not e.key.startswith("moe ")]
        busy = sum(dev_us(e) for e in rows) / 1e3 / n
        stages = dict.fromkeys(["router", "sort/dispatch", "experts", "casts", "combine"], 0.0)
        for e in prof.events():        # host-side ranges: the kernels their ops launch
            if e.name.startswith("moe ") and str(e.device_type).endswith("CPU"):
                stages[e.name[4:]] += e.device_time_total / 1e3 / n
        stages["experts"] -= stages["casts"]          # the cast ranges nest in the experts'
        copies = sum(dev_us(e) for e in rows if "copy" in e.key.lower()) / 1e3 / n
        b1 = sum(dev_us(e) for e in rows
                 if any(k in e.key for k in pc.FWD_KERNELS)) / 1e3 / n
        return {"ms": wall * 1e3 / n, "busy_ms": busy,
                "kernels": sum(e.count for e in rows) / n, "stages_ms": stages,
                "all_copies_ms": copies, "b1_ms": b1,
                "top": [(dev_us(e) / 1e3 / n, e.count // n, e.key[:80])
                        for e in sorted(rows, key=dev_us, reverse=True)[:6]]}

    patches = [mock.patch.object(moe, fn, ranged(label, getattr(moe, fn)))
               for label, fn in MOE_RANGES]
    eng = rec_engine(model, 256 + ticks + 8)
    rng = np.random.default_rng(5)
    for sp in (SamplingParams(), SamplingParams(seed=3, **ENGINE_SAMPLED)):
        eng.submit(rng.integers(0, model.cfg.vocab_size, size=256), ticks + 8, sampling=sp)
    while eng.n_active < REC_SLOTS or eng.scheduler.active:
        eng.step()
    eng.step()                                   # the pipeline holds a tick
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (1, DENSE_BUDGET))).cuda()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for p in patches:
        p.start()
    try:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            _, wall = timed(lambda: [eng.step() for _ in range(ticks)])
        tick = split(prof, wall, ticks)
        with torch.inference_mode():
            model.state.prefill(tokens, max_len=DENSE_BUDGET + 8)     # warm
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                _, wall = timed(lambda: model.state.prefill(tokens, max_len=DENSE_BUDGET + 8))
        pre = split(prof, wall, 1)
    finally:
        for p in patches:
            p.stop()
    eng.run()
    del eng
    gc.collect()
    return {"tick": tick, "prefill": pre}


def log_profile(label, prof):
    log(f"  {label}: {prof['ms']:.2f} ms (profiler on), device busy {prof['busy_ms']:.2f} ms "
        f"= {prof['busy_ms'] / prof['ms']:.1%}, {prof['kernels']:.0f} kernel launches; device "
        f"ms: " + ", ".join(f"{k} {v:.3f}" for k, v in prof["stages_ms"].items())
        + f", B1 {prof['b1_ms']:.3f}; all cast and copy kernels {prof['all_copies_ms']:.3f}; "
        f"the top kernels:")
    for ms, n, key in prof["top"]:
        log(f"    {ms:9.3f} ms  x{n:<5d} {key}")


def phase_moe_serve(arch, card):
    """One MoE model at its published width, bf16, seeded weights drawn on
    the card, at the most whole cycles that fit (moe_depth: dbrx 5 of 40
    layers, capped at MOE_SERVE_LAYERS; maverick its first (GLU, MoE)
    cycle), served through
    ServeEngine at the published capacity factor 1.25: 4 requests on 2
    slots (prompts 4096 / 1024 / 3072 / 2048, 16 new tokens, 0 and 1
    greedy, 2 and 3 sampled), prefill budget 2048, overlap on. Gates: B1
    once a layer a prefill block (inside each 2048-token chunk, one model
    call: capacity couples the tokens of a call) and nothing else, no plain
    version; outputs in range and finite; a second run (the drop shares of
    the first MoE layer recorded) gives the same tokens and
    log-probabilities bit for bit; a profile (profile_moe). Then the
    served logic in f32 at 2 layers and capacity factor 8.0 (nothing
    drops, which the run checks; at 1.25 the served chunks and a
    train-mode forward route differently by design) against a train-mode
    forward of the same tokens: the engine's log-probabilities within
    REC_LP_TOL, and request 0's whole logit rows through DecodeState
    (rec_rows) within F32_TOL of max|logit| and REC_LP_TOL. Returns a
    row."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    depth = moe_depth(full, 4, MOE_SERVE_RESERVE_GIB)
    depth = max(min(depth, MOE_SERVE_LAYERS), cycle_split(full)[1])
    cfg = full.replace(n_layers=depth)
    cycle, g, rest = cycle_split(full)
    torch.cuda.reset_peak_memory_stats()
    model, t_build = timed(lambda: rec_model(cfg))
    weights = sum(p.numel() for p in model.lm.parameters())
    log(f"phase 11: {arch} serving, bf16, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim} ({cfg.n_kv_heads} kv), {cfg.n_experts} experts of d_ff "
        f"{cfg.d_ff}, top-{cfg.moe_top_k}, MoE every {cfg.moe_period} layer(s), capacity "
        f"factor {cfg.capacity_factor}, vocab {cfg.vocab_size}; {depth} of {full.n_layers} "
        f"layers (whole cycles of {g}: {4 * cycle / 2**30:.2f} GiB f32 a cycle, "
        f"{4 * rest / 2**30:.2f} GiB embedding, {MOE_SERVE_RESERVE_GIB} GiB reserve, in "
        f"{DENSE_SHARE:.0%} of {card_gib():.1f} GiB, one cycle at least); {weights / 1e9:.3f}B "
        f"parameters, {4 * weights / 2**30:.1f} GiB f32 weights drawn on the card (seed 0) in "
        f"{t_build:.1f} s; {card}")
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in DENSE_LENS]
    samp = rec_samp()
    max_len = max(DENSE_LENS) + DENSE_GEN
    warm = rec_engine(model, max_len)             # allocator, cuBLAS
    warm.submit(prompts[1][:512], 2)
    warm.run()
    del warm
    gc.collect()
    eng = rec_engine(model, max_len)
    outs, wall, launched, plain = rec_serve_run(eng, prompts, samp)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = eng.stats()
    del eng
    ttft = np.array([o.ttft_s for o in outs.values()]) * 1e3
    gen = sum(len(o.tokens) for o in outs.values())
    tick_ms = st["decode_s"] * 1e3 / st["decode_steps"]
    blocks = sum(-(-len(p) // cfg.lt_block_size) for p in prompts)
    expected = {k: depth * blocks if k == "polysketch_causal" else 0 for k in KERNELS}
    log(f"  run: {wall * 1e3:.1f} ms for {gen} generated tokens = {gen / wall:.1f} generated "
        f"tok/s (prompts {sum(map(len, prompts))} tokens); TTFT p50 "
        f"{np.percentile(ttft, 50):.1f} ms, p99 {np.percentile(ttft, 99):.1f} ms; "
        f"{st['decode_steps']} decode ticks, {tick_ms:.2f} ms a tick; "
        f"{st['scheduler']['chunks']} prefill chunks; peak device memory {peak:.2f} GiB")
    log(f"  launches in the run: {launched} (expected {expected}: one B1 a layer per "
        f"{cfg.lt_block_size}-token block of each prompt); plain-version calls: {plain}")
    if launched != expected or plain:
        raise AssertionError(f"{arch}: the engine did not launch B1 once a layer per prefill "
                             "block and nothing else, or called a plain version")
    for i, o in outs.items():
        if len(o.tokens) != DENSE_GEN or o.tokens.min() < 0 \
                or o.tokens.max() >= cfg.vocab_size or not np.isfinite(o.logprobs).all():
            raise AssertionError(f"{arch} request {i}: bad output {o.tokens}, {o.logprobs}")
    calls = []
    hook = record_drops(model.lm, calls)
    try:
        again, _, launched2, plain2 = rec_serve_run(rec_engine(model, max_len), prompts, samp)
    finally:
        hook.remove()
    shares = drop_shares(calls)
    same = all(np.array_equal(outs[i].tokens, again[i].tokens)
               and np.array_equal(outs[i].logprobs, again[i].logprobs) for i in outs)
    log(f"  a second run: tokens and log-probabilities equal the first's bit for bit: {same}; "
        f"launches {launched2 == expected}, plain calls {plain2}")
    log(f"  the first MoE layer's prefill calls (tokens, share of routed assignments dropped "
        f"at capacity factor {cfg.capacity_factor}): "
        + ", ".join(f"({n}, {sh:.4f})" for n, sh in shares))
    if not same or launched2 != expected or plain2:
        raise AssertionError(f"{arch}: the served run does not repeat bit for bit")
    for i in (0, 2):
        log(f"  req{i}: {' '.join(map(str, outs[i].tokens.tolist()))}")
    prof = profile_moe(model)
    log_profile("profile of 4 decode ticks (2 slots decoding, one sampled), a tick",
                prof["tick"])
    log_profile(f"profile of one {DENSE_BUDGET}-token prefill call", prof["prefill"])
    del model, outs, again
    gc.collect()
    torch.cuda.empty_cache()

    # the served logic in f32 at capacity factor 8.0 (nothing drops): at the
    # published 1.25 a train-mode forward and the served chunks route their
    # tokens differently by design (capacity couples the tokens of a call)
    c32 = full.replace(n_layers=2, compute_dtype="float32", capacity_factor=MOE_NO_DROP)
    m32 = rec_model(c32)
    calls = []
    hook = record_drops(m32.lm, calls)
    try:
        outs32, _, launched32, plain32 = rec_serve_run(rec_engine(m32, max_len), prompts, samp)
        worst32 = max(float(np.abs(o.logprobs - train_logprobs(m32, prompts[i], o.tokens)).max())
                      for i, o in outs32.items())
        # request 0's whole logit rows through DecodeState (the prefill's
        # every row, then teacher-forced decode steps): the emitted tokens'
        # log-probabilities lie near 0 with random weights, a prompt
        # token's do not
        seq = torch.from_numpy(np.concatenate([prompts[0], outs32[0].tokens])
                               .astype(np.int64)).cuda()
        want = train_rows(m32, seq)
        rows32 = rec_rows(m32, seq, len(prompts[0]), want)
    finally:
        hook.remove()
    shares32 = drop_shares(calls)
    log(f"  f32, 2 layers, capacity factor {MOE_NO_DROP}: calls of the first MoE layer (tokens, "
        f"share dropped): " + ", ".join(f"({n}, {sh:.4f})" for n, sh in shares32)
        + f"; launches {launched32}, plain calls {plain32}")
    if any(sh for _, sh in shares32):
        raise AssertionError(f"{arch}: tokens dropped at capacity factor {MOE_NO_DROP}")
    check(f"{arch}: engine logprobs vs train-mode forward, f32, 2 layers, cf {MOE_NO_DROP} "
          f"(nats)", worst32, REC_LP_TOL)
    check(f"{arch}: served logit rows vs train-mode, f32, cf {MOE_NO_DROP} (rel. to max)",
          rows32[0], F32_TOL)
    check(f"{arch}: served rows' next-token logprobs vs train-mode, f32, cf {MOE_NO_DROP} "
          f"(nats)", rows32[1], REC_LP_TOL)
    del m32, outs32, want
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 11 {arch} serving: {time.perf_counter() - t_phase:.1f} s")
    return {"arch": arch, "layers": depth, "published_layers": full.n_layers,
            "params_b": weights / 1e9, "tick_ms": tick_ms,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)), "gen_tok_s": gen / wall,
            "peak_gib": peak, "b1_launches": launched["polysketch_causal"],
            "prefill_chunks": st["scheduler"]["chunks"], "drop_shares": shares,
            "logprob_err_f32_cf8": worst32, "rows_f32_cf8": rows32, "profile": prof,
            "card": card}


def phase_moe_train(card, arch="dbrx-132b"):
    """dbrx trained at its published width, bf16, remat "full" as
    published, at the depth that fits at 16 B a parameter (moe_depth: 1 of
    40 layers), 1 x 4096 Markov tokens a step (1 x 2048 if 4096 does not
    fit, logged), seeded weights drawn on the card: a warm-up and
    MOE_TRAIN_STEPS timed steps (step ms, tokens/s, peak GiB), the loss and
    both aux metrics finite, B1 twice a layer a step (the recomputed
    forward) and its backward once, no plain version. Returns a row."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    depth = moe_depth(full, 16, MOE_TRAIN_RESERVE_GIB)
    cfg = full.replace(n_layers=depth)
    cycle, g, rest = cycle_split(full)
    log(f"phase 11: {arch} training, bf16, remat {cfg.remat!r}, {depth} of {full.n_layers} "
        f"layers (reckoned at 16 B a parameter: {16 * cycle / 2**30:.2f} GiB a layer, "
        f"{16 * rest / 2**30:.2f} GiB embedding, {MOE_TRAIN_RESERVE_GIB} GiB reserve, in "
        f"{DENSE_SHARE:.0%} of {card_gib():.1f} GiB); {card}")
    tcfg = TrainConfig(seq_len=MOE_TRAIN_SEQ, global_batch=1, steps=100, peak_lr=3e-3)
    for seq in (MOE_TRAIN_SEQ, MOE_TRAIN_SEQ // 2):
        it = DataIterator(make_markov_lm(cfg.vocab_size, seed=1), 1, seq, seed=0,
                          device="cuda")
        batches = [next(it) for _ in range(MOE_TRAIN_STEPS + 1)]
        lm = rec_model(cfg, trainable=True).lm
        torch.cuda.reset_peak_memory_stats()
        state, step = init_train_state(lm), make_train_step(cfg, tcfg)
        try:
            state, _ = step(state, batches[0])            # warm-up
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if seq < MOE_TRAIN_SEQ:
                raise
            log(f"  1 x {seq} tokens a step does not fit (out of memory in the warm-up step): "
                f"training at 1 x {seq // 2}")
            del state, step, lm
            gc.collect()
            torch.cuda.empty_cache()
    zero_counts()
    times, losses, auxes = [], [], []
    with PlainCalls() as plain:
        for batch in batches[1:]:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
            auxes.append((float(metrics["aux_load_balance"]), float(metrics["aux_router_z"])))
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(times)
    expected = {k: 0 for k in KERNELS}
    expected["polysketch_causal"] = (1 if cfg.remat == "none" else 2) * depth * n
    expected["polysketch_causal_backward"] = depth * n
    step_ms = float(np.median(times)) * 1e3
    log(f"  1 x {seq} tokens a step: losses {[round(x, 4) for x in losses]}; aux (load "
        f"balance, router z) {[(round(a, 4), round(b, 3)) for a, b in auxes]}; step time "
        f"median {step_ms:.1f} ms {[round(t * 1e3, 1) for t in times]}; "
        f"{seq / np.median(times):.0f} tokens/s; peak device memory {peak:.2f} GiB")
    log(f"  launches over the {n} steps: {launched} (expected {expected}); plain-version "
        f"calls: {plain.calls}")
    if not (all(np.isfinite(losses)) and np.isfinite(auxes).all()):
        raise AssertionError(f"{arch} training: a non-finite loss or aux metric")
    if launched != expected or plain.calls:
        raise AssertionError(f"{arch} training: not B1 twice and its backward once a layer a "
                             "step, or a plain version called")
    del state, step, lm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 11 training: {time.perf_counter() - t_phase:.1f} s")
    return {"arch": arch, "layers": depth, "published_layers": full.n_layers, "seq": seq,
            "step_ms": step_ms, "tokens_s": seq / float(np.median(times)), "peak_gib": peak,
            "losses": losses, "aux": auxes,
            "launches": {k: launched[k] for k in ("polysketch_causal",
                                                  "polysketch_causal_backward")},
            "card": card}


def phase_moe_b1_timing():
    """B1's forward at dbrx's attention shape in bf16 (bh 48, n 2048, r 32,
    h 128, b 256): the kernel against its plain version (5e-2 of max|out|),
    its time beside the plain version's and its bound. Returns (ms, plain
    ms, bound, max|err|)."""
    before = counts()
    rnd = seeded(65)
    bh, n, r, h, b = 48, 2048, 32, 128, 256
    dt = torch.bfloat16
    flat = [rnd(bh, n, r, scale=0.5, dtype=dt), rnd(bh, n, r, scale=0.5, dtype=dt)]
    flat += [rnd(bh, n, h, dtype=dt) for _ in range(3)]
    kw = dict(degree=4, scale=1.0 / h, block_size=b)
    got = pc.polysketch_causal_cuda(*flat, **kw)
    want = pc.polysketch_causal_torch(*flat, **kw)
    e = err(got, want)
    check("B1 bf16 at dbrx's shape (bh 48, n 2048, h 128, b 256) vs plain (rel.)",
          e / want.float().abs().max().item(), BF16_TOL)
    run = lambda: pc.polysketch_causal_cuda(*flat, **kw)  # noqa: E731
    ms = min(event_ms(run), event_ms(run))
    plain_ms = event_ms(lambda: pc.polysketch_causal_torch(*flat, **kw), iters=5, warmup=1)
    bd = b1_bound(bh, n, r, h, b, 4, itemsize=2)
    log(f"  B1 forward bf16 at dbrx's shape: kernel {ms:.3f} ms, plain PyTorch {plain_ms:.3f} "
        f"ms; bound {bd.tc_ms:.3f} ms by {bd.tc_by}, {bd.tc_ms / ms:.1%} of it; library call: "
        f"{NO_LIBRARY}")
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    del flat, got, want
    torch.cuda.empty_cache()
    return ms, plain_ms, bd, e


def phase_moe(card):
    """Phase 11: the dispatch gate, both models served, SMOKE on the card
    against the CPU, dbrx trained, B1 timed at dbrx's shape. Returns its
    rows."""
    t0 = time.perf_counter()
    rows = {"dispatch": {f"{k[0]} g{k[1]}": v for k, v in phase_moe_dispatch().items()}}
    rows["serve"] = [phase_moe_serve(arch, card) for arch in MOE_ARCHS]
    log("phase 11: SMOKE greedy tokens on the card against the CPU")
    phase_rec_cross_device(MOE_ARCHS)
    rows["train"] = phase_moe_train(card)
    rows["b1"] = phase_moe_b1_timing()
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"moe": {k: v for k, v in rows.items() if k != "b1"}}, default=float))
    return rows


# ---------------------------------------------------------------------------
# phase 12: the VLM (llava-next-mistral-7b: image embeddings over its first
# 576 positions) and the encoder-decoder (whisper-large-v3: a softmax
# encoder over 1500 frames, a polysketch decoder with cross-attention over
# them) served and trained at their published widths
# ---------------------------------------------------------------------------

VLM_ARCH, AUDIO_ARCH = "llava-next-mistral-7b", "whisper-large-v3"
# llava: 4 requests of 576 image rows and 1472 text tokens (2048), 16 new
VLM_BATCH, VLM_PROMPT, VLM_GEN = 4, 2048, 16
VLM_TRAIN_SEQ = 4096           # 1 x 4096 tokens a step, 576 of them image rows
# whisper: 4 requests of 1500 frames and a 228-token prompt (the previous
# text plus the start-of-transcript tokens), 32 new: the decode crosses
# position 255, where the decoder's polysketch state folds its first block
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_GEN = 4, 228, 32
AUDIO_TRAIN = (4, 448)         # rows x tokens a step, each row over 1500 frames
XM_TRAIN_STEPS = 3
# llava's training depth, cut to make room for phase 13 (before it llava
# trained at train_depth's 14 of 32 layers: 35.0 s of the phase against
# 19.3 s at 7, NVIDIA H100 80GB HBM3, 700 W) and to 4 for phase 16 (13.0 s
# at 7)
VLM_TRAIN_LAYERS = 4
# Whisper's training depth (encoder and decoder), cut to make room for
# phase 14 (full depth, 32 + 32: 54.8 s of the phase against 23.2 s at 16
# + 16, NVIDIA H100 80GB HBM3, 700 W) and to 8 + 8 for phase 16 (20.0 s at
# 16 + 16)
AUDIO_TRAIN_LAYERS = 8
# phase 12's serving depth (llava's layers; Whisper's encoder and decoder
# layers each), cut to make room for phase 15 (full depth, 32 and 32 + 32:
# llava 22.9 s, Whisper 29.7 s of the phase, NVIDIA H100 80GB HBM3, 700 W)
# and to 12 for phase 16 (llava 9.7 s, Whisper 14.4 s at 16)
XM_SERVE_LAYERS = 12
# Whisper's bf16 serving gate. Phase 7's (served log-probabilities within
# DENSE_LP_TOL of a blocked plain bf16 forward) does not hold for it
# (4.674e-2 nats; ROADMAP.md §C): its greedy tokens keep log-probabilities
# well below 0 (llava's, like the dense models', repeat a token at ~0
# nats), and its bf16 logits are spaced 2^-5 at its max|logit| of 5.59, so
# one rounding flip carried through 32 decoder layers moves a
# log-probability by a few hundredths; and an earlier float8 control, the
# decoder's sketched state rounded to float8_e5m2, read 4.692e-2, because
# the state folds once, at position 256, and only the last 4 of the 32
# steps read it. Nor does any distance from the f32 twin of the same
# weights separate a sound run from a degraded one (NVIDIA H100 80GB
# HBM3, 700 W; max / mean nats over the 4 x 32 served tokens): the bf16
# train-mode forward 3.235e-2 / 1.350e-2, served 4.044e-2 / 1.180e-2, served
# with the decoder's self-attention state rounded to float8_e5m2 3.751e-2 /
# 1.221e-2, with the cross-attention memory so rounded 4.393e-2 / 1.334e-2,
# with both 4.480e-2 / 1.398e-2: at random weights the served
# log-probabilities hardly depend on what the decode steps read, and bf16
# rounding flips dominate them. So Whisper's bf16 serving has no gate
# (ROADMAP.md §C, known limits): the phase logs these distances, with the
# "both" control, and holds Whisper's logic in f32 (ENGINE_LP_TOL) and its
# kernels by the train-mode logits gate (DENSE_LOGIT_TOL).


def cache_to_float8(cache, parts=("self", "cross")):
    """Phase 12's control: each decoder layer's self-attention state
    (block k, v and sketched keys, the folded state) and cross-attention
    k and v (the memory each decode step reads), those of `parts`,
    rounded to float8_e5m2."""
    def r(x):
        return x.to(torch.float8_e5m2).to(x.dtype)
    out = []
    for c in cache:
        node = dict(c)
        if "self" in parts:
            st = c["self"]
            node["self"] = st._replace(z=r(st.z), kbuf=r(st.kbuf), vbuf=r(st.vbuf),
                                       mbuf=r(st.mbuf))
        if "cross" in parts:
            node["cross"] = c["cross"]._replace(k=r(c["cross"].k), v=r(c["cross"].v))
        out.append(node)
    return out


def xm_inputs(cfg, rows, n_tokens, seed):
    """A batch dict on the card: seeded tokens (rows, n_tokens) and the
    model's other input, N(0, 1) in f32 (the model casts it): a VLM's
    image_embeds (rows, n_image_tokens, D), Whisper's frames (rows,
    encoder_len, D)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, n_tokens))).cuda()}
    rnd = seeded(seed + 1)
    if cfg.family == "vlm":
        batch["image_embeds"] = rnd(rows, cfg.n_image_tokens, cfg.d_model)
    else:
        batch["frames"] = rnd(rows, cfg.encoder_len, cfg.d_model)
    return batch


def xm_serve(model, batch, gen, force=None, degrade=None):
    """Greedy serving through the batch-dict make_serve_fns: the prefill,
    then gen - 1 decode steps at positions shared by the batch (each fed
    the argmax, or the tokens of `force` (B, gen) when given; `degrade`,
    when given, maps the prefill's cache to the one the steps read).
    Returns (tokens (B, gen), each one's served log-probability (B, gen),
    both numpy; the prefill's seconds, seconds a decode step)."""
    prefill, decode = make_serve_fns(model)
    s0 = batch["tokens"].shape[1]
    if force is not None:
        force = torch.from_numpy(force.astype(np.int64)).cuda()
    toks, lps = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = prefill(batch)
    if degrade is not None:
        cache = degrade(cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(gen):
        lp = torch.log_softmax(last.float(), -1)
        tok = lp.argmax(-1) if force is None else force[:, i]
        toks.append(tok)
        lps.append(lp.gather(1, tok[:, None])[:, 0])
        if i + 1 < gen:
            last, cache = decode(tok[:, None], cache, s0 + i)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.stack(toks, 1).cpu().numpy(), torch.stack(lps, 1).cpu().numpy(),
            t1 - t0, (t2 - t1) / max(gen - 1, 1))


def xm_train_logprobs(model, batch, toks):
    """A train-mode forward over each request's prompt and its emitted
    tokens but the last, with the batch's image embeddings or frames:
    (the log-probability of each emitted token (B, gen) numpy, the logits)."""
    s0 = batch["tokens"].shape[1]
    t = torch.from_numpy(toks.astype(np.int64)).cuda()
    seq = torch.cat([batch["tokens"], t[:, :-1]], 1)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    with torch.inference_mode():
        logits, _ = model.lm(seq, mode="train", **extra)
        lp = torch.log_softmax(logits[:, s0 - 1:].float(), -1).gather(2, t[..., None])[..., 0]
    return lp.cpu().numpy(), logits


def phase_xm_serve(arch, card):
    """llava-next-mistral-7b or whisper-large-v3 at its published width,
    XM_SERVE_LAYERS deep (Whisper's encoder and decoder each), bf16,
    seeded weights drawn on the card, served greedily through
    the batch-dict make_serve_fns: llava 4 x (576 image rows + 1472 text
    tokens) and 16 new tokens, Whisper 4 x (1500 frames, a 228-token
    prompt) and 32 new. Gates: B1 once a layer per prefill block and
    nothing else (no plain version); outputs in range and finite; in bf16
    the train-mode logits through B1 within DENSE_LOGIT_TOL of max|logit|
    of a blocked plain forward (phase 7's gate), and the served
    log-probabilities within DENSE_LP_TOL of the blocked plain forward
    (llava; phase 7's gate; Whisper's distances, which no gate holds, are
    logged: the note above cache_to_float8); in f32 (the same weights) the
    served log-probabilities within ENGINE_LP_TOL of a train-mode forward
    (the image rows or frames included); llava's logits change with
    image_embeds + 1; ServeEngine and generate refuse Whisper. Returns a
    row."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    vlm = full.family == "vlm"
    cfg = (full.replace(n_layers=XM_SERVE_LAYERS) if vlm else
           full.replace(n_layers=XM_SERVE_LAYERS, encoder_layers=XM_SERVE_LAYERS))
    rows, n, gen = (VLM_BATCH, VLM_PROMPT, VLM_GEN) if vlm else \
        (AUDIO_BATCH, AUDIO_PROMPT, AUDIO_GEN)
    gc.collect()
    torch.cuda.empty_cache()
    model, t_build = timed(lambda: build_model(cfg, device="cuda", seed=0,
                                               draw_on_device=True))
    weights = sum(p.numel() for p in model.lm.parameters())
    what = (f"{rows} x ({cfg.n_image_tokens} image rows + {n - cfg.n_image_tokens} text "
            f"tokens)" if vlm else f"{rows} x ({cfg.encoder_len} frames, a {n}-token prompt)")
    depth = (f"{cfg.n_layers} of {full.n_layers} layers" if vlm
             else f"{cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers of "
                  f"{full.encoder_layers} + {full.n_layers}")
    log(f"phase 12: {arch} serving, bf16, published width, depth cut to XM_SERVE_LAYERS "
        f"({depth}), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim} ({cfg.n_kv_heads} kv), "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {weights / 1e9:.3f}B parameters, "
        f"{4 * weights / 2**30:.2f} GiB f32 weights drawn on the card (seed 0) in "
        f"{t_build:.1f} s; make_serve_fns, {what}, {gen} new tokens, greedy; {card}")
    batch = xm_inputs(cfg, rows, n, seed=31)
    xm_serve(model, xm_inputs(cfg, 1, cfg.n_image_tokens + 8, seed=32), 2)  # allocator, cuBLAS
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with PlainCalls() as plain:
        toks, lps, pre_s, step_s = xm_serve(model, batch, gen)
    run_counts = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    blocks = -(-n // cfg.lt_block_size)
    expected = {k: cfg.n_layers * blocks if k == "polysketch_causal" else 0 for k in KERNELS}
    tok_s = rows * gen / (pre_s + step_s * (gen - 1))
    log(f"  prefill (TTFT) {pre_s * 1e3:.1f} ms; {step_s * 1e3:.2f} ms a decode step; "
        f"{tok_s:.1f} generated tok/s; peak device memory {peak:.2f} GiB")
    log(f"  launches in the run: {run_counts} (expected {expected}: one B1 a layer per "
        f"{cfg.lt_block_size}-token block of the prompt); plain-version calls: {plain.calls}")
    if run_counts != expected or plain.calls:
        raise AssertionError(f"{arch}: the serving run did not launch B1 once a layer per "
                             "prefill block and nothing else, or called a plain version")
    if toks.min() < 0 or toks.max() >= cfg.vocab_size or not np.isfinite(lps).all():
        raise AssertionError(f"{arch}: bad output {toks}, {lps}")
    enc_ms = None
    if not vlm:
        with torch.inference_mode():
            _, enc_s = timed(lambda: model.lm.encode(batch["frames"]))
        enc_ms = enc_s * 1e3
        log(f"  the encoder alone over {rows} x {cfg.encoder_len} frames: {enc_ms:.1f} ms "
            f"(inside the prefill's {pre_s * 1e3:.1f} ms)")
    got_lp, got = xm_train_logprobs(model, batch, toks)
    with plain_ops():
        want_lp, want = xm_train_logprobs(model, batch, toks)
    lp_err = float(np.abs(lps - want_lp).max())
    top = want.float().abs().max().item()
    logit_err = err(got, want) / top
    log(f"  bf16: served log-probabilities vs the train-mode forward through B1 "
        f"{float(np.abs(lps - got_lp).max()):.3e} nats, vs a blocked plain one {lp_err:.3e}")
    check(f"{arch}: train-mode logits, B1 vs blocked plain, bf16 (rel. to max)", logit_err,
          DENSE_LOGIT_TOL)
    del got, want
    plain_err, vs_f32 = None, None
    if vlm:
        check(f"{arch}: served logprobs (B1) vs a blocked plain bf16 forward (nats)", lp_err,
              DENSE_LP_TOL)
    else:
        step = 2.0 ** (np.floor(np.log2(top)) - 7)
        log(f"  phase 7's bf16 gate, served vs a blocked plain forward, is not Whisper's "
            f"({lp_err:.3e} nats against {DENSE_LP_TOL:.0e}; a bf16 step of the logits at "
            f"max|logit| {top:.2f} is {step:.4f})")
        with plain_ops():
            _, plain_lps, _, _ = xm_serve(model, batch, gen, force=toks)
        plain_err = float(np.abs(lps - plain_lps).max())
        log(f"  the same serving path with B1's plain version, fed these tokens: "
            f"{plain_err:.3e} nats from B1's")
        f32 = twin(model, "float32")                  # the same weights, f32 compute
        want32, _ = xm_train_logprobs(f32, batch, toks)
        del f32
        dists = {"train-mode bf16": got_lp, "served": lps,
                 "control: state and memory in float8": xm_serve(
                     model, batch, gen, force=toks, degrade=cache_to_float8)[1]}
        dists = {k: (float(np.abs(v - want32).max()), float(np.abs(v - want32).mean()))
                 for k, v in dists.items()}
        log("  against the f32 train-mode forward at these tokens (nats, max / mean over "
            f"{rows} x {gen} tokens; max in bf16 steps of the logits): " + "; ".join(
                f"{k} {mx:.3e} / {mn:.3e} ({mx / step:.2f})" for k, (mx, mn) in dists.items())
            + " (no bf16 gate: a known limit, ROADMAP.md §C)")
        vs_f32 = {"mean_nats": {k: mn for k, (_, mn) in dists.items()},
                    "max_nats": {k: mx for k, (mx, _) in dists.items()}}
    if vlm:
        other = dict(batch, image_embeds=batch["image_embeds"] + 1.0)
        with torch.inference_mode():
            a = model.lm(batch["tokens"][:1], mode="train",
                         image_embeds=batch["image_embeds"][:1])[0]
            b = model.lm(other["tokens"][:1], mode="train",
                         image_embeds=other["image_embeds"][:1])[0]
        moved = err(a, b)
        log(f"  image_embeds + 1 moves request 0's logits by max|diff| {moved:.3e}")
        if not moved > 1e-4:
            raise AssertionError(f"{arch}: the image embeddings do not reach the logits")
        del a, b, other
    else:
        for label, call in (("ServeEngine", lambda: ServeEngine(model, slots=1, max_len=64)),
                            ("generate", lambda: generate(model, np.zeros((1, 4), np.int64),
                                                          2))):
            try:
                call()
            except NotImplementedError as e:
                log(f"  {label} refuses it: {e}")
            else:
                raise AssertionError(f"{arch}: {label} did not refuse a model without a "
                                     "DecodeState")
    f32 = twin(model, "float32")                  # the same weights, f32 compute
    train32, _ = xm_train_logprobs(f32, batch, toks)
    log(f"  train-mode forwards at the bf16 run's tokens, bf16 vs f32: "
        f"{float(np.abs(got_lp - train32).max()):.3e} nats")
    toks32, lps32, pre32, step32 = xm_serve(f32, batch, gen)
    want32, _ = xm_train_logprobs(f32, batch, toks32)
    lp_err32 = float(np.abs(lps32 - want32).max())
    log(f"  f32 (the same weights): prefill {pre32 * 1e3:.1f} ms, {step32 * 1e3:.2f} ms a "
        f"decode step; greedy tokens equal bf16's: {np.array_equal(toks, toks32)}")
    check(f"{arch}: served logprobs vs train-mode forward, f32 (nats)", lp_err32,
          ENGINE_LP_TOL)
    log(f"  req0: {' '.join(map(str, toks[0].tolist()))}")
    del f32, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 12 {arch} serving: {time.perf_counter() - t_phase:.1f} s")
    return {"arch": arch, "params_b": round(weights / 1e9, 3), "requests": rows,
            "prompt": n, "gen": gen, "prefill_ms": pre_s * 1e3, "encoder_ms": enc_ms,
            "decode_step_ms": step_s * 1e3, "gen_tok_s": tok_s, "peak_gib": peak,
            "logprob_err_bf16": lp_err, "logit_rel_err_bf16": logit_err,
            "logprob_err_bf16_plain_serving": plain_err, "bf16_vs_f32": vs_f32,
            "logprob_err_f32": lp_err32, "b1_launches": run_counts["polysketch_causal"]}


def xm_train_batches(cfg, count):
    """`count` training batches on the card: Markov tokens (llava 1 x 4097,
    Whisper 4 x 449) and seeded image embeddings or frames."""
    rows, seq = (1, VLM_TRAIN_SEQ) if cfg.family == "vlm" else AUDIO_TRAIN
    it = DataIterator(make_markov_lm(cfg.vocab_size, seed=1), rows, seq, seed=0,
                      device="cuda")
    out = []
    for i in range(count):
        extra = xm_inputs(cfg, rows, 1, seed=40 + i)
        del extra["tokens"]
        out.append(dict(next(it), **extra))
    return out


def phase_xm_train(arch, card):
    """llava-next-mistral-7b (1 x 4096 tokens, 576 image rows, remat "full",
    at the depth that trains, train_depth, at most VLM_TRAIN_LAYERS) or
    whisper-large-v3 (4 x 448
    tokens over 1500 frames, 8 encoder + 8 decoder layers
    (AUDIO_TRAIN_LAYERS), remat "dots", which is full
    rematerialisation as in the reference) trained at its published width,
    seeded weights drawn on the card: (1) one step's f32 gradients (the
    same weights under f32 compute) through B1 and its backward against
    the plain path's, each leaf within F32_TOL of its max; (2) bf16, a
    warm-up and XM_TRAIN_STEPS timed steps (step ms, tokens/s, peak GiB),
    B1 twice and its backward once a decoder layer a step, no plain
    version; (3) two runs of 2 steps from the seed equal bit for bit
    (deterministic algorithms on). Returns a row."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    vlm = full.family == "vlm"
    depth = min(train_depth(full), VLM_TRAIN_LAYERS) if vlm else AUDIO_TRAIN_LAYERS
    cfg = (full.replace(n_layers=depth) if vlm else
           full.replace(n_layers=depth, encoder_layers=AUDIO_TRAIN_LAYERS))
    rows, seq = (1, VLM_TRAIN_SEQ) if vlm else AUDIO_TRAIN
    log(f"phase 12: {arch} training, bf16, remat {cfg.remat!r}, {rows} x {seq} tokens a step "
        + (f"({cfg.n_image_tokens} image rows), " if vlm
           else f"over {cfg.encoder_len} frames, ")
        + (f"{depth} of {full.n_layers} layers (train_depth, at most VLM_TRAIN_LAYERS)" if vlm
           else f"{cfg.encoder_layers} encoder + {depth} decoder layers of "
                f"{full.encoder_layers} + {full.n_layers} (AUDIO_TRAIN_LAYERS)")
        + f"; {card}")
    batches = xm_train_batches(cfg, XM_TRAIN_STEPS + 1)
    tcfg = TrainConfig(seq_len=seq, global_batch=rows, steps=100, peak_lr=3e-3)

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        return build_model(cfg, device="cuda", seed=0, trainable=True, draw_on_device=True)

    model = fresh()
    f32 = twin(model, "float32").lm               # the same weights, f32 compute
    frozen = {n for n, p in model.lm.named_parameters() if not p.requires_grad}
    for name, p in f32.named_parameters():
        p.requires_grad_(name not in frozen)
    loss_fn = make_loss_fn(f32.cfg)

    def backward():
        for p in f32.parameters():
            p.grad = None
        loss, _ = loss_fn(f32, batches[0])
        loss.backward()

    backward()
    got = {n: p.grad.clone() for n, p in f32.named_parameters() if p.grad is not None}
    with plain_ops():
        backward()
    torch.cuda.synchronize()
    want = {n: p.grad for n, p in f32.named_parameters() if p.grad is not None}
    errs = leaf_errors(got, want)
    log(f"  one step's f32 gradients, kernels vs plain ({len(errs)} leaves, rel. to each "
        f"leaf's max|.|): worst {errs[-1][0]:.3e} ({errs[-1][1]}), median "
        f"{float(np.median([e for e, _ in errs])):.3e}")
    check(f"{arch} f32 gradients kernels vs plain, worst leaf", errs[-1][0], F32_TOL)
    del got, want, f32
    for p in model.lm.parameters():
        p.grad = None

    lm = model.lm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step = init_train_state(lm), make_train_step(cfg, tcfg)
    state, _ = step(state, batches[0])            # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times, losses = [], []
    with PlainCalls() as plain:
        for batch in batches[1:]:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
    run_counts = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(times)
    expected = {k: 0 for k in KERNELS}
    # remat runs each decoder layer's forward again in the backward
    expected["polysketch_causal"] = (1 if cfg.remat == "none" else 2) * depth * n
    expected["polysketch_causal_backward"] = depth * n
    step_ms = float(np.median(times)) * 1e3
    tokens = rows * seq
    log(f"  losses {[round(x, 4) for x in losses]}; step time median {step_ms:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times]}; {tokens / np.median(times):.0f} tokens/s; peak "
        f"device memory {peak:.2f} GiB")
    log(f"  launches over the {n} steps: {run_counts} (expected {expected}); plain-version "
        f"calls: {plain.calls}")
    if not all(np.isfinite(losses)) or run_counts != expected or plain.calls:
        raise AssertionError(f"{arch} training: non-finite loss, or not B1 twice and its "
                             "backward once a decoder layer a step, or a plain version called")
    del state, step, lm, model

    torch.use_deterministic_algorithms(True)
    try:
        def run():
            lm = fresh().lm
            state, step = init_train_state(lm), make_train_step(cfg, tcfg)
            for batch in batches[:2]:
                state, _ = step(state, batch)
            return [p.detach().cpu() for p in lm.parameters()]
        first = run()
        second = run()
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"  (deterministic algorithms on) two runs of 2 steps from seed 0: parameters equal "
        f"bit for bit: {same}")
    if not same:
        raise AssertionError(f"{arch} training is not bit-reproducible on the card")
    del first, second, batches
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 12 {arch} training: {time.perf_counter() - t_phase:.1f} s")
    return {"arch": arch, "layers": depth, "published_layers": full.n_layers,
            "tokens_a_step": tokens, "step_ms": step_ms,
            "tokens_s": tokens / float(np.median(times)), "peak_gib": peak,
            "grad_worst_f32": errs[-1][0],
            "launches": {k: run_counts[k] for k in ("polysketch_causal",
                                                    "polysketch_causal_backward")}}


def phase_xm(card):
    """Phase 12: both models served, then both trained. Returns its rows."""
    t0 = time.perf_counter()
    rows = {"serve": [phase_xm_serve(arch, card) for arch in (VLM_ARCH, AUDIO_ARCH)]}
    rows["train"] = [phase_xm_train(arch, card) for arch in (VLM_ARCH, AUDIO_ARCH)]
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"vlm_audio": rows}, default=float))
    return rows


# ---------------------------------------------------------------------------
# phase 13: training what the JAX package trains: exact polynomial attention
# in bf16 through B2's forward and backward kernels (gpt2s-poly4 at full
# width and depth; starcoder2-3b with attention "polynomial" at its
# published width, h 128, GQA 12:1), and the data-parallel steps at world 1
# on NCCL (the manual-DP step with the mean and the int8 all-reduce, and
# launch/train.py --mesh 1x1)
# ---------------------------------------------------------------------------

POLY_BF16_STEPS = 3              # timed steps, after one warm-up
# bf16 gradient gates of exact polynomial attention (scripts/bf16_grad_study.py
# on SMOKE gpt2s-poly4, CPU): the reference's own bf16 gradients lie up to
# 4.20e-2 of a leaf's max|.| from float64, the median leaf up to 2.15e-2;
# two paths each that far from float64 may differ by twice it
POLY_BF16_GRAD_TOL, POLY_BF16_GRAD_MEDIAN = 0.084, 0.043
# starcoder2-3b with exact polynomial attention: 22 of its 30 layers, the
# depth phase 8 trains on the 80 GB card (train_depth; each layer is the
# published one)
POLY_STARCODER_LAYERS = 22
DP_STEPS = 2                     # steps of each data-parallel run
DP_CLI = ["--arch", "gpt2s-polysketch", "--steps", "3", "--batch", "2", "--seq", "1024",
          "--device", "cuda", "--draw-on-device", "--log-every", "1"]


def poly_bf16_configs():
    """(name, config, rows, seq) of phase 13's two bf16 training runs."""
    star = get_config("starcoder2-3b")
    return (("gpt2s-poly4 bf16", GPT2_SMALL_POLY4.replace(compute_dtype="bfloat16"),
             TRAIN_BATCH, TRAIN_SEQ),
            ("starcoder2-3b polynomial", star.replace(attention="polynomial",
                                                      n_layers=POLY_STARCODER_LAYERS),
             1, TRAIN_SEQ))


def b2_plain_ops():
    """ops' B2 entry point with its plain versions, whatever the device."""
    return mock.patch.object(ops, "poly_attention",
                             functools.partial(ops.poly_attention, impl="torch"))


def phase_poly_bf16_train(name, cfg, rows, seq, card):
    """One model with exact polynomial attention trained in bf16 at its
    width (seeded weights drawn on the card): (1) one step's gradients
    through B2's forward and backward kernels against the plain path's,
    leaf by leaf, within the polynomial bf16 gates (POLY_BF16_GRAD_TOL,
    POLY_BF16_GRAD_MEDIAN);
    (2) a warm-up and POLY_BF16_STEPS timed steps (step ms, tokens/s, peak
    GiB) with B2's forward once a layer a step (twice under remat) and its
    backward once, no other kernel and no plain version. Returns a row."""
    t_phase = time.perf_counter()
    h = cfg.resolved_head_dim
    log(f"phase 13: {name} training, bf16, remat {cfg.remat!r}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {h} ({cfg.n_kv_heads} kv), {cfg.n_layers} layers, "
        f"{rows} x {seq} tokens a step, through B2's forward and backward kernels; {card}")
    it = DataIterator(make_markov_lm(cfg.vocab_size, seed=1), rows, seq, seed=0,
                      device="cuda")
    batches = [next(it) for _ in range(POLY_BF16_STEPS + 1)]
    tcfg = TrainConfig(seq_len=seq, global_batch=rows, steps=100, peak_lr=3e-3)
    gc.collect()
    torch.cuda.empty_cache()
    lm = build_model(cfg, device="cuda", seed=0, trainable=True, draw_on_device=True).lm
    loss_fn = make_loss_fn(cfg)

    def grads():
        for p in lm.parameters():
            p.grad = None
        loss, _ = loss_fn(lm, batches[0])
        loss.backward()
        out = {n: p.grad.clone() for n, p in lm.named_parameters() if p.grad is not None}
        for p in lm.parameters():
            p.grad = None
        return out

    got = grads()
    with b2_plain_ops():
        want = grads()
    errs = leaf_errors(got, want)
    median = float(np.median([e for e, _ in errs]))
    log(f"  one step's gradients, kernels vs plain ({len(errs)} leaves, rel. to each leaf's "
        f"max|.|): worst {errs[-1][0]:.3e} ({errs[-1][1]}), median {median:.3e}")
    check(f"{name} gradients kernels vs plain, worst leaf", errs[-1][0], POLY_BF16_GRAD_TOL)
    check(f"{name} gradients kernels vs plain, median leaf", median, POLY_BF16_GRAD_MEDIAN)
    del got, want
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(lm)
    step = make_train_step(cfg, tcfg)
    state, _ = step(state, batches[0])            # warm-up
    torch.cuda.synchronize()
    zero_counts()
    times, losses = [], []
    with PlainCalls() as plain:
        for batch in batches[1:]:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
    run_counts = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(times)
    expected = {k: 0 for k in KERNELS}
    expected["poly_flash"] = (1 if cfg.remat == "none" else 2) * cfg.n_layers * n
    expected["poly_flash_backward"] = cfg.n_layers * n
    step_ms = float(np.median(times)) * 1e3
    tokens = rows * seq
    log(f"  losses {[round(x, 4) for x in losses]}; step time median {step_ms:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times]}; {tokens / np.median(times):.0f} tokens/s; "
        f"peak device memory {peak:.2f} GiB")
    log(f"  launches over the {n} steps: {run_counts} (expected {expected}); plain-version "
        f"calls: {plain.calls}")
    if not all(np.isfinite(losses)) or run_counts != expected or plain.calls:
        raise AssertionError(f"{name} training: non-finite loss, or not B2's forward and "
                             "backward as expected, or a plain version called")
    del state, step, lm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 13 {name}: {time.perf_counter() - t_phase:.1f} s")
    return {"name": name, "layers": cfg.n_layers, "head_dim": h, "rows": rows, "seq": seq,
            "step_ms": round(step_ms, 1), "tokens_s": round(tokens / float(np.median(times))),
            "peak_gib": round(peak, 2), "grad_worst": errs[-1][0], "grad_median": median,
            "launches": {k: run_counts[k] for k in ("poly_flash", "poly_flash_backward")}}


def int8_rounding_bound(x):
    """The most the int8 all-reduce at world 1 may move one element of x:
    half a level of the first stage's scale and half a level of the second
    stage's (the dequantized first stage's), in float64."""
    from repro_torch.distributed.compression import _quant
    flat = x.reshape(1, -1).float()
    q, s1 = _quant(flat, dim=1)
    part = (q.float() * s1 / 127.0).sum(0)
    s2 = part.abs().max().clamp(min=1e-20)
    return 0.5 * (s1.double().item() + s2.double().item()) / 127.0


def phase_dp(card):
    """The data-parallel training paths at world 1 on NCCL (rendezvous on
    the loopback address), gpt2s-polysketch at full width, 2 x 4096 tokens
    a step, deterministic algorithms on: (1) make_manual_dp_train_step
    with the mean all-reduce gives make_train_step's parameters bit for
    bit after DP_STEPS steps; (2) with the int8 all-reduce, each synced
    gradient element lies within the two roundings' half levels of the
    unsynced one (int8_rounding_bound, per leaf of the reference's tree),
    and two runs give the same parameters bit for bit; (3)
    launch/train.py --mesh 1x1:data,model gives the losses of the run
    without --mesh over 3 steps. Returns a row."""
    import torch.distributed as dist
    from repro_torch.distributed import compression
    from repro_torch.launch import train as train_cli
    from repro_torch.train.step import make_manual_dp_train_step
    t_phase = time.perf_counter()
    cfg = get_config("gpt2s-polysketch")
    log(f"phase 13: data parallelism at world 1 on NCCL, {cfg.name} at full width, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step; {card}")
    batches = train_batches(cfg, DP_STEPS)
    _, owned = train_cli.init_ranks("cuda")

    def at():   # the phase's clock, beside each reading
        return f"[at {time.perf_counter() - t_phase:.1f} s]"
    log(f"  process group: {dist.get_backend()}, world {dist.get_world_size()} {at()}")
    row = {}
    torch.use_deterministic_algorithms(True)
    try:
        def run(**tkw):
            gc.collect()
            torch.cuda.empty_cache()
            lm = build_model(cfg, device="cuda", seed=0, trainable=True,
                             draw_on_device=True).lm
            tcfg = TrainConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=100,
                               peak_lr=3e-3, **tkw)
            step = (make_manual_dp_train_step(cfg, tcfg) if tkw.get("grad_compression")
                    else make_train_step(cfg, tcfg))
            state, losses, times = init_train_state(lm), [], []
            for batch in batches:
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                times.append(time.perf_counter() - t0)
            params = [p.detach().clone() for p in lm.parameters()]
            del state, step, lm
            return params, losses, times

        base, base_losses, base_t = run()
        psum, psum_losses, psum_t = run(grad_compression="none")
        same = all(torch.equal(a, b) for a, b in zip(base, psum))
        log(f"  make_train_step losses {base_losses}, step ms "
            f"{[round(t * 1e3, 1) for t in base_t]} {at()}")
        log(f"  manual DP (mean all-reduce) losses {psum_losses}, step ms "
            f"{[round(t * 1e3, 1) for t in psum_t]}; parameters after {DP_STEPS} steps equal "
            f"make_train_step's bit for bit: {same} {at()}")
        if not same or base_losses != psum_losses:
            raise AssertionError("the manual-DP step at world 1 is not make_train_step's bits")
        del psum
        seen = {}
        sync = compression.tree_int8_allreduce_mean

        def recorded(tree, group=None):
            out = sync(tree, group)
            if "in" not in seen:
                seen["in"] = {k: v.detach().clone() for k, v in tree.items()}
                seen["out"] = {k: v.detach().clone() for k, v in out.items()}
            return out
        compression.tree_int8_allreduce_mean = recorded
        try:
            i8, i8_losses, i8_t = run(grad_compression="int8")
        finally:
            compression.tree_int8_allreduce_mean = sync
        worst, worst_leaf = 0.0, None
        for k, x in seen["in"].items():
            bound = int8_rounding_bound(x) * (1 + 1e-5)
            moved = (seen["out"][k].double() - x.double()).abs().max().item()
            if moved / bound > worst:
                worst, worst_leaf = moved / bound, k
        log(f"  manual DP (int8 all-reduce) losses {i8_losses}, step ms "
            f"{[round(t * 1e3, 1) for t in i8_t]}; the first sync moved each gradient "
            f"element by at most {worst:.3f} of the two roundings' half levels "
            f"({len(seen['in'])} leaves of the reference's tree; the most: {worst_leaf}) {at()}")
        if worst > 1.0:
            raise AssertionError(f"int8 all-reduce moved {worst_leaf} past its rounding bound")
        again, _, _ = run(grad_compression="int8")
        same8 = all(torch.equal(a, b) for a, b in zip(i8, again))
        log(f"  two int8 runs give the same parameters bit for bit: {same8} {at()}")
        if not same8:
            raise AssertionError("the int8 manual-DP step is not bit-stable")
        del i8, again, base, seen
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, plain_losses = train_cli.run(DP_CLI)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, mesh_losses = train_cli.run(DP_CLI + ["--mesh", "1x1:data,model"])
        mesh_peak = torch.cuda.max_memory_allocated() / 2**30
        diff = max(abs(a - b) for a, b in zip(plain_losses, mesh_losses))
        log(f"  launch/train.py {' '.join(DP_CLI[2:])}: losses {plain_losses}; with --mesh "
            f"1x1:data,model {mesh_losses} (max|diff| {diff:.3e}, bit for bit: "
            f"{plain_losses == mesh_losses}; peak {mesh_peak:.2f} GiB) {at()}")
        if len(mesh_losses) != 3 or diff > 1e-6:
            raise AssertionError("--mesh 1x1 does not give the losses of the run without it")
        row = {"psum_equal": same, "int8_bound_share": worst, "int8_bit_stable": same8,
               "step_ms": {"make_train_step": base_t, "psum": psum_t, "int8": i8_t},
               "mesh_losses": mesh_losses, "losses": plain_losses}
    finally:
        torch.use_deterministic_algorithms(False)
        if owned:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 13 data parallelism: {time.perf_counter() - t_phase:.1f} s")
    return row


def phase_train_all(card):
    """Phase 13: the two bf16 polynomial runs, then data parallelism."""
    t0 = time.perf_counter()
    rows = {"poly_bf16": [phase_poly_bf16_train(*c, card) for c in poly_bf16_configs()],
            "dp": phase_dp(card)}
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"train_all": rows}, default=float))
    return rows


# ---------------------------------------------------------------------------
# phase 14: replicated serving with bit-exact failover
# ---------------------------------------------------------------------------

# prompts whose streams cross a 1024-token block boundary in their first
# decode ticks (1020 +4, 2040 +8, 3070 +2, 2046 +2), and two that do not
REPLICA_LENS = (1020, 2040, 3070, 2046, 600, 1500)
REPLICA_GEN, REPLICA_SLOTS, REPLICA_BUDGET = 24, 4, 2048
REPLICA_SAMPLED = (dict(temperature=0.8, top_k=40), dict(temperature=0.8, top_p=0.9),
                   dict(temperature=0.8, top_k=40, top_p=0.9))
REPLICA_KILL_AFTER = 2          # the kill: this many ticks after replica 0's first checkpoint
REPLICA_HANG_FACTOR = 4         # the hang limit: this many times run A's slowest tick
# the reference's CI chaos gate at full width: prompt buckets 1020 / 1530 / 2040
REPLICA_CLI = ["--arch", "gpt2s-polysketch", "--draw-on-device", "--requests", "4",
               "--slots", "2", "--prompt-len", "2040", "--gen", "24", "--overlap",
               "--prefill-budget", "2048", "--replicas", "2", "--logprobs"]
# the SIGTERM drain: SMOKE (block 16), so the drain's extra ticks stay under 16
REPLICA_DRAIN_CLI = ["--smoke", "--requests", "4", "--slots", "2", "--prompt-len", "40",
                     "--gen", "2000", "--prefix-cache-mb", "8"]
REPLICA_DIR = os.path.join(ROOT, "build", "replica_drain")   # git-ignored


def replica_workload(vocab):
    """6 requests (REPLICA_LENS), 0-2 greedy and 3-5 sampled (REPLICA_SAMPLED,
    a seed each); 6 warm-up prompts of the same lengths, other tokens."""
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, vocab, n) for n in REPLICA_LENS]
    warm = [rng.integers(0, vocab, n) for n in REPLICA_LENS]
    samp = [SamplingParams()] * 3 + [SamplingParams(seed=140 + i, **s)
                                     for i, s in enumerate(REPLICA_SAMPLED)]
    return prompts, warm, samp


def replica_run(label, model, prompts, warm, samp, *, chaos=None, cache=True,
                hang_timeout=None, profile=None):
    """One counted run of the workload through a ReplicaSet of 2 replicas x
    REPLICA_SLOTS slots on the card (a 512 MiB PrefixCache when `cache`,
    log-probabilities, budget REPLICA_BUDGET, overlap, tracing), after each
    engine served the `warm` prompts (2 tokens; none: no warm-up, and the
    watchdogs stay unarmed) and reset_stats() armed the
    watchdogs. `profile`: (first, last) coordinator ticks to count the CUDA
    runtime calls of. Returns (outputs by request, the ReplicaSet, its row)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    tel = Telemetry(trace=True)
    rs = ReplicaSet(model, n_replicas=2, slots=REPLICA_SLOTS,
                    max_len=max(REPLICA_LENS) + REPLICA_GEN,
                    prefix_cache=PrefixCache(PREFIX_CACHE_BYTES) if cache else None,
                    logprobs=True, prefill_budget=REPLICA_BUDGET, overlap=True,
                    hang_timeout_s=hang_timeout,
                    chaos=ChaosInjector(chaos) if chaos else None, telemetry=tel)
    if warm:
        for k, eng in enumerate(rs.engines):
            # other tokens on each replica: they share the prefix cache
            for p in warm:
                eng.submit((p + k) % model.cfg.vocab_size, 2)
            eng.run()
        rs.reset_stats()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:   # the profiler's own calls
        pass
    base = {e.key: e.count for e in prof.key_averages()}
    ckpts = []                     # (replica, tick, host ms of the call, serialized bytes)
    checkpoint = rs._checkpoint

    def timed_checkpoint(i, tick):
        n, nbytes, t0 = rs._n_ckpts, rs.cache.ckpt_bytes if rs.cache else 0, time.perf_counter()
        checkpoint(i, tick)
        if rs._n_ckpts > n:
            ckpts.append((i, tick, (time.perf_counter() - t0) * 1e3,
                          (rs.cache.ckpt_bytes - nbytes) / (rs._n_ckpts - n)))
    rs._checkpoint = timed_checkpoint
    torch.cuda.synchronize()
    zero_counts()
    with PlainCalls() as plain:
        t0 = time.perf_counter()
        gids = [rs.submit(p, REPLICA_GEN, sampling=s) for p, s in zip(prompts, samp)]
        outs, ticks, t_death, t_recovered, victims, prof = {}, 0, None, None, {}, None
        sync_window, tick_ms = None, []
        while rs.busy:
            t_tick = time.perf_counter()
            if profile and ticks == profile[0]:
                prof = torch_profile(activities=acts)
                prof.__enter__()
                window0 = (sum(rs._ticks), len(ckpts))
            for o in rs.step():
                outs[o.rid] = o
            ticks += 1
            if prof is None and not (profile and profile[0] <= ticks - 1 < profile[1]):
                tick_ms.append((time.perf_counter() - t_tick) * 1e3)
            if prof is not None and ticks == profile[1]:
                prof.__exit__(None, None, None)
                calls = {e.key: e.count - base.get(e.key, 0) for e in prof.key_averages()}
                sync_window = (sum(calls.get(k, 0) for k in SYNC_CALLS),
                               sum(rs._ticks) - window0[0], len(ckpts) - window0[1])
                prof = None
            now = time.perf_counter()
            if t_death is None and rs._deaths:
                t_death = now
                victims = {g.grid: len(g.emitted) for g in rs._live.values() if g.recovered}
            elif t_death is not None and t_recovered is None and any(
                    g not in rs._live or len(rs._live[g].emitted) > k
                    for g, k in victims.items()):
                t_recovered = now
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counts()
    st = rs.stats()
    by_req = {i: outs[g] for i, g in enumerate(gids)}
    ttft = np.array([o.ttft_s for o in by_req.values()]) * 1e3
    row = {"run": label, "chaos": chaos or "none", "cache": cache, "wall_ms": wall * 1e3,
           "coordinator_ticks": ticks, "ms_a_coordinator_tick": wall * 1e3 / ticks,
           "tick_ms_p50": float(np.median(tick_ms)),
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "recovery_ms": ((t_recovered - t_death) * 1e3 if t_recovered else None),
           "launches": launched, "plain_calls": plain.calls,
           "checkpoint_ticks": [(i, t) for i, t, _, _ in ckpts],
           "checkpoint_ms": [round(ms, 3) for _, _, ms, _ in ckpts],
           "checkpoint_bytes": sorted({int(b) for _, _, _, b in ckpts}),
           "first_checkpoint_tick": {i: min((t for j, t, _, _ in ckpts if j == i),
                                             default=None) for i in range(2)},
           "replica_ticks": list(rs._ticks),
           "slowest_tick_ms": max((max(d.durations, default=0.0) for d in rs._stragglers)) * 1e3,
           "sync_window": sync_window,
           **{k: st[k] for k in ("deaths", "unarmed_deaths", "failovers", "checkpoints",
                                 "checkpoints_dropped", "duplicate_outputs",
                                 "recovered_installs", "retraces", "alive", "requests")}}
    log(f"  run {label} ({row['chaos']}, cache {cache}): {wall * 1e3:.1f} ms, {ticks} "
        f"coordinator ticks, {row['ms_a_coordinator_tick']:.2f} ms a tick (median "
        f"{row['tick_ms_p50']:.2f} outside a profile), TTFT p50 "
        f"{row['ttft_p50_ms']:.1f} ms; deaths {st['deaths']}, failovers {st['failovers']}, "
        f"checkpoints {st['checkpoints']} (+{st['checkpoints_dropped']} dropped), recovered "
        f"installs {st['recovered_installs']}, duplicates {st['duplicate_outputs']}, "
        f"retraces {st['retraces']}; recovery {row['recovery_ms']} ms; launches {launched}, "
        f"plain calls {plain.calls}; checkpoint calls {len(ckpts)} ms "
        f"{row['checkpoint_ms'][:6]} bytes {row['checkpoint_bytes']}; first checkpoint "
        f"ticks {row['first_checkpoint_tick']}, replica ticks {row['replica_ticks']}, "
        f"slowest tick {row['slowest_tick_ms']:.1f} ms"
        + (f"; profiled window: {sync_window[0]} host syncs over {sync_window[1]} replica "
           f"ticks and {sync_window[2]} checkpoints" if sync_window else "")
        + (f"; UNARMED DEATHS {st['unarmed_deaths']}" if st["unarmed_deaths"]
           else ""))
    return by_req, rs, row


def replica_gates(label, row, base, outs, deaths, kernel, more=()):
    """A run's tokens and log-probabilities equal run A's request by request,
    its deaths are exactly the schedule's, nothing is duplicated or lost, no
    survivor retraced, `kernel` launched with no plain-version call."""
    for i, o in base.items():
        got = outs[i]
        if not (np.array_equal(got.tokens, o.tokens)
                and np.array_equal(got.logprobs, o.logprobs)):
            raise AssertionError(f"run {label}, request {i}: tokens or log-probabilities "
                                 "differ from run A's")
    bad = [k for k, ok in more if not ok]
    if (row["deaths"] != deaths or row["unarmed_deaths"] or row["duplicate_outputs"]
            or row["requests"] != len(base) or row["retraces"] or row["plain_calls"]
            or not row["launches"][kernel] or bad):
        raise AssertionError(f"run {label}: deaths {row['deaths']} (armed {deaths}), "
                             f"unarmed {row['unarmed_deaths']}, duplicates "
                             f"{row['duplicate_outputs']}, requests {row['requests']}, "
                             f"retraces {row['retraces']}, plain calls {row['plain_calls']}, "
                             f"{kernel} launches {row['launches'][kernel]}, failed: {bad}")
    log(f"  run {label}: the {len(base)} requests' tokens and log-probabilities equal run "
        "A's bit for bit: True")


def phase_replicas(card):
    """Phase 14: gpt2s-polysketch at full width and depth (13 layers), f32,
    seed-0 weights drawn on the card, served by a ReplicaSet of 2 replicas x 4
    slots on cuda:0 (a 512 MiB PrefixCache, log-probabilities, overlap, budget
    2048): 6 requests (REPLICA_LENS, 24 new tokens, 0-2 greedy, 3-5 sampled)
    in four runs: A fault-free; B kill@K:r0, K two ticks after replica 0's
    first checkpoint in A; C drop-snapshot@0:r0 and the same kill (a cold
    prefill and a full replay); D hang@K':r1:sX with a hang limit of 4 x A's
    slowest tick, X the limit + 1 s. Then gpt2s-poly4 (a KV state, no
    snapshot, no cache; no warm-up) in runs A and B; then launch/serve.py at full width
    with --replicas 2 and --chaos kill@6 against the same flags without chaos
    (the --tokens-out files equal, the fleet lines' deaths {} and
    {'kill': 1}), and a SMOKE subprocess under SIGTERM after
    its `serving:` line (exit 0, one checkpoint file a decoding slot). Gates:
    B, C, D and poly4's B bit for bit with their A; the deaths exactly the
    schedule's; failovers; no duplicate; checkpoints in B, dropped ones in C;
    recovered installs; no retrace on the survivors after the warm-up; B1
    (B2 for poly4) launched in every run with no plain-version call, and B2
    more often in poly4's B than its A (the recovery's cold prefill); run
    A's profiled ticks at one host sync a replica tick and one more a
    checkpoint. Returns {"rows": ..., "replica_launches": {kernel: {run:
    launches}}}."""
    t_phase = time.perf_counter()
    cfg = get_config("gpt2s-polysketch")
    log(f"phase 14: replicated serving, {cfg.name} full width and depth ({cfg.n_layers} "
        f"layers), f32, 2 replicas x {REPLICA_SLOTS} slots on one card, prompts "
        f"{REPLICA_LENS}, {REPLICA_GEN} new tokens, requests 0-2 greedy, 3-5 sampled "
        f"{REPLICA_SAMPLED}, budget {REPLICA_BUDGET}, overlap on; card {card}")
    model = build_model(cfg, device="cuda", seed=0, draw_on_device=True)
    prompts, warm, samp = replica_workload(cfg.vocab_size)
    rows, outs = {}, {}
    outs["A"], rs_a, rows["A"] = replica_run("A", model, prompts, warm, samp, profile=(2, 4))
    first0 = rows["A"]["first_checkpoint_tick"][0]
    first1 = rows["A"]["first_checkpoint_tick"][1]
    if first0 is None or first1 is None:
        raise AssertionError(f"run A: a replica wrote no checkpoint ({rows['A']})")
    kill = first0 + REPLICA_KILL_AFTER
    if kill >= rows["A"]["replica_ticks"][0] - 1:
        raise AssertionError(f"kill tick {kill} is past replica 0's run")
    hang_at = first1 + REPLICA_KILL_AFTER
    limit = max(REPLICA_HANG_FACTOR * rows["A"]["slowest_tick_ms"] / 1e3, 0.5)
    syncs, rticks, nck = rows["A"]["sync_window"]
    log(f"  run A's profiled window: {syncs} host syncs over {rticks} replica ticks and "
        f"{nck} checkpoints (allowed {rticks + nck})")
    if syncs > rticks + nck:
        raise AssertionError(f"run A: {syncs} host syncs over {rticks} replica ticks and "
                             f"{nck} checkpoints")
    del rs_a
    specs = {"B": dict(chaos=f"kill@{kill}:r0"),
             "C": dict(chaos=f"drop-snapshot@0:r0,kill@{kill}:r0"),
             "D": dict(chaos=f"hang@{hang_at}:r1:s{limit + 1.0:.3f}", hang_timeout=limit)}
    for run, kw in specs.items():
        outs[run], rs, rows[run] = replica_run(run, model, prompts, warm, samp, **kw)
        del rs
        gc.collect()
    r = rows
    replica_gates("B", r["B"], outs["A"], outs["B"], {"kill": 1}, "polysketch_causal", (
        ("failovers", r["B"]["failovers"] >= 1), ("checkpoints", r["B"]["checkpoints"] >= 1),
        ("recovered_installs", r["B"]["recovered_installs"] >= 1)))
    replica_gates("C", r["C"], outs["A"], outs["C"], {"kill": 1}, "polysketch_causal", (
        ("failovers", r["C"]["failovers"] >= 1),
        ("checkpoints_dropped", r["C"]["checkpoints_dropped"] >= 1),
        ("recovered_installs", r["C"]["recovered_installs"] >= 1)))
    replica_gates("D", r["D"], outs["A"], outs["D"], {"hang": 1}, "polysketch_causal", (
        ("failovers", r["D"]["failovers"] >= 1),
        ("recovered_installs", r["D"]["recovered_installs"] >= 1)))
    if (r["A"]["deaths"] or r["A"]["unarmed_deaths"] or r["A"]["retraces"]
            or r["A"]["plain_calls"]):
        raise AssertionError(f"run A: {r['A']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the SIGTERM drain's process starts now and runs beside poly4's runs and
    # the CLI's (no timing gate of theirs), so its start-up overlaps them
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        drain_job = pool.submit(replica_drain)
        poly = build_model(GPT2_SMALL_POLY4, device="cuda", seed=0, draw_on_device=True)
        log(f"  {poly.cfg.name}: runs A and B without a prefix cache (a KV state has no "
            "snapshot: the recovery prefills the whole prompt in one B2 call a layer, then "
            "replays)")
        outs["poly4 A"], rs, rows["poly4 A"] = replica_run(
            "poly4 A", poly, prompts, (), samp, cache=False)
        del rs
        outs["poly4 B"], rs, rows["poly4 B"] = replica_run(
            "poly4 B", poly, prompts, (), samp, chaos=f"kill@{kill}:r0", cache=False)
        del rs, poly
        gc.collect()
        torch.cuda.empty_cache()
        pa, pb = rows["poly4 A"], rows["poly4 B"]
        replica_gates("poly4 B", pb, outs["poly4 A"], outs["poly4 B"], {"kill": 1},
                      "poly_flash", (
                          ("failovers", pb["failovers"] >= 1),
                          ("recovery prefill",
                           pb["launches"]["poly_flash"] > pa["launches"]["poly_flash"])))

        files = []
        for chaos, deaths in (("none", {}), ("kill@6", {"kill": 1})):
            files.append(os.path.join(REPLICA_DIR, f"tokens-{chaos}.json"))
            os.makedirs(REPLICA_DIR, exist_ok=True)
            t0 = time.perf_counter()
            # the CLI exits non-zero on a death its schedule did not cause; its
            # fleet line must also name exactly the death the schedule armed
            with contextlib.redirect_stdout(io.StringIO()) as out:
                serve_cli.main(REPLICA_CLI + ["--chaos", chaos, "--tokens-out", files[-1]])
            text = out.getvalue()
            log("\n".join("    " + line for line in text.splitlines()))
            log(f"  launch/serve.py --replicas 2 --chaos {chaos}: "
                f"{time.perf_counter() - t0:.1f} s")
            if f"deaths={deaths!r} " not in text:
                raise AssertionError(f"launch/serve.py --chaos {chaos}: its fleet line does not "
                                     f"say deaths={deaths!r}")
            gc.collect()
        same = open(files[0], "rb").read() == open(files[1], "rb").read()
        log(f"  launch/serve.py --chaos kill@6 --tokens-out equals the fault-free file: {same}")
        if not same:
            raise AssertionError("the CLI's --chaos kill@6 tokens differ from the fault-free run's")
        drain = drain_job.result()
    shutil.rmtree(REPLICA_DIR, ignore_errors=True)
    for row in rows.values():
        row["card"] = card
    log(json.dumps({"replicas": list(rows.values()), "drain": drain}, default=float))
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "replica_launches": {
        k: {run: row["launches"][k] for run, row in rows.items()}
        for k in ("polysketch_causal", "poly_flash")}}


def replica_drain():
    """launch/serve.py (SMOKE, on the card) with a disk tier under build/:
    SIGTERM a second after its flushed `serving:` line; it must exit 0
    and leave one checkpoint file a decoding slot. Returns its numbers."""
    d = os.path.join(REPLICA_DIR, "cache")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve",
                             *REPLICA_DRAIN_CLI, "--prefix-cache-dir", d], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving:"):
                break
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        out = "".join(lines) + proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    m = re.search(r"SIGTERM: drained (\d+) decoding slot\(s\), (\d+) requests served, "
                  r"(\d+) checkpoint file", out)
    files = [f for _, _, fs in os.walk(d) for f in fs if f.startswith("ckpt-")]
    row = {"rc": rc, "seconds": time.perf_counter() - t0,
           "decoding_slots": int(m.group(1)) if m else None,
           "files": len(files), "line": m.group(0) if m else None}
    log(f"  SIGTERM drain (SMOKE on the card): exit {rc}, {row['line']}, {len(files)} "
        f"checkpoint files, {row['seconds']:.1f} s")
    if rc != 0 or not m or not 0 < row["decoding_slots"] == len(files) == int(m.group(3)):
        raise AssertionError(f"the SIGTERM drain: exit {rc}, files {files}, output:\n"
                             + out[-3000:])
    return row


# ---------------------------------------------------------------------------
# phase 15: compute over the "model" mesh axis, two ranks sharing the card
# ---------------------------------------------------------------------------

# launch/serve.py's workload of the phase: 4 greedy requests of 1024-2048
# prompt tokens (the CLI's buckets of --prompt-len 2048) and 16 new tokens
# on 4 slots, log-probabilities on
TP_SERVE_CLI = ["--arch", "gpt2s-polysketch", "--draw-on-device", "--requests", "4",
                "--slots", "4", "--prompt-len", "2048", "--gen", "16", "--logprobs",
                "--overlap", "--prefill-budget", "2048"]
TP_TRAIN_CLI = ["--arch", "gpt2s-polysketch", "--draw-on-device", "--steps", "3",
                "--batch", "2", "--seq", "1024", "--log-every", "1"]
TP_POLY_LENS = (2048, 1024, 1536, 600)   # gpt2s-poly4 through ServeEngine at 1x2
TP_GEN, TP_SLOTS = 16, 4
TP_LP_TOL = F32_TOL                      # the log-probabilities against 1x1
TP_LOSS_TOL = F32_TOL                    # the training losses against the run without --mesh
TP_DIR = os.path.join(ROOT, "build", "tp")   # git-ignored


def tp_poly_prompts(vocab):
    rng = np.random.default_rng(15)
    return [rng.integers(0, vocab, size=n) for n in TP_POLY_LENS]


def tp_poly_serve(plan=None):
    """gpt2s-poly4 (B2) through ServeEngine on `plan` (None: one device):
    the TP_POLY_LENS prompts, greedy, TP_GEN new tokens each. Returns
    (tokens, log-probabilities, ms a decode tick, launches)."""
    model = build_model(GPT2_SMALL_POLY4, device="cuda", seed=0, draw_on_device=True)
    eng = ServeEngine(model, slots=TP_SLOTS, max_len=max(TP_POLY_LENS) + TP_GEN,
                      logprobs=True, plan=plan)
    zero_counts()
    with PlainCalls() as plain:
        for p in tp_poly_prompts(model.cfg.vocab_size):
            eng.submit(p, TP_GEN)
        outs = sorted(eng.run(), key=lambda o: o.rid)
    torch.cuda.synchronize()
    st = eng.stats()
    out = ([o.tokens.tolist() for o in outs], [o.logprobs.tolist() for o in outs],
           st["decode_s"] * 1e3 / max(st["decode_steps"], 1), counts(), plain.calls)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_cli(fn, args):
    """One CLI run with the kernels' launches and the plain versions'
    calls counted and its standard output kept. Returns (its result,
    launches, plain calls, output, wall s)."""
    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with PlainCalls() as plain, contextlib.redirect_stdout(buf):
        got = fn(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return got, counts(), plain.calls, buf.getvalue(), wall


def tick_ms(out: str) -> float:
    m = re.search(r"tick gap median=([0-9.]+)ms", out)
    return float(m.group(1)) if m else float("nan")


def tp_rank(rank, world, port):
    """One of the two ranks that share the card over gloo (spawned by
    phase_tp): the serving CLI at --mesh 1x2 --shard-model and --mesh 2x1,
    gpt2s-poly4 through ServeEngine at 1x2, the training CLI at --mesh
    1x2:data,model, and a checkpoint of that run's sharded state, each
    with its launches counted; writes its readings to TP_DIR."""
    import torch.distributed as dist
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.serve.plan import ServePlan
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    os.environ.pop("LOCAL_RANK", None)
    device, _ = init_ranks("cuda", share_card=True)
    row = {"rank": rank, "backend": dist.get_backend(), "device": str(device)}
    for label, mesh in (("serve_1x2", ["--mesh", "1x2", "--shard-model"]),
                        ("serve_2x1", ["--mesh", "2x1"])):
        path = os.path.join(TP_DIR, f"{label}.json")
        _, launched, plain, out, wall = tp_cli(
            serve_cli.main, TP_SERVE_CLI + mesh + ["--share-card", "--tokens-out", path])
        row[label] = {"launches": launched, "plain_calls": plain, "tick_ms": tick_ms(out),
                      "wall_s": wall}
    plan = ServePlan.build(1, 2, shard_model=True, device=device)
    toks, lps, ms, launched, plain = tp_poly_serve(plan)
    row["poly4_1x2"] = {"tokens": toks, "logprobs": lps, "tick_ms": ms,
                        "launches": launched, "plain_calls": plain}
    (state, losses), launched, plain, _, wall = tp_cli(
        train_cli.run, TP_TRAIN_CLI + ["--mesh", "1x2:data,model", "--share-card"])
    t0 = time.perf_counter()
    CheckpointManager(os.path.join(TP_DIR, "ckpt")).save(state.step, state, block=True)
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    row["train_1x2"] = {"losses": losses, "launches": launched, "plain_calls": plain,
                        "step_ms": wall * 1e3 / len(losses), "ckpt_ms": ckpt_ms,
                        "wq_block": list(state.params["layers.0.mixer.wq"].shape)}
    del state
    with open(os.path.join(TP_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    dist.destroy_process_group()


def tp_kernel_checks():
    """B1 and B2 at one rank's share of the heads (6 of gpt2s's 12) against
    their plain versions: B1 at the prefill's call (n 2048, block 1024)
    and, with its backward, at the 1x2 training step's (batch 2, n 1024,
    block 1024: bh 12), B2 at the poly4 prefill's (n 2048). Not counted as
    launches. Returns {kernel: max|err|}."""
    rnd = seeded(15)
    qm, km = rnd(1, 6, 2048, 32, scale=0.5), rnd(1, 6, 2048, 32, scale=0.5)
    ln = lambda x: torch.nn.functional.layer_norm(x, (64,), eps=1e-6)  # noqa: E731
    q, k, v = ln(rnd(1, 6, 2048, 64)), ln(rnd(1, 6, 2048, 64)), rnd(1, 6, 2048, 64)
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    e1 = err(ops.polysketch_attention(qm, km, q, k, v, **kw),
             ops.polysketch_attention(qm, km, q, k, v, impl="torch", **kw))
    check("B1 at a rank's heads: bh 1 x 6, n 2048, r 32, h 64, b 1024", e1, F32_TOL)
    kw = dict(degree=4, scale=1.0 / 64)
    e2 = err(ops.poly_attention(q, k, v, **kw),
             ops.poly_attention(q, k, v, impl="torch", **kw))
    check("B2 at a rank's heads: bh 1 x 6, n 2048, h 64, p 4", e2, F32_TOL)
    # the training step's call at 1x2: TP_TRAIN_CLI's batch 2 x 6 heads, n 1024
    rnd = seeded(16)
    xs = (rnd(2, 6, 1024, 32, scale=0.5), rnd(2, 6, 1024, 32, scale=0.5),
          rnd(2, 6, 1024, 64), rnd(2, 6, 1024, 64), rnd(2, 6, 1024, 64))
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    e3 = err(ops.polysketch_attention(*xs, **kw),
             ops.polysketch_attention(*xs, impl="torch", **kw))
    check("B1 at a rank's training call: bh 2 x 6, n 1024, b 1024", e3, F32_TOL)
    _, e4, _, _ = check_grads("B1 backward at a rank's training call: bh 2 x 6, n 1024",
                              ops.polysketch_attention, xs, rnd(2, 6, 1024, 64), **kw)
    torch.cuda.synchronize()
    return {"polysketch_causal": max(e1, e3), "poly_flash": e2,
            "polysketch_causal_backward": e4}


def tp_tokens(path):
    with open(path) as f:
        return json.load(f)["outputs"]


def tp_compare(label, got, base):
    """Tokens equal, log-probabilities within TP_LP_TOL; returns (max|diff|,
    the number of bit-equal log-probabilities, their count)."""
    worst, same, n = 0.0, 0, 0
    for rid, want in base.items():
        mine = got[rid]
        if mine["tokens"] != want["tokens"]:
            raise AssertionError(f"{label}: request {rid}'s tokens differ from 1x1's")
        for a, b in zip(mine["logprobs"], want["logprobs"]):
            worst = max(worst, abs(a - b))
            same += a == b
            n += 1
    check(f"{label}: log-probabilities against 1x1 (tokens equal)", worst, TP_LP_TOL)
    return worst, same, n


def phase_tp(card):
    """Phase 15 (see the module docstring). Returns its row."""
    from repro_torch.launch import train as train_cli
    t_phase = time.perf_counter()
    log(f"phase 15: compute over the 'model' mesh axis, gpt2s-polysketch (and gpt2s-poly4) "
        f"at full width and depth, f32, two ranks sharing one card over gloo (collectives "
        f"staged through the host: not a multi-card speed); {card}")
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    kernel_err = tp_kernel_checks()
    base_path = os.path.join(TP_DIR, "serve_1x1.json")
    _, serve_base, plain, out, wall = tp_cli(
        serve_cli.main, TP_SERVE_CLI + ["--tokens-out", base_path])
    base_tick = tick_ms(out)
    log(f"  1x1 serving CLI: {wall:.1f} s, tick gap median {base_tick} ms, launches "
        f"{serve_base}, plain calls {plain}")
    ptoks, plps, pms, poly_base, pplain = tp_poly_serve()
    (_, base_losses), train_base, tplain, _, twall = tp_cli(train_cli.run, TP_TRAIN_CLI)
    log(f"  1x1: gpt2s-poly4 engine {pms:.2f} ms a tick, launches {poly_base}; training "
        f"losses {base_losses}, {twall * 1e3 / len(base_losses):.1f} ms a step (3 steps, "
        f"the first included), launches {train_base}")
    if plain or pplain or tplain:
        raise AssertionError("a 1x1 run of phase 15 called a plain version")
    t0 = time.perf_counter()
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import _free_port
    mp.spawn(tp_rank, args=(2, _free_port()), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(TP_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"  two ranks ({ranks[0]['backend']} on {ranks[0]['device']} and "
        f"{ranks[1]['device']}): {spawn_s:.1f} s with their start-up")
    base = tp_tokens(base_path)
    cfg = get_config("gpt2s-polysketch")
    wq_block = [cfg.d_model, cfg.n_heads // 2, cfg.resolved_head_dim]
    row = {"kernel_err": kernel_err, "ranks": ranks,
           "base": {"serve_launches": serve_base, "serve_tick_ms": base_tick,
                    "poly4_launches": poly_base, "poly4_tick_ms": pms,
                    "train_launches": train_base, "losses": base_losses,
                    "train_step_ms": twall * 1e3 / len(base_losses)}}
    for label in ("serve_1x2", "serve_2x1"):
        worst, same, n = tp_compare(f"launch/serve.py --mesh {label[6:]}",
                                    tp_tokens(os.path.join(TP_DIR, f"{label}.json")), base)
        launched = [r[label]["launches"]["polysketch_causal"] for r in ranks]
        log(f"  {label}: {same}/{n} log-probabilities bit for bit, max|diff| {worst:.3e}; "
            f"B1 launches a rank {launched} (1x1: {serve_base['polysketch_causal']}); ms a "
            f"tick (tick gap median, rank 0) {ranks[0][label]['tick_ms']} against 1x1's "
            f"{base_tick}; wall {[round(r[label]['wall_s'], 1) for r in ranks]} s")
        row[label] = {"max_lp_diff": worst, "bit_equal": same, "count": n,
                      "b1_launches": launched}
        want = ([serve_base["polysketch_causal"]] * 2 if label == "serve_1x2" else None)
        if want is not None and launched != want:
            raise AssertionError(f"{label}: B1 launches {launched}, want {want} (each rank "
                                 "runs every prefill on its heads)")
        if label == "serve_2x1" and (sum(launched) != serve_base["polysketch_causal"]
                                     or min(launched) == 0):
            raise AssertionError(f"{label}: B1 launches {launched} do not split the 1x1 "
                                 f"run's {serve_base['polysketch_causal']} over the data ranks")
        if any(r[label]["plain_calls"] for r in ranks):
            raise AssertionError(f"{label}: a rank called a plain version")
    for r in ranks:
        p = r["poly4_1x2"]
        if p["tokens"] != ptoks:
            raise AssertionError("gpt2s-poly4 at 1x2: tokens differ from 1x1's")
        worst = max(abs(a - b) for x, y in zip(p["logprobs"], plps) for a, b in zip(x, y))
        check(f"gpt2s-poly4 ServeEngine 1x2 rank {r['rank']}: log-probabilities against "
              f"1x1", worst, TP_LP_TOL)
        if p["launches"]["poly_flash"] != poly_base["poly_flash"] or p["plain_calls"]:
            raise AssertionError(f"gpt2s-poly4 at 1x2: B2 launches {p['launches']} against "
                                 f"1x1's {poly_base}, or a plain call")
        t = r["train_1x2"]
        diff = max(abs(a - b) for a, b in zip(t["losses"], base_losses))
        check(f"launch/train.py --mesh 1x2:data,model rank {r['rank']}: losses against "
              f"the run without --mesh", diff, TP_LOSS_TOL)
        for k in ("polysketch_causal", "polysketch_causal_backward"):
            if t["launches"][k] != train_base[k]:
                raise AssertionError(f"training at 1x2: rank {r['rank']} launched {k} "
                                     f"{t['launches'][k]} times, 1x1 {train_base[k]}")
        if t["plain_calls"] or t["wq_block"] != wq_block:
            raise AssertionError(f"training at 1x2: wq block {t['wq_block']} (want "
                                 f"{wq_block}) or a plain call")
    log(f"  gpt2s-poly4 1x2: B2 launches a rank "
        f"{[r['poly4_1x2']['launches']['poly_flash'] for r in ranks]} (1x1 "
        f"{poly_base['poly_flash']}), ms a tick {[round(r['poly4_1x2']['tick_ms'], 2) for r in ranks]}"
        f" against 1x1's {pms:.2f}")
    log(f"  training 1x2: losses {ranks[0]['train_1x2']['losses']} against {base_losses}; "
        f"B1 / B1 backward launches a rank "
        f"{[(r['train_1x2']['launches']['polysketch_causal'], r['train_1x2']['launches']['polysketch_causal_backward']) for r in ranks]}"
        f" (1x1 {train_base['polysketch_causal']} / "
        f"{train_base['polysketch_causal_backward']}); ms a step (3 steps, the first "
        f"included) {[round(r['train_1x2']['step_ms'], 1) for r in ranks]} against 1x1's "
        f"{twall * 1e3 / len(base_losses):.1f}; a checkpoint call (gather + rank 0 writes + "
        f"barrier) {[round(r['train_1x2']['ckpt_ms'], 1) for r in ranks]} ms")
    log(f"  phase 15: {time.perf_counter() - t_phase:.1f} s ({card}; two ranks sharing one "
        f"card over host-staged gloo collectives, not a multi-card speed)")
    for r in ranks:
        for k in ("tokens", "logprobs"):
            r["poly4_1x2"].pop(k)
    log(json.dumps({"tensor_parallel": row}, default=float))
    return row


# ---------------------------------------------------------------------------
# phase 16: the MoE family over a device mesh, two ranks sharing the card:
# dbrx trained with its experts split over "model" (expert parallelism)
# ---------------------------------------------------------------------------

EP_ARCH = "dbrx-132b"
EP_LAYERS = 1                  # of 40: 16 B a parameter, a rank holds 8 of 16 experts
EP_SHAPE = (1, 2)              # (data, model)
EP_ROWS, EP_SEQ, EP_STEPS = 2, 1024, 3   # phase 15's --mesh traffic: 2 x 1024 a step
EP_TOL = F32_TOL               # losses and both aux metrics against 1x1, f32 compute
EP_DIR = os.path.join(ROOT, "build", "ep")   # git-ignored


def ep_cfg():
    """dbrx at its published width, EP_LAYERS of its 40 layers, in f32:
    against 1x1 the mesh changes only the order of float sums (the
    Megatron partial sums, the gradients' sums), which f32 holds to 1e-4;
    in bf16 those sums round each partial and may flip a near-tie of the
    top-4, which would need a gate set from readings."""
    return get_config(EP_ARCH).replace(n_layers=EP_LAYERS, compute_dtype="float32")


def ep_train(mesh=None):
    """EP_STEPS steps of ep_cfg's dbrx (seed-0 weights drawn on the card) on
    EP_ROWS x EP_SEQ Markov tokens a step: make_train_step on one device,
    or make_sharded_train_step with init_sharded_train_state over `mesh`.
    Counts the kernels' launches and the plain versions' calls, logs each
    dispatch plan's digest and the bytes gather_model returns (the router
    logits and the expert outputs gathered whole over "model"). Returns a
    row."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.train.step import init_sharded_train_state, make_sharded_train_step
    cfg = ep_cfg()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", seed=0, trainable=True, draw_on_device=True)
    tcfg = TrainConfig(seq_len=EP_SEQ, global_batch=EP_ROWS, steps=100, peak_lr=3e-4)
    if mesh is None:
        state, step = init_train_state(model.lm), make_train_step(cfg, tcfg)
        held = dict(model.lm.named_parameters())
    else:
        state = init_sharded_train_state(model.lm, mesh, model.axes())
        step = make_sharded_train_step(cfg, tcfg)
        held = state.params
    del model
    wi = held["layers.0.ffn.wi"]
    expert_bytes = sum(x.numel() * x.element_size() for n, x in held.items()
                       if n.endswith(("ffn.wi", "ffn.wg", "ffn.wo")))
    del held
    it = DataIterator(make_markov_lm(cfg.vocab_size, seed=1), EP_ROWS, EP_SEQ, seed=0,
                      device="cuda")
    batches = [next(it) for _ in range(EP_STEPS)]
    digests, gathered = [], [0]
    plan_fn, gather_fn = moe.dispatch_plan, tp.gather_model

    def plan_logged(*a, **k):
        plan = plan_fn(*a, **k)
        digests.append(moe.plan_digest(plan))
        return plan

    def gather_counted(x, dim):
        out = gather_fn(x, dim)
        gathered[0] += out.numel() * out.element_size()
        return out
    zero_counts()
    losses, aux, times = [], [], []
    with PlainCalls() as plain, mock.patch.object(moe, "dispatch_plan", plan_logged), \
            mock.patch.object(tp, "gather_model", gather_counted):
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
            aux.append((float(metrics["aux_load_balance"]), float(metrics["aux_router_z"])))
    launched = counts()
    row = {"losses": losses, "aux": aux, "step_ms": [t * 1e3 for t in times],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launched, "plain_calls": plain.calls, "wi_block": list(wi.shape),
           "expert_gib": expert_bytes / 2**30, "gathered_bytes_a_step": gathered[0] / EP_STEPS,
           "digests": digests,
           "batch_sum": sum(int(b["tokens"].sum()) for b in batches)}
    del state, step, wi, batches
    gc.collect()
    torch.cuda.empty_cache()
    return row


def ep_rank(rank, world, port):
    """One of the two ranks that share the card over gloo (spawned by
    phase_ep): ep_train over the (1, 2) mesh; writes its row to EP_DIR."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    os.environ.pop("LOCAL_RANK", None)
    device, _ = init_ranks("cuda", share_card=True)
    row = ep_train(make_mesh(EP_SHAPE, ("data", "model"), "cuda"))
    row.update(rank=rank, backend=dist.get_backend(), device=str(device))
    with open(os.path.join(EP_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    dist.destroy_process_group()


def ep_kernel_checks():
    """B1 and its backward at one rank's call in phase 16's training step:
    24 of dbrx's 48 heads, batch 2, n 1024, r 32, h 128, block 256, f32,
    against their plain versions (F32_TOL; the gradients within F32_TOL of
    their max). Not counted as launches. Returns {kernel: max|err|}."""
    before = counts()
    cfg = ep_cfg()
    h, r, b = cfg.resolved_head_dim, cfg.sketch_size, cfg.lt_block_size
    rnd = seeded(16)
    ln = lambda x: torch.nn.functional.layer_norm(x, (h,), eps=1e-6)  # noqa: E731
    heads = cfg.n_heads // EP_SHAPE[1]
    xs = (rnd(EP_ROWS, heads, EP_SEQ, r, scale=0.5), rnd(EP_ROWS, heads, EP_SEQ, r, scale=0.5),
          ln(rnd(EP_ROWS, heads, EP_SEQ, h)), ln(rnd(EP_ROWS, heads, EP_SEQ, h)),
          rnd(EP_ROWS, heads, EP_SEQ, h))
    kw = dict(degree=cfg.poly_degree, scale=1.0 / h, block_size=b)
    shape = f"bh {EP_ROWS} x {heads}, n {EP_SEQ}, r {r}, h {h}, b {b}, f32"
    e1 = err(ops.polysketch_attention(*xs, **kw),
             ops.polysketch_attention(*xs, impl="torch", **kw))
    check(f"B1 at a rank's call in dbrx's 1x2 training step: {shape}", e1, F32_TOL)
    _, e2, _, _ = check_grads(f"B1 backward at a rank's call: {shape}",
                              ops.polysketch_attention, xs, rnd(EP_ROWS, heads, EP_SEQ, h), **kw)
    torch.cuda.synchronize()
    for name, fn in KERNELS.items():   # checking launches do not count
        fn.launches = before[name]
    del xs
    torch.cuda.empty_cache()
    return {"polysketch_causal": e1, "polysketch_causal_backward": e2}


def phase_ep(card):
    """Phase 16 (see the module docstring). Returns its row."""
    t_phase = time.perf_counter()
    cfg = ep_cfg()
    log(f"phase 16: the MoE family over a device mesh: {EP_ARCH} at its published width "
        f"(d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim} "
        f"({cfg.n_kv_heads} kv), {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
        f"{cfg.moe_top_k}, capacity factor {cfg.capacity_factor}, vocab {cfg.vocab_size}), "
        f"{cfg.n_layers} of 40 layers, f32, remat {cfg.remat!r}, {EP_STEPS} steps of {EP_ROWS} x "
        f"{EP_SEQ} Markov tokens at {EP_SHAPE[0]}x{EP_SHAPE[1]} (data, model), each 'model' "
        f"rank holding and running {cfg.n_experts // EP_SHAPE[1]} experts, against 1x1 on "
        f"the same weights and batches; two ranks sharing one card over gloo (collectives "
        f"staged through the host: not a multi-card speed); {card}")
    shutil.rmtree(EP_DIR, ignore_errors=True)
    os.makedirs(EP_DIR)
    kernel_err = ep_kernel_checks()
    base = ep_train()
    log(f"  1x1: losses {base['losses']}, aux (load balance, router z) {base['aux']}; ms a "
        f"step {[round(t, 1) for t in base['step_ms']]}; peak {base['peak_gib']:.2f} GiB; "
        f"launches {base['launches']}; plain calls {base['plain_calls']}")
    t0 = time.perf_counter()
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import _free_port
    mp.spawn(ep_rank, args=(2, _free_port()), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(EP_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    expected = {k: 0 for k in KERNELS}
    expected["polysketch_causal"] = (1 if cfg.remat == "none" else 2) * cfg.n_layers * EP_STEPS
    expected["polysketch_causal_backward"] = cfg.n_layers * EP_STEPS
    wi_block = [cfg.n_experts // EP_SHAPE[1], cfg.d_model // EP_SHAPE[0], cfg.d_ff]
    for r in ranks:
        log(f"  rank {r['rank']} ({r['backend']} on {r['device']}): losses {r['losses']}, aux "
            f"{r['aux']}; ms a step {[round(t, 1) for t in r['step_ms']]}; peak "
            f"{r['peak_gib']:.2f} GiB; expert blocks {r['expert_gib']:.2f} GiB (wi "
            f"{r['wi_block']}); gathered over 'model' {r['gathered_bytes_a_step'] / 2**20:.1f} "
            f"MiB a step; launches {r['launches']}; plain calls {r['plain_calls']}; "
            f"{len(r['digests'])} plans")
        if r["batch_sum"] != base["batch_sum"]:
            raise AssertionError(f"rank {r['rank']}: other batches than 1x1's")
        diff = max(abs(a - b) for a, b in zip(r["losses"], base["losses"]))
        check(f"dbrx 1x2 rank {r['rank']}: losses against 1x1", diff, EP_TOL)
        diff = max(abs(a - b) for x, y in zip(r["aux"], base["aux"]) for a, b in zip(x, y))
        check(f"dbrx 1x2 rank {r['rank']}: aux_load_balance and aux_router_z against 1x1",
              diff, EP_TOL)
        if r["launches"] != expected or base["launches"] != expected:
            raise AssertionError(f"rank {r['rank']}: launches {r['launches']} (1x1 "
                                 f"{base['launches']}), want {expected}: B1 twice a layer a "
                                 f"step under remat 'full', its backward once")
        if r["plain_calls"] or base["plain_calls"]:
            raise AssertionError(f"rank {r['rank']} or 1x1 called a plain version")
        if r["wi_block"] != wi_block:
            raise AssertionError(f"rank {r['rank']}: wi block {r['wi_block']}, want {wi_block}")
    if ranks[0]["digests"] != ranks[1]["digests"] or not ranks[0]["digests"]:
        raise AssertionError("the two 'model' ranks routed differently")
    log(f"  the plans' digests equal on both ranks ({len(ranks[0]['digests'])} plans); two "
        f"ranks: {spawn_s:.1f} s with their start-up")
    log(f"  phase 16: {time.perf_counter() - t_phase:.1f} s ({card}; two ranks sharing one "
        f"card over host-staged gloo collectives, not a multi-card speed)")
    for r in ranks:
        r.pop("digests")
    base.pop("digests")
    row = {"kernel_err": kernel_err, "base": base, "ranks": ranks, "card": card}
    log(json.dumps({"expert_parallel": row}, default=float))
    return row


# ---------------------------------------------------------------------------
# phase 4: kernel time at the slice's shape
# ---------------------------------------------------------------------------

def event_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def b1_ops(bh, n, r, h, b, degree, itemsize=4):
    """B1's operations as the algorithm needs them (masked pairs not
    counted), as (products, rest, TF32 products). Products: the diagonal's
    Q K^T and W V (4h a pair), the cross term Phi(qm) [Zv | Zd] (2r^2 (h + 1)
    a row), the fold Km^T [Km (x) V | Km] (2br^2 (h + 1) a block). Rest:
    scale, power and row sum a pair; the cross term's elementwise work a
    row; the product km (x) v and the prefix a block. TF32 products: three
    an f32 product (3xTF32); with bf16 operands (itemsize 2) only the
    passes whose lo half is not zero: Q K^T on the bf16 tensor cores
    (BF16_PASS: both operands bf16), W V two (W is f32), the cross term
    three (Phi(qm) and Z_l are f32), the fold two (Km is bf16)."""
    t = n // b
    pairs = t * b * (b + 1) // 2
    cross = n * (2 * r * r * h + 2 * r * r)
    fold = t * (2 * b * r * r * h + 2 * b * r * r)
    prod = pairs * 4 * h + cross + fold
    rest = (pairs * (2 + pow_muls(degree)) + n * (2 * r * h + 2 * r + h)
            + t * b * r * h + t * (r * r * h + r * r))
    tf32 = (3 * prod if itemsize == 4
            else pairs * 2 * h * (BF16_PASS + 2) + 3 * cross + 2 * fold)
    return bh * prod, bh * rest, bh * tf32


def b1_bound(bh, n, r, h, b, degree, itemsize=4):
    """B1's bounds on an H100: bytes are each input read once (z0 included:
    the wrapper passes zeros when none is given) and each output written
    once, the returned state included; the TF32 products as b1_ops counts
    them for the operands' width."""
    state = bh * (r * r * h + r * r) * 4
    nbytes = bh * n * (2 * r + 3 * h) * itemsize + bh * n * h * itemsize + 2 * state
    prod, rest, tf32 = b1_ops(bh, n, r, h, b, degree, itemsize)
    return bounds(prod, rest, nbytes, tf32)


class Bounds(NamedTuple):
    tc_ms: float      # the tensor-core route (3xTF32)
    tc_by: str        # 'bytes' | 'operations'
    fma_ms: float     # every operation on the f32 FMA pipes
    fma_by: str
    flops: int        # products + rest
    nbytes: int


def bounds(prod, rest, nbytes, tf32=None) -> Bounds:
    """Least times on an H100 (ms), each the larger of operations and bytes
    at the HBM rate: on the tensor-core route, `tf32` TF32 product flops
    (three TF32 products per f32 product by default; a product of two bf16
    operands counts BF16_PASS of one, the bf16 peak) at the TF32 peak plus
    the rest at the f32 peak; on the FMA route, all operations at the f32
    peak."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_tc = (3 * prod if tf32 is None else tf32) / H100_TF32_FLOPS + rest / H100_F32_FLOPS
    t_fma = (prod + rest) / H100_F32_FLOPS
    by = lambda t_ops: "operations" if t_ops >= t_bytes else "bytes"  # noqa: E731
    return Bounds(max(t_tc, t_bytes) * 1e3, by(t_tc), max(t_fma, t_bytes) * 1e3,
                  by(t_fma), prod + rest, nbytes)


def b1_bwd_bound(bh, n, r, h, b, degree, itemsize=4):
    """B1's backward (local_exact) as the function needs it, each product
    counted once. Products: on the diagonal's pairs, S = Q K^T (2h),
    dW = G [V | 1]^T (2(h + 1)), dq, dk and dv (2h each); r^2-wide, the
    fold and M = Z g over every row (2r^2 (h + 1) each), N = dH [v | 1]
    and Phi(km) dHv over the rows of the blocks before the last (dH of the
    last block is zero): 2r^2 (h + 1) and 2r^2 h. Rest: per pair
    dS = p x^(p-1) dW and W = x^p; per row g's preparation, the
    contractions of M and N with the sketch (4r^2 each), Phi(km) (r^2),
    the fold's qm (x) g (r (h + 1)); the suffix's adds. Bytes: qm, km, q,
    k, v, out, dO, 1 + den and the saved Z_l read once; dqm, dkm, dq, dk,
    dv and dz0 written once. csrc/polysketch_causal_bwd.cu does more: its
    query-diagonal and key-diagonal kernels each rebuild S and dW (and dS),
    ~13 GFLOP at the training shape, the price of having no atomics; that
    recomputation is part of the gap between the kernel and this bound. The
    state kernels (M, N and Phi(km) dHv) and the fold recompute nothing.
    TF32 products: three an f32 product; with bf16 operands (itemsize 2)
    S = Q K^T on the bf16 tensor cores (BF16_PASS: both operands bf16),
    dW, dq and dk two (G and dS are f32), dv three, the fold two (qm is
    bf16), M three (Z and g are f32), N two, Phi(km) dHv three."""
    t = n // b
    pairs = t * b * (b + 1) // 2
    rr = r * r
    prod = (pairs * (8 * h + 2 * (h + 1)) + n * 2 * rr * (h + 1) * 2
            + (n - b) * (2 * rr * (h + 1) + 2 * rr * h))
    rest = (pairs * (4 + pow_muls(degree - 1) + pow_muls(degree))
            + n * (3 * h + 2) + n * 4 * rr + (n - b) * 5 * rr + n * r * (h + 1)
            + t * rr * (h + 1))
    nbytes = itemsize * (n * (2 * r + 5 * h + 1) + n * (2 * r + 3 * h)) \
        + 4 * (t + 1) * rr * (h + 1)
    if itemsize == 4:
        tf32 = 3 * prod
    else:   # bf16 operands: as b1_ops, fewer passes where both operands are exact in TF32
        tf32 = (pairs * (2 * h * BF16_PASS + 2 * (h + 1) * 2 + 2 * h * 2 + 2 * h * 2
                         + 2 * h * 3)
                + n * 2 * rr * (h + 1) * (2 + 3)
                + (n - b) * (2 * rr * (h + 1) * 2 + 2 * rr * h * 3))
    return bounds(bh * prod, bh * rest, bh * nbytes, bh * tf32)


def pow_muls(degree):
    """Multiplies of x^p by repeated squaring."""
    return max(degree.bit_length() - 1 + bin(degree).count("1") - 1, 0)


def phase_timing():
    """B1 at the slice's shape and at the two calls each layer of a
    2040-token prefill makes: n = b = 1024 returning its state, then
    n = b = 1016 seeded with it."""
    log("phase 4: B1 time at the slice's shape and the prefill's call shapes "
        "(CUDA events, warmed up)")
    qm, km, q, k, v = (x.reshape(48, 2048, -1).contiguous() for x in slice_inputs())
    head = [x[:, :1024].contiguous() for x in (qm, km, q, k, v)]
    tail = [x[:, 1024:2040].contiguous() for x in (qm, km, q, k, v)]
    kw = dict(degree=4, scale=1.0 / 64, return_state=True)
    launches = pc.polysketch_causal_cuda.launches
    _, zv0, zd0 = pc.polysketch_causal_cuda(*head, block_size=1024, **kw)
    out = {}
    for name, xs, n, z0 in (("n 2048, b 1024", (qm, km, q, k, v), 2048, ()),
                            ("prefill block n = b = 1024", head, 1024, ()),
                            ("prefill tail n = b = 1016 + z0", tail, 1016, (zv0, zd0))):
        b = 1024 if n == 2048 else n
        run = lambda: pc.polysketch_causal_cuda(*xs, *z0, block_size=b, **kw)  # noqa: E731
        ms = event_ms(run)
        plain_ms = event_ms(lambda: pc.polysketch_causal_torch(*xs, *z0, block_size=b, **kw))
        ms2 = event_ms(run)
        bd = b1_bound(48, n, 32, 64, b, 4)
        out[n] = (min(ms, ms2), plain_ms, bd)
        log(f"  B1 {name} bh=48 r=32 h=64: kernel {min(ms, ms2):.3f} ms (runs {ms:.3f}, "
            f"{ms2:.3f}; the plain version ran between them), plain PyTorch "
            f"{plain_ms:.3f} ms; bound {bd.tc_ms:.3f} ms by {bd.tc_by} on the tensor cores "
            f"({bd.flops / 1e9:.1f} GFLOP, products in 3xTF32 at 495 TFLOP/s, the rest at "
            f"67; {bd.nbytes / 1e6:.1f} MB at 3.35 TB/s), {bd.tc_ms / min(ms, ms2):.1%} of "
            f"it; f32-FMA bound {bd.fma_ms:.3f} ms, {bd.fma_ms / min(ms, ms2):.1%} of it; "
            f"library call: {NO_LIBRARY}")
    pc.polysketch_causal_cuda.launches = launches   # timing launches do not count
    return out


# B1's forward passes (a substring of their kernels' names)
B1_FWD_PASSES = (("fold", "fold_kernel"), ("prefix", "prefix_kernel"),
                 ("output", "output_kernel"))
# the forward kernels that carry B1's diagonal and cross term and B2 on
# wgmma: each should hold 8 warps an SM (12: two consumer warpgroups and a
# producer) with no spills
FWD_HEAVY = ("output_kernel", "poly_flash_kernel")


def phase_timing_forward(ptxas):
    """The forward kernels' registers, spills, shared memory and CTAs an SM
    (forward_occupancy: B2 causal and B1 local_exact, at h 64 in f32 and at
    h 128 in bf16), and B1's forward per pass (fold, prefix, output;
    torch.profiler) at the training shape (bh 24, n 4096, r 32, h 64,
    b 1024, f32) and at starcoder2-3b's (h 128, b 256, bf16 and f32),
    saving Z_l and 1 + den. Returns {shape: {pass: ms}}."""
    for label, rows, src, inst in (
            ("B2 forward kernel on the card (causal, h 64, f32)", pf.forward_occupancy(64),
             "poly_flash", "IfLb1ELi8E"),
            ("B2 forward kernel on the card (causal, h 128, bf16)",
             pf.forward_occupancy(128, torch.bfloat16), "poly_flash",
             "I13__nv_bfloat16Lb1ELi16E"),
            ("B1 forward kernels on the card (local_exact, h 64, f32)",
             pc.forward_occupancy(True, 64), "polysketch_causal", "IfLb1ELi8E"),
            ("B1 forward kernels on the card (local_exact, h 128, bf16)",
             pc.forward_occupancy(True, 128, torch.bfloat16), "polysketch_causal",
             "I13__nv_bfloat16Lb1ELi16E")):
        kernel_occupancy(label, rows, ptxas.get(src, {}), FWD_HEAVY, inst=inst)
    log("phase 4: B1 forward per pass (torch.profiler, device ms a call)")
    before = counts()
    xs, _ = train_attention_inputs()
    shapes = {"bh 24 n 4096 r 32 h 64 b 1024 f32":
              ([x.reshape(24, 4096, -1).contiguous() for x in xs],
               dict(degree=4, scale=1.0 / 64, block_size=1024))}
    del xs
    for dt in (torch.bfloat16, torch.float32):
        rnd = seeded(64)
        flat = [rnd(24, 4096, 32, scale=0.5, dtype=dt), rnd(24, 4096, 32, scale=0.5, dtype=dt)]
        flat += [rnd(24, 4096, 128, dtype=dt) for _ in range(3)]
        shapes[f"bh 24 n 4096 r 32 h 128 b 256 {str(dt)[6:]}"] = (
            flat, dict(degree=4, scale=1.0 / 128, block_size=256))
    out = {}
    for name, (flat, kw) in shapes.items():
        bh, _, r = flat[0].shape
        h = flat[2].shape[-1]
        # an explicit zero state: the wrapper's own zeros would add a fill
        # kernel to the profile
        flat = flat + [torch.zeros(bh, r, r * h, device="cuda"),
                       torch.zeros(bh, r, r, device="cuda")]
        split = profile_passes(
            lambda: pc.polysketch_causal_cuda(*flat, return_saved=True, **kw),  # noqa: B023
            B1_FWD_PASSES)
        out[name] = split
        log(f"  B1 {name}: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"; sum {sum(split.values()):.3f} ms")
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    del shapes
    torch.cuda.empty_cache()
    return out


# B1's backward passes (a substring of their kernels' names)
B1_BWD_PASSES = (("prep", "grad_prep"), ("fold", "grad_fold"), ("suffix", "grad_suffix"),
                 ("query state", "grad_query_state"), ("key state", "grad_key_state"),
                 ("query diagonal", "grad_query_diag"), ("key diagonal", "grad_key_diag"))
# the kernels that carry the backward's products: each should hold 8 warps
# an SM with no spills
B1_BWD_HEAVY = ("grad_query_state", "grad_key_state", "grad_query_diag", "grad_key_diag")


def kernel_occupancy(label, rows, logged, heavy=(), inst=""):
    """Print each kernel of `rows` (a wrapper's backward_occupancy()): its
    registers a thread and spills (the most over its template instantiations
    in `logged`, its source's ptxas -v entries from build_kernels; only
    those whose template arguments hold `inst`, where some do), shared
    memory a CTA and CTAs an SM. A kernel in `heavy` is flagged unless it
    holds 8 warps an SM with no spills."""
    log(f"phase 4: {label}")
    for name, row in rows.items():
        spills = [(k, v) for k, v in logged.items() if k.startswith(name)
                  and k[len(name):len(name) + 1] in ("", "I")]
        if any(inst in k for k, _ in spills):
            spills = [(k, v) for k, v in spills if inst in k]
        spills = [v for _, v in spills]
        spill = max((s["spill_stores"] + s["spill_loads"] for s in spills), default=None)
        flag = ""
        if name in heavy:
            ok = row["warps_per_sm"] >= 8 and spill == 0
            flag = "  (8 warps an SM, no spills: " + ("yes)" if ok else "NO)")
        log(f"  {name:28s} {row['registers']:3d} registers, {row['local_bytes']} B local, "
            f"spill bytes {spill if spill is not None else 'not in the log'}, "
            f"{row['smem_bytes']} B shared a CTA, {row['threads']} threads, "
            f"{row['ctas_per_sm']} CTAs = {row['warps_per_sm']} warps an SM{flag}")


def time_backward(label, run, plain, passes, bd, plain_iters=5):
    """A backward kernel's call `run` and its plain version `plain` on the
    same inputs: kernel, plain, kernel with CUDA events, then the kernel
    per pass (torch.profiler, `passes` as profile_passes takes them),
    against the bound `bd`, and with CUDA events once more after the
    profile, so that the split's sum can be read against a time taken just
    after it. Returns (best kernel ms of the first two, plain ms, bd)."""
    ms = event_ms(run)
    plain_ms = event_ms(plain, iters=plain_iters, warmup=1)
    ms2 = event_ms(run)
    per_pass = profile_passes(run, passes)
    ms3 = event_ms(run)
    best = min(ms, ms2)
    split = sum(per_pass.values())
    log(f"  {label}: kernel {best:.3f} ms (runs {ms:.3f}, {ms2:.3f}; the plain version ran "
        f"between them), plain PyTorch {plain_ms:.3f} ms; bound {bd.tc_ms:.3f} ms by "
        f"{bd.tc_by} on the tensor cores ({bd.flops / 1e9:.1f} GFLOP, {bd.nbytes / 1e6:.1f} "
        f"MB), {bd.tc_ms / best:.1%} of it; f32-FMA bound {bd.fma_ms:.3f} ms, "
        f"{bd.fma_ms / best:.1%} of it; library call: {NO_LIBRARY}")
    log("  per pass (torch.profiler, device ms a call): "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_pass.items())
        + f"; sum {split:.3f}, {split / best:.1%} of the CUDA-event time; CUDA events "
        f"just after the profile {ms3:.3f} ms")
    return best, plain_ms, bd


def phase_timing_backward(ptxas):
    """B1's backward at the training shape (bh 24, n 4096, r 32, h 64,
    b 1024): its kernels' occupancy, its time (time_backward), and the
    forward that saves its inputs."""
    kernel_occupancy("B1 backward kernels on the card (local_exact, h 64)",
                     pc.backward_occupancy(local_exact=True, h=64),
                     ptxas.get("polysketch_causal_bwd", {}), B1_BWD_HEAVY, inst="Li64E")
    log("phase 4: B1 backward time at the training shape (CUDA events, warmed up)")
    xs, dout = train_attention_inputs()
    flat = [x.reshape(24, 4096, -1).contiguous() for x in xs]
    dout = dout.reshape(24, 4096, -1).contiguous()
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)
    before = counts()
    out, _, _, saved = pc.polysketch_causal_cuda(*flat, return_saved=True, **kw)
    timing = time_backward(
        "B1 backward bh=24 n=4096 r=32 h=64 b=1024",
        lambda: pc.polysketch_causal_backward_cuda(dout, *flat, out, saved, **kw),
        lambda: pc.polysketch_causal_backward_torch(dout, *flat, out, saved, **kw),
        B1_BWD_PASSES, b1_bwd_bound(24, 4096, 32, 64, 1024, 4))
    fwd_ms = event_ms(lambda: pc.polysketch_causal_cuda(*flat, return_saved=True, **kw))
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    log(f"  B1 forward at the same shape, saving Z_l and 1 + den: {fwd_ms:.3f} ms")
    return timing


def phase_timing_h128(ptxas):
    """B1's forward and backward at starcoder2-3b's training shape (1 x 24
    heads, n 4096, r 32, h 128, b 256), bf16 as the model trains and f32:
    the backward kernels' occupancy at h 128, and each time beside its
    plain version's and its bound (bytes at the operands' width). Returns
    {dtype: {"fwd": (ms, plain ms, bound), "bwd": (...)}}."""
    kernel_occupancy("B1 backward kernels on the card (local_exact, h 128, bf16)",
                     pc.backward_occupancy(local_exact=True, h=128, dtype=torch.bfloat16),
                     ptxas.get("polysketch_causal_bwd", {}), B1_BWD_HEAVY, inst="Li128E")
    log("phase 4: B1 forward and backward at h 128, bh 24 n 4096 r 32 b 256 (starcoder2-3b's "
        "training shape; CUDA events, warmed up)")
    before = counts()
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        rnd = seeded(64)
        bh, n, r, h, b = 24, 4096, 32, 128, 256
        flat = [rnd(bh, n, r, scale=0.5, dtype=dt), rnd(bh, n, r, scale=0.5, dtype=dt)]
        flat += [rnd(bh, n, h, dtype=dt) for _ in range(3)]
        dout = rnd(bh, n, h, dtype=dt)
        kw = dict(degree=4, scale=1.0 / h, block_size=b)
        isz = 2 if dt == torch.bfloat16 else 4
        run = lambda: pc.polysketch_causal_cuda(*flat, return_saved=True, **kw)  # noqa: E731
        ms = event_ms(run)
        plain_ms = event_ms(lambda: pc.polysketch_causal_torch(*flat, return_saved=True, **kw),
                            iters=5, warmup=1)
        ms2 = event_ms(run)
        bd = b1_bound(bh, n, r, h, b, 4, itemsize=isz)
        name = str(dt)[6:]
        log(f"  B1 forward {name} (saving Z_l and 1 + den): kernel {min(ms, ms2):.3f} ms (runs "
            f"{ms:.3f}, {ms2:.3f}), plain PyTorch {plain_ms:.3f} ms; bound {bd.tc_ms:.3f} ms "
            f"by {bd.tc_by} ({bd.flops / 1e9:.1f} GFLOP, {bd.nbytes / 1e6:.1f} MB), "
            f"{bd.tc_ms / min(ms, ms2):.1%} of it; library call: {NO_LIBRARY}")
        o, _, _, saved = run()
        bwd = time_backward(
            f"B1 backward {name} bh=24 n=4096 r=32 h=128 b=256",
            lambda: pc.polysketch_causal_backward_cuda(dout, *flat, o, saved, **kw),
            lambda: pc.polysketch_causal_backward_torch(dout, *flat, o, saved, **kw),
            B1_BWD_PASSES, b1_bwd_bound(bh, n, r, h, b, 4, itemsize=isz), plain_iters=2)
        out[name] = {"fwd": (min(ms, ms2), plain_ms, bd), "bwd": bwd}
        del flat, dout, o, saved
        torch.cuda.empty_cache()
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    return out


def phase_timing_xm():
    """B1 at phase 12's shapes, bf16, kernel vs plain with CUDA events, each
    beside its bound at the operands' width: llava's serving prefill (one
    256-token block of 4 x 32 heads of 128, seeded with a state), llava's
    phase-1 shape (bh 128, n 2048, b 256), and Whisper's decoder in
    training (bh 80, n 512, h 64, b 256: 448 tokens padded), its backward
    there too. Returns {name: (ms, plain ms, bounds)}."""
    log("phase 4: B1 at phase 12's shapes, bf16 (CUDA events, warmed up)")
    before = counts()
    out = {}
    dt = torch.bfloat16
    for key, bh, n, h, b, z in (("llava prefill block", 128, 256, 128, 256, True),
                                ("llava", 128, 2048, 128, 256, False),
                                ("whisper train", 80, 512, 64, 256, False)):
        rnd = seeded(170)
        flat = [rnd(bh, n, 32, scale=0.5, dtype=dt), rnd(bh, n, 32, scale=0.5, dtype=dt)]
        flat += [rnd(bh, n, h, dtype=dt) for _ in range(3)]
        kw = dict(degree=4, scale=1.0 / h, block_size=b)
        z0 = ()
        if z:   # a state as a previous block leaves it
            _, zv, zd = pc.polysketch_causal_cuda(*flat, return_state=True, **kw)
            z0 = (zv, zd)
        run = lambda: pc.polysketch_causal_cuda(*flat, *z0, return_state=True, **kw)  # noqa: E731,B023
        ms = event_ms(run)
        plain_ms = event_ms(lambda: pc.polysketch_causal_torch(*flat, *z0, return_state=True,  # noqa: B023
                                                               **kw), iters=5, warmup=1)
        ms2 = event_ms(run)
        bd = b1_bound(bh, n, 32, h, b, 4, itemsize=2)
        out[key] = (min(ms, ms2), plain_ms, bd)
        log(f"  B1 {key} bh={bh} n={n} r=32 h={h} b={b} bf16: kernel {min(ms, ms2):.3f} ms "
            f"(runs {ms:.3f}, {ms2:.3f}), plain PyTorch {plain_ms:.3f} ms; bound "
            f"{bd.tc_ms:.3f} ms by {bd.tc_by} ({bd.flops / 1e9:.1f} GFLOP, "
            f"{bd.nbytes / 1e6:.1f} MB), {bd.tc_ms / min(ms, ms2):.1%} of it; library call: "
            f"{NO_LIBRARY}")
        if key == "whisper train":
            dout = rnd(bh, n, h, dtype=dt)
            o, _, _, saved = pc.polysketch_causal_cuda(*flat, return_saved=True, **kw)
            out["whisper train backward"] = time_backward(
                f"B1 backward whisper train bh={bh} n={n} r=32 h={h} b={b} bf16",
                lambda: pc.polysketch_causal_backward_cuda(dout, *flat, o, saved, **kw),  # noqa: B023
                lambda: pc.polysketch_causal_backward_torch(dout, *flat, o, saved, **kw),  # noqa: B023
                B1_BWD_PASSES, b1_bwd_bound(bh, n, 32, h, b, 4, itemsize=2), plain_iters=2)
            del dout, o, saved
        del flat, z0
        torch.cuda.empty_cache()
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    return out


def b2_bound(bh, n, h, degree, itemsize=4):
    """Causal B2 (n == t): per pair the products Q K^T and W V (4h), the
    scale, the power and the row sum; per row the normalisation. Bytes:
    q, k, v read once, out written once. TF32 products: three an f32
    product; with bf16 operands Q K^T on the bf16 tensor cores (BF16_PASS:
    both operands bf16) and W V two (W is f32)."""
    pairs = bh * n * (n + 1) // 2
    prod = pairs * 4 * h
    rest = pairs * (2 + pow_muls(degree)) + bh * n * (h + 2)
    tf32 = 3 * prod if itemsize == 4 else pairs * 2 * h * (BF16_PASS + 2)
    return bounds(prod, rest, 4 * bh * n * h * itemsize, tf32)


def b2_bwd_bound(bh, n, h, degree, itemsize=4):
    """Causal B2's backward as the function needs it, each product counted
    once: per pair S = Q K^T, dW = dNum V^T, dv, dq and dk (2h each); the
    rest per pair dS = p x^(p-1) scale dW, W = x^p, dDen's add and the mask,
    per row dNum, dDen and Delta. Bytes: q, k, v, out, dO (itemsize) and D
    read once, dq, dk and dv (itemsize) written once. TF32 products: three
    an f32 product; with bf16 q, k and v (itemsize 2) those whose operands
    are exact in TF32 need fewer: Q K^T on the bf16 tensor cores
    (BF16_PASS: both operands bf16), dNum V^T, dS Q and dS K two (dNum and
    dS are f32), W^T dNum three. csrc/poly_flash_bwd.cu forms
    each product once at h 64 (S and dW twice at h 128); it also reads and
    writes each dq row once per key tile at or before it (its ordered sum,
    through L2), which this count leaves out."""
    pairs = bh * n * (n + 1) // 2
    prod = pairs * 5 * 2 * h
    rest = pairs * (4 + pow_muls(degree - 1) + pow_muls(degree)) + bh * n * (3 * h + 2)
    tf32 = 3 * prod if itemsize == 4 else pairs * 2 * h * (BF16_PASS + 2 + 2 + 2 + 3)
    return bounds(prod, rest, bh * n * (8 * h * itemsize + 4), tf32)


def b3_bound(bh, n, m, k, b, itemsize=4):
    """B3 as the block algorithm needs it. Products: each block's triangle
    (2m for a score, 2k for its row of W C), the fold B^T C and the cross
    term A Z (2mk a row each); the rest: the prefix's adds over blocks.
    Bytes: A, B, C read once, O written once."""
    t = n // b
    pairs = t * b * (b + 1) // 2
    prod = bh * (pairs * (2 * m + 2 * k) + 4 * n * m * k)
    return bounds(prod, bh * t * m * k, bh * n * (2 * m + 2 * k) * itemsize)


def phase_timing_poly_lt():
    """B2 and B3 timed as phase 4 times B1: kernel, plain, kernel."""
    log("phase 4: B2 and B3 times at their paths' shapes (CUDA events, warmed up)")
    before = counts()
    out = {"poly_flash": {}, "lt_mult": {}}
    for n in (2040, 2048):
        q, k, v = (x.reshape(48, n, 64).contiguous() for x in poly_slice_inputs(n))
        kw = dict(degree=4, scale=1.0 / 64)
        ms = event_ms(lambda: pf.poly_flash_cuda(q, k, v, **kw))
        plain_ms = event_ms(lambda: pf.poly_flash_torch(q, k, v, **kw))
        ms2 = event_ms(lambda: pf.poly_flash_cuda(q, k, v, **kw))
        bd = b2_bound(48, n, 64, 4)
        out["poly_flash"][n] = (min(ms, ms2), plain_ms, bd)
        log(f"  B2 bh=48 n={n} h=64 p=4: kernel {min(ms, ms2):.3f} ms (runs {ms:.3f}, "
            f"{ms2:.3f}), plain PyTorch {plain_ms:.3f} ms; bound {bd.tc_ms:.3f} ms by "
            f"{bd.tc_by} on the tensor cores ({bd.flops / 1e9:.1f} GFLOP, "
            f"{bd.nbytes / 1e6:.1f} MB), {bd.tc_ms / min(ms, ms2):.1%} of it; f32-FMA bound "
            f"{bd.fma_ms:.3f} ms, {bd.fma_ms / min(ms, ms2):.1%} of it; library call: "
            f"{NO_LIBRARY}")
    for n in (2048, 16384):
        a, b, c = lt_bench_inputs(n)
        kw = dict(block_size=LT_BENCH["blk"])
        ms = event_ms(lambda: lt.lt_mult_cuda(a, b, c, **kw))
        plain_ms = event_ms(lambda: lt.lt_mult_torch(a, b, c, **kw))
        ms2 = event_ms(lambda: lt.lt_mult_cuda(a, b, c, **kw))
        bd = b3_bound(4, n, 32, 64, LT_BENCH["blk"])
        out["lt_mult"][n] = (min(ms, ms2), plain_ms, bd)
        log(f"  B3 bh=4 n={n} m=32 k=64 block=256: kernel {min(ms, ms2):.4f} ms (runs "
            f"{ms:.4f}, {ms2:.4f}), plain PyTorch {plain_ms:.4f} ms; bound {bd.tc_ms:.4f} "
            f"ms by {bd.tc_by} on the tensor cores ({bd.flops / 1e9:.3f} GFLOP, "
            f"{bd.nbytes / 1e6:.1f} MB), {bd.tc_ms / min(ms, ms2):.1%} of it; f32-FMA "
            f"bound {bd.fma_ms:.4f} ms by {bd.fma_by}, {bd.fma_ms / min(ms, ms2):.1%} of "
            f"it; library call: {NO_LIBRARY}")
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    return out


B2_BWD_PASSES = (("prep", "poly_flash_bwd_prep"),
                 ("key tiles (dk, dv, dq)", "poly_flash_bwd_kernel"))
# B2's backward kernel that should hold 8 warps an SM with no spills
B2_BWD_HEAVY = ("poly_flash_bwd_kernel",)


def phase_timing_b2_backward(ptxas):
    """B2's backward at the training shape (bh 24, n 4096, h 64, p 4): its
    kernels' occupancy, its time (time_backward), and B2's forward at the
    same shape with and without den_out."""
    kernel_occupancy("B2 backward kernels on the card (h 64, f32)", pf.backward_occupancy(64),
                     ptxas.get("poly_flash_bwd", {}), B2_BWD_HEAVY, inst=B2_BWD_INST[
                         ("float32", 64)])
    log("phase 4: B2 backward and forward time at the training shape (CUDA events, "
        "warmed up)")
    xs, dout = b2_grad_inputs(16, 2, 12, 12, TRAIN_SEQ, 64, 4)
    q, k, v, dout = (x.reshape(24, TRAIN_SEQ, 64).contiguous() for x in (*xs, dout))
    kw = dict(degree=4, scale=1.0 / 64)
    before = counts()
    out, den = pf.poly_flash_cuda(q, k, v, return_den=True, **kw)
    timing = time_backward(
        f"B2 backward bh=24 n={TRAIN_SEQ} h=64 p=4",
        lambda: pf.poly_flash_backward_cuda(dout, q, k, v, out, den, **kw),
        lambda: pf.poly_flash_backward_torch(dout, q, k, v, out, den, **kw),
        B2_BWD_PASSES, b2_bwd_bound(24, TRAIN_SEQ, 64, 4))
    fwd_ms = event_ms(lambda: pf.poly_flash_cuda(q, k, v, **kw))
    fwd_den_ms = event_ms(lambda: pf.poly_flash_cuda(q, k, v, return_den=True, **kw))
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    fbd = b2_bound(24, TRAIN_SEQ, 64, 4)
    log(f"  B2 forward at the same shape: {fwd_ms:.3f} ms, with den_out {fwd_den_ms:.3f} ms; "
        f"bound {fbd.tc_ms:.3f} ms ({fbd.tc_ms / fwd_ms:.1%} of it)")
    return timing


def phase_timing_long():
    """The four training kernels at the 32k training shape (bh 12,
    n 32768, h 64; B1 at b 1024, r 32): kernel, plain, kernel with CUDA
    events (the plain versions 3 times), the backwards per pass, each
    beside its bound. Returns {kernel: (ms, plain ms, bounds)}."""
    log(f"phase 4: B1 and B2, forward and backward, at the 32k training shape (bh 12, "
        f"n {LONG_TOKENS}, h 64; CUDA events, warmed up)")
    before = counts()
    n, out = LONG_TOKENS, {}
    xs, dout = long_kernel_inputs()
    flat = [x.reshape(12, n, -1).contiguous() for x in xs]
    dout = dout.reshape(12, n, -1).contiguous()
    kw = dict(degree=4, scale=1.0 / 64, block_size=1024)

    def fwd_row(name, run, plain, bd):
        ms = event_ms(run, iters=5, warmup=1)
        plain_ms = event_ms(plain, iters=3, warmup=1)
        ms2 = event_ms(run, iters=5, warmup=1)
        out[name] = (min(ms, ms2), plain_ms, bd)
        log(f"  {name} bh=12 n={n}: kernel {min(ms, ms2):.3f} ms (runs {ms:.3f}, {ms2:.3f}), "
            f"plain PyTorch {plain_ms:.3f} ms; bound {bd.tc_ms:.3f} ms by {bd.tc_by} on the "
            f"tensor cores ({bd.flops / 1e9:.1f} GFLOP, {bd.nbytes / 1e6:.1f} MB), "
            f"{bd.tc_ms / min(ms, ms2):.1%} of it; f32-FMA bound {bd.fma_ms:.3f} ms; "
            f"library call: {NO_LIBRARY}")

    fwd_row("polysketch_causal",
            lambda: pc.polysketch_causal_cuda(*flat, return_saved=True, **kw),
            lambda: pc.polysketch_causal_torch(*flat, return_saved=True, **kw),
            b1_bound(12, n, 32, 64, 1024, 4))
    o, _, _, saved = pc.polysketch_causal_cuda(*flat, return_saved=True, **kw)
    out["polysketch_causal_backward"] = time_backward(
        f"B1 backward bh=12 n={n} r=32 h=64 b=1024",
        lambda: pc.polysketch_causal_backward_cuda(dout, *flat, o, saved, **kw),
        lambda: pc.polysketch_causal_backward_torch(dout, *flat, o, saved, **kw),
        B1_BWD_PASSES, b1_bwd_bound(12, n, 32, 64, 1024, 4), plain_iters=3)
    del xs, flat, o, saved
    xs, dout = b2_grad_inputs(32, 1, 12, 12, n, 64, 4)
    q, k, v, dout = (x.reshape(12, n, 64).contiguous() for x in (*xs, dout))
    kw = dict(degree=4, scale=1.0 / 64)
    fwd_row("poly_flash", lambda: pf.poly_flash_cuda(q, k, v, return_den=True, **kw),
            lambda: pf.poly_flash_torch(q, k, v, return_den=True, **kw),
            b2_bound(12, n, 64, 4))
    o, den = pf.poly_flash_cuda(q, k, v, return_den=True, **kw)
    out["poly_flash_backward"] = time_backward(
        f"B2 backward bh=12 n={n} h=64 p=4",
        lambda: pf.poly_flash_backward_cuda(dout, q, k, v, o, den, **kw),
        lambda: pf.poly_flash_backward_torch(dout, q, k, v, o, den, **kw),
        B2_BWD_PASSES, b2_bwd_bound(12, n, 64, 4), plain_iters=3)
    for name, fn in KERNELS.items():   # timing launches do not count
        fn.launches = before[name]
    torch.cuda.empty_cache()
    return out


# (pass, a substring of its kernels' names)
LT_PASSES = (("fold", "fold"), ("prefix", "prefix"), ("outputs", "output"))


def profile_passes(run, passes, calls=20):
    """Device time per pass per call (ms) of `run` from torch.profiler over
    `calls` calls after 3 warm-up calls, each kernel counted under the
    first pass in `passes` whose key its name holds."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    per_pass = {name: 0.0 for name, _ in passes}
    for e in device_rows(prof):
        name = next((p for p, key in passes if key in e.key), None)
        if name is None:
            raise AssertionError(f"profile: unexpected device kernel {e.key!r}")
        per_pass[name] += dev_us(e) / 1e3 / calls
    return per_pass


def lt_mult_breakdown(fn, n, passes=LT_PASSES, calls=20, host_calls=100):
    """B3's wrapper `fn` at kernel_bench's shape: device time per pass per
    call (ms, profile_passes); and the host's time per call (ms), wall
    clock over `host_calls` calls issued without a sync, beside the CUDA
    events' time over the same calls."""
    a, b, c = lt_bench_inputs(n)
    run = lambda: fn(a, b, c, block_size=LT_BENCH["blk"])  # noqa: E731
    per_pass = profile_passes(run, passes, calls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(host_calls):
        run()
    host_ms = (time.perf_counter() - t0) * 1e3 / host_calls
    end.record()
    torch.cuda.synchronize()
    return per_pass, host_ms, start.elapsed_time(end) / host_calls


def phase_lt_mult_breakdown():
    log("phase 4: B3 per pass (torch.profiler device time per call) and host time per "
        "call (wall clock over 100 calls without sync, against CUDA events)")
    before = lt.lt_mult_cuda.launches
    for n in (2048, 16384):
        passes, host_ms, event_ms_ = lt_mult_breakdown(lt.lt_mult_cuda, n)
        log(f"  B3 n={n}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
            + f"; device sum {sum(passes.values()):.4f} ms; host {host_ms:.4f} ms per "
            f"call, CUDA events {event_ms_:.4f} ms per call")
    lt.lt_mult_cuda.launches = before   # timing launches do not count


def build_kernels():
    """Build every kernel from this checkout (one nvcc a source, in
    parallel) and log each kernel's registers and spills. Returns {source:
    {kernel (name and mangled template arguments): {"spill_stores",
    "spill_loads"}}} from ptxas -v."""
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s, nvcc per source: "
        + ", ".join(f"{n} {b.seconds:.1f} s" for n, b in libs.items()))
    ptxas = {}
    for name, built in libs.items():
        kernel = "?"
        for line in built.log.splitlines():
            entry = re.search(r"\d([a-z_]+_kernel|grad_[a-z_]+)(I\w*?EE)?\w*' for", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if entry:
                kernel = entry.group(1) + (entry.group(2) or "")
            elif "registers" in line or "spill" in line:
                log(f"  {name} {kernel}: {line.split(':', 1)[-1].strip()}")
            if spill and not entry:
                ptxas.setdefault(name, {})[kernel] = {"spill_stores": int(spill.group(1)),
                                                      "spill_loads": int(spill.group(2))}
    return ptxas


def xm_json(name, rows, times, errs):
    """Phase 12's part of B1's (or its backward's) row in the JSON line:
    the time at each shape beside its plain version and its bound (phase
    4), the bf16 errors against the plain version (phase 1), and the
    launches on the served and trained paths."""
    bwd = name == "polysketch_causal_backward"
    shapes = ({"whisper train backward": "bh 80, n 512 (448 padded), r 32, h 64, b 256"}
              if bwd else
              {"llava prefill block": "bh 128, n 256, r 32, h 128, b 256, seeded z0",
               "llava": "bh 128, n 2048, r 32, h 128, b 256",
               "whisper train": "bh 80, n 512 (448 padded), r 32, h 64, b 256"})
    out = {"times_bf16": {k: {"shape": v, "ms": times[k][0], "plain_ms": times[k][1],
                              "bound_ms": times[k][2].tc_ms, "bound_by": times[k][2].tc_by}
                          for k, v in shapes.items()},
           "max_err_bf16": errs["bfloat16"][1 if bwd else 0],
           "launches": {"train": {r["arch"]: r["launches"][name] for r in rows["train"]}}}
    if not bwd:
        out["launches"]["serve"] = {r["arch"]: r["b1_launches"] for r in rows["serve"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-long-context", action="store_true",
                    help="phase 6: profile a step at each model's shortest and longest "
                         "context (about 3 minutes more)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    ptxas = build_kernels()

    max_err = phase_kernel_grid()
    bwd_err = phase_b1_backward_grid()
    b2_err = phase_poly_flash_grid()
    b2_bwd_err = phase_b2_backward_grid()
    b2_wide = phase_b2_backward_wide(ptxas)
    long_errs = phase_long_kernels()
    h128_errs = phase_b1_h128_grid(card)
    xm_errs = phase_b1_xm_grid(card)
    max_err = max(max_err, long_errs["polysketch_causal"], h128_errs["float32"][0],
                  xm_errs["float32"][0])
    bwd_err = max(bwd_err, h128_errs["float32"][1], xm_errs["float32"][1])
    bwd_err = max(bwd_err, long_errs["polysketch_causal_backward"])
    b2_err = max(b2_err, long_errs["poly_flash"])
    b2_bwd_err = max(b2_bwd_err, long_errs["poly_flash_backward"])
    b3_err = phase_lt_mult_grid()
    phase_tolerance_study()
    model = build_model(get_config("gpt2s-polysketch"), device="cuda", seed=0)
    launches, prompts = phase_serve(model)
    phase_self_checks(model, prompts)
    b1_engine = phase_engine(model, "polysketch_causal")
    b1_prefix = phase_prefix_cache(model, card)
    del model
    gc.collect()            # engines hold reference cycles (metric callbacks)
    torch.cuda.empty_cache()
    poly = build_model(GPT2_SMALL_POLY4, device="cuda", seed=0)
    b2_launches = phase_serve_kv(poly, prompts, "poly_flash")
    phase_poly_self_checks(poly, prompts)
    b2_engine = phase_engine(poly, "poly_flash")
    del poly
    gc.collect()
    torch.cuda.empty_cache()
    soft = build_model(GPT2_SMALL_SOFTMAX, device="cuda", seed=0)
    phase_serve_kv(soft, prompts)
    phase_softmax_self_checks(soft)
    phase_engine(soft)
    del soft
    gc.collect()
    torch.cuda.empty_cache()
    b3_launches = phase_lt_mult_path()
    train_cfg = get_config("gpt2s-polysketch")
    batches = train_batches(train_cfg, 5)   # one stream: the three share the vocabulary
    bwd_launches, _, _ = phase_train(train_cfg, batches,
                                     ("polysketch_causal", "polysketch_causal_backward"))
    torch.cuda.empty_cache()
    phase_train_checks(train_cfg, batches)
    torch.cuda.empty_cache()
    phase_remat_gate(train_cfg)
    b2_bwd_launches, _, _ = phase_train(GPT2_SMALL_POLY4, batches,
                                        ("poly_flash", "poly_flash_backward"))
    torch.cuda.empty_cache()
    phase_train_checks(GPT2_SMALL_POLY4, batches, "poly_attention")
    torch.cuda.empty_cache()
    phase_remat_gate(GPT2_SMALL_POLY4)
    phase_train(GPT2_SMALL_SOFTMAX, batches)
    del batches
    torch.cuda.empty_cache()
    phase_remat_gate(GPT2_SMALL_SOFTMAX)
    b1_times = phase_timing()
    bwd_times = phase_timing_backward(ptxas)
    phase_timing_forward(ptxas)
    times = phase_timing_poly_lt()
    b2_bwd_times = phase_timing_b2_backward(ptxas)
    phase_lt_mult_breakdown()
    long_times = phase_timing_long()
    t6 = time.perf_counter()
    long_rows, long_launches = {}, dict.fromkeys(KERNELS, 0)
    for cfg, kernels in ((train_cfg, ("polysketch_causal", "polysketch_causal_backward")),
                         (GPT2_SMALL_POLY4, ("poly_flash", "poly_flash_backward")),
                         (GPT2_SMALL_SOFTMAX, ())):
        long_rows[cfg.name], launched = phase_long_context(cfg, kernels,
                                                           args.profile_long_context)
        for k, v in launched.items():
            long_launches[k] += v
    log(f"phase 6: {time.perf_counter() - t6:.1f} s for the three models")
    log(json.dumps({"long_context": long_rows}))
    h128_times = phase_timing_h128(ptxas)
    xm_times = phase_timing_xm()
    dense_rows = [phase_dense_serve(arch, card, profile=arch == "starcoder2-3b")
                  for arch in DENSE_ARCHS]
    dense_train = phase_dense_train(card)
    log(json.dumps({"dense_serve": dense_rows, "dense_train": dense_train}))
    gc.collect()
    torch.cuda.empty_cache()
    phase_recurrent(card)
    gc.collect()
    torch.cuda.empty_cache()
    moe_rows = phase_moe(card)
    gc.collect()
    torch.cuda.empty_cache()
    xm_rows = phase_xm(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_all = phase_train_all(card)
    gc.collect()
    torch.cuda.empty_cache()
    replicas = phase_replicas(card)
    gc.collect()
    torch.cuda.empty_cache()
    tp = phase_tp(card)
    gc.collect()
    torch.cuda.empty_cache()
    ep = phase_ep(card)
    tp_launches = {
        "polysketch_causal": {
            "serve_1x2": tp["serve_1x2"]["b1_launches"],
            "serve_2x1": tp["serve_2x1"]["b1_launches"],
            "train_1x2": [r["train_1x2"]["launches"]["polysketch_causal"]
                          for r in tp["ranks"]]},
        "polysketch_causal_backward": {
            "train_1x2": [r["train_1x2"]["launches"]["polysketch_causal_backward"]
                          for r in tp["ranks"]]},
        "poly_flash": {"serve_1x2": [r["poly4_1x2"]["launches"]["poly_flash"]
                                     for r in tp["ranks"]]}}
    dense_launches = {
        "polysketch_causal": {"serve": sum(r["b1_launches"] for r in dense_rows),
                              "train": dense_train["launches"]["polysketch_causal"]},
        "polysketch_causal_backward": {
            "serve": 0, "train": dense_train["launches"]["polysketch_causal_backward"]}}

    engine_launches = {"polysketch_causal": b1_engine, "poly_flash": b2_engine}

    def row(name, replaces, launches, max_abs_err, timing, source=None):
        t_ms, t_plain, bd = timing
        out = {"name": name, "route": "cuda", "status": "ok",
               "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
               "replaces": replaces, "launches": launches,
               "engine_launches": engine_launches.get(name, 0),
               "max_abs_err": max_abs_err, "ms": t_ms, "plain_ms": t_plain,
               "bound_ms": bd.tc_ms, "bound_by": bd.tc_by, "bound_fma_ms": bd.fma_ms,
               "library_ms": None}
        if name == "polysketch_causal":   # phase 9: the prefix cache's path
            out["prefix_cache_launches"] = b1_prefix
        if name in replicas["replica_launches"]:   # phase 14: the replicated runs
            out["replica_launches"] = replicas["replica_launches"][name]
        if name in tp_launches:   # phase 15: each of the two ranks' launches
            out["tp_launches_a_rank"] = tp_launches[name]
        if name in tp["kernel_err"]:   # phase 15: at a rank's share of the heads
            out["tp_max_abs_err"] = tp["kernel_err"][name]
        if name in ep["kernel_err"]:   # phase 16: dbrx's experts split over two ranks
            out["ep_launches_a_rank"] = [r["launches"][name] for r in ep["ranks"]]
            out["ep_1x1_launches"] = ep["base"]["launches"][name]
            out["ep_max_abs_err"] = ep["kernel_err"][name]
        if name in dense_launches:   # the dense models at h 128, bf16
            key = "fwd" if name == "polysketch_causal" else "bwd"
            h_ms, h_plain, h_bd = h128_times["bfloat16"][key]
            out["h128_bf16"] = {"shape": "bh 24, n 4096, r 32, h 128, b 256", "ms": h_ms,
                                "plain_ms": h_plain, "bound_ms": h_bd.tc_ms,
                                "bound_by": h_bd.tc_by,
                                "launches": dense_launches[name],
                                "max_abs_err_bf16": h128_errs["bfloat16"][
                                    0 if name == "polysketch_causal" else 1]}
        if name == "polysketch_causal":   # phase 11: the MoE models, h 128, bf16
            m_ms, m_plain, m_bd, m_err = moe_rows["b1"]
            out["moe_bf16"] = {"shape": "bh 48, n 2048, r 32, h 128, b 256", "ms": m_ms,
                               "plain_ms": m_plain, "bound_ms": m_bd.tc_ms,
                               "bound_by": m_bd.tc_by, "max_abs_err_bf16": m_err,
                               "launches": {"serve": [r["b1_launches"]
                                                      for r in moe_rows["serve"]],
                                            "train": moe_rows["train"]["launches"]}}
        if name == "polysketch_causal_backward":
            out["moe_train_launches"] = moe_rows["train"]["launches"][name]
        if name in ("polysketch_causal", "polysketch_causal_backward"):
            # phase 12: llava (h 128, GQA 4:1) and Whisper's decoder (h 64), bf16
            out["vlm_audio"] = xm_json(name, xm_rows, xm_times, xm_errs)
        if name in ("poly_flash", "poly_flash_backward"):
            # phase 13: exact polynomial attention trained in bf16 (h 64, 128)
            out["train_bf16_launches"] = {r["name"]: r["launches"][name]
                                          for r in train_all["poly_bf16"]}
        if name == "poly_flash_backward":   # phase 1 and 4: bf16 and h 128
            out["bf16_h128"] = {
                f"{dt} h {h}": {"shape": f"bh 24, n {TRAIN_SEQ}, h {h}, p 4",
                                "ms": r["ms"], "plain_ms": r["plain_ms"],
                                "bound_ms": r["bound"].tc_ms, "bound_by": r["bound"].tc_by,
                                "max_abs_err": r["abs"], "max_rel_err": r["rel"]}
                for (dt, h), r in b2_wide.items()}
        if name in long_times:
            l_ms, l_plain, l_bd = long_times[name]
            out["long_context"] = {"shape": f"bh 12, n {LONG_TOKENS}", "ms": l_ms,
                                   "plain_ms": l_plain, "bound_ms": l_bd.tc_ms,
                                   "bound_by": l_bd.tc_by,
                                   "launches": long_launches[name]}
        return out

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the kernels' build "
        f"included")
    log(card)                     # as nvidia-smi prints it: name, power limit
    log(json.dumps({"kernels": [
        row("polysketch_causal", "src/repro/kernels/polysketch_causal.py:118",
            launches, max_err, b1_times[2048]),
        row("polysketch_causal_backward", "src/repro/core/linear_attention.py:35",
            bwd_launches, bwd_err, bwd_times, source="polysketch_causal_bwd"),
        row("poly_flash", "src/repro/kernels/poly_flash.py:59", b2_launches, b2_err,
            times["poly_flash"][2040]),
        row("poly_flash_backward", "src/repro/core/poly_attention.py:33", b2_bwd_launches,
            b2_bwd_err, b2_bwd_times, source="poly_flash_bwd"),
        row("lt_mult", "src/repro/kernels/lt_mult.py:45", b3_launches, b3_err,
            times["lt_mult"][16384])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
