"""Continuous-batching serve engine over the DecodeState protocol.

Port of the JAX package's ``serve/engine.py``: ``make_serve_fns``,
``generate`` (greedy or sampled) and ``ServeEngine``. The engine speaks
only the DecodeState protocol (core.state), so the same slot machinery
serves every state kind the port has: polysketch (constant-size), the
full KV caches of exact polynomial and softmax attention, and the
recurrent families' SSD, RG-LRU and sliding-window ring states.

The engine keeps a fixed number of decode *slots*. The slots' caches are
stacked on the batch axis of one model cache (core.decode's slot
helpers), with one position per slot, so every slot sits at its own
depth. Admission runs through the chunked prefill scheduler
(serve/scheduler.py): each tick dispatches at most a ``prefill_budget``
of prompt tokens before the decode tick, so a long polysketch prompt
admits across ticks. A finished prefill (a batch-1
core.state.PartialPrefill) is written into its free slot; live slots are
never touched. Decode runs all slots in one batched step; free slots
decode along on stale state (their outputs are never read, and admission
rewrites the whole slot) until the queue refills them.

The reference's tick maps its decode step over the slots (``jax.vmap``),
so an MoE layer routes each slot's token as a call of its own, where
capacity never drops one; the port's tick runs the slots as one batch
under ``moe.each_row_alone``, which routes them so (a
batched call would couple them through capacity). ``generate`` batches
its rows into one call, as the reference's does.

The decode tick has no host sync inside it: the model step, sampling,
the slot updates and the packing of its tokens (and log-probabilities)
run on the device, and the tokens reach the host in one copy a tick.
Every host-to-device write in admission and in the tick is a fill with a
Python scalar or a copy from pinned memory. With ``overlap=True`` that
copy is non-blocking, into pinned memory behind a CUDA event, and the
host reads it one tick late, as the reference does: the device computes
tick N while the host accounts tick N-1. A slot that retired in between
drops its speculative token (its request id no longer matches), so the
emitted tokens are the lockstep engine's.

The engine owns its slot-stacked state and updates it in place (the
reference donates it); the protocol-level functions keep value
semantics.

With a ``PrefixCache`` attached (legal when the model's
``snapshot_granularity`` is not None: polysketch, or the recurrent
kinds), admission looks up the longest cached prefix of each prompt,
restores its snapshot and prefills only the rest (for polysketch, seeding
B1 with the restored state); a shared system prompt
costs its prefill once, then a dictionary lookup, across restarts too
when the cache has a ``save_dir``. Tokens are the same bits as a cold
prefill's (the block grid, core.state).

Observability (serve/telemetry.py): the registry is the accounting; with
``Telemetry(trace=True)`` the tracer records tick phases, per-slot
request timelines and cache events; the retrace watchdog counts new call
signatures of the engine's entry points and kernel builds after warm-up.

Failover (serve/replicas.py drives it): ``slot_covered`` and
``snapshot_slot`` export a decoding slot's state at block boundaries,
``live_requests`` is the host view a coordinator mirrors, and
``admit_recovered`` re-homes a request whose replica died so that its
remaining tokens are the bits the dead replica would have emitted: the
deepest usable checkpoint is restored, the prompt tokens past it are
prefilled on the block grid, and the emitted tokens are replayed through
the live tick's own decode step at the engine's slot width (cuBLAS picks
its kernel, and so its reduction order, by shape, so a batch-1 replay
could round otherwise). ``drain_checkpoints`` is the SIGTERM path.

An engine runs under a ``ServePlan`` (serve/plan.py) on its device. On a
plan over a D x M mesh the engine runs SPMD: every rank runs this loop
over the same submissions, and every host decision (admission, the
scheduler's plans, the prefix cache's index, the slots' host mirror and
the stats) is the same on every rank. Data rank d holds its share of the
slot stack (``plan.slot_range``) and runs the prefill chunks and decode
ticks of its own slots only, with its "model" peers, each on its own
heads. A snapshot a prefill makes is gathered whole over "model" and
broadcast over "data" from the slot's data rank, so every rank's prefix
cache stores the same whole snapshot (restored to each rank's heads). At
the host sync each tick's tokens and log-probabilities (and its
admissions' first tokens) are all-gathered over "data"
(``_GatheredCopy``: the "collective" span inside host_sync,
``serve_collective_ms``). ``decision_digest`` hashes the host state that
must agree across ranks. Failover (``admit_recovered``) stays on
single-device plans: a ReplicaSet places each replica itself.
"""
from __future__ import annotations

import hashlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import decode as dec
from repro_torch.core.state import bucket_chunks
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import build
from repro_torch.models import moe
from repro_torch.serve.plan import ServePlan
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampling import (SamplingParams, advance_key,
                                        device_scalars, init_slot_keys,
                                        init_slot_sampling, request_key,
                                        sample_first, sample_step, set_slot,
                                        token_logprobs)
from repro_torch.serve.scheduler import PrefillScheduler, to_device
from repro_torch.serve.telemetry import CallSignatures, Telemetry

def make_serve_fns(model):
    """Returns (prefill_fn, decode_fn), the single-shot serving functions,
    batch-dict based as the reference's, so that a VLM's image_embeds and
    an encoder-decoder's frames prefill through the same path.

    prefill_fn(batch)                   -> (last_logits, cache)
    decode_fn(tokens, cache, positions) -> (logits, cache)   tokens (B, 1)

    `batch` is {"tokens": (B, S), and "image_embeds" (B, n_img, D) or
    "frames" (B, T, D) where the model takes them}, or the tokens alone.
    The cache is sized to the prompt (the reference's shape cells), and
    `positions` is an int shared by the batch or a (B,) tensor. A model
    with a DecodeState prefills through it (on the block grid, each call
    spliced with its own image rows); one without (Whisper) runs its
    prefill in one call, encoding the frames, and reads the memory's k
    and v from the cache in each decode step.
    """
    state, lm = model.state, model.lm

    def batch_of(batch):
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                    ).to(model.device) for k, v in batch.items()}

    @torch.inference_mode()
    def prefill(batch):
        batch = batch_of(batch)
        tokens = batch["tokens"].long()
        if state is not None:
            return state.prefill(tokens, max_len=tokens.shape[1],
                                 image_embeds=batch.get("image_embeds"))
        cache = lm.init_cache(tokens.shape[0], tokens.shape[1])
        logits, cache = lm(tokens, frames=batch.get("frames"), mode="prefill",
                           cache=cache)
        return logits[:, -1], cache

    @torch.inference_mode()
    def decode(tokens, cache, positions):
        if state is not None:
            return state.decode_step(tokens, positions, cache)
        positions = (positions.reshape(-1, 1) if torch.is_tensor(positions)
                     else torch.full((1,), positions, dtype=torch.long,
                                     device=tokens.device))
        logits, cache = lm(tokens, mode="decode", cache=cache,
                           positions=positions)
        return logits[:, -1], cache

    return prefill, decode


def _decode_state(model, what: str):
    """The model's DecodeState; NotImplementedError for a model without
    one (the encoder-decoder), as the reference's engine refuses it."""
    if model.state is None:
        raise NotImplementedError(
            f"{model.cfg.name!r} exposes no DecodeState; {what} serves "
            "decode-state models only (serve it through make_serve_fns)")
    return model.state


class GenerationResult(NamedTuple):
    tokens: torch.Tensor       # (B, steps)
    logits_last: torch.Tensor  # (B, V) logits after the last decode step


def _row_keys(seed: int, rows: int, device) -> torch.Tensor:
    """request_key(seed, r) for every row, made on the CPU and copied once."""
    keys = torch.stack([request_key(seed, r) for r in range(rows)])
    return keys.to(device)


@torch.inference_mode()
def generate(model, prompt, steps: int, *, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             sampling: SamplingParams | None = None,
             max_len: int | None = None) -> GenerationResult:
    """Sampling loop on the DecodeState protocol. prompt: (B, S0) ints
    (tensor or numpy).

    Batch row r draws the PRNG stream `request_key(seed, r)` and advances
    it by one split per emitted token, exactly like a ServeEngine slot, so
    `generate(..., sampling=sp).tokens[0]` is a single-slot engine run of
    the same `(seed, prompt, SamplingParams)`. Token i is sampled from the
    logits after token i-1 (the prefill's last position for i = 0), then
    fed back through decode_step at position S0 + i, with the position
    shared by the batch.
    """
    state = _decode_state(model, "generate()")
    sp = sampling or SamplingParams(temperature=temperature, top_k=top_k,
                                    top_p=top_p, seed=seed)
    dev = model.device
    if isinstance(prompt, np.ndarray):
        prompt = torch.from_numpy(prompt)
    prompt = prompt.to(device=dev, dtype=torch.long)
    bsz, s0 = prompt.shape
    max_len = max_len or (s0 + steps)
    if s0 + steps > max_len:
        raise ValueError(
            f"prompt({s0}) + steps({steps}) exceeds max_len={max_len}")
    last, cache = state.prefill(prompt, max_len=max_len)
    if not sp.is_greedy:
        keys = _row_keys(sp.seed, bsz, dev)
        samp = device_scalars(sp, bsz, dev)
    toks = []
    for i in range(steps):
        if sp.is_greedy:
            tok = torch.argmax(last, dim=-1)
        else:
            tok, keys = sample_step(keys, last, *samp)
        toks.append(tok)
        last, cache = state.decode_step(tok[:, None], s0 + i, cache)
    tokens = (torch.stack(toks, dim=1) if toks
              else prompt.new_zeros((bsz, 0)))
    return GenerationResult(tokens=tokens, logits_last=last)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int64, host-resident
    max_new_tokens: int
    eos_id: int | None = None
    submit_time: float = 0.0
    sampling: SamplingParams = field(default_factory=SamplingParams)


@dataclass
class RequestOutput:
    rid: int
    tokens: np.ndarray           # (n_generated,) int32, includes EOS if hit
    prompt_len: int
    finish_reason: str           # "eos" | "length"
    ttft_s: float = 0.0          # submit -> first token
    latency_s: float = 0.0       # submit -> retirement
    decode_steps: int = 0
    logprobs: np.ndarray | None = None  # (n_generated,) f32, engine opt-in


@dataclass
class RecoveredRequest:
    """Host record of an in-flight request re-homed after its replica died
    (serve/replicas.py builds it from its mirror: the stream a client has
    already seen). `snapshot` is the deepest usable checkpoint, taken at
    `snap_tokens` stream tokens; recovery is right without one too (a
    cold prompt prefill and a full replay), a checkpoint only shortens the
    replay."""
    prompt: np.ndarray
    emitted: list[int]
    lps: list[float]
    max_new_tokens: int
    eos_id: int | None
    sampling: SamplingParams
    submit_time: float
    ttft_s: float = 0.0
    snapshot: object = None
    snap_tokens: int = 0


@dataclass
class _Slot:
    request: Request | None = None
    prefilling: bool = False     # reserved: prefill in flight, not decoding
    emitted: list[int] = field(default_factory=list)
    lps: list[float] = field(default_factory=list)
    ttft_s: float = 0.0
    last_tok_s: float | None = None  # inter-token latency tracking
    pos0: int = 0                # the slot's position at install (the prompt
                                 # length, or the rebuilt one after failover)
    ticks: int = 0               # decode ticks dispatched since install

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def decoding(self) -> bool:
        return self.request is not None and not self.prefilling


class _HostCopy:
    """One device-to-host copy of a (2, n) float64 tensor: rows are token
    ids and log-probabilities (both exact in float64). On a card the copy
    goes into pinned memory without blocking, behind a CUDA event; `read`
    waits for that event only."""

    def __init__(self, packed: torch.Tensor):
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = packed, None

    def read(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _GatheredCopy:
    """The host copy of a tick on a data-sharded plan: each data rank's
    (2, n_local + F) packing (its slots' tokens, then the admissions'
    first tokens, zeros where another data rank owns the slot),
    all-gathered over "data" when read, and merged into the one-device
    layout (2, slots + F): every slot's column from its data rank, each
    first token from its owner's. `read` is the tick's collective: it is
    timed into the engine's collective histogram and traced as the
    "collective" span."""

    def __init__(self, packed: torch.Tensor, engine, n_local: int, owners: list):
        self.packed, self.engine = packed, engine
        self.n_local, self.owners = n_local, owners

    def read(self) -> np.ndarray:
        eng = self.engine
        tr = eng.telemetry.tracer
        t0 = time.perf_counter()
        if tr:
            tr.begin("tick", "collective", mesh=eng.plan.describe())
        got = eng.plan.gather_data(self.packed).cpu().numpy()  # jaxlint: disable=host-sync-in-jit-path -- the tick's one host sync, read one tick late under overlap
        if tr:
            tr.end("tick")
        eng._m_collective.observe((time.perf_counter() - t0) * 1e3)
        n = self.n_local
        cols = [got[d][:, :n] for d in range(got.shape[0])]
        cols += [got[o][:, n + i:n + i + 1] for i, o in enumerate(self.owners)]
        return np.concatenate(cols, axis=1)


@dataclass
class _TickRecord:
    """One dispatched decode tick, not yet read (the overlap pipeline's
    double buffer). `rids` pins which request occupied each slot at
    dispatch; `firsts` are admissions whose first token rides this copy,
    as (slot, rid, column)."""
    copy: _HostCopy
    active: np.ndarray
    rids: list
    firsts: list
    t_dispatch: float


class ServeEngine:
    """Continuous-batching engine over fixed decode slots.

    Requests are admitted into free slots: each prefill runs at the
    request's own prompt length (in block-grid chunks for a resumable
    kind), and the batch-1 state is written into its slot without
    disturbing live slots. All slots then decode together; each stops on
    EOS or its max-new-tokens budget.

    Decoding is per-request `SamplingParams` (greedy by default): the
    per-slot params and PRNG keys are device state, so one tick samples
    every slot with its own params. Tokens depend only on `(seed, prompt,
    SamplingParams)`, never on slot placement or admission order (at a
    fixed slot count, so the batched products keep their shapes), and
    match `generate(..., sampling=sp)`. A tick whose decoding slots are
    all greedy (known on the host) skips the sampler, as the reference's
    `lax.cond` does.

    `logprobs=True` also reports the log-probability of each emitted
    token under the raw distribution, computed in the tick.
    `prefill_budget` (prompt tokens a tick, None = unlimited) bounds the
    admission work dispatched ahead of each decode step; `overlap=True`
    reads tokens one tick late (see the module docstring).

    `prefix_cache` attaches a PrefixCache (see the module docstring);
    `min_snapshot_blocks` is its admission floor: only prefixes of at
    least that many blocks are snapshotted or promoted. `telemetry`
    carries the registry, tracer, watchdog and memory sampler; the default
    `Telemetry()` keeps tracing and memory sampling off. One Telemetry
    per engine. `plan` (serve/plan.py, default the model's device) names
    the device the engine serves on; a model elsewhere is copied there.
    """

    def __init__(self, model, *, slots: int = 4, max_len: int = 4096,
                 prefix_cache: PrefixCache | None = None,
                 min_snapshot_blocks: int = 1, logprobs: bool = False,
                 prefill_budget: int | None = None, overlap: bool = False,
                 telemetry: Telemetry | None = None,
                 plan: ServePlan | None = None):
        _decode_state(model, "ServeEngine")
        self.plan = plan if plan is not None else ServePlan.single_device(
            model.device)
        whole = model
        self._mesh = self.plan.n_devices > 1
        self._lo, self._hi = self.plan.slot_range(slots)
        model = self.plan.place(model)
        state = model.state
        if slots < 1:
            raise ValueError("need at least one decode slot")
        if min_snapshot_blocks < 1:
            raise ValueError("min_snapshot_blocks must be >= 1")
        self.model = model
        self.cfg = model.cfg
        self.state = state
        self.device = dev = model.device
        self.slots = slots
        self.max_len = max_len
        self.min_snapshot_blocks = min_snapshot_blocks
        self.logprobs = logprobs
        self.overlap = overlap
        self.queue: deque[Request] = deque()
        # failover re-admissions waiting for a free slot, served ahead of
        # the queue (a recovered request already carries latency)
        self._recover_pending: deque[tuple[Request, RecoveredRequest]] = \
            deque()
        self.finished: list[RequestOutput] = []
        self._next_rid = 0
        self._slots = [_Slot() for _ in range(slots)]
        self._pending: _TickRecord | None = None  # overlap double buffer
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        tr = self.telemetry.tracer

        # Device state: the slot-stacked cache (batch axis = slots, one
        # position each), the next token to feed each slot, each slot's
        # position for RoPE, its PRNG key and sampling params, and the
        # dispatch-time mask of decoding slots (kept by fills).
        # On a data-sharded plan they hold this data rank's slots only.
        local = self._hi - self._lo
        with torch.inference_mode():
            self._caches = state.broadcast_slots(state.init_slot(max_len),
                                                 local)
            self._tokens = torch.zeros((local, 1), dtype=torch.long,
                                       device=dev)
            self._pos = torch.zeros(local, dtype=torch.long, device=dev)
            self._keys = init_slot_keys(local, dev)
            self._samp = init_slot_sampling(local, dev)
            self._active = torch.zeros(local, dtype=torch.bool, device=dev)
        self._active_host = np.zeros(local, dtype=bool)

        self.prefix_cache = prefix_cache
        if prefix_cache is not None:
            if state.snapshot_granularity is None:
                raise ValueError(
                    "prefix cache requires a snapshot-capable decode state "
                    f"(config {self.cfg.name!r}, state kinds "
                    f"{'/'.join(state.kinds)} declare no constant-size "
                    "snapshot)")
            prefix_cache.bind_block_size(state.block_size)
            # snapshots are weight- and shape-specific: the binding
            # fingerprints the snapshot leaves' shapes, read from a fresh
            # slot's state (a ring's window is min(sliding_window,
            # max_len), so engines that differ in max_len may not share)
            sig = repr(state.snapshot_signature(max_len)).encode()
            # the whole weights: the same fingerprint on every mesh
            prefix_cache.bind_params(whole.lm, state_sig=sig)
            prefix_cache.bind_codec(
                state.serialize,
                lambda data: state.deserialize(data, max_len=max_len))
            prefix_cache.attach_tracer(tr)
        # distinct resumed-chunk lengths ever dispatched (bounded by the
        # power-of-two bucketing)
        self._resume_lens: set[int] = set()

        act = self.plan.activation_context

        def prefill(tokens):
            with act():
                return state.prefill(to_device(tokens, dev),
                                     state.init_slot(self.max_len))

        def resume(tokens, cache, pos0):
            with act():
                return state.resume(to_device(tokens, dev), cache, pos0)

        def restore(snapshot, n_tokens):
            return state.restore(state.init_slot(self.max_len),
                                 self.plan.local_snapshot(snapshot), n_tokens)

        def decode(tokens, pos, caches):
            with act(), moe.each_row_alone():
                return state.decode_step(tokens, pos, caches, inplace=True)

        # the entry points count their call signatures, the port's jit
        # caches: the retrace watchdog reads growth after reset_stats()
        # (warm-up done) as a live tick meeting a new shape; a kernel
        # library built or loaded mid-serve counts too
        self._prefill = CallSignatures(prefill)
        self._prefill_resume = CallSignatures(resume)
        self._fresh_slot = CallSignatures(lambda: state.init_slot(self.max_len))
        self._restore = CallSignatures(restore)
        self._install_slot = CallSignatures(self._install_impl)
        self._decode = CallSignatures(decode)
        self._replay = CallSignatures(self._replay_impl)
        self._install_restored = CallSignatures(self._install_restored_impl)
        for name, fn in (("prefill", self._prefill),
                         ("prefill_resume", self._prefill_resume),
                         ("fresh_slot", self._fresh_slot),
                         ("restore", self._restore),
                         ("install_slot", self._install_slot),
                         ("decode", self._decode),
                         ("replay", self._replay),
                         ("install_restored", self._install_restored),
                         ("kernel_libraries", build.LOADED)):
            self.telemetry.watchdog.register(name, fn)

        self.scheduler = PrefillScheduler(
            state, prefill_fn=self._prefill, resume_fn=self._prefill_resume,
            fresh_fn=self._fresh_slot, restore_fn=self._restore,
            prefix_cache=prefix_cache,
            min_snapshot_blocks=min_snapshot_blocks, budget=prefill_budget,
            resume_lens=self._resume_lens, tracer=tr, owns=self._owns,
            share=self._share_snapshot)

        reg = self.telemetry.registry
        self._m_prefills = reg.counter(
            "serve_prefills_total", "prefills installed into slots")
        self._m_sampled = reg.counter(
            "serve_sampled_requests_total",
            "installed requests with non-greedy sampling")
        self._m_ticks = reg.counter(
            "serve_decode_ticks_total", "decode ticks dispatched")
        self._m_tokens = reg.counter(
            "serve_tokens_total", "tokens emitted (first + decode)")
        self._m_finished = reg.counter(
            "serve_requests_finished_total",
            "retired requests by finish reason", labels=("reason",))
        self._m_recovered = reg.counter(
            "serve_recovered_slots_total",
            "requests re-installed mid-stream after a replica failover")
        self._m_prefill_s = reg.counter(
            "serve_prefill_seconds_total",
            "admission dispatch + lockstep first-token sync wall time")
        self._m_decode_s = reg.counter(
            "serve_decode_seconds_total", "decode pipeline wall time")
        self._m_ttft = reg.histogram(
            "serve_ttft_ms", "submit -> first token",
            edges=self.TTFT_EDGES_MS)
        self._m_itl = reg.histogram(
            "serve_itl_ms", "inter-token latency across all requests",
            edges=self.ITL_EDGES_MS)
        self._m_tick_gap = reg.histogram(
            "serve_tick_gap_ms",
            "host-observed gap between consecutive decode-tick "
            "completions within a busy streak",
            edges=self.TICK_GAP_EDGES_MS, window=16384)
        self._m_collective = reg.histogram(
            "serve_collective_ms",
            "host-sync wait of a data-sharded tick (the all-gather of its "
            "tokens over 'data')", edges=self.ITL_EDGES_MS)
        # mesh topology exported as set-gauges (reset() zeroes them, so
        # reset_stats re-sets; see _set_mesh_gauges)
        self._g_mesh_devices = reg.gauge(
            "serve_mesh_devices", "devices per mesh axis", labels=("axis",))
        self._g_mesh_info = reg.gauge(
            "serve_mesh_info", "serving mesh shape (constant 1, the shape "
            "in the label)", labels=("shape",))
        self._set_mesh_gauges()
        reg.gauge("serve_slots", "decode slots", fn=lambda: float(slots))
        reg.gauge("serve_active_requests",
                  "slots with an installed decoding request",
                  fn=lambda: float(self.n_active))
        reg.gauge("serve_queue_depth", "requests waiting for a slot",
                  fn=lambda: float(len(self.queue)))
        sch = self.scheduler
        reg.counter("serve_scheduler_chunks_total",
                    "prefill chunks dispatched", fn=lambda: sch.chunks)
        reg.counter("serve_scheduler_chunk_tokens_total",
                    "prompt tokens dispatched as chunks",
                    fn=lambda: sch.chunk_tokens)
        reg.counter("serve_scheduler_coalesced_total",
                    "admissions parked on an in-flight shared prefix",
                    fn=lambda: sch.coalesced)
        reg.counter("serve_scheduler_promote_splits_total",
                    "prefix-cache promote splits planned",
                    fn=lambda: sch.promotes)
        reg.gauge("serve_scheduler_inflight", "prefills in flight",
                  fn=lambda: float(len(sch.jobs)))
        reg.gauge("serve_scheduler_parked", "prefills parked on an "
                  "in-flight shared prefix",
                  fn=lambda: float(sum(j.waiting for j in sch.jobs)))
        if prefix_cache is not None:
            pc = prefix_cache
            reg.counter("serve_prefix_cache_lookups_total",
                        "prefix-cache probes", fn=lambda: pc.lookups)
            reg.counter("serve_prefix_cache_hits_total",
                        "probes that restored a snapshot",
                        fn=lambda: pc.hits)
            reg.counter("serve_prefix_cache_hit_tokens_total",
                        "prompt tokens skipped via snapshot restore",
                        fn=lambda: pc.hit_tokens)
            reg.counter("serve_prefix_cache_evictions_total",
                        "snapshots evicted", fn=lambda: pc.evictions)
            reg.counter("serve_prefix_disk_corrupt_total",
                        "disk-tier snapshots quarantined as corrupt",
                        fn=lambda: pc.disk_corrupt)
        # gap anchor: the previous tick's read within the current busy
        # streak; None across idle periods
        self._gap_anchor: float | None = None
        self._last_sync: float | None = None

    # ------------------------------------------------------------------
    # submission / scheduling
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: int | None = None,
               sampling: SamplingParams | None = None) -> int:
        """Enqueue a request; returns its id. prompt: (S,) or (1, S) ints.
        `sampling` defaults to greedy decoding. The prompt stays on the
        host: the scheduler ships one chunk at a time."""
        if torch.is_tensor(prompt):
            prompt = prompt.detach().cpu().numpy()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.shape[0] + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({prompt.shape[0]}) + max_new({max_new_tokens}) "
                f"exceeds engine max_len={self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens, eos_id,
                      time.perf_counter(), sampling or SamplingParams())
        self.queue.append(req)
        tr = self.telemetry.tracer
        if tr:
            tr.instant("queue", "submit", rid=rid,
                       prompt_len=int(prompt.shape[0]),
                       max_new=int(max_new_tokens),
                       sampling=req.sampling.describe())
        return rid

    @property
    def n_active(self) -> int:
        """Slots with an installed (decoding) request; mid-prefill slots
        are reserved but not yet decoding."""
        return sum(s.decoding for s in self._slots)

    @property
    def busy(self) -> bool:
        return (bool(self.queue) or bool(self._recover_pending)
                or self.scheduler.active
                or self.n_active > 0 or self._pending is not None)

    def _clear_slot(self, slot: _Slot):
        slot.request = None
        slot.prefilling = False
        slot.emitted = []
        slot.lps = []
        slot.last_tok_s = None
        slot.pos0 = 0
        slot.ticks = 0

    def _retire(self, si: int, reason: str) -> RequestOutput:
        slot = self._slots[si]
        req = slot.request
        out = RequestOutput(
            rid=req.rid, tokens=np.asarray(slot.emitted, np.int32),
            prompt_len=int(req.prompt.shape[0]), finish_reason=reason,
            ttft_s=slot.ttft_s, latency_s=time.perf_counter() - req.submit_time,
            decode_steps=len(slot.emitted) - 1,
            logprobs=(np.asarray(slot.lps, np.float32) if self.logprobs
                      else None))
        self._clear_slot(slot)
        self.finished.append(out)
        self._m_finished.labels(reason=reason).inc()
        tr = self.telemetry.tracer
        if tr:
            tr.end(f"slot{si}", rid=out.rid, reason=reason)  # decode span
            tr.instant(f"slot{si}", "retire", rid=out.rid, reason=reason,
                       tokens=int(len(out.tokens)))
        return out

    def _check_finished(self, si: int) -> RequestOutput | None:
        slot = self._slots[si]
        req = slot.request
        if req.eos_id is not None and slot.emitted[-1] == req.eos_id:
            return self._retire(si, "eos")
        if len(slot.emitted) >= req.max_new_tokens:
            return self._retire(si, "length")
        return None

    def _start_admissions(self):
        """Reserve free slots for pending recoveries, then queued requests
        (FIFO), and hand their prefills to the scheduler; chunks flow from
        scheduler.tick()."""
        for si, slot in enumerate(self._slots):
            if not (self.queue or self._recover_pending):
                break
            if not slot.free:
                continue
            if self._recover_pending:
                self._install_recovery(si, *self._recover_pending.popleft())
                continue
            req = self.queue.popleft()
            slot.request = req
            slot.prefilling = True
            self.scheduler.start(req, si)

    # -- the data-sharded plan's slot ownership --------------------------

    def _owns(self, si: int) -> bool:
        """Whether this data rank holds slot si's state."""
        return self._lo <= si < self._hi

    def _share_snapshot(self, snapshot, si: int, n_tokens: int):
        """A snapshot of slot si's state (None on a data rank that does not
        hold it) made whole and the same on every rank: gathered over
        "model" on the slot's data rank, broadcast over "data" from it.
        Every rank calls it at the same point of its loop."""
        if not self._mesh:
            return snapshot
        if snapshot is not None:
            snapshot = self.plan.gather_snapshot(snapshot)
        owner = self.plan.owner(si, self.slots)
        template = None
        if not self._owns(si):
            state = self.state
            template = [x._replace(pos=int(n_tokens))
                        if isinstance(x, dec.RingKVCache) else x
                        for x in state.snapshot(state.init_slot(self.max_len, whole=True))]
        return self.plan.share(snapshot, owner, template)

    def _set_mesh_gauges(self):
        for axis, n in self.plan.axis_sizes.items():
            self._g_mesh_devices.labels(axis=axis).set(float(n))
        self._g_mesh_info.labels(shape=self.plan.describe()).set(1.0)

    def decision_digest(self) -> str:
        """A hash of the host state every rank of a mesh must hold alike:
        each slot's request, phase and stream, the queue, the scheduler's
        jobs, announcements and stats, and the prefix cache's index and
        stats. Two ranks that took a different decision differ here."""
        h = hashlib.sha256()

        def put(*xs):
            h.update(repr(xs).encode())
        for slot in self._slots:
            req = slot.request
            put(None if req is None else req.rid, slot.prefilling, slot.emitted,
                slot.pos0, slot.ticks)
        put([r.rid for r in self.queue])
        sch = self.scheduler
        put(sorted(sch.stats().items()), sorted(sch.pending.items()))
        for job in sch.jobs:
            put(job.req.rid, job.slot, list(job.cuts), job.wait_key,
                None if job.part is None else job.part.n_tokens)
        if self.prefix_cache is not None:
            put(sorted(self.prefix_cache.stats().items()))
        return h.hexdigest()

    def _install(self, job):
        """Completed prefill -> slot device state (_install_impl, through
        its signature counter). Returns (slot, rid, first token, its
        log-probability), the last two device tensors of shape (1,); zeros
        on a data rank that does not hold the slot (its owner's ride the
        tick's gather)."""
        req, si = job.req, job.slot
        if self._owns(si):
            tok, lp = self._install_slot(job.part.state, job.part.logits,
                                         si - self._lo, req)
        else:
            tok = torch.zeros(1, dtype=torch.long, device=self.device)
            lp = torch.zeros(1, dtype=torch.float32, device=self.device)
        self._slots[si].prefilling = False
        self._slots[si].pos0 = int(req.prompt.shape[0])
        self._slots[si].ticks = 0
        self._m_prefills.inc()
        if not req.sampling.is_greedy:
            self._m_sampled.inc()
        tr = self.telemetry.tracer
        if tr:
            tr.end(f"slot{si}", rid=req.rid)  # prefill span
            tr.begin(f"slot{si}", "decode", rid=req.rid,
                     prompt_len=int(req.prompt.shape[0]))
        return si, req.rid, tok, lp

    def _install_impl(self, cache, logits, si: int, req: Request):
        """All on the device: the first token sampled off the final chunk's
        `logits` with the request's stream key (made on the host from its
        seed and written by fills, so placement never changes the tokens),
        `cache` written into slot `si` (of this rank's slot stack), and the
        slot's token, position, key and params."""
        sp = req.sampling
        k0, k1 = request_key(sp.seed).tolist()
        key = self._keys[si:si + 1]
        key[0, 0].fill_(k0)
        key[0, 1].fill_(k1)
        samp = set_slot(self._samp, si, sp)
        tok, new_key, lp = sample_first(logits, key, samp,
                                        logprobs=self.logprobs)
        key.copy_(new_key)
        self.state.slot_scatter(self._caches, cache, si, inplace=True)
        self._tokens[si].copy_(tok)
        self._pos[si].fill_(int(req.prompt.shape[0]))
        return tok, lp

    def cancel(self, rid: int):
        """Withdraw a request that has not yet produced a token: queued,
        pending recovery, or mid-prefill (its slot is freed and its
        in-flight chunk work dropped). A request that has emitted tokens is
        not cancellable here. Returns the withdrawn Request, or None if rid
        is unknown/decoding."""
        pending = [req for req, _ in self._recover_pending]
        for where, reqs in ((self.queue, list(self.queue)),
                            (self._recover_pending, pending)):
            for i, req in enumerate(reqs):
                if req.rid == rid:
                    del where[i]
                    if self.telemetry.tracer:
                        self.telemetry.tracer.instant("queue", "drop",
                                                      rid=rid)
                    return req
        for si, slot in enumerate(self._slots):
            if (slot.request is not None and slot.request.rid == rid
                    and slot.prefilling):
                job = next((j for j in self.scheduler.jobs if j.slot == si),
                           None)
                if job is not None:
                    self.scheduler.drop(job)
                req = slot.request
                self._clear_slot(slot)
                return req
        return None

    # ------------------------------------------------------------------
    # failover: checkpoint export, recovered admission, drain
    # ------------------------------------------------------------------

    def slot_covered(self, si: int) -> int:
        """Stream tokens (prompt + absorbed emitted ones) that slot si's
        device state covers once its dispatched ticks have run. Host
        arithmetic, no sync."""
        slot = self._slots[si]
        return slot.pos0 + slot.ticks

    @torch.inference_mode()
    def snapshot_slot(self, si: int):
        """Slot si's decode state as ``(snapshot, n_tokens)``, or None when
        it cannot be checkpointed now (free, mid-prefill, a kind with no
        constant-size snapshot, or off the block grid). The snapshot's
        copies are enqueued on the device behind every dispatched tick and
        ahead of the next one, which writes the slot stack in place."""
        slot = self._slots[si]
        state = self.state
        if not slot.decoding or state.snapshot_granularity is None:
            return None
        covered = self.slot_covered(si)
        if covered <= 0 or covered % state.block_size:
            return None
        snap = (state.snapshot(state.slot_view(self._caches, si - self._lo, covered))
                if self._owns(si) else None)
        return self._share_snapshot(snap, si, covered), covered

    def live_requests(self) -> list[dict]:
        """Host view of every request the engine still owes tokens: queued,
        pending recovery, mid-prefill and decoding, with the tokens (and
        log-probabilities) read so far as plain host lists. What a
        coordinator mirrors and a SIGTERM drain persists."""
        out = [dict(rid=req.rid, phase="queued", request=req, emitted=[],
                    lps=[], ttft_s=0.0) for req in self.queue]
        out += [dict(rid=req.rid, phase="queued", request=req,
                     emitted=list(rec.emitted), lps=list(rec.lps),
                     ttft_s=rec.ttft_s) for req, rec in self._recover_pending]
        out += [dict(rid=slot.request.rid,
                     phase="prefill" if slot.prefilling else "decode",
                     request=slot.request, emitted=list(slot.emitted),
                     lps=list(slot.lps), ttft_s=slot.ttft_s)
                for slot in self._slots if not slot.free]
        return out

    @torch.inference_mode()
    def admit_recovered(self, rec: RecoveredRequest) -> int:
        """Re-home a request recovered from a dead replica: installed in a
        free slot at once when there is one, else parked ahead of the
        queue. Returns its NEW request id on this engine. Single-device
        plans only (a ReplicaSet places each replica itself)."""
        if self._mesh:
            raise NotImplementedError(
                f"failover re-admission on a {self.plan.describe()} plan is not "
                f"ported ({tp.REFUSALS_ITEM}); a ReplicaSet places each replica on "
                "its own single-device plan")
        prompt = np.asarray(rec.prompt, np.int64).reshape(-1)
        if prompt.shape[0] + rec.max_new_tokens > self.max_len:
            raise ValueError(
                f"recovered prompt({prompt.shape[0]}) + "
                f"max_new({rec.max_new_tokens}) exceeds engine "
                f"max_len={self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, rec.max_new_tokens, rec.eos_id,
                      rec.submit_time, rec.sampling)
        for si, slot in enumerate(self._slots):
            if slot.free:
                self._install_recovery(si, req, rec)
                return rid
        self._recover_pending.append((req, rec))
        return rid

    def _install_recovery(self, si: int, req: Request,
                          rec: RecoveredRequest):
        """Rebuild a recovered request's state in slot si so that its
        remaining tokens are the bits of the fault-free run.

        The dead replica had absorbed prompt ++ emitted[:-1]; the last
        emitted token was sampled but not yet fed. So the rebuilt cache
        covers ``target = prompt_len + k - 1`` tokens (k = len(emitted)):
        the deepest usable checkpoint (on the block grid, <= target) is
        restored, the prompt tokens past it are prefilled on the block grid
        (the whole prompt in one call for a kind that is not resumable, as
        its admission does), and the emitted tokens are replayed through
        the live tick's decode step at the slot width (`_replay`). The
        slot is then installed with feed emitted[-1] at position target
        and the request's key advanced past its k tokens."""
        slot = self._slots[si]
        self._m_recovered.inc()
        k = len(rec.emitted)
        if k == 0:
            # nothing emitted yet: an ordinary admission
            slot.request = req
            slot.prefilling = True
            self.scheduler.start(req, si)
            return
        state = self.state
        prompt = req.prompt
        s0 = int(prompt.shape[0])
        target = s0 + k - 1
        ctx = np.concatenate([prompt, np.asarray(rec.emitted[:-1], np.int64)])
        blk = state.block_size
        pos, cache = 0, None
        if (rec.snapshot is not None and state.resumable
                and 0 < rec.snap_tokens <= target
                and rec.snap_tokens % blk == 0):
            cache = self._restore(rec.snapshot, rec.snap_tokens)
            pos = rec.snap_tokens
        if pos < s0:
            if pos == 0 or not state.resumable:
                _, cache = self._prefill(prompt[None])
                pos = s0
            else:
                for cut in bucket_chunks(pos, s0, blk,
                                         self.scheduler.max_chunk_blocks):
                    self._resume_lens.add(cut - pos)
                    _, cache = self._prefill_resume(ctx[None, pos:cut], cache,
                                                    pos)
                    pos = cut
        if pos < target:
            cache = self._replay(ctx[pos:target], pos, cache, si)
        key = advance_key(request_key(req.sampling.seed), k)
        self._install_restored(cache, si, rec.emitted[-1], target, key, req)
        slot.request = req
        slot.prefilling = False
        slot.emitted = list(rec.emitted)
        slot.lps = list(rec.lps)
        slot.ttft_s = rec.ttft_s
        slot.last_tok_s = None
        slot.pos0 = target
        slot.ticks = 0
        if not req.sampling.is_greedy:
            self._m_sampled.inc()
        tr = self.telemetry.tracer
        if tr:
            tr.begin(f"slot{si}", "decode", rid=req.rid, recovered=True,
                     prompt_len=s0, replayed=k - 1,
                     from_ckpt=int(rec.snap_tokens))
        # recovery meets new signatures (a restore, resumed chunks, the
        # install): re-arm the steady baseline so that only a later growth
        # on the hot path counts as a mid-serve retrace
        wd = self.telemetry.watchdog
        if wd.steady:
            wd.mark_steady()

    def _replay_impl(self, tokens: np.ndarray, pos0: int, cache, si: int):
        """Absorb already-emitted `tokens` from position pos0 into the
        batch-1 `cache` through the decode step the live tick runs, at the
        live tick's shapes: a scratch slot stack holding `cache` in every
        row decodes them one at a time (a row's bits do not depend on the
        other rows at a fixed shape, but a batch-1 product may round
        otherwise than the slot-wide one). Returns row si as a batch-1
        cache of views into the scratch (slot_scatter copies it)."""
        state, dev = self.state, self.device
        scratch = state.broadcast_slots(cache, self.slots)
        pos = torch.full((self.slots,), pos0, dtype=torch.long, device=dev)
        tok = torch.empty((self.slots, 1), dtype=torch.long, device=dev)
        for t in tokens.tolist():
            tok.fill_(t)
            _, scratch = self._decode(tok, pos, scratch)
            pos += 1
        return state.slot_view(scratch, si, pos0 + len(tokens))

    def _install_restored_impl(self, cache, si: int, feed: int, pos: int,
                               key: torch.Tensor, req: Request):
        """A recovery's install, by fills: `cache` into slot si, the feed
        token and position given, and the request's stream key (on the
        CPU, advanced past its emitted tokens) and sampling params."""
        k0, k1 = key.tolist()
        self._keys[si, 0].fill_(k0)
        self._keys[si, 1].fill_(k1)
        set_slot(self._samp, si, req.sampling)
        self.state.slot_scatter(self._caches, cache, si, inplace=True)
        self._tokens[si].fill_(int(feed))
        self._pos[si].fill_(int(pos))

    @torch.inference_mode()
    def drain_checkpoints(self, *, tag_ns: bytes = b"psk-drain",
                          flush: bool = True) -> list[str]:
        """Graceful-shutdown persistence (the SIGTERM path): admissions
        stop, then at most one block of extra decode ticks runs so that
        every decoding slot reaches a snapshot boundary, each checkpointed
        into the prefix cache's side store as it aligns; the store is then
        flushed to the disk tier. Returns the paths written ([] without a
        cache or save_dir)."""
        pc = self.prefix_cache
        if pc is None or self.state.snapshot_granularity is None:
            return []
        self.queue.clear()
        done: set[int] = set()

        def sweep():
            for si, slot in enumerate(self._slots):
                if not slot.decoding or slot.request.rid in done:
                    continue
                got = self.snapshot_slot(si)
                if got is None:
                    continue
                tag = hashlib.sha256(
                    tag_ns + b":%d" % slot.request.rid).digest()
                pc.put_ckpt(tag, got[1], got[0])
                done.add(slot.request.rid)

        sweep()
        for _ in range(self.state.block_size):
            if all(not s.decoding or s.request.rid in done
                   for s in self._slots):
                break
            self.step()
            sweep()
        if flush and pc.save_dir is not None:
            return pc.flush_ckpts_to_disk()
        return []

    def _note_token(self, slot: _Slot, now: float) -> float | None:
        """Returns this token's inter-token latency in ms (None for a
        request's first token)."""
        itl_ms = None
        if slot.last_tok_s is not None:
            itl_ms = (now - slot.last_tok_s) * 1e3
            self._m_itl.observe(itl_ms)
        slot.last_tok_s = now
        return itl_ms

    def _append_firsts(self, firsts, values, done, now: float):
        """Record admissions' first tokens: (slot, rid, column) into the
        host copy's `values`."""
        tr = self.telemetry.tracer
        for si, rid, col in firsts:
            slot = self._slots[si]
            req = slot.request
            if req is None or req.rid != rid:
                continue
            slot.emitted.append(int(values[0, col]))
            if self.logprobs:
                slot.lps.append(float(values[1, col]))
            slot.ttft_s = now - req.submit_time
            self._m_ttft.observe(slot.ttft_s * 1e3)
            self._m_tokens.inc()
            self._note_token(slot, now)
            if tr:
                tr.instant(f"slot{si}", "first_token", rid=rid,
                           ttft_ms=round(slot.ttft_s * 1e3, 3))
            fin = self._check_finished(si)
            if fin is not None:
                done.append(fin)

    def _host_copy(self, packed, n_local: int, first_slots: list):
        """The host copy of `packed`: on a data-sharded plan gathered over
        "data" when read (_GatheredCopy)."""
        if not self._mesh:
            return _HostCopy(packed)
        return _GatheredCopy(packed, self, n_local,
                             [self.plan.owner(si, self.slots) for si in first_slots])

    @staticmethod
    def _pack(toks, lps) -> torch.Tensor:
        """(2, n) float64: token ids and log-probabilities, one copy."""
        return torch.stack([toks.to(torch.float64), lps.to(torch.float64)])

    def _set_active(self, active: np.ndarray):
        """Bring the device's active mask (this rank's slots) to `active`
        by fills."""
        for si in np.flatnonzero(active != self._active_host):
            self._active[si].fill_(bool(active[si]))
        self._active_host = active.copy()

    def _dispatch_decode(self, firsts) -> _TickRecord | None:
        """Dispatch one decode tick over the installed slots, with no host
        sync: the model step, sampling, the frozen-slot updates and the
        packing of this tick's tokens (and the admissions' first tokens,
        `firsts`: (slot, rid, token, logprob) device tensors) for one
        device-to-host copy."""
        active = np.array([s.decoding for s in self._slots])
        if not active.any():
            assert not firsts, "installed slots must be decoding"
            return None
        rids = [s.request.rid if s.decoding else None for s in self._slots]
        all_greedy = all(not a or s.request.sampling.is_greedy
                         for a, s in zip(active, self._slots))
        t0 = time.perf_counter()
        self._set_active(active[self._lo:self._hi])
        logits, self._caches = self._decode(self._tokens, self._pos,
                                            self._caches)
        keys = self._keys
        if all_greedy:
            # greedy slots never read their keys: leaving them is not
            # observable in any request's tokens
            out, new_keys = torch.argmax(logits, dim=-1), keys
        else:
            out, new_keys = sample_step(keys, logits, *self._samp)
        lps = (token_logprobs(logits, out) if self.logprobs else
               torch.zeros(out.shape, dtype=torch.float32, device=out.device))
        # free slots decode along on stale state, but their feed token, key
        # and position are frozen here
        act = self._active
        self._tokens = torch.where(act[:, None], out[:, None], self._tokens)
        self._keys = torch.where(act[:, None], new_keys, keys)
        self._pos = torch.where(act, self._pos + 1, self._pos)
        packed = self._pack(out, lps)
        if firsts:
            packed = torch.cat([packed] + [self._pack(tok, lp)
                                           for _, _, tok, lp in firsts], dim=1)
        copy = self._host_copy(packed, out.shape[0], [si for si, _, _, _ in firsts])
        self._m_ticks.inc()
        # ticks counts DISPATCHED decode steps: the tick absorbs each
        # slot's feed token on the device at dispatch, so pos0 + ticks is
        # what the slot's state covers now (snapshot_slot's depth)
        for si in np.flatnonzero(active):
            self._slots[si].ticks += 1
        meta = [(si, rid, self.slots + i)
                for i, (si, rid, _, _) in enumerate(firsts)]
        return _TickRecord(copy, active, rids, meta, t0)

    def _sync_record(self, rec: _TickRecord, done):
        """Read one tick record's tokens on the host and account them.
        First tokens precede the tick's token in each request's stream, so
        admissions recorded on this tick are appended first; a slot whose
        request retired (or was replaced) since dispatch fails the rid
        check and its speculative token is dropped."""
        tr = self.telemetry.tracer
        if tr:
            tr.begin("tick", "host_sync")
        values = rec.copy.read()
        now = time.perf_counter()
        if tr:
            tr.end("tick", slots=int(rec.active.sum()))
        t_ref = (rec.t_dispatch if self._last_sync is None
                 else max(rec.t_dispatch, self._last_sync))
        self._m_decode_s.inc(now - t_ref)
        self._last_sync = now
        if self._gap_anchor is not None:
            self._m_tick_gap.observe((now - self._gap_anchor) * 1e3)
        self._gap_anchor = now
        if tr:
            tr.begin("tick", "retire")
        self._append_firsts(rec.firsts, values, done, now)
        for si, slot in enumerate(self._slots):
            if not rec.active[si]:
                continue
            req = slot.request
            if req is None or req.rid != rec.rids[si]:
                continue
            slot.emitted.append(int(values[0, si]))
            if self.logprobs:
                slot.lps.append(float(values[1, si]))
            self._m_tokens.inc()
            itl_ms = self._note_token(slot, now)
            if tr:
                tr.instant(f"slot{si}", "token", rid=req.rid,
                           itl_ms=round(itl_ms, 3) if itl_ms else 0.0)
            fin = self._check_finished(si)
            if fin is not None:
                done.append(fin)
        if tr:
            tr.end("tick", retired=len(done))
        if not any(s.decoding for s in self._slots) and self._pending is None:
            # busy streak over: the wait for the next admission is idle
            # time, not a decode stall
            self._gap_anchor = None

    @torch.inference_mode()
    def step(self) -> list[RequestOutput]:
        """One engine tick.

        Lockstep (overlap=False): admit (up to one prefill budget of chunk
        work; all admissions' first tokens read together in one copy),
        decode every installed slot once, read this tick's tokens before
        returning.

        Overlapped (overlap=True): dispatch chunk work and the decode tick
        (which carries the admissions' first tokens in its copy), then read
        the PREVIOUS tick's tokens.

        Returns requests that finished this tick."""
        done: list[RequestOutput] = []
        tr = self.telemetry.tracer
        if tr:
            tr.begin("tick", "tick", n=int(self._m_ticks.value))
            tr.begin("tick", "plan")
        self._start_admissions()
        if tr:
            tr.end("tick")
            tr.begin("tick", "chunk_dispatch")
        t0 = time.perf_counter()
        firsts = [self._install(job) for job in self.scheduler.tick()]
        if not self.overlap and firsts:
            # lockstep: all admissions' first tokens in one copy
            copy = self._host_copy(torch.cat(
                [self._pack(tok, lp) for _, _, tok, lp in firsts], dim=1), 0,
                [si for si, _, _, _ in firsts])
            values = copy.read()
        if tr:
            tr.end("tick", installs=len(firsts))
        self._m_prefill_s.inc(time.perf_counter() - t0)
        if self.overlap:
            if tr:
                tr.begin("tick", "decode_dispatch")
            rec = self._dispatch_decode(firsts)
            if tr:
                tr.end("tick")
            prev, self._pending = self._pending, rec
            if prev is not None:
                self._sync_record(prev, done)
        else:
            if firsts:
                meta = [(si, rid, i) for i, (si, rid, _, _) in
                        enumerate(firsts)]
                self._append_firsts(meta, values, done, time.perf_counter())
            if tr:
                tr.begin("tick", "decode_dispatch")
            rec = self._dispatch_decode([])
            if tr:
                tr.end("tick")
            if rec is not None:
                self._sync_record(rec, done)
        if tr:
            tr.end("tick")  # the tick span
        self.telemetry.on_tick()
        return done

    def run(self) -> list[RequestOutput]:
        """Drain the queue and all active slots. Returns outputs in
        completion order."""
        out = []
        while self.busy:
            out.extend(self.step())
        return out

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------

    def reset_stats(self):
        """Zero the accounting (e.g. after a warm-up run) and mark the
        entry points steady: a call signature or kernel library first seen
        after this point is a mid-serve retrace the watchdog counts."""
        self.finished = []
        self._gap_anchor = None
        self._last_sync = None
        self.telemetry.reset()
        self._set_mesh_gauges()  # reset() zeroes set-gauges
        self.scheduler.reset_stats()
        if self.prefix_cache is not None:
            self.prefix_cache.reset_stats()

    # histogram bucket edges (milliseconds, final bucket open-ended);
    # Prometheus `le` semantics
    TTFT_EDGES_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                     1000.0, float("inf"))
    ITL_EDGES_MS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 250.0,
                    1000.0, float("inf"))
    TICK_GAP_EDGES_MS = ITL_EDGES_MS

    def stats(self) -> dict:
        """A view over the telemetry registry. Still-resident requests
        count too: decode_s includes the ticks spent on live slots."""
        live = [s for s in self._slots if not s.free]
        gen_tokens = (sum(len(o.tokens) for o in self.finished)
                      + sum(len(s.emitted) for s in live))
        # the first token of every request comes from the prefill logits,
        # so decode throughput counts only decode-step tokens
        decode_tokens = (sum(o.decode_steps for o in self.finished)
                         + sum(max(len(s.emitted) - 1, 0) for s in live))
        decode_s = self._m_decode_s.value
        gap_p = self._m_tick_gap.percentiles()
        out = {
            "requests": len(self.finished),
            "active_requests": len(live),
            "generated_tokens": gen_tokens,
            "prefills": int(self._m_prefills.value),
            "sampled_requests": int(self._m_sampled.value),
            "recovered": int(self._m_recovered.value),
            "decode_steps": int(self._m_ticks.value),
            "prefill_s": self._m_prefill_s.value,
            "decode_s": decode_s,
            "decode_tok_per_s": (decode_tokens / decode_s
                                 if decode_s else 0.0),
            "itl_ms": self._m_itl.percentiles(),
            "ttft_ms": self._m_ttft.percentiles(),
            "ttft_hist": {"edges_ms": list(self.TTFT_EDGES_MS),
                          "counts": self._m_ttft.counts},
            "tick_gap_ms": {**gap_p, "median": gap_p["p50"],
                            "max": self._m_tick_gap.max},
            "retraces": self.telemetry.watchdog.retraces,
            "signatures": self.telemetry.watchdog.cache_sizes(),
            "scheduler": self.scheduler.stats(),
            "mesh": {
                "shape": self.plan.describe(),
                "devices": dict(self.plan.axis_sizes),
                "collective_ms": self._m_collective.percentiles(),
            },
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out
