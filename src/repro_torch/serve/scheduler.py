"""Chunked prefill scheduling for ServeEngine, prefix-aware.

Port of the JAX package's ``serve/scheduler.py``. The block-based causal
algorithm makes a polysketch prefill a sequence of constant-state
lt_block_size chunks, so admission work is preemptible: a
``PrefillScheduler`` keeps a FIFO of in-flight prefills (``PrefillJob``),
each carried between chunks as a ``core.state.PartialPrefill``, and every
engine tick dispatches at most a ``prefill_budget`` of chunk work before
the decode tick. A long prompt admits across ticks instead of stalling
every live request for its whole prefill.

Chunks come from ``core.state.bucket_chunks`` (power-of-two multiples of
the block size, capped at the budget).

With a ``serve.prefix_cache.PrefixCache`` attached, a job plans its
prefill from a lookup: it restores the deepest snapshot of its prompt's
prefix and prefills only the rest, splits the prefill at a promoted
shared boundary to snapshot it there, and snapshots its block-aligned
truncation: when done for a block-granularity state (polysketch: the
tail sits in buffers the snapshot omits), or by splitting the prefill at
the truncation for a token-granularity one (SSD, RG-LRU, ring). Every
snapshot a job plans to insert is announced in a pending-key map before
it exists. A later request whose chain
crosses an announced boundary deeper than its own best snapshot parks
until that snapshot lands, then replans and restores from it: under N
concurrent misses on a shared prefix the promote split happens once, and
the followers resume from it instead of prefilling the prefix N times.

Non-resumable decode states (the KV kinds) cannot be chunked: their job
is one whole-prompt dispatch, not preemptible by the budget, and they
take no prefix cache.

Each chunk's tokens go to the device from pinned memory without blocking
the host, so dispatching a chunk never waits for the device.

On a data-sharded serving plan every rank runs the same scheduler over
the same jobs and takes the same decisions; ``owns(slot)`` says whether
this rank holds a job's slot and so computes its chunks (elsewhere a
job's carry is None), and ``share(snapshot, slot, n_tokens)`` turns the
owner's snapshot into the whole one every rank's prefix cache stores.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.state import PartialPrefill, bucket_chunks
from repro_torch.serve.telemetry import NULL_TRACER


@dataclass
class PrefillJob:
    """One request's in-flight admission prefill."""
    req: Any                      # serve.engine.Request (duck-typed)
    slot: int                     # reserved engine slot
    part: PartialPrefill | None = None
    cuts: deque = field(default_factory=deque)   # absolute cut points
    whole: bool = False           # non-resumable: one whole-prompt dispatch
    snap_at: dict = field(default_factory=dict)  # cut pos -> chain key
    final_key: bytes = b""        # inserted at completion
    final_pos: int = 0
    wait_key: bytes | None = None  # parked on another job's pending snapshot
    announced: list = field(default_factory=list)

    @property
    def waiting(self) -> bool:
        return self.wait_key is not None


def to_device(tokens: np.ndarray, device) -> torch.Tensor:
    """(1, S) int64 tokens on `device`, copied from pinned host memory
    without blocking (no host sync)."""
    t = torch.from_numpy(tokens).to(torch.int64)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class PrefillScheduler:
    """Budgeted, prefix-aware chunk dispatcher over the engine's prefill
    functions:

      prefill_fn(tokens)             -> (logits, state)   whole prompt
      resume_fn(tokens, state, pos0) -> (logits, state)   one chunk
      fresh_fn()                     -> state             zero tokens
      restore_fn(snapshot, n)        -> state             snapshot restore

    ``budget`` is in prompt tokens per tick (None = unlimited); a tick may
    overshoot by at most one chunk (chunks are capped near the budget via
    bucket_chunks' max_blocks) and always dispatches at least one chunk
    when any job is runnable, so prefills progress under any budget.
    ``resume_lens`` collects every resumed chunk length dispatched.
    """

    def __init__(self, state, *, prefill_fn: Callable, resume_fn: Callable,
                 fresh_fn: Callable, restore_fn: Callable,
                 prefix_cache=None, min_snapshot_blocks: int = 1,
                 budget: int | None = None, resume_lens: set | None = None,
                 tracer=None, owns: Callable | None = None,
                 share: Callable | None = None):
        if budget is not None and budget < 1:
            raise ValueError("prefill_budget must be >= 1 (or None)")
        self.state = state
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.prefill_fn = prefill_fn
        self.resume_fn = resume_fn
        self.fresh_fn = fresh_fn
        self.restore_fn = restore_fn
        self.owns = owns or (lambda slot: True)
        self.share = share or (lambda snapshot, slot, n_tokens: snapshot)
        self.pc = prefix_cache
        self.min_blocks = min_snapshot_blocks
        self.budget = budget
        self.resume_lens = resume_lens if resume_lens is not None else set()
        self.jobs: list[PrefillJob] = []
        # announced, not yet materialized snapshot boundaries of in-flight
        # jobs: chain key -> token position (the coalescing rendezvous)
        self.pending: dict[bytes, int] = {}
        self.started = self.completed = 0
        self.chunks = self.chunk_tokens = 0
        self.coalesced = self.promotes = 0

    @property
    def active(self) -> bool:
        return bool(self.jobs)

    @property
    def max_chunk_blocks(self) -> int | None:
        if self.budget is None:
            return None
        return max(1, self.budget // self.state.block_size)

    def start(self, req, slot: int) -> PrefillJob:
        """Enqueue one request's prefill into a reserved slot."""
        job = PrefillJob(req=req, slot=slot)
        self.started += 1
        if self.tracer:
            # the prefill span runs from slot reservation to slot install
            # (the engine ends it); probe and park instants land inside it
            self.tracer.begin(f"slot{slot}", "prefill", rid=req.rid,
                              prompt_len=int(req.prompt.shape[0]))
        self._plan(job)
        self.jobs.append(job)
        return job

    def tick(self) -> list[PrefillJob]:
        """Dispatch up to one budget of chunk work (FIFO over jobs; parked
        jobs are skipped). Returns jobs whose prefill completed this tick;
        the engine installs them into their slots."""
        budget = float("inf") if self.budget is None else self.budget
        spent = 0
        done = []
        for job in list(self.jobs):
            if spent >= budget:
                break
            if job.waiting:
                if job.wait_key in self.pending:
                    continue                   # producer still in flight
                job.wait_key = None
                if self.tracer:
                    self.tracer.instant(f"slot{job.slot}", "unpark",
                                        rid=job.req.rid)
                self._plan(job)                # snapshot landed: replan
                if job.waiting:
                    continue
            while job.cuts and spent < budget:
                spent += self._dispatch(job)
            if not job.cuts:
                self._finish(job)
                done.append(job)
        return done

    def drop(self, job: PrefillJob):
        """Evict an in-flight prefill (its carry is released; announced
        boundaries are withdrawn so parked followers replan)."""
        self._withdraw(job)
        self.jobs.remove(job)
        if self.tracer:
            self.tracer.end(f"slot{job.slot}", rid=job.req.rid)  # prefill
            self.tracer.instant(f"slot{job.slot}", "drop", rid=job.req.rid)

    def stats(self) -> dict:
        return {
            "started": self.started,
            "completed": self.completed,
            "inflight": len(self.jobs),
            "waiting": sum(j.waiting for j in self.jobs),
            "chunks": self.chunks,
            "chunk_tokens": self.chunk_tokens,
            "coalesced": self.coalesced,
            "promote_splits": self.promotes,
        }

    def reset_stats(self):
        self.started = self.completed = 0
        self.chunks = self.chunk_tokens = 0
        self.coalesced = self.promotes = 0

    # ------------------------------------------------------------------

    def _announce(self, job: PrefillJob, key: bytes, pos: int):
        if key and key not in self.pending:
            self.pending[key] = pos
            job.announced.append(key)

    def _withdraw(self, job: PrefillJob):
        for k in job.announced:
            self.pending.pop(k, None)
        job.announced = []

    def _materialized(self, job: PrefillJob, key: bytes):
        """The snapshot at `key` now exists: clear its announcement
        whichever job made it (two jobs may plan an insert at one boundary
        and the other may land first), so parked followers unpark."""
        self.pending.pop(key, None)
        if key in job.announced:
            job.announced.remove(key)

    def _plan(self, job: PrefillJob):
        """Decide the job's cut list and restore point, or park it on an
        in-flight boundary an earlier job announced."""
        req = job.req
        prompt = req.prompt
        plen = int(prompt.shape[0])
        blk = self.state.block_size
        if not self.state.resumable:
            job.whole = True
            job.cuts = deque([plen])
            return
        mine = self.owns(job.slot)
        if self.pc is None:
            job.part = PartialPrefill(self.fresh_fn() if mine else None, 0)
            job.cuts = deque(bucket_chunks(0, plen, blk,
                                           self.max_chunk_blocks))
            return

        # coalesce before planning: the deepest announced boundary past
        # the best resident snapshot (leaving >= 1 token to prefill) is
        # worth parking for. The check is read-only, so a parked job makes
        # exactly one plan() (at unpark) and never inflates the stats
        usable_d = (plen - 1) // blk
        keys = self.pc.chain_keys(prompt, usable_d)
        best_key, best_pos = None, self.pc.resident_depth(keys) * blk
        for d in range(1, usable_d + 1):
            pos = self.pending.get(keys[d - 1])
            if pos == d * blk and pos > best_pos:
                best_key, best_pos = keys[d - 1], pos
        if best_key is not None:
            job.wait_key = best_key
            self.coalesced += 1
            if self.tracer:
                self.tracer.instant(f"slot{job.slot}", "park",
                                    rid=req.rid, depth=best_pos)
            return

        plan = self.pc.plan(prompt, min_blocks=self.min_blocks)
        if self.tracer:
            if plan.n_restore:
                self.tracer.instant(f"slot{job.slot}", "cache_hit",
                                    rid=req.rid, tokens=int(plan.n_restore))
            else:
                self.tracer.instant(f"slot{job.slot}", "cache_miss",
                                    rid=req.rid)
        snap_at = {}
        if plan.n_promote:
            snap_at[plan.n_promote] = plan.promote_key
            self.promotes += 1
        want_trunc = (bool(plan.trunc_key)
                      and plan.n_trunc > plan.n_restore
                      and plan.n_trunc != plan.n_promote)
        # a token-granularity state covers exactly the tokens so far, so its
        # snapshot at a truncation inside the prompt needs the prefill split
        # there
        split_trunc = (want_trunc and plan.n_trunc < plen
                       and self.state.snapshot_granularity == "token")
        if split_trunc:
            snap_at[plan.n_trunc] = plan.trunc_key
        job.snap_at = snap_at
        if want_trunc and not split_trunc:
            # block granularity (the final state's prefix matrix covers
            # exactly the truncation; the tail sits in the buffers), or a
            # block-aligned prompt whose final state is the truncation
            job.final_key, job.final_pos = plan.trunc_key, plan.n_trunc
        for pos, key in snap_at.items():
            self._announce(job, key, pos)
        if job.final_key:
            self._announce(job, job.final_key, job.final_pos)

        if not mine:
            job.part = PartialPrefill(None, plan.n_restore)
        elif plan.n_restore:
            job.part = PartialPrefill(
                self.restore_fn(plan.snapshot, plan.n_restore),
                plan.n_restore)
        else:
            job.part = PartialPrefill(self.fresh_fn(), 0)
        cuts, pos = [], plan.n_restore
        for cut in sorted(set(snap_at) | {plen}):
            if cut > pos:
                cuts.extend(bucket_chunks(pos, cut, blk,
                                          self.max_chunk_blocks))
                pos = cut
        job.cuts = deque(cuts)

    def _dispatch(self, job: PrefillJob) -> int:
        """Dispatch the job's next chunk (no host sync). Returns the chunk's
        token count for budget accounting."""
        cut = job.cuts.popleft()
        prompt = job.req.prompt
        tr = self.tracer
        pos = 0 if job.whole else job.part.n_tokens
        if not job.whole:
            self.resume_lens.add(cut - pos)
        if not self.owns(job.slot):
            logits, state = None, None
        elif job.whole:
            logits, state = self.prefill_fn(prompt[None])
        else:
            logits, state = self.resume_fn(prompt[None, pos:cut],
                                           job.part.state, pos)
        job.part = PartialPrefill(state, cut, logits)
        self.chunks += 1
        self.chunk_tokens += cut - pos
        if tr:
            tr.instant(f"slot{job.slot}", "chunk", rid=job.req.rid,
                       pos=int(pos), end=int(cut))
        key = job.snap_at.get(cut)
        if key:
            self.pc.insert(key, cut, self._snapshot(state, job.slot, cut))
            self._materialized(job, key)
            if tr:
                tr.instant(f"slot{job.slot}", "snapshot", rid=job.req.rid,
                           pos=int(cut))
        return cut - pos

    def _snapshot(self, state, slot: int, n_tokens: int):
        """The whole snapshot of a job's state (None where this rank does
        not hold the slot), the same on every rank."""
        snap = None if state is None else self.state.snapshot(state)
        return self.share(snap, slot, n_tokens)

    def _finish(self, job: PrefillJob):
        if job.final_key and self.pc is not None:
            self.pc.insert(job.final_key, job.final_pos,
                           self._snapshot(job.part.state, job.slot, job.final_pos))
            self._materialized(job, job.final_key)
            if self.tracer:
                self.tracer.instant(f"slot{job.slot}", "snapshot",
                                    rid=job.req.rid, pos=int(job.final_pos))
        self._withdraw(job)
        self.jobs.remove(job)
        self.completed += 1
