"""Chunked prefill scheduling for ServeEngine.

Port of the JAX package's ``serve/scheduler.py`` without its prefix-cache
paths (no ``PrefixCache`` is ported: planning takes the reference's
no-cache branches). The block-based causal algorithm makes a polysketch
prefill a sequence of constant-state lt_block_size chunks, so admission
work is preemptible: a ``PrefillScheduler`` keeps a FIFO of in-flight
prefills (``PrefillJob``), each carried between chunks as a
``core.state.PartialPrefill``, and every engine tick dispatches at most a
``prefill_budget`` of chunk work before the decode tick. A long prompt
admits across ticks instead of stalling every live request for its whole
prefill.

Chunks come from ``core.state.bucket_chunks`` (power-of-two multiples of
the block size, capped at the budget). Non-resumable decode states (the
KV kinds) cannot be chunked: their job is one whole-prompt dispatch, not
preemptible by the budget.

Each chunk's tokens go to the device from pinned memory without blocking
the host, so dispatching a chunk never waits for the device.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.state import PartialPrefill, bucket_chunks


@dataclass
class PrefillJob:
    """One request's in-flight admission prefill."""
    req: Any                      # serve.engine.Request (duck-typed)
    slot: int                     # reserved engine slot
    part: PartialPrefill | None = None
    cuts: deque = field(default_factory=deque)   # absolute cut points
    whole: bool = False           # non-resumable: one whole-prompt dispatch


def to_device(tokens: np.ndarray, device) -> torch.Tensor:
    """(1, S) int64 tokens on `device`, copied from pinned host memory
    without blocking (no host sync)."""
    t = torch.from_numpy(tokens).to(torch.int64)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class PrefillScheduler:
    """Budgeted chunk dispatcher over the engine's prefill functions:

      prefill_fn(tokens)             -> (logits, state)   whole prompt
      resume_fn(tokens, state, pos0) -> (logits, state)   one chunk
      fresh_fn()                     -> state             zero tokens

    ``budget`` is in prompt tokens per tick (None = unlimited); a tick may
    overshoot by at most one chunk (chunks are capped near the budget via
    bucket_chunks' max_blocks) and always dispatches at least one chunk
    when any job is runnable, so prefills progress under any budget.
    """

    def __init__(self, state, *, prefill_fn: Callable, resume_fn: Callable,
                 fresh_fn: Callable, budget: int | None = None):
        if budget is not None and budget < 1:
            raise ValueError("prefill_budget must be >= 1 (or None)")
        self.state = state
        self.prefill_fn = prefill_fn
        self.resume_fn = resume_fn
        self.fresh_fn = fresh_fn
        self.budget = budget
        self.jobs: list[PrefillJob] = []
        self.started = self.completed = 0
        self.chunks = self.chunk_tokens = 0

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
        self._plan(job)
        self.jobs.append(job)
        return job

    def tick(self) -> list[PrefillJob]:
        """Dispatch up to one budget of chunk work (FIFO over jobs). Returns
        jobs whose prefill completed this tick; the engine installs them
        into their slots."""
        budget = float("inf") if self.budget is None else self.budget
        spent = 0
        done = []
        for job in list(self.jobs):
            if spent >= budget:
                break
            while job.cuts and spent < budget:
                spent += self._dispatch(job)
            if not job.cuts:
                self._finish(job)
                done.append(job)
        return done

    def drop(self, job: PrefillJob):
        """Evict an in-flight prefill (its PartialPrefill carry is simply
        released)."""
        self.jobs.remove(job)

    def stats(self) -> dict:
        return {
            "started": self.started,
            "completed": self.completed,
            "inflight": len(self.jobs),
            "chunks": self.chunks,
            "chunk_tokens": self.chunk_tokens,
        }

    def reset_stats(self):
        self.started = self.completed = 0
        self.chunks = self.chunk_tokens = 0

    def _plan(self, job: PrefillJob):
        """The job's cut list: one whole-prompt dispatch for a kind that is
        not resumable, else bucket_chunks cuts capped by the budget."""
        plen = int(job.req.prompt.shape[0])
        if not self.state.resumable:
            job.whole = True
            job.cuts = deque([plen])
            return
        job.part = PartialPrefill(self.fresh_fn(), 0)
        job.cuts = deque(bucket_chunks(0, plen, self.state.block_size,
                                       self.max_chunk_blocks))

    def _dispatch(self, job: PrefillJob) -> int:
        """Dispatch the job's next chunk (no host sync). Returns the chunk's
        token count for budget accounting."""
        cut = job.cuts.popleft()
        prompt = job.req.prompt
        if job.whole:
            logits, state = self.prefill_fn(prompt[None])
            job.part = PartialPrefill(state, cut, logits)
            self.chunks += 1
            self.chunk_tokens += cut
            return cut
        pos = job.part.n_tokens
        logits, state = self.resume_fn(prompt[None, pos:cut], job.part.state,
                                       pos)
        job.part = PartialPrefill(state, cut, logits)
        self.chunks += 1
        self.chunk_tokens += cut - pos
        return cut - pos

    def _finish(self, job: PrefillJob):
        self.jobs.remove(job)
        self.completed += 1
