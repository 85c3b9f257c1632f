"""Fault-tolerance utilities: preemption handling, straggler detection and
retried I/O.

The port of ``PreemptionGuard``, ``StragglerDetector`` and ``with_retries``
from the JAX package's ``distributed/fault.py``; host-side Python, no
device code.
"""
from __future__ import annotations

import functools
import logging
import signal
import time
from collections import deque
from typing import Callable

log = logging.getLogger("repro_torch.fault")


class PreemptionGuard:
    """SIGTERM -> finish the current step, checkpoint, exit cleanly."""

    def __init__(self):
        self.preempted = False
        self._prev = None

    def install(self):
        def handler(signum, frame):
            log.warning("SIGTERM received: checkpoint-and-exit requested")
            self.preempted = True
        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def uninstall(self):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)


class StragglerDetector:
    """Flags steps that run slow.

    Keeps a rolling window of step durations; a step > mu + z*sigma is
    flagged.
    """

    def __init__(self, window: int = 50, z: float = 3.0, min_steps: int = 10):
        self.durations: deque[float] = deque(maxlen=window)
        self.z = z
        self.min_steps = min_steps
        self.flagged: list[tuple[int, float]] = []
        self._t0 = None
        self._step = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        if self._t0 is None:
            raise RuntimeError(
                "StragglerDetector.stop() without a matching start(); call "
                "start() at the beginning of the step being timed")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        """Record one externally-timed step duration (seconds)."""
        slow = False
        if len(self.durations) >= self.min_steps:
            mu = sum(self.durations) / len(self.durations)
            var = sum((d - mu) ** 2 for d in self.durations) / len(self.durations)
            if dt > mu + self.z * max(var, 1e-12) ** 0.5:
                slow = True
                self.flagged.append((self._step, dt))
                log.warning("straggler step %d: %.3fs vs mean %.3fs",
                            self._step, dt, mu)
        self.durations.append(dt)
        self._step += 1
        return slow


def with_retries(fn: Callable, *, retries: int = 3, backoff: float = 0.5,
                 on_retry: Callable | None = None):
    """Retry wrapper for flaky I/O (the prefix cache's disk tier): an
    OSError is retried after `backoff * 2**attempt` seconds, up to
    `retries` times, then raised. `on_retry(attempt, exc)` is called before
    each sleep (the caller's retry counter)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except OSError as e:  # noqa: PERF203
                if attempt == retries:
                    raise
                if on_retry is not None:
                    on_retry(attempt + 1, e)
                log.warning("retry %d/%d after %s", attempt + 1, retries, e)
                time.sleep(backoff * 2 ** attempt)
    return wrapped
