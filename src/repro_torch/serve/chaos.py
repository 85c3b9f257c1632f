"""Seeded fault injection for the replicated serving stack.

The port of the JAX package's ``serve/chaos.py`` (host code only, the
port's own copy; the seeded choice of a victim goes through Python's
``random.Random(seed)`` as the reference's does, so the same seed picks the
same replica in both packages).

Chaos testing a serving fleet only means something if the fault schedule
is reproducible: the CI gate compares a `--chaos kill@N` run's tokens
against the fault-free run bit-for-bit, so the injector must be pure
host-side, deterministic under a seed, and armable at an exact engine
tick. Each `ChaosSpec` names one fault at one tick on one replica
(explicit `rN`, or seeded-random at `arm()` time); the coordinator
(serve/replicas.py) calls `before_tick` right before stepping a replica
and treats a raised `ReplicaKilled` — or an injected hang it times out —
as that replica's death.

Fault kinds:
  kill           raise ReplicaKilled before the tick (hard crash)
  hang           sleep `seconds` inside the tick (death iff the
                 coordinator's hang timeout is exceeded)
  slow-tick      sleep a small `seconds` on `count` consecutive ticks
                 (a straggler, not a death — the StragglerDetector
                 should flag it)
  drop-snapshot  suppress the replica's checkpoint writes from the tick
                 onward (`count` drops, default all) — recovery then
                 falls back to full prompt prefill + token replay
  disk-flake     arm the shared PrefixCache's `io_fault` hook to raise
                 OSError on the next `count` disk ops (absorbed by
                 with_retries when count <= its retry budget)

Spec syntax (``parse_chaos``): ``KIND@TICK`` with optional ``:rN``
(replica), ``:xN`` (count), ``:sF`` (seconds); several specs join with
commas; ``none`` (or "") is the empty schedule. Examples: ``kill@12``,
``hang@8:r1:s0.4``, ``slow-tick@5:x8``, ``kill@6,disk-flake@0:x2``.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, replace

FAULT_KINDS = ("kill", "hang", "slow-tick", "drop-snapshot", "disk-flake")

_DEFAULT_SECONDS = {"hang": 1.0, "slow-tick": 0.05}
_DEFAULT_COUNT = {"slow-tick": 5, "disk-flake": 2}


class ReplicaKilled(RuntimeError):
    """Raised inside a replica's tick by an armed `kill` fault."""


@dataclass(frozen=True)
class ChaosSpec:
    kind: str
    tick: int
    replica: int | None = None   # None => seeded-random at arm() time
    seconds: float | None = None
    count: int | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.tick}")

    def describe(self) -> str:
        s = f"{self.kind}@{self.tick}"
        if self.replica is not None:
            s += f":r{self.replica}"
        if self.count is not None:
            s += f":x{self.count}"
        if self.seconds is not None:
            s += f":s{self.seconds:g}"
        return s


def parse_chaos(text: str) -> list[ChaosSpec]:
    """Parse a ``--chaos`` schedule string into specs (see module doc)."""
    text = (text or "").strip()
    if text in ("", "none"):
        return []
    specs = []
    for part in text.split(","):
        part = part.strip()
        if "@" not in part:
            raise ValueError(
                f"chaos spec {part!r}: expected KIND@TICK[:rN][:xN][:sF]")
        kind, _, rest = part.partition("@")
        fields = rest.split(":")
        try:
            tick = int(fields[0])
        except ValueError:
            raise ValueError(f"chaos spec {part!r}: bad tick {fields[0]!r}")
        spec = ChaosSpec(kind=kind.strip(), tick=tick)
        for f in fields[1:]:
            if not f:
                continue
            tag, val = f[0], f[1:]
            if tag == "r":
                spec = replace(spec, replica=int(val))
            elif tag == "x":
                spec = replace(spec, count=int(val))
            elif tag == "s":
                spec = replace(spec, seconds=float(val))
            else:
                raise ValueError(
                    f"chaos spec {part!r}: unknown field {f!r} "
                    "(expected rN / xN / sF)")
        specs.append(spec)
    return specs


class ChaosInjector:
    """Holds an armed fault schedule and fires it from `before_tick`.

    `arm(n_replicas)` resolves every spec with `replica=None` to a
    concrete replica through `random.Random(seed)` — same seed, same
    victims — and freezes the schedule. All sleeps/raises happen on the
    host thread driving the replica; nothing here touches device state.
    """

    def __init__(self, specs: list[ChaosSpec] | str = (), *, seed: int = 0):
        if isinstance(specs, str):
            specs = parse_chaos(specs)
        self.specs = [s if s.seconds is not None else
                      replace(s, seconds=_DEFAULT_SECONDS.get(s.kind))
                      for s in specs]
        self.specs = [s if s.count is not None else
                      replace(s, count=_DEFAULT_COUNT.get(s.kind))
                      for s in self.specs]
        self.seed = seed
        self.armed: list[ChaosSpec] = []
        self.fired: list[str] = []
        self._disk_left = 0

    def arm(self, n_replicas: int) -> list[ChaosSpec]:
        rng = random.Random(self.seed)
        armed = []
        for s in self.specs:
            if s.replica is None:
                s = replace(s, replica=rng.randrange(n_replicas))
            elif not 0 <= s.replica < n_replicas:
                raise ValueError(
                    f"chaos spec {s.describe()} targets replica "
                    f"{s.replica} but only {n_replicas} exist")
            armed.append(s)
        self.armed = armed
        self._disk_left = sum(s.count or 0 for s in armed
                              if s.kind == "disk-flake")
        return armed

    # -- coordinator hooks -------------------------------------------------

    def before_tick(self, replica: int, tick: int):
        """Fire any fault due on (replica, tick). Raises ReplicaKilled for
        `kill`; sleeps for `hang`/`slow-tick` (the coordinator's own tick
        timing turns a long enough hang into a death)."""
        for s in self.armed:
            if s.replica != replica:
                continue
            if s.kind == "kill" and tick == s.tick:
                self.fired.append(s.describe())
                raise ReplicaKilled(
                    f"chaos: replica {replica} killed at tick {tick}")
            if s.kind == "hang" and tick == s.tick:
                self.fired.append(s.describe())
                time.sleep(s.seconds)
            elif (s.kind == "slow-tick"
                    and s.tick <= tick < s.tick + (s.count or 1)):
                self.fired.append(s.describe())
                time.sleep(s.seconds)

    def drops_snapshot(self, replica: int, tick: int) -> bool:
        """True when this replica's checkpoint write at `tick` should be
        suppressed (an armed drop-snapshot window covers it)."""
        for s in self.armed:
            if (s.kind == "drop-snapshot" and s.replica == replica
                    and tick >= s.tick
                    and (s.count is None or tick < s.tick + s.count)):
                return True
        return False

    def io_fault_hook(self):
        """A callable for `PrefixCache.io_fault`, or None when no
        disk-flake fault is armed. Raises OSError on the first `count`
        disk operations, then passes everything."""
        if self._disk_left <= 0:
            return None

        def fault(op: str):
            if self._disk_left_dec():
                self.fired.append(f"disk-flake:{op}")
                raise OSError(f"chaos: injected {op} failure")
        return fault

    def _disk_left_dec(self) -> bool:
        if self._disk_left > 0:
            self._disk_left -= 1
            return True
        return False
