"""Prefix-reuse snapshot cache: content-addressed constant-size decode state.

Port of the JAX package's ``serve/prefix_cache.py``. A polysketch model's
decode state is constant in size, so a cached prefix of any length is one
snapshot of the folded prefix state ``z`` per layer (r^2 x (h+1) per kv
head): a request sharing a system prompt restores it and prefills only its
suffix. At gpt2s-polysketch's full width a snapshot is 13 layers x 12 kv
heads x 1024 x 65 x 4 B = 41,533,440 B, whatever the prefix's length. The
recurrent kinds snapshot their whole constant-size state (SSD and RG-LRU:
h and the conv window; a ring: its W slots of k and v).

The store is written against the DecodeState protocol (core.state): it
never inspects the model; snapshots are opaque lists of per-layer
snapshots and serialization goes through the codec the engine binds.

Content addressing: a SHA-256 chain over block_size-token prompt blocks,
key_d = H(key_{d-1} || int32 tokens of block d), so a lookup walks the
request's own chain and the deepest key present is the longest reusable
prefix. The chain is the reference's, byte for byte.

Admission (both tiers subject to the engine's ``min_snapshot_blocks``):
after every prefill the state at the prompt's block-aligned truncation is
inserted; a bounded seen-key set records every chain key served, and a
lookup that finds a seen-but-unsnapshotted boundary deeper than its best
snapshot (a second request sharing that prefix) splits the prefill there
and snapshots it ("promote on the second sighting").

Eviction is by hit count under a byte budget: the victim is the least-hit
entry, ties broken LRU. The memory tier keeps snapshots where the engine
made them (on the card): no host copy on insert or hit.

Persistence: with ``save_dir`` every admitted snapshot is also written to
``save_dir/<params fingerprint>/<chain key>.npz`` through the bound codec
(a copy of the snapshot to the host), and missing keys are probed lazily
on lookup, so a restarted engine warms itself from the store. Reads and
writes are retried (distributed.fault.with_retries); a corrupt file is
quarantined (renamed ``.bad``) and counted, an oversized one skipped, and
a persistent I/O fault degrades to a miss. The fingerprint is the port's
own: the two packages do not share disk stores.

Bit-exactness: a resumable prefill runs on the block grid (core.state), so
a prefill resumed from a snapshot makes exactly the calls the cold prefill
makes from there on, and gives the same bits.
"""
from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.distributed.fault import with_retries


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def snapshot_nbytes(snapshot) -> int:
    """Bytes of a snapshot's tensors (a ring's host-int position is none)."""
    return sum(x.numel() * x.element_size() for x in _leaves(snapshot)
               if torch.is_tensor(x))


def params_fingerprint(module: torch.nn.Module) -> bytes:
    """Content fingerprint of a module's parameters.

    Hashes every parameter's name, shape and dtype (in named_parameters
    order), its first 32 values, and its sum and abs-sum (so an edit
    anywhere in it moves the fingerprint). The values and sums are
    gathered on the parameters' device into one small float64 tensor and
    copied to the host once: the weights themselves never leave the card.
    Two engines attaching one PrefixCache with different weights are
    rejected instead of restoring foreign state."""
    h = hashlib.sha256()
    parts = []
    for name, p in module.named_parameters():
        h.update(name.encode())
        h.update(str((tuple(p.shape), str(p.dtype))).encode())
        flat = p.detach().reshape(-1)
        parts.append(flat[:32].to(torch.float64))
        if p.is_floating_point():
            parts.append(torch.stack([flat.sum(dtype=torch.float32),
                                      flat.abs().sum(dtype=torch.float32)])
                         .to(torch.float64))
    if parts:
        h.update(torch.cat(parts).cpu().numpy().tobytes())
    return h.digest()


# ---------------------------------------------------------------------------
# the content-addressed store
# ---------------------------------------------------------------------------

@dataclass
class _Entry:
    snapshot: object
    n_tokens: int
    nbytes: int
    hits: int = 0


@dataclass
class PrefillPlan:
    """What the scheduler should do for one prompt (host ints).

    n_restore: tokens covered by the best snapshot (0 = cold start).
    snapshot:  the snapshot to restore, or None.
    n_promote: seen-but-unsnapshotted shared boundary to split the prefill
               at and snapshot (None = no promote split).
    n_trunc:   the prompt's block-aligned truncation, snapshotted after the
               prefill completes (0 = below the admission floor).
    """
    n_restore: int = 0
    snapshot: object = None
    n_promote: int | None = None
    promote_key: bytes = b""
    n_trunc: int = 0
    trunc_key: bytes = b""


class PrefixCache:
    """Byte-budgeted store of constant-size prefix-state snapshots.

    block_size is bound by the engine to the model's state grid
    (cfg.lt_block_size): snapshots are valid only at its multiples.
    `save_dir` adds a disk tier (see the module docstring); it needs the
    engine-bound codec and params fingerprint before any I/O happens.
    """

    def __init__(self, max_bytes: int, block_size: int | None = None, *,
                 max_seen_keys: int = 1 << 16, save_dir: str | None = None):
        if max_bytes < 1:
            raise ValueError("max_bytes must be positive")
        self.max_bytes = int(max_bytes)
        self.block_size = block_size
        self.max_seen_keys = max_seen_keys
        self.save_dir = save_dir
        self._params_fp: bytes | None = None
        self._serialize = None
        self._deserialize = None
        self._entries: OrderedDict[bytes, _Entry] = OrderedDict()
        self._seen: OrderedDict[bytes, None] = OrderedDict()
        # eviction index: hit count -> recency-ordered keys
        self._hit_buckets: dict[int, OrderedDict[bytes, None]] = {}
        # disk keys that failed to load or to admit: never re-read
        self._disk_skip: OrderedDict[bytes, None] = OrderedDict()
        # decode-state checkpoints: tag -> up to two (n_tokens, bytes)
        # pairs, deepest last; a keyspace of its own (see put_ckpt)
        self._ckpts: dict[bytes, list[tuple[int, bytes]]] = {}
        self.ckpt_bytes = 0
        self.bytes = 0
        self.lookups = self.hits = self.misses = 0
        self.hit_tokens = 0
        self.inserts = self.evictions = 0
        self.disk_loads = self.disk_writes = 0
        self.disk_corrupt = self.disk_retries = 0
        self.ckpt_puts = self.ckpt_hits = self.ckpt_misses = 0
        self.ckpt_drops = self.ckpt_corrupt = 0
        self._tracer = None  # serve.telemetry.Tracer, engine-attached
        # fault-injection hook: called with "read" / "write" at the top of
        # every raw disk attempt, inside the retry wrapper; raising OSError
        # simulates a flaky store
        self.io_fault = None
        retry_kw = dict(retries=2, backoff=0.02,
                        on_retry=self._note_disk_retry)
        self._read_retry = with_retries(self._raw_read, **retry_kw)
        self._write_retry = with_retries(self._raw_write, **retry_kw)

    def attach_tracer(self, tracer):
        """Store internals (evictions, disk loads, quarantines) emit
        instants on the tracer's "cache" track."""
        self._tracer = tracer

    def bind_block_size(self, block_size: int):
        if self.block_size is None:
            self.block_size = block_size
        elif self.block_size != block_size:
            raise ValueError(
                f"prefix cache bound to block_size={self.block_size}, "
                f"engine model uses {block_size}")

    def bind_params(self, module, state_sig: bytes = b""):
        """Tie the store to one parameter set and, through `state_sig`,
        one snapshot leaf signature: snapshots are valid only under the
        weights and shapes that produced them."""
        fp = params_fingerprint(module)
        if state_sig:
            fp = hashlib.sha256(fp + state_sig).digest()
        if self._params_fp is None:
            self._params_fp = fp
        elif self._params_fp != fp:
            raise ValueError(
                "prefix cache already holds snapshots for different model "
                "weights or snapshot shapes; use one PrefixCache per "
                "(parameter set, snapshot shape) pair")

    def bind_codec(self, serialize, deserialize):
        """Snapshot (de)serializers from the engine's DecodeState."""
        self._serialize = serialize
        self._deserialize = deserialize

    # -- content addressing ------------------------------------------------

    def _chain(self, tokens, n_blocks: int) -> list[bytes]:
        """key_d for d = 1..n_blocks over block_size-token prompt blocks."""
        blk = self.block_size
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))  # jaxlint: disable=host-sync-in-jit-path -- prompts are host ints (engine.submit); hashing needs host bytes
        key = hashlib.sha256(b"psk-prefix:%d" % blk).digest()
        keys = []
        for d in range(n_blocks):
            key = hashlib.sha256(
                key + toks[d * blk:(d + 1) * blk].tobytes()).digest()
            keys.append(key)
        return keys

    def chain_keys(self, tokens, n_blocks: int) -> list[bytes]:
        """Read-only chain keys for the first n_blocks prompt blocks (no
        stats, no seen-marking, no I/O): the scheduler matches a prompt
        against boundaries in-flight prefills have announced."""
        assert self.block_size, "bind_block_size() first"
        return self._chain(tokens, n_blocks)

    def resident_depth(self, keys) -> int:
        """Deepest in-memory entry along `keys` (read-only)."""
        best = 0
        for d, key in enumerate(keys, start=1):
            if key in self._entries:
                best = d
        return best

    # -- disk tier ---------------------------------------------------------

    @property
    def _disk_ready(self) -> bool:
        return (self.save_dir is not None and self._params_fp is not None
                and self._deserialize is not None)

    def _disk_path(self, key: bytes) -> str:
        return os.path.join(self.save_dir, self._params_fp.hex()[:16],
                            key.hex() + ".npz")

    def _note_disk_retry(self, attempt: int, exc: Exception):
        self.disk_retries += 1

    def _raw_read(self, path: str) -> bytes:
        if self.io_fault is not None:
            self.io_fault("read")
        with open(path, "rb") as f:
            return f.read()

    def _raw_write(self, path: str, tmp: str, data: bytes):
        if self.io_fault is not None:
            self.io_fault("write")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _quarantine(self, path: str):
        """Rename an unreadable snapshot file out of the store (``.bad``)
        and count it: corruption is a miss, not a crash."""
        self.disk_corrupt += 1
        try:
            os.replace(path, path + ".bad")
        except OSError:
            pass
        if self._tracer:
            self._tracer.instant("cache", "disk_corrupt",
                                 path=os.path.basename(path))

    def _disk_probe(self, key: bytes) -> bool:
        """Pull a persisted snapshot into the memory tier; True iff the key
        is now a usable entry. A missing file, a persistently unreadable
        one, a corrupt one (quarantined) and one that cannot fit the budget
        all land in a bounded skip-set, so no lookup probes them twice."""
        if key in self._disk_skip:
            return False
        path = self._disk_path(key)
        if not os.path.exists(path):
            self._mark_disk_skip(key)
            return False
        try:
            data = self._read_retry(path)
        except OSError:
            # the path fails, the file may be fine: skip, no quarantine
            self._mark_disk_skip(key)
            return False
        try:
            snapshot, n_tokens = self._deserialize(data)
        except Exception:
            self._quarantine(path)
            self._mark_disk_skip(key)
            return False
        if self._admit(key, n_tokens, snapshot):
            self.disk_loads += 1
            if self._tracer:
                self._tracer.instant("cache", "disk_load",
                                     n_tokens=int(n_tokens))
            return True
        self._mark_disk_skip(key)
        return False

    def _mark_disk_skip(self, key: bytes):
        self._disk_skip[key] = None
        self._disk_skip.move_to_end(key)
        while len(self._disk_skip) > self.max_seen_keys:
            self._disk_skip.popitem(last=False)

    def _disk_write(self, key: bytes, n_tokens: int, snapshot):
        """Best-effort persistence: I/O errors are retried, then swallowed
        (the memory tier holds the entry). Serializing copies the snapshot
        to the host: one sync, on the admission tick that inserts."""
        if not self._disk_ready or self._serialize is None:
            return
        path = self._disk_path(key)
        # a pid-unique tmp name: engines sharing one save_dir never
        # interleave bytes; os.replace publishes whole files
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            if os.path.exists(path):
                return
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._write_retry(path, tmp, self._serialize(snapshot, n_tokens))
        except OSError:
            return
        self.disk_writes += 1

    # -- lookup / planning -------------------------------------------------

    def plan(self, tokens, min_blocks: int = 1) -> PrefillPlan:
        """Longest-prefix lookup and admission plan for one prompt.

        The match is capped at the deepest block boundary strictly inside
        the prompt (at least one token is left to prefill, for the
        first-token logits). Boundaries shallower than `min_blocks` blocks
        are never promoted or truncation-snapshotted (restoring an existing
        shallow snapshot is still allowed). Marks the prompt's chain keys
        as seen.
        """
        assert self.block_size, "bind_block_size() first"
        blk = self.block_size
        plen = int(len(tokens))
        self.lookups += 1
        trunc_d = plen // blk                 # full block-aligned truncation
        max_d = (plen - 1) // blk             # deepest usable match depth
        keys = self._chain(tokens, trunc_d)

        # every depth is probed: snapshots sit at truncation and promote
        # boundaries without their shallower keys, and the bounded seen-set
        # may have dropped a shallow key of a resident deeper snapshot
        hit_d = seen_d = 0
        for d in range(1, max_d + 1):
            key = keys[d - 1]
            if key in self._entries:
                hit_d = seen_d = d
            elif key in self._seen:
                seen_d = d
        if self._disk_ready:
            # the disk tier deepest-first: at most one snapshot is loaded
            # a lookup, and a shallow probe never evicts a deeper entry
            for d in range(max_d, hit_d, -1):
                if self._disk_probe(keys[d - 1]):
                    hit_d = d
                    seen_d = max(seen_d, d)
                    break

        admit_d = trunc_d if trunc_d >= min_blocks else 0
        plan = PrefillPlan(n_trunc=admit_d * blk,
                           trunc_key=keys[admit_d - 1] if admit_d else b"")
        if hit_d:
            key = keys[hit_d - 1]
            entry = self._entries[key]
            self._bucket_remove(key, entry.hits)
            entry.hits += 1
            self._bucket_add(key, entry.hits)
            self._entries.move_to_end(key)
            plan.n_restore = entry.n_tokens
            plan.snapshot = entry.snapshot
            self.hits += 1
            self.hit_tokens += entry.n_tokens
        else:
            self.misses += 1
        if seen_d > hit_d and seen_d >= min_blocks and seen_d != admit_d:
            # an earlier prompt shared this boundary and no snapshot exists
            # there yet: split the prefill and snapshot it. A seen boundary
            # at the truncation is left out: the truncation snapshot covers
            # it already
            plan.n_promote = seen_d * blk
            plan.promote_key = keys[seen_d - 1]

        for d in range(trunc_d):
            self._mark_seen(keys[d])
        return plan

    def _mark_seen(self, key: bytes):
        self._seen[key] = None
        self._seen.move_to_end(key)
        while len(self._seen) > self.max_seen_keys:
            self._seen.popitem(last=False)

    # -- admission / eviction ----------------------------------------------

    def _bucket_add(self, key: bytes, hits: int):
        self._hit_buckets.setdefault(hits, OrderedDict())[key] = None

    def _bucket_remove(self, key: bytes, hits: int):
        bucket = self._hit_buckets[hits]
        del bucket[key]
        if not bucket:
            del self._hit_buckets[hits]

    def _evict_one(self):
        """Victim = fewest hits, ties broken LRU."""
        low = min(self._hit_buckets)
        victim, _ = self._hit_buckets[low].popitem(last=False)
        if not self._hit_buckets[low]:
            del self._hit_buckets[low]
        old = self._entries.pop(victim)
        self.bytes -= old.nbytes
        self.evictions += 1
        if self._tracer:
            self._tracer.instant("cache", "evict", n_tokens=old.n_tokens,
                                 nbytes=old.nbytes, hits=old.hits)

    def _admit(self, key: bytes, n_tokens: int, snapshot) -> bool:
        if key in self._entries:
            self._entries.move_to_end(key)
            hits = self._entries[key].hits
            self._bucket_remove(key, hits)      # refresh recency
            self._bucket_add(key, hits)
            return False
        nbytes = snapshot_nbytes(snapshot)
        if nbytes > self.max_bytes:
            return False  # one snapshot larger than the whole budget
        while self.bytes + nbytes > self.max_bytes and self._entries:
            self._evict_one()
        self._entries[key] = _Entry(snapshot, int(n_tokens), nbytes)
        self._bucket_add(key, 0)
        self.bytes += nbytes
        self.inserts += 1
        return True

    def insert(self, key: bytes, n_tokens: int, snapshot):
        """Admit one snapshot under the byte budget; persist it when a disk
        tier is configured. The store keeps `snapshot` itself (on its
        device): pass one that nothing else writes, as DecodeState.snapshot
        returns."""
        if not key:
            return
        if self._admit(key, n_tokens, snapshot):
            self._disk_skip.pop(key, None)  # a local write beats a stale
            self._disk_write(key, n_tokens, snapshot)  # negative probe

    # -- decode-state checkpoints ------------------------------------------
    #
    # A keyspace of its own: a decode-produced state at position n is
    # numerically (not bitwise) the prefill-produced state at n, so a
    # checkpoint must never serve as a prefix hit. Checkpoints are keyed by
    # an opaque per-request tag and stored as the codec's bytes.

    def put_ckpt(self, tag: bytes, n_tokens: int, snapshot):
        """Checkpoint one live request's decode state under `tag`, keeping
        the two deepest positions a tag (under an overlapped engine the
        deepest can run one tick ahead of the host's token stream)."""
        if self._serialize is None:
            raise RuntimeError("put_ckpt() needs bind_codec() first")
        data = self._serialize(snapshot, int(n_tokens))
        ents = self._ckpts.setdefault(tag, [])
        for i, (n, old) in enumerate(ents):
            if n == int(n_tokens):
                self.ckpt_bytes -= len(old)
                ents.pop(i)
                break
        ents.append((int(n_tokens), data))
        ents.sort()
        while len(ents) > 2:
            _, old = ents.pop(0)
            self.ckpt_bytes -= len(old)
        self.ckpt_bytes += len(data)
        self.ckpt_puts += 1
        if self._tracer:
            self._tracer.instant("cache", "checkpoint",
                                 n_tokens=int(n_tokens), nbytes=len(data))

    def get_ckpt(self, tag: bytes, max_tokens: int | None = None):
        """Deepest usable checkpoint for `tag` -> (snapshot, n_tokens) or
        None; `max_tokens` caps the position. Corrupt entries are dropped
        and counted, never raised."""
        ents = self._ckpts.get(tag, [])
        for n, data in reversed(ents):
            if max_tokens is not None and n > max_tokens:
                continue
            try:
                snapshot, n_tok = self._deserialize(data)
            except Exception:
                self.ckpt_corrupt += 1
                ents.remove((n, data))
                self.ckpt_bytes -= len(data)
                continue
            self.ckpt_hits += 1
            return snapshot, int(n_tok)
        self.ckpt_misses += 1
        return None

    def drop_ckpt(self, tag: bytes):
        """Release a retired request's checkpoints."""
        ents = self._ckpts.pop(tag, None)
        if ents:
            self.ckpt_bytes -= sum(len(d) for _, d in ents)
            self.ckpt_drops += 1

    def flush_ckpts_to_disk(self) -> list[str]:
        """Persist every live checkpoint's deepest form to the disk tier.
        Returns the written paths; best-effort like _disk_write."""
        if self.save_dir is None or self._params_fp is None:
            return []
        d = os.path.join(self.save_dir, self._params_fp.hex()[:16])
        paths = []
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            return []
        for tag, ents in self._ckpts.items():
            if not ents:
                continue
            _, data = ents[-1]
            path = os.path.join(d, f"ckpt-{tag.hex()[:32]}.npz")
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                self._write_retry(path, tmp, data)
            except OSError:
                continue
            paths.append(path)
        return paths

    # -- accounting --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def reset_stats(self):
        self.lookups = self.hits = self.misses = 0
        self.hit_tokens = self.inserts = self.evictions = 0
        self.disk_loads = self.disk_writes = 0
        self.disk_corrupt = self.disk_retries = 0
        self.ckpt_puts = self.ckpt_hits = self.ckpt_misses = 0
        self.ckpt_drops = self.ckpt_corrupt = 0

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "entries": len(self._entries),
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "seen_keys": len(self._seen),
            "disk_loads": self.disk_loads,
            "disk_writes": self.disk_writes,
            "disk_corrupt": self.disk_corrupt,
            "disk_retries": self.disk_retries,
            "checkpoints": {
                "tags": len(self._ckpts),
                "bytes": self.ckpt_bytes,
                "puts": self.ckpt_puts,
                "hits": self.ckpt_hits,
                "misses": self.ckpt_misses,
                "drops": self.ckpt_drops,
                "corrupt": self.ckpt_corrupt,
            },
        }
