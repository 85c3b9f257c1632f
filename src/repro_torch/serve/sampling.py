"""Per-request sampling for the serve stack (temperature / top-k / top-p).

Port of the JAX package's ``serve/sampling.py``. One sampler serves every
consumer: ``generate``, the engine's first token off a prefill, and the
engine's decode tick. ``sample_token`` takes every slot in one call, with
per-slot temperature, top-k, top-p and greedy tensors (the reference
``vmap``s a per-slot function), so a greedy request and a sampled one
share a tick with no Python loop over slots.

Determinism contract (the reference's): a request's tokens depend only on
``(seed, prompt, SamplingParams)``, never on its slot, its admission
order or what shares its batch. Its PRNG stream starts at
``request_key(seed)`` and advances by one ``split`` per sampled token
(the first at the prefill's first token); the keys are JAX's threefry,
rebuilt bit for bit in ``serve/prng.py``.

A key is an int64 (..., 2) tensor of uint32 words.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.serve import prng


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    temperature: 0 => greedy (argmax). top_k: 0 disables; k >= 1 keeps the
    k highest logits. top_p: 1.0 disables; in (0, 1) keeps the smallest
    prefix of the sorted distribution with cumulative probability >= p
    (the argmax token is always kept). seed: the request's whole PRNG
    stream. greedy: explicit override; None => temperature <= 0.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    greedy: bool | None = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.greedy is False and self.temperature <= 0.0:
            raise ValueError("greedy=False requires temperature > 0")

    @property
    def is_greedy(self) -> bool:
        return self.greedy if self.greedy is not None else self.temperature <= 0.0

    def describe(self) -> str:
        """"greedy", "t=0.8" or "t=0.8 k=40 p=0.95" (defaults omitted)."""
        if self.is_greedy:
            return "greedy"
        parts = [f"t={self.temperature:g}"]
        if self.top_k:
            parts.append(f"k={self.top_k}")
        if self.top_p < 1.0:
            parts.append(f"p={self.top_p:g}")
        return " ".join(parts)


class SlotSampling(NamedTuple):
    """Slot-stacked device mirror of SamplingParams (engine state)."""
    temperature: torch.Tensor   # (slots,) f32
    top_k: torch.Tensor         # (slots,) int64, 0 = off
    top_p: torch.Tensor         # (slots,) f32
    greedy: torch.Tensor        # (slots,) bool


def init_slot_sampling(slots: int, device=None) -> SlotSampling:
    """All-greedy stacked params (free slots sample along harmlessly)."""
    return SlotSampling(
        temperature=torch.zeros(slots, dtype=torch.float32, device=device),
        top_k=torch.zeros(slots, dtype=torch.int64, device=device),
        top_p=torch.ones(slots, dtype=torch.float32, device=device),
        greedy=torch.ones(slots, dtype=torch.bool, device=device))


def device_scalars(sp: SamplingParams, rows: int = 1, device=None
                   ) -> SlotSampling:
    """`sp` as (rows,) tensors of SlotSampling's dtypes, made by fills (no
    host-to-device copy)."""
    def fill(v, dt):
        return torch.full((rows,), v, dtype=dt, device=device)
    return SlotSampling(fill(float(sp.temperature), torch.float32),
                        fill(int(sp.top_k), torch.int64),
                        fill(float(sp.top_p), torch.float32),
                        fill(bool(sp.is_greedy), torch.bool))


def set_slot(samp: SlotSampling, slot: int, sp: SamplingParams
             ) -> SlotSampling:
    """Write one slot's params in place (fills: no host sync); returns
    that slot's (1,) views."""
    samp.temperature[slot].fill_(float(sp.temperature))
    samp.top_k[slot].fill_(int(sp.top_k))
    samp.top_p[slot].fill_(float(sp.top_p))
    samp.greedy[slot].fill_(bool(sp.is_greedy))
    return SlotSampling(*(x[slot:slot + 1] for x in samp))


def init_slot_keys(slots: int, device=None) -> torch.Tensor:
    """(slots, 2) raw keys; admission overwrites one per request."""
    return torch.zeros((slots, 2), dtype=torch.int64, device=device)


def request_key(seed: int, row: int = 0) -> torch.Tensor:
    """The PRNG stream of one request, on the CPU: depends only on (seed,
    row).

    `generate` gives batch row r the stream `request_key(seed, r)`; the
    engine is batch 1 per request and uses row 0, which is what makes the
    two paths give the same tokens."""
    return prng.fold_in(prng.prng_key(seed), row)


def advance_key(key: torch.Tensor, n: int) -> torch.Tensor:
    """The request stream key after `n` emitted tokens (`sample_step`
    advances a stream as split(key)[0] once per token)."""
    for _ in range(n):
        key = prng.split(key)[..., 0, :]
    return key


# Filter candidate budget, as in the reference: top-k / top-p thresholds
# come from the CANDIDATES largest logits instead of a full-vocab sort.
# Exact whenever the vocab fits (V <= CANDIDATES) or the filtered set does
# (top_k <= CANDIDATES and the p-mass nucleus inside the top CANDIDATES
# logits); the top_k=0 / top_p>=1.0 bypass never touches candidates.
CANDIDATES = 128


def sample_token(key, logits, temperature, top_k, top_p, greedy):
    """Sample one token id per row from unnormalized logits.

    key (S, 2); logits (S, V); temperature, top_p (S,) f32; top_k (S,)
    int64; greedy (S,) bool. Returns (S,) int64.

    Filtering masks to -inf in f32 on the temperature-scaled logits:
    top-k keeps the k largest, then top-p keeps the shortest descending
    prefix of the candidates reaching cumulative probability p (ties at
    the threshold all kept). The candidates' values, not their indices,
    set the threshold, so the order `topk` gives equal values does not
    matter. top_k=0 and top_p>=1.0 are exact no-ops.
    """
    l32 = logits.to(torch.float32)
    greedy_tok = torch.argmax(l32, dim=-1)
    v = l32.shape[-1]
    c = min(v, CANDIDATES)
    t = torch.where(temperature > 0, temperature, 1.0)
    scaled = l32 / t[:, None]
    cand = torch.topk(scaled, c, dim=-1).values           # (S, c) descending
    k = torch.where(top_k <= 0, c, top_k.clamp(1, c))
    in_k = torch.arange(c, device=l32.device)[None, :] < k[:, None]
    neg_inf = torch.full((), float("-inf"), device=l32.device)
    cand_kept = torch.where(in_k, cand, neg_inf)
    # nucleus probabilities: over the top-k-kept set when top-k is on,
    # over the full vocab when off
    lse = torch.where(top_k <= 0, torch.logsumexp(scaled, dim=-1),
                      torch.logsumexp(cand_kept, dim=-1))
    probs = torch.exp(cand_kept - lse[:, None])
    cum_excl = torch.cumsum(probs, dim=-1) - probs         # mass strictly above
    keep = in_k & ((cum_excl < top_p[:, None]) | (top_p >= 1.0)[:, None])
    keep = keep | (torch.arange(c, device=l32.device) == 0)  # argmax always kept
    # both filters keep a prefix of the descending candidates, so one
    # logit threshold applies them jointly in the original order
    thresh = torch.where(keep, cand, -neg_inf).amin(dim=-1)
    thresh = torch.where((top_k <= 0) & (top_p >= 1.0), neg_inf, thresh)
    masked = torch.where(scaled >= thresh[:, None], scaled, neg_inf)
    tok = prng.categorical(key, masked)
    return torch.where(greedy, greedy_tok, tok)


def sample_step(key, logits, temperature, top_k, top_p, greedy):
    """One step of each row's sampling schedule: split the stream key,
    sample from the logits with the second half. Returns (tokens (S,),
    advanced keys (S, 2)). Every consumer goes through this, so the key
    schedule (one split per emitted token) is the same everywhere."""
    keys = prng.split(key)
    return (sample_token(keys[:, 1], logits, temperature, top_k, top_p,
                         greedy), keys[:, 0])


def sample_first(logits, key, samp: SlotSampling, *, logprobs: bool = False):
    """A request's first token, from its prefill's last-position logits
    (1, V): the first split of its stream happens here. Returns (token
    (1,), advanced key (1, 2), log-probability (1,) f32, 0 unless
    `logprobs`)."""
    tok, key = sample_step(key, logits, *samp)
    if logprobs:
        lp = token_logprobs(logits, tok)
    else:
        lp = torch.zeros(tok.shape, dtype=torch.float32, device=tok.device)
    return tok, key, lp


def token_logprobs(logits, tok):
    """log_softmax of the raw (pre-sampling) logits at each row's token."""
    lsm = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lsm, -1, tok[:, None])[:, 0]
