"""JAX's threefry2x32 PRNG, bit for bit, in PyTorch.

The serve stack's determinism contract (a request's tokens depend only on
its seed, prompt and sampling parameters) is stated in JAX's key
schedule: ``PRNGKey(seed)``, ``fold_in``, ``split`` and the bits behind
``uniform``, ``gumbel`` and ``categorical``. This module rebuilds that
schedule so that the port samples the reference's tokens:

- the threefry2x32 hash (20 rounds, rotations 13/15/26/6 and 17/29/16/24,
  key schedule with 0x1BD11BDA);
- the ``jax_threefry_partitionable=True`` layouts: ``split`` and
  ``random_bits`` hash a 64-bit iota held as (hi, lo) word pairs, one
  hash per output element (not the legacy counter layout, which hashes a
  flat 32-bit iota in two halves);
- ``uniform``'s mantissa fill (random bits >> 9 | the bits of 1.0, minus
  1.0, then one fused multiply-add into [minval, maxval), as XLA emits it)
  and ``gumbel``'s default "low" mode, -log(-log(uniform(tiny, 1)));
- XLA's float32 ``log`` on the CPU, which is not the correctly rounded
  log that ``torch.log`` gives: the Cephes polynomial with its fused
  multiply-adds (``xla_log``). It is within 1 ulp of ``torch.log`` and
  equals XLA's on every value ``uniform(tiny, 1)`` can return and on its
  log's negation, so Gumbel noise and ``categorical`` match bit for bit.
  A fused multiply-add of float32 operands is taken in float64, where the
  product is exact.

Words are uint32 values held in int64 tensors and masked to 32 bits after
every add and shift (torch's uint32 lacks most arithmetic). A key is an
int64 tensor of shape (..., 2); leading axes batch independent keys, as
``jax.vmap`` over keys would. Everything runs on the keys' device, with no
host sync: Python ints enter only as kernel scalars.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
TINY_F32 = torch.finfo(torch.float32).tiny


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of count words (x1, x2) under key words (k1,
    k2); all int64 tensors of uint32 values, broadcast together. Returns
    the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 (2,) tensor.

    JAX (without x64) takes an int seed as int32: the high word is 0 and
    the low word is the seed's two's-complement bits."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit int32, as JAX takes it")
    return torch.tensor([0, seed & MASK], dtype=torch.int64)


def key_words(key: torch.Tensor):
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the count (0, data).
    `data` is an int or an int64 tensor broadcast against key[..., 0]."""
    k1, k2 = key_words(key)
    if not torch.is_tensor(data):
        data = torch.full_like(k1, int(data) & MASK)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(data), data & MASK)
    return torch.stack([y1, y2], dim=-1)


def _iota_2x32(shape, device):
    """iota_2x32_shape: the 64-bit row-major index of every element of
    `shape`, as (hi, lo) words."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (partitionable layout): (..., num, 2)."""
    k1, k2 = key_words(key)
    hi, lo = _iota_2x32((num,), key.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of `shape` (partitionable layout):
    (..., *shape) int64 holding uint32 values."""
    shape = tuple(shape)
    k1, k2 = key_words(key)
    hi, lo = _iota_2x32(shape, key.device)
    lead = (...,) + (None,) * len(shape)
    b1, b2 = threefry2x32(k1[lead], k2[lead], hi, lo)
    return b1 ^ b2


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    f64 = torch.float64
    a, b, c = (x.to(f64) if torch.is_tensor(x) else x for x in (a, b, c))
    return (a * b + c).to(torch.float32)


# Cephes' log polynomial, as XLA's CPU backend evaluates it
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524


def _f32(v: float) -> float:
    """A Python float rounded to float32, as XLA holds its constants."""
    return torch.tensor(v, dtype=torch.float32).item()


_LOG_P = tuple(_f32(p) for p in _LOG_P)
_LOG_Q1, _LOG_Q2, _SQRTHF = _f32(_LOG_Q1), _f32(_LOG_Q2), _f32(_SQRTHF)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU, for positive finite x (what Gumbel
    noise takes): mantissa in [sqrt(1/2), sqrt(2)) less 1, Cephes'
    degree-8 polynomial in it, the exponent's ln 2 split in two."""
    x = torch.clamp_min(x, TINY_F32)
    bits = x.view(torch.int32)
    emm0 = (bits >> 23) - 0x7F
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    e = 1.0 + emm0.to(torch.float32)
    small = m < _SQRTHF
    tmp1 = torch.where(small, m, 0.0)
    m = m - 1.0
    e = e - torch.where(small, 1.0, 0.0)
    m = m + tmp1
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    m = m - 0.5 * x2
    m = m + y
    return m + _LOG_Q2 * e


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (..., *shape)."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | _ONE_F32_BITS           # < 2^31: fits int32
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    f32 = dict(dtype=torch.float32, device=key.device)
    lo = minval if torch.is_tensor(minval) else torch.full((), minval, **f32)
    hi = maxval if torch.is_tensor(maxval) else torch.full((), maxval, **f32)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low" (JAX's default:
    ``jax_high_dynamic_range_gumbel`` is off)."""
    return -xla_log(-xla_log(uniform(key, shape, TINY_F32, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis (float32
    logits): the argmax of logits + Gumbel noise; ties go to the first
    index in both frameworks. key (..., 2), logits (..., V) -> (...,)."""
    return torch.argmax(gumbel(key, logits.shape[-1:]) + logits, dim=-1)
