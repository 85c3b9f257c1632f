"""Synthetic datasets: a learnable Markov LM stream (perplexity-parity
benchmark) and the paper's two synthetic tasks (Appendix F): selective
copying and induction heads. All generators are deterministic in
(seed, step) so the data pipeline state is a pair of ints.

The port's own copy of the JAX package's ``data/synthetic.py`` (numpy
only): the same seed and step give the same tokens in both packages.
"""
from __future__ import annotations

import numpy as np


def make_markov_lm(vocab: int, seed: int = 0, branching: int = 4):
    """A sparse random Markov chain; entropy well below uniform so models can
    visibly learn. Returns sample(batch, seq, step) -> tokens (B, S+1)."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, vocab, size=(vocab, branching))
    probs = rng.dirichlet(np.ones(branching) * 0.5, size=vocab)

    def sample(batch: int, seq: int, step: int) -> np.ndarray:
        r = np.random.default_rng((seed * 1_000_003 + step) % (2 ** 63))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = r.integers(0, vocab, size=batch)
        for t in range(seq):
            u = r.random(batch)
            cum = np.cumsum(probs[toks[:, t]], axis=1)
            choice = (u[:, None] > cum).sum(1).clip(0, branching - 1)
            toks[:, t + 1] = nxt[toks[:, t], choice]
        return toks

    return sample


def selective_copying(batch: int, seq: int, step: int, *, n_colors: int = 16,
                      n_memorize: int = 8, seed: int = 0):
    """Paper F.1 / Gu & Dao: colored tokens at random positions in a noise
    stream; the model must emit them in order at the end.

    vocab layout: 0 = noise, 1 = separator, 2.. = colors.
    Returns (tokens (B, S+1), loss_mask (B, S)) for next-token training.
    """
    r = np.random.default_rng((seed * 7_777_777 + step) % (2 ** 63))
    total = seq + 1
    ctx = total - n_memorize - 1
    toks = np.zeros((batch, total), np.int32)
    mask = np.zeros((batch, seq), np.float32)
    for i in range(batch):
        pos = np.sort(r.choice(ctx, size=n_memorize, replace=False))
        colors = r.integers(2, 2 + n_colors, size=n_memorize)
        toks[i, pos] = colors
        toks[i, ctx] = 1
        toks[i, ctx + 1:] = colors
        mask[i, ctx:] = 1.0  # predict positions ctx+1 .. end
    return toks, mask


def induction_heads(batch: int, seq: int, step: int, *, vocab: int = 16,
                    seed: int = 0):
    """Paper F.2: random tokens; a special token appears once at a random
    position; the second-to-last token repeats it; the model must output the
    token that followed the first occurrence.

    vocab layout: 0..vocab-1 = random tokens, vocab = special.
    Returns (tokens (B, S+1), loss_mask (B, S))."""
    r = np.random.default_rng((seed * 3_333_333 + step) % (2 ** 63))
    total = seq + 1
    toks = r.integers(0, vocab, size=(batch, total)).astype(np.int32)
    mask = np.zeros((batch, seq), np.float32)
    special = vocab
    for i in range(batch):
        p = r.integers(0, total - 4)
        toks[i, p] = special
        toks[i, total - 2] = special
        toks[i, total - 1] = toks[i, p + 1]
        mask[i, seq - 1] = 1.0
    return toks, mask
