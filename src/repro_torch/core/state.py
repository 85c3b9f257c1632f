"""DecodeState: the decode-state lifecycle of one model.

A small port of the facade in the JAX package's ``core/state.py``:
``init``, ``prefill``, ``resume`` and ``decode_step``, with the state
kind of the model's mixer (``mixer_state_kind``) and whether a prefill can
be resumed (``resumable``). Snapshots, the full kind registry and slot
stacking are not ported yet.

- ``polysketch`` (resumable): prefill runs on the block grid. A prompt
  segment goes through the model in chunks that end on multiples of
  ``lt_block_size`` (absolute positions). A prefill resumed at a block
  boundary therefore makes exactly the calls, on exactly the shapes, that
  the cold prefill of the whole prompt makes from there on, and gives the
  same bits. A one-shot call over the whole prompt would not: cuBLAS picks
  its kernel by shape, and a product over 2040 rows need not round like
  one over 1024 + 1016 rows (seen on an H100).
- ``poly_kv`` and ``kv_full`` (not resumable): the full KV cache of exact
  polynomial attention and of softmax attention. Prefill is one call
  over the whole prompt, which attends to itself and is written into the
  cache at position 0, as in the reference; a prefill cannot continue
  from a state, so ``resume`` at a position past 0 raises. The cache is
  sized at init, so ``prefill`` needs ``max_len`` or a pre-built state.
"""
from __future__ import annotations

import torch

# kind -> resumable (the reference's StateSpec.resumable)
_RESUMABLE = {"polysketch": True, "poly_kv": False, "kv_full": False}


def mixer_state_kind(cfg) -> str:
    """The decode-state kind of the config's attention mixer."""
    kinds = {"polysketch": "polysketch", "polynomial": "poly_kv",
             "softmax": "kv_full"}
    if cfg.attention not in kinds:
        raise ValueError(f"no decode state ported for attention "
                         f"{cfg.attention!r}")
    return kinds[cfg.attention]


class DecodeState:
    """Cache lifecycle for one LM module (see models.transformer.LM)."""

    def __init__(self, lm):
        self.lm = lm
        self.cfg = lm.cfg
        self.kind = mixer_state_kind(lm.cfg)

    @property
    def block_size(self) -> int:
        """Resumed-prefill grid (multiples of lt_block_size)."""
        return self.cfg.lt_block_size

    @property
    def resumable(self) -> bool:
        return _RESUMABLE[self.kind]

    def init(self, batch: int, max_len: int | None = None):
        return self.lm.init_cache(batch, max_len)

    def prefill(self, tokens, state=None, *, max_len=None):
        """tokens (B, S) -> (last-position logits (B, V), state)."""
        if state is None:
            state = self.init(tokens.shape[0], max_len)
        return self.resume(tokens, state, 0)

    def resume(self, tokens, state, pos0: int):
        """Continue a prefill: `state` already covers the first pos0 tokens
        (block-aligned); this segment attends through it and positions run
        at the true absolute offsets. A kind that is not resumable takes
        pos0 == 0 only."""
        s = tokens.shape[1]
        if s == 0:
            raise ValueError("prefill needs at least one token")
        if not self.resumable and pos0:
            raise ValueError(f"a {self.kind!r} state is not resumable: its "
                             f"prefill starts at 0, got pos0={pos0}")
        start, logits = 0, None
        while start < s:
            if self.resumable:
                blk = self.block_size
                end = min(s, ((pos0 + start) // blk + 1) * blk - pos0)
            else:
                end = s
            positions = pos0 + start + torch.arange(end - start,
                                                    device=tokens.device)
            logits, state = self.lm(tokens[:, start:end], mode="prefill",
                                    cache=state, positions=positions)
            start = end
        return logits[:, -1], state

    def decode_step(self, tok, pos: int, state):
        """tok (B, 1) at position `pos` (shared across the batch)
        -> (logits (B, V), state)."""
        positions = torch.full((1,), pos, dtype=torch.long, device=tok.device)
        logits, state = self.lm(tok, mode="decode", cache=state,
                                positions=positions)
        return logits[:, -1], state
