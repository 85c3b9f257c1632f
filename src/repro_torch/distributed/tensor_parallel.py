"""Compute over the "model" mesh axis: the active context, the Megatron
pair of collectives, the gather points and the vocab-parallel loss.

The reference computes over "model" through GSPMD: its shardings come
from the rule tables, and ``shard_act`` constraints name the gather
points ("act_heads" before the attention's output contraction, "act_mlp"
before the GLU's). The port runs one process a rank and writes the
collectives out. ``distributed.sharding.activation_sharding(mesh, rules)``
makes a context active on the calling thread; inside it the model code
asks this module what the rules say:

- Every rank of the "model" axis computes its own heads (and its own
  mlp columns and, in training, its own vocab rows) whenever that axis
  has more than one rank. Its weights hold those blocks already (the
  training state's and a serving plan's placement cut them), so the
  model code computes with the weights as they are; ``local_count``
  gives its share of a dim.
- Under rules that keep a gather point on "model" (``DEFAULT_RULES``,
  training) the contraction after it is Megatron's partial sum: the
  block's input goes through ``enter`` (identity forward, all-reduce of
  the gradient backward) and its output through ``reduce`` (all-reduce
  forward, identity backward).
- Under rules that map it to () (``SERVING_RULES``) the operand is
  gathered whole first (``sharding.shard_act``), so the contraction runs
  in an order that does not depend on the mesh.
- The vocab: under rules that keep it on "model" (training) the lookup
  and the loss are vocab-parallel (``splits("vocab", V)``); a serving
  plan whose placement split an untied lm_head by vocab says so when it
  activates the context (``gathers_vocab``), and the logits are gathered
  whole (the reference's ``constrain_logits``).
- The experts: under rules that keep "experts" on "model" (training)
  each rank holds E/M whole experts of wi, wg and wo and E/M router
  columns (``splits("experts", E)``). The router logits are gathered whole
  over "model" (``gather_model``: forward an all-gather, backward this
  rank's slice, as everything after it is computed alike on every rank),
  so every rank routes alike; each runs its own experts, whose outputs are
  gathered whole into the (E, G * cap, D) buffer the same way before the
  combine. The MoE block's input goes through ``enter``: its gradient
  arrives in parts (this rank's experts and router columns).

Outside a context, or on a "model" axis of one rank, every function here
returns its input.

The batch axes. ``split_rows(mesh, axes)`` says, on the calling thread,
that a call's token rows are this rank's share of rows split over the
mesh's `axes` in rank order (the data-parallel ranks of a training
step). Only the MoE reads it: its routing couples the tokens of one call
(capacity, the aux losses' means), so it gathers the rows
(``rows_gather``) or sums its statistics over them (``rows_sum``) to
compute what one device computes on the whole call.

All of it lives in thread-local state, which ``thread_state`` copies and
``thread_state_active`` re-activates: a rematerialised block's recompute
runs where autograd runs the backward, on CUDA a thread of its own
(``models/transformer._run_block``).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

# The ROADMAP item a refusal names.
REFUSALS_ITEM = "ROADMAP A.9 item 4"

_LOCAL = threading.local()


@dataclass(frozen=True)
class Active:
    """The active mesh and rules, and the "model" axis as this rank sees
    it: its process group (None at one rank), size and index."""
    mesh: object
    rules: dict
    group: object
    size: int
    rank: int
    vocab_head: bool = False   # an untied lm_head holds this rank's vocab columns


def active() -> Active | None:
    return getattr(_LOCAL, "ctx", None)


def model_axis(mesh) -> tuple[object, int, int]:
    """(process group, size, this rank's index) of `mesh`'s "model" axis:
    (None, 1, 0) for a mesh without one, and for a plain {axis: size} or a
    duck-typed mesh, which name sizes but no running ranks to compute
    over."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and "model" in names:
        size = mesh.size(names.index("model"))
        if size > 1:
            return mesh.get_group("model"), size, mesh.get_local_rank("model")
    return None, 1, 0


@contextlib.contextmanager
def activate(mesh, rules, *, vocab_head: bool = False):
    group, size, rank = model_axis(mesh)
    before = active()
    _LOCAL.ctx = Active(mesh, rules, group, size, rank, vocab_head)
    try:
        yield _LOCAL.ctx
    finally:
        _LOCAL.ctx = before


def model_size() -> int:
    ctx = active()
    return 1 if ctx is None else ctx.size


def keeps(name: str) -> bool:
    """Whether the active rules keep logical `name` on a "model" axis of
    more than one rank: a gather point that stays split (the partial sum)."""
    ctx = active()
    return ctx is not None and ctx.size > 1 and "model" in ctx.rules.get(name, ())


def local_count(n: int) -> int:
    """This rank's share of a dim of `n` that the "model" axis splits (n
    itself when it does not divide, or at one rank)."""
    m = model_size()
    return n // m if m > 1 and n % m == 0 else n


def splits(name: str, n: int) -> bool:
    """Whether a dim of `n` named `name` stays split over "model" through
    the compute: the active rules keep it there and the axis divides it."""
    return keeps(name) and n % model_size() == 0


def expert_range(n: int) -> tuple[int, int]:
    """[lo, hi): the experts of `n` this rank holds and runs (all of them
    unless the active rules split "experts" over "model")."""
    if not splits("experts", n):
        return 0, n
    ctx = active()
    per = n // ctx.size
    return ctx.rank * per, (ctx.rank + 1) * per


def gathers_vocab(n: int) -> bool:
    """Whether the logits come out as this rank's block of a vocab of `n`
    that the caller gathers whole: serving an lm_head placed by vocab."""
    ctx = active()
    return ctx is not None and ctx.vocab_head and ctx.size > 1 and n % ctx.size == 0


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every "model" rank's block of `x` along `dim`, concatenated in rank
    order (serving's gather points; no gradient)."""
    ctx = active()
    parts = [torch.empty_like(x) for _ in range(ctx.size)]
    dist.all_gather(parts, x.contiguous(), group=ctx.group)
    return torch.cat(parts, dim=dim)


class _GatherModel(torch.autograd.Function):
    """Every "model" rank's block of x along `dim`: all-gather forward;
    backward this rank's slice of the gradient, which every rank holds
    alike (what follows the gather is computed alike on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, None


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every "model" rank's block of `x` along `dim`, concatenated in rank
    order, with a gradient that takes this rank's slice back (training's
    gathers of the router logits and the expert outputs)."""
    ctx = active()
    if ctx is None or ctx.size == 1:
        return x
    return _GatherModel.apply(x, dim % x.dim(), ctx.group, ctx.size, ctx.rank)


class _Enter(torch.autograd.Function):
    """A block's input: identity forward, all-reduce of the gradient
    backward (each rank's gradient covers its own heads or columns)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """A block's output: all-reduce of the partial sums forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor) -> torch.Tensor:
    """The input of a block whose output is a partial sum (training)."""
    ctx = active()
    if ctx is None or ctx.size == 1:
        return x
    return _Enter.apply(x, ctx.group)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over "model" of every rank's partial `x`."""
    ctx = active()
    if ctx is None or ctx.size == 1:
        return x
    return _Reduce.apply(x, ctx.group)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[targets] per position, where `logits` (..., V/M)
    holds this rank's vocab rows [rank V/M, (rank + 1) V/M): the max and
    the sum of exponentials reduced over "model", the target's logit taken
    where it lives. The max is a constant of the loss (it cancels), so it
    takes no gradient."""
    ctx = active()
    z = logits.to(torch.float32)
    vl = z.shape[-1]
    with torch.no_grad():
        m = z.max(dim=-1, keepdim=True).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=ctx.group)
    s = reduce(torch.exp(z - m).sum(dim=-1))
    idx = targets - ctx.rank * vl
    here = (idx >= 0) & (idx < vl)
    zt = torch.gather(z, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    zt = reduce(torch.where(here, zt, torch.zeros_like(zt)))
    return torch.log(s) + m[..., 0] - zt


def vocab_parallel_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens] where `table` holds this rank's vocab rows: the rows of
    tokens outside them are zeros, summed over "model" (exact: each row
    comes from one rank)."""
    ctx = active()
    vl = table.shape[0]
    idx = tokens - ctx.rank * vl
    here = (idx >= 0) & (idx < vl)
    h = table[idx.clamp(0, vl - 1)] * here[..., None].to(table.dtype)
    return reduce(h)


def check_trainable(cfg, size: int):
    """Raise for what training over a "model" axis of `size` does not do:
    a head count it does not divide (the reference would fall back to
    splitting head_dim, a contraction inside the attention kernel), an
    expert count it does not divide (the reference would split the
    experts' "mlp" axis instead), the recurrent mixers' "rnn" axis, and
    the encoder-decoder (its own lookup and logits are not
    vocab-parallel)."""
    if size <= 1:
        return
    check_heads(cfg, size)
    if cfg.ffn == "moe" and cfg.n_experts % size:
        raise NotImplementedError(
            f"{cfg.name!r}: a 'model' axis of {size} does not divide its {cfg.n_experts} "
            f"experts; the reference would split the experts' 'mlp' axis instead, which "
            f"is not ported ({REFUSALS_ITEM}); use a model axis that divides them")
    recurrent = [m for m in cfg.block_pattern if m not in ("attn", "local_attn")]
    if recurrent:
        raise NotImplementedError(
            f"{cfg.name!r}: training over a 'model' axis of {size} splits the recurrent "
            f"mixers' 'rnn' axis ({', '.join(recurrent)}), which is not ported "
            f"({REFUSALS_ITEM}); use model 1")
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name!r}: training the encoder-decoder over a 'model' axis of {size} "
            f"is not ported ({REFUSALS_ITEM}); use model 1")


def check_heads(cfg, size: int):
    """Raise unless a "model" axis of `size` divides the q and kv heads."""
    if size > 1 and (cfg.n_heads % size or cfg.n_kv_heads % size):
        raise NotImplementedError(
            f"{cfg.name!r}: a 'model' axis of {size} does not divide its {cfg.n_heads} q "
            f"and {cfg.n_kv_heads} kv heads; the reference would split head_dim, a "
            f"contraction inside the attention kernel, which is not ported "
            f"({REFUSALS_ITEM})")


def head_shared_params(lm) -> list[str]:
    """The parameters of every attention mixer other than its projections
    (q/k norms, the q/k LayerNorm, the sketch): each rank applies them to
    its own heads only, so their gradients are summed over "model"."""
    from repro_torch.models.attention import Attention
    out = []
    for prefix, mod in lm.named_modules():
        if isinstance(mod, Attention):
            out += [f"{prefix}.{n}" for n, _ in mod.named_parameters()
                    if n not in ("wq", "wk", "wv", "wo")]
    return out


def sum_over_model(tensors: list[torch.Tensor], group):
    """All-reduce `tensors` (same dtype) over `group` in one flat buffer,
    in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


# ---------------------------------------------------------------------------
# the batch axes: an MoE call's rows split over data-parallel ranks
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rows:
    """The mesh axes a call's token rows are split over, major to minor:
    each one's (process group, size, this rank's index), sizes above 1."""
    axes: tuple

    @property
    def size(self) -> int:
        n = 1
        for _, s, _ in self.axes:
            n *= s
        return n

    @property
    def index(self) -> int:
        i = 0
        for _, s, r in self.axes:
            i = i * s + r
        return i


def thread_state() -> dict:
    """A copy of this thread's contexts that the model code reads (the
    active mesh and rules, the rows' split)."""
    return dict(vars(_LOCAL))


@contextlib.contextmanager
def thread_state_active(state: dict):
    """Inside: this thread's contexts are `state` (a thread_state)."""
    before = thread_state()
    vars(_LOCAL).clear()
    vars(_LOCAL).update(state)
    try:
        yield
    finally:
        vars(_LOCAL).clear()
        vars(_LOCAL).update(before)


def rows() -> Rows | None:
    """The active split of the rows over the batch axes (None: a call's
    rows are all here)."""
    return getattr(_LOCAL, "rows", None)


@contextlib.contextmanager
def split_rows(mesh, axes):
    """Inside: a call's token rows are this rank's share of the rows split
    over `mesh`'s `axes` (major to minor) in rank order. Axes of one rank
    split nothing."""
    names = list(mesh.mesh_dim_names)
    held = tuple((mesh.get_group(a), mesh.size(names.index(a)), mesh.get_local_rank(a))
                 for a in axes if mesh.size(names.index(a)) > 1)
    before = rows()
    _LOCAL.rows = Rows(held) if held else None
    try:
        yield _LOCAL.rows
    finally:
        _LOCAL.rows = before


def _sum_rows(x, split: Rows):
    x = x.contiguous().clone()
    for group, _, _ in split.axes:
        dist.all_reduce(x, group=group)
    return x


class _RowsGather(torch.autograd.Function):
    """Every rank's rows of x, in rank order: all-gather forward (the
    minor axis first); backward the sum of every rank's gradient, cut to
    this rank's rows (each rank's loss reads its own rows of what follows)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split, ctx.n = split, x.shape[0]
        for group, size, _ in reversed(split.axes):
            parts = [torch.empty_like(x) for _ in range(size)]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts)
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum_rows(g, ctx.split).narrow(0, ctx.split.index * ctx.n, ctx.n), None


class _RowsSum(torch.autograd.Function):
    """The sum over the batch axes: all-reduce forward and backward. Every
    rank's loss holds the sum's term once, and the step takes the mean of
    the ranks' gradients, so the backward's sum gives each rank the whole
    term's gradient, and the mean the reference's."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _sum_rows(x, split)

    @staticmethod
    def backward(ctx, g):
        return _sum_rows(g, ctx.split), None


def rows_gather(x: torch.Tensor) -> torch.Tensor:
    """x (N, ...), this rank's rows: every rank's rows along dim 0."""
    split = rows()
    return x if split is None else _RowsGather.apply(x, split)


def rows_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's `x` over the batch axes."""
    split = rows()
    return x if split is None else _RowsSum.apply(x, split)
