"""Train-step factory: loss, grads (with optional microbatch accumulation),
clipping over every parameter, AdamW and the lr schedule.

The port of the JAX package's ``train/step.py`` (``TrainState``,
``init_train_state``, ``make_loss_fn``, ``make_train_step``,
``make_manual_dp_train_step``). The reference's functional step maps a
state to a new one; here the parameters live in the LM module and the
step updates them and the AdamW moments in place, returning the new
state. ``make_sharded_train_step`` is the port's counterpart of the
reference's jit over sharded parameters (``launch/train.py --mesh``):
parameters and moments stored by ``distributed.sharding``'s specs (FSDP
over "data"), the compute split over "model" (Megatron's, the
reference's GSPMD under the training rules).

Gradients come from autograd; in train mode the attention runs
``ops.polysketch_attention``, whose gradient on the card is B1's backward
kernel. An MoE model's loss adds its router aux losses, weighted by the
config (``router_aux_weight``, ``router_z_weight``), and reports them as
``aux_load_balance`` and ``aux_router_z``.

The clipping and the AdamW update work in place: a dbrx layer's expert
tensors are 4 GiB each, and a copy of every gradient beside 16 bytes a
parameter would not fit on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.bridge import is_stacked, jax_path
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, linear_warmup_linear_decay)


@dataclass
class TrainState:
    """The reference's TrainState(params, opt, step): the LM (which holds
    the parameters), the AdamW state keyed by parameter name, and the
    number of steps taken."""
    lm: torch.nn.Module
    opt: AdamWState
    step: int


def init_train_state(lm) -> TrainState:
    return TrainState(lm=lm, opt=adamw_init(dict(lm.named_parameters())),
                      step=0)


def make_loss_fn(cfg):
    """loss_fn(lm, batch) -> (loss, metrics): the mean next-token NLL, or
    the masked mean when the batch has a loss_mask (B, S); with MoE layers
    plus router_aux_weight * load_balance + router_z_weight * router_z.
    A batch's image_embeds (a VLM's) or frames (Whisper's) go to the
    model with the tokens, as the reference passes them."""
    def loss_fn(lm, batch):
        tokens = batch["tokens"]                      # (B, S+1)
        targets = tokens[:, 1:]
        extra = {k: batch[k] for k in ("image_embeds", "frames") if k in batch}
        logits, _, aux = lm(tokens[:, :-1], mode="train", return_aux=True,
                            **extra)
        if tp.splits("vocab", cfg.vocab_size):
            # this rank's vocab rows (training over "model")
            nll = tp.vocab_parallel_nll(logits, targets)
        else:
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            loss = nll.mean()
        else:
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        metrics = {"ce_loss": loss.detach()}
        if aux:
            loss = (loss + cfg.router_aux_weight * aux["load_balance"]
                    + cfg.router_z_weight * aux["router_z"])
            metrics.update({f"aux_{k}": v.detach() for k, v in aux.items()})
        metrics["loss"] = loss.detach()
        return loss, metrics

    return loss_fn


def make_train_step(cfg, tcfg):
    """Returns train_step(state, batch) -> (state, metrics). With
    tcfg.microbatches > 1 the batch is cut into that many consecutive
    slices; their gradients are summed and divided by the count, and the
    metrics are the last slice's, as the reference's scan carries them.
    Each slice's backward frees its graph (its logits and log-softmax
    included) before the next slice's forward; only the summed .grad and
    a detached loss carry over."""
    loss_fn = make_loss_fn(cfg)
    schedule = linear_warmup_linear_decay(tcfg.peak_lr, tcfg.steps,
                                          tcfg.warmup_frac)
    mb = tcfg.microbatches

    def train_step(state: TrainState, batch):
        lm = state.lm
        params = dict(lm.named_parameters())
        grads, metrics = _grads(lm, params, loss_fn, batch, mb)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = schedule(state.step)
        opt = adamw_update(grads, state.opt, params, lr=lr, b1=tcfg.b1,
                           b2=tcfg.b2, weight_decay=tcfg.weight_decay, cfg=cfg)
        del grads
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(lm, opt, state.step + 1), metrics

    return train_step


def _grads(lm, params, loss_fn, batch, mb):
    """The gradient of the mean loss over `batch` (mb consecutive slices,
    their gradients summed and divided by mb), taken out of the
    parameters' .grad; and the last slice's metrics. On a data-parallel
    rank `batch` is `_rows`'s share, whose slice j is this rank's rows of
    the global microbatch j."""
    for p in params.values():
        p.grad = None
    for i in range(mb):
        part = batch if mb == 1 else {
            k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
            for k, v in batch.items()}
        loss, metrics = loss_fn(lm, part)
        loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in params.items()}
    if mb > 1:
        grads = {n: g.div_(mb) for n, g in grads.items()}
    for p in params.values():
        p.grad = None
    return grads, metrics


def _rows(batch, index: int, parts: int, mb: int = 1):
    """One data-parallel rank's shard of every array of a batch: of each of
    the mb global microbatches (rows [j B / mb, (j + 1) B / mb), the
    reference's), the rank's slice of B / (mb parts) rows, in microbatch
    order, so that `_grads`'s consecutive slices are this rank's shares of
    the global microbatches. At mb 1, rows [index B / parts, (index + 1) B
    / parts). A dense model cannot tell the order of its rows; an MoE
    routes, drops and takes its aux losses' means over one call's rows,
    which must be the reference's microbatch."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (parts * mb):
            raise ValueError(f"batch of {v.shape[0]} rows does not split into {mb} "
                             f"microbatches over {parts} data-parallel ranks")
        step = v.shape[0] // (parts * mb)
        out[k] = v.reshape(mb, parts, step, *v.shape[1:])[:, index].reshape(
            mb * step, *v.shape[1:])
    return out


def _stacked(grads, cfg, fn):
    """fn applied to the gradients as the reference's tree holds them: the
    layers of a stacked leaf (bridge.is_stacked) stacked into one tensor,
    as the int8 all-reduce quantizes a leaf's chunks over all its layers
    at once; returns them unstacked, by the port's names."""
    paths: dict[str, list[str]] = {}
    for n in grads:   # layers in order, as named_parameters gives them
        paths.setdefault(jax_path(n, cfg), []).append(n)
    tree = {p: (torch.stack([grads[n] for n in names]) if is_stacked(p, cfg)
                else grads[names[0]]) for p, names in paths.items()}
    done = fn(tree)
    out = {}
    for p, names in paths.items():
        if is_stacked(p, cfg):
            out.update(zip(names, done[p].unbind(0)))
        else:
            out[names[0]] = done[p]
    return out


def _mean_metrics(metrics, group):
    """Each metric averaged over the group's ranks (the reference's pmean)."""
    names = sorted(metrics)
    x = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32) for k in names])
    dist.all_reduce(x, group=group)
    x = x / dist.get_world_size(group)
    return {k: x[i] for i, k in enumerate(names)}


def make_manual_dp_train_step(cfg, tcfg, group=None):
    """The reference's shard_map manual-DP step on a process group (None:
    the default one): per-rank gradients and an explicit sync, so the
    gradient collective is the port's to choose, a mean all-reduce
    (tree_psum_mean) or, when tcfg.grad_compression == "int8", the int8
    all-to-all reduce (tree_int8_allreduce_mean).

    train_step(state, batch) takes the global batch. Parameters are
    replicated: each rank holds the whole LM and takes its block of the
    batch's rows (rank r of N: rows r * B / N ..), computes the gradient
    of its own mean loss, syncs it and averages the metrics; then every
    rank clips and steps AdamW on the same synced gradients, as the
    reference does after shard_map. The int8 sync quantizes each leaf of
    the reference's tree, a stacked leaf over all its layers at once."""
    loss_fn = make_loss_fn(cfg)
    schedule = linear_warmup_linear_decay(tcfg.peak_lr, tcfg.steps,
                                          tcfg.warmup_frac)
    if tcfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression must be 'none' or 'int8', got "
                         f"{tcfg.grad_compression!r}")

    def sync(grads):
        if tcfg.grad_compression == "int8":
            return _stacked(grads, cfg, lambda tree: compression.tree_int8_allreduce_mean(
                tree, group))
        return compression.tree_psum_mean(grads, group)

    def train_step(state: TrainState, batch):
        lm = state.lm
        params = dict(lm.named_parameters())
        local = _rows(batch, dist.get_rank(group), dist.get_world_size(group))
        grads, metrics = _grads(lm, params, loss_fn, local, 1)
        grads = sync(grads)
        metrics = _mean_metrics({k: metrics[k] for k in ("loss", "ce_loss")}, group)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = schedule(state.step)
        opt = adamw_update(grads, state.opt, params, lr=lr, b1=tcfg.b1,
                           b2=tcfg.b2, weight_decay=tcfg.weight_decay, cfg=cfg)
        del grads
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(lm, opt, state.step + 1), metrics

    return train_step


@dataclass
class ShardedTrainState:
    """The training state of the sharded step: the LM (whose parameters
    hold no storage between steps), this rank's block of every parameter,
    the AdamW moments of those blocks, the step, the mesh and each
    parameter's spec."""
    lm: torch.nn.Module
    params: dict[str, torch.Tensor]
    opt: AdamWState
    step: int
    mesh: object
    specs: dict[str, tuple]


def init_sharded_train_state(lm, mesh, axes: dict[str, tuple]) -> ShardedTrainState:
    """Shard `lm`'s parameters (the same values on every rank, e.g. from
    one seed) by shardings_for(axes) over `mesh`: each rank keeps its
    blocks and AdamW moments of their size, and the LM's parameters give
    up their storage until a step gathers them. Raises for a model the
    mesh's "model" axis cannot split (tensor_parallel.check_trainable)."""
    tp.check_trainable(lm.cfg, tp.model_axis(mesh)[1])
    named = dict(lm.named_parameters())
    specs = shd.shardings_for(axes, named, mesh)
    params = {n: shd.shard(p.detach(), specs[n], mesh) for n, p in named.items()}
    _release(named)
    return ShardedTrainState(lm, params, adamw_init(params), 0, mesh, specs)


def _release(named):
    for p in named.values():
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


def dp_axes(mesh, batch_size: int) -> tuple[str, ...]:
    """The mesh axes the batch is split over (batch_spec's leading entry)."""
    return shd.spec_axes(shd.batch_spec(mesh, batch_size)[0])


def whole_train_state(state: ShardedTrainState) -> dict[str, dict]:
    """{"params", "m", "v"}: every parameter and moment gathered whole
    from the ranks' blocks (a collective: every rank calls it)."""
    def whole(blocks):
        return {n: shd.gather(x, state.specs[n], state.mesh) for n, x in blocks.items()}
    return {"params": whole(state.params), "m": whole(state.opt.m),
            "v": whole(state.opt.v)}


def shard_train_state(state: ShardedTrainState, params, m, v, count,
                      step: int) -> ShardedTrainState:
    """`state` holding this rank's blocks of the whole `params`, `m` and
    `v` (by its specs, on its mesh), the AdamW count and the step."""
    def blocks(named):
        dev = next(iter(state.params.values())).device
        return {n: shd.shard(named[n].to(dev), state.specs[n], state.mesh)
                for n in state.params}
    opt = AdamWState(blocks(m), blocks(v), count.to(state.opt.count.device))
    return ShardedTrainState(state.lm, blocks(params), opt, step, state.mesh,
                             state.specs)


def make_sharded_train_step(cfg, tcfg):
    """train_step(state, batch) -> (state, metrics) over a
    ShardedTrainState: the reference's train step under jit with sharded
    parameters and its training rules. Each parameter is gathered over
    "data" only (FSDP) into the LM, so a "model" block stays this rank's:
    wq/wk/wv and the GLU's wi/wg hold its output columns (heads, mlp), wo
    and the GLU's wo its input rows, the embedding table (and an untied
    lm_head) its vocab rows, an MoE layer's wi/wg/wo its E/M whole experts
    and its router their columns (expert parallelism, models/moe.py).
    Under ``activation_sharding`` with DEFAULT_RULES the model computes on
    those blocks (Megatron's: each block's output summed over "model", the
    lookup and the cross-entropy vocab-parallel;
    distributed/tensor_parallel.py). Each rank takes its rows of the
    global batch (batch_spec over the mesh's batch axes) and computes the
    gradient of their mean loss (microbatches as make_train_step); the
    attention's head-shared parameters' gradients
    are summed over "model" (each rank saw its own heads), the gradients
    are reduced over the batch axes to each rank's blocks of their mean
    (sharding.reduce_grad), clipped by the global norm of the whole
    gradients (sharding.global_sumsq) and stepped by AdamW on the blocks;
    the LM gives up the gathered storage again. A rank's share of
    microbatch j is its slice of the global microbatch j (`_rows`). An MoE
    layer computes on its call's rows over the batch axes
    (tensor_parallel.split_rows): dispatch groups aligned to the data
    shards, the aux losses over the whole microbatch (models/moe.py), so
    its routing, drops and aux metrics are the reference's. The losses are
    averaged over the ranks; the aux metrics are every rank's alike."""
    loss_fn = make_loss_fn(cfg)
    schedule = linear_warmup_linear_decay(tcfg.peak_lr, tcfg.steps,
                                          tcfg.warmup_frac)
    mb = tcfg.microbatches

    def train_step(state: ShardedTrainState, batch):
        mesh, specs = state.mesh, state.specs
        named = dict(state.lm.named_parameters())
        compute = ("model",) if "model" in mesh.mesh_dim_names else ()
        fsdp = [a for a in mesh.mesh_dim_names if a not in compute]
        with torch.no_grad():
            for n, p in named.items():
                p.data = shd.gather(state.params[n], specs[n], mesh, axes=fsdp)
        rows = next(iter(batch.values())).shape[0]
        axes = dp_axes(mesh, rows)
        index, parts = 0, 1
        for a in axes:
            dim = mesh.mesh_dim_names.index(a)
            index = index * mesh.size(dim) + mesh.get_local_rank(dim)
            parts *= mesh.size(dim)
        with shd.activation_sharding(mesh, shd.DEFAULT_RULES), tp.split_rows(mesh, axes):
            grads, metrics = _grads(state.lm, named, loss_fn,
                                    _rows(batch, index, parts, mb), mb)
            group, size, _ = tp.model_axis(mesh)
            if size > 1:
                tp.sum_over_model([grads[n] for n in tp.head_shared_params(state.lm)],
                                  group)
        _release(named)
        for n in list(grads):   # one gradient and its block at a time
            grads[n] = shd.reduce_grad(grads.pop(n), specs[n], mesh, axes, compute)
        gnorm = torch.sqrt(shd.global_sumsq(grads, specs, mesh))
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, norm=gnorm)
        lr = schedule(state.step)
        opt = adamw_update(grads, state.opt, state.params, lr=lr, b1=tcfg.b1,
                           b2=tcfg.b2, weight_decay=tcfg.weight_decay, cfg=cfg)
        del grads
        # over every rank: a model axis's ranks hold their data rank's values
        metrics.update(_mean_metrics({k: metrics[k] for k in ("loss", "ce_loss")}, None))
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return ShardedTrainState(state.lm, state.params, opt, state.step + 1, mesh,
                                 specs), metrics

    return train_step
