"""Train-step factory: loss, grads (with optional microbatch accumulation),
clipping over every parameter, AdamW and the lr schedule.

The port of the JAX package's ``train/step.py`` (``TrainState``,
``init_train_state``, ``make_loss_fn``, ``make_train_step``). The
reference's functional step maps a state to a new one; here the
parameters live in the LM module and the step updates them and the
AdamW moments in place, returning the new state. The
manual data-parallel step waits for the port's sharding.

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
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = schedule(state.step)
        opt = adamw_update(grads, state.opt, params, lr=lr, b1=tcfg.b1,
                           b2=tcfg.b2, weight_decay=tcfg.weight_decay, cfg=cfg)
        del grads
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(lm, opt, state.step + 1), metrics

    return train_step
