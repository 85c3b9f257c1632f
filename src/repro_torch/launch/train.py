"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2s-polysketch \
        --steps 50 --batch 8 --seq 128 --ckpt-dir build/run1
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

The port of the JAX package's ``launch/train.py``: config registry,
seeded model init, the synthetic Markov data pipeline, AdamW and its
schedule, the train step, the checkpoint manager (atomic, async, keep-k,
auto-resume), the preemption guard and the straggler detector. It takes
the reference's flags, plus ``--device`` (default cuda; raises when there
is no card). ``--mesh "AxB:data,model"`` trains over a device mesh of one
process a rank (``torchrun``, which sets the ranks; one process alone is
world 1): parameters and AdamW moments stored sharded by the sharding
rules, gathered over "data" for each step (FSDP), the compute split over
"model" (each rank's heads, mlp columns and vocab rows, Megatron's partial
sums), each data rank on its rows of the batch, gradients reduced to each
rank's blocks (``train.step.make_sharded_train_step``). The world size
must be the mesh's size; with ``--device cuda`` each rank takes its own
card, so a mesh larger than the visible cards raises unless
``--share-card`` puts every rank on one card over gloo (a test harness,
never chosen on its own). ``--ckpt-dir`` with ``--mesh`` writes the
reference's mesh-agnostic layout (whole arrays, rank 0 writes) and
restores onto any mesh or none:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \
        --device cpu --mesh 1x2:data,model --steps 3 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --mesh 1x1:data,model

``--set remat=full`` (or
``dots``) rematerialises each block; the paper's 32k context on one
card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2s-polysketch \
        --seq 32768 --batch 1 --set remat=full --steps 3

It logs the device's peak memory at the end. The registry's dense
polysketch models train in bf16 (head width 128), e.g. starcoder2-3b cut
to the depth one 80 GB card holds (`--draw-on-device` draws the seeded
weights there):

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --draw-on-device --set n_layers=16 --batch 1 --seq 4096 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --smoke \
        --device cpu --steps 4 --batch 2 --seq 64

The recurrent families train the same way (mamba2-780m at full depth
on one card; recurrentgemma-9b cut to whole groups of its 3-layer
pattern, e.g. --set n_layers=9):

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-9b \
        --smoke --device cpu --steps 4 --batch 2 --seq 64

The mixture-of-experts models add their router aux losses to the loss and
log them (aux_load_balance, aux_router_z); dbrx trains one of its 40
layers on one card (16 bytes a parameter: 57.8 GiB). Over ``--mesh`` a
"model" axis splits the experts (each rank holds and runs E/M of them,
and logs its range and block bytes), as the reference's rules do; two
ranks sharing one card (``--share-card``) hold half of a dbrx layer's
experts each:

    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b \
        --smoke --device cpu --steps 4 --batch 2 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b \
        --draw-on-device --set n_layers=1 --batch 1 --seq 4096 --steps 3
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch dbrx-132b \
        --smoke --device cpu --mesh 1x2:data,model --steps 3 --batch 4 --seq 32
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch dbrx-132b \
        --draw-on-device --set n_layers=1 --mesh 1x2:data,model --share-card \
        --batch 2 --seq 1024 --steps 3

llava-next-mistral-7b trains on tokens only, as the reference's CLI does
(the image splice trains through ``make_train_step`` with batches that
carry ``image_embeds``); whisper-large-v3 exits non-zero, since this
CLI's data pipeline feeds no encoder frames (the reference's neither).
"""
from __future__ import annotations

import argparse
import logging
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import DataIterator, make_markov_lm
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.fault import PreemptionGuard, StragglerDetector
from repro_torch.launch.mesh import init_ranks, make_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.step import init_sharded_train_state, make_sharded_train_step
from repro_torch.utils import resolve_device

log = logging.getLogger("repro_torch.train")


def main(argv=None):
    return run(argv)[0]


def run(argv=None):
    """main's work: returns (the final state, the loss of every step)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2s-polysketch",
                    help="a registered config: gpt2s-polysketch, deepseek-7b, "
                         "starcoder2-3b, qwen3-14b, yi-34b, mamba2-780m, "
                         "recurrentgemma-9b, dbrx-132b, "
                         "llama4-maverick-400b-a17b, llava-next-mistral-7b "
                         "(tokens only)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--draw-on-device", action="store_true",
                    help="draw the seeded weights on the device (seconds for "
                         "billions of weights; other values than the CPU draw)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="",
                    help='e.g. "2x4:data,model", one process a rank (default: '
                         'one device)')
    ap.add_argument("--share-card", action="store_true",
                    help="with --mesh on CUDA: every rank on one card over gloo "
                         "(a test harness for multi-rank paths on a one-card "
                         "machine; never chosen on its own)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    base = get_config(args.arch, smoke=args.smoke)
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = type(getattr(base, k))(v) if hasattr(base, k) else v
    cfg = get_config(args.arch, smoke=args.smoke, **overrides)
    if cfg.family == "audio":
        raise SystemExit(f"{cfg.name}: this CLI's Markov token stream feeds no "
                         "encoder frames, which an encoder-decoder trains on; "
                         "train it through train.make_train_step with batches "
                         "of tokens and frames")
    if not args.mesh:
        if args.share_card:
            raise SystemExit("--share-card goes with --mesh")
        return _train(args, cfg, args.device, None)
    mesh_shape = parse_mesh(args.mesh)
    device, owned = init_ranks(args.device, share_card=args.share_card)
    try:
        return _train(args, cfg, device, mesh_shape)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, cfg, device, mesh_shape):
    """The run on `device`, over a mesh of ((sizes), (axes)) when given."""
    chatty = mesh_shape is None or dist.get_rank() == 0
    model = build_model(cfg, device=device, seed=args.seed,
                        trainable=True, draw_on_device=args.draw_on_device)
    dev = model.device
    tcfg = TrainConfig(seq_len=args.seq, global_batch=args.batch,
                       steps=args.steps, peak_lr=args.lr,
                       microbatches=args.microbatches, seed=args.seed)
    if mesh_shape is not None:
        mesh = make_mesh(*mesh_shape, dev.type)
        state = init_sharded_train_state(model.lm, mesh, model.axes())
        step_fn = make_sharded_train_step(cfg, tcfg)
        if chatty:
            log.info("mesh %s over %d ranks", args.mesh, dist.get_world_size())
        if cfg.ffn == "moe":
            log_experts(state, cfg)
    else:
        state = init_train_state(model.lm)
        step_fn = make_train_step(cfg, tcfg)
    it = DataIterator(make_markov_lm(cfg.vocab_size, seed=args.seed + 1),
                      args.batch, args.seq, seed=args.seed, device=dev)

    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        latest, restored, extras = ckpt.restore_latest(state)
        if latest is not None:
            state, start_step = restored, latest
            it.restore(extras["data"])
            if chatty:
                log.info("resumed from step %d", start_step)

    guard = PreemptionGuard().install()
    straggler = StragglerDetector()
    t_start = time.perf_counter()
    losses = []
    try:
        for i in range(start_step, args.steps):
            batch = next(it)
            straggler.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])          # waits for the device
            losses.append(loss)
            straggler.stop()
            if chatty and ((i + 1) % args.log_every == 0 or i == start_step):
                aux = "".join(f" {k} {float(v):.4f}" for k, v in metrics.items()
                              if k.startswith("aux_"))
                log.info("step %d loss %.4f lr %.2e grad_norm %.3f%s", i + 1,
                         loss, float(metrics["lr"]), float(metrics["grad_norm"]),
                         aux)
            save_now = ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0
            if save_now or (ckpt and guard.preempted):
                ckpt.save(i + 1, state, extras={"data": it.state()})
            if guard.preempted:
                log.warning("preempted: checkpoint written at step %d", i + 1)
                break
        if ckpt:
            ckpt.save(state.step, state, extras={"data": it.state()}, block=True)
            ckpt.wait()
    finally:
        guard.uninstall()
    dt = time.perf_counter() - t_start
    n = state.step - start_step
    if chatty:
        log.info("done: %d steps on %s, %.2f s/step, %d flagged stragglers", n,
                 torch.device(dev), dt / max(n, 1), len(straggler.flagged))
        log.info("peak device memory: %s", _peak_memory(dev))
    return state, losses


def log_experts(state, cfg):
    """Log this rank's experts and the bytes of its blocks of the expert
    weights (wi, wg, wo of every MoE layer)."""
    _, m, r = tp.model_axis(state.mesh)
    per = cfg.n_experts // m
    held = sum(x.numel() * x.element_size() for n, x in state.params.items()
               if n.endswith(("ffn.wi", "ffn.wg", "ffn.wo")) and x.dim() == 3)
    log.info("rank %d: experts [%d, %d) of %d, its expert blocks %.1f MiB (f32; AdamW's "
             "m and v as much again each)", dist.get_rank(), r * per, (r + 1) * per,
             cfg.n_experts, held / 2**20)


def parse_mesh(text: str):
    """"2x4:data,model" -> ((2, 4), ("data", "model"))."""
    shape_s, _, axes_s = text.partition(":")
    try:
        shape = tuple(int(x) for x in shape_s.split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: want e.g. 2x4:data,model") from None
    axes = tuple(a for a in axes_s.split(",") if a)
    if len(axes) != len(shape):
        raise SystemExit(f"--mesh {text!r}: {len(shape)} sizes but {len(axes)} axis names")
    return shape, axes


def _peak_memory(dev) -> str:
    """The device's peak allocation since the process started, in GiB."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return f"not tracked on {dev.type}"
    return f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"


if __name__ == "__main__":
    main()
