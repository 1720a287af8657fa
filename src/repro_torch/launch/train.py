"""End-to-end training driver (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt \
        --ckpt-every 50 [--compress-grads] [--device cpu] [--dp 2 --tp 2]

Wires together: config registry -> model init -> train step (remat, int8
gradient compression with error feedback when asked, AdamW) -> synthetic
data pipeline -> async checkpointing with restart-resume -> straggler
watchdog.  The flags, the prints and the return value (the losses) are the
reference's; ``--device`` (default the card) is the port's.

``--dp`` / ``--tp`` above one train on a ``("data", "model")`` mesh, one
process a rank, with the sharded step (``train_step.
make_sharded_train_step``: DTensor state placed by the rule table,
tensor-parallel MLP and head, each rank its rows of the global batch).
Under ``torchrun`` (``WORLD_SIZE`` set) the ranks are torchrun's; else the
launcher spawns ``dp x tp`` ranks of itself, which meet on a file store
in a temporary directory, and returns rank 0's losses.  ``--dp 0`` (the
default) takes the world's ranks over ``--tp`` (one with no world).  The
backend is gloo on the CPU, NCCL on the card when there is a card a rank,
else gloo (NCCL refuses two ranks on one card).
Rank 0 prints.  Parameters are the port's ``registry.init`` drawn from a
``torch.Generator`` seeded by ``--seed`` (every rank the same draw).  A
directory that already holds checkpoints resumes from the newest valid
one, at the data step its manifest records, at any mesh.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import PipelineConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.distributed.fault import Coordinator, StepWatchdog
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import train_step as ts_mod


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--dp", type=int, default=0,
                    help="0 = the world's ranks over --tp")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap


def backend_for(device: torch.device, world: int) -> str:
    """gloo on the CPU; on the card NCCL where every rank has a card of
    its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def main(argv=None):
    args = _parser().parse_args(argv)
    resolve_device(args.device)           # no card asked for without one
    world = max(args.dp, 1) * args.tp
    if world > 1 and not dist.is_initialized() and \
            "WORLD_SIZE" not in os.environ:
        return _spawn(argv, world)
    return _run(args)


def _spawn(argv, world: int) -> list:
    """Run ``world`` ranks of this launcher; rank 0's losses."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(world, d, argv), nprocs=world, join=True)
        with open(os.path.join(d, "losses.json")) as f:
            return json.load(f)


def _rank(rank: int, world: int, directory: str, argv) -> None:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    dist.init_process_group(backend_for(device, world),
                            init_method=f"file://{directory}/store",
                            rank=rank, world_size=world)
    try:
        losses = _run(args)
        if rank == 0:
            with open(os.path.join(directory, "losses.json"), "w") as f:
                json.dump(losses, f)
    finally:
        dist.destroy_process_group()


def _run(args) -> list:
    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        dist.init_process_group(backend_for(
            device, int(os.environ["WORLD_SIZE"])))
    mesh, dp, tp, row = None, 1, 1, 0
    if dist.is_initialized():
        tp = args.tp
        dp = args.dp or dist.get_world_size() // tp
        mesh = make_host_mesh(dp, tp, device.type)
        row = mesh.get_coordinate()[0]
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    say(f"mesh: {{'data': {dp}, 'model': {tp}}} device={device} "
        f"arch={cfg.name} reduced={args.reduced}")

    comp = CompressionConfig(enabled=args.compress_grads)
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup,
                          decay_steps=max(args.steps, 2 * args.warmup))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = registry.init(cfg, gen, device, trainable=True)
    if mesh is None:
        state = ts_mod.init_state(cfg, params, device, comp)
        step_fn = ts_mod.make_train_step(cfg, opt_cfg, comp,
                                         microbatches=args.microbatches)
    else:
        state = ts_mod.init_sharded_state(cfg, params, mesh, comp)
        del params
        step_fn = ts_mod.make_sharded_train_step(
            cfg, mesh, opt_cfg, comp, microbatches=args.microbatches)

    data = SyntheticLM(PipelineConfig(cfg.vocab_size, args.seq,
                                      args.batch, seed=args.seed), cfg)
    if args.batch % dp:
        raise ValueError(f"--batch {args.batch} over {dp} data ranks")
    rows = slice(row * (args.batch // dp), (row + 1) * (args.batch // dp))

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.all_steps():
        state, manifest = ckpt.restore(state)
        start = manifest["metadata"].get("data_step", manifest["step"])
        say(f"resumed from step {start}")

    coord = Coordinator()
    watchdog = StepWatchdog(coord)
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v[rows]).to(device)
                 for k, v in data.global_batch(step).items()}
        watchdog.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        watchdog.stop(step)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"{watchdog.ema_s or 0:6.3f}s/step", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, state,
                            metadata=SyntheticLM.state_dict(step + 1))
    if ckpt:
        ckpt.wait()
    if coord.events:
        say(f"watchdog events: {len(coord.events)}")
    if losses:
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
