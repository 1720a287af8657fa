"""End-to-end training driver (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt \
        --ckpt-every 50 [--compress-grads] [--device cpu]

Wires together: config registry -> model init -> train step (remat, int8
gradient compression with error feedback when asked, AdamW) -> synthetic
data pipeline -> async checkpointing with restart-resume -> straggler
watchdog.  The flags, the prints and the return value (the losses) are the
reference's; ``--device`` (default the card) is the port's.  One process
drives one device: ``--dp 0`` (the default) and ``--dp 1`` mean that
device, and any other ``--dp`` or ``--tp`` raises, since the mesh and the
sharded state wait for the multi-card slice (ROADMAP.md, Queue 1 item 4).
Parameters are the port's ``registry.init`` drawn from a
``torch.Generator`` seeded by ``--seed``.  A directory that already holds
checkpoints resumes from the newest valid one, at the data step its
manifest records.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import PipelineConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.distributed.fault import Coordinator, StepWatchdog
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import train_step as ts_mod


def main(argv=None):
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
                    help="0 = the one local device")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    if args.dp not in (0, 1) or args.tp != 1:
        raise NotImplementedError(
            f"--dp {args.dp} --tp {args.tp}: the port trains on one device "
            f"per process; the mesh and the sharded state wait for the "
            f"multi-card slice (ROADMAP.md, Queue 1 item 4)")
    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    print(f"mesh: {{'data': 1, 'model': 1}} device={device} "
          f"arch={cfg.name} reduced={args.reduced}")

    comp = CompressionConfig(enabled=args.compress_grads)
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup,
                          decay_steps=max(args.steps, 2 * args.warmup))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = registry.init(cfg, gen, device, trainable=True)
    state = ts_mod.init_state(cfg, params, device, comp)

    data = SyntheticLM(PipelineConfig(cfg.vocab_size, args.seq,
                                      args.batch, seed=args.seed), cfg)
    step_fn = ts_mod.make_train_step(cfg, opt_cfg, comp,
                                     microbatches=args.microbatches)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and ckpt.all_steps():
        state, manifest = ckpt.restore(state)
        start = manifest["metadata"].get("data_step", manifest["step"])
        print(f"resumed from step {start}")

    coord = Coordinator()
    watchdog = StepWatchdog(coord)
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.global_batch(step).items()}
        watchdog.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        watchdog.stop(step)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"{watchdog.ema_s or 0:6.3f}s/step", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, state,
                            metadata=SyntheticLM.state_dict(step + 1))
    if ckpt:
        ckpt.wait()
    if coord.events:
        print(f"watchdog events: {len(coord.events)}")
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
