"""Serving driver (``repro.launch.serve``): a thin CLI over the
continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --reduced --requests 8 --prompt-len 16 --new-tokens 32 \
        [--device cpu]

Requests with random prompts stream into ``serving.ServeEngine``:
admission, page allocation and prefill / decode interleaving happen inside
the engine; this file only builds the model, submits, and reports.  The
parameters are the port's ``registry.init`` from a ``torch.Generator``
seeded by ``--seed``; the prompts come from ``numpy.random.default_rng(seed
+ 1)``, since the reference's ``jax.random`` draw cannot be reproduced
without JAX.  ``--device`` (default the card) is the port's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page", type=int, default=None,
                    help="KV page size (default: solve_recurrence_blocks)")
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = registry.init(cfg, gen, device)
    max_len = args.prompt_len + args.new_tokens
    engine = ServeEngine(cfg, params, max_slots=args.max_slots,
                         max_len=max_len, page=args.page,
                         pool_pages=args.pool_pages, device=device)
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (args.requests, args.prompt_len))
    t0 = time.perf_counter()
    rids = [engine.submit(row.tolist(), args.new_tokens,
                          now=time.perf_counter() - t0)
            for row in prompts]
    results = engine.run(now=time.perf_counter() - t0)
    wall = time.perf_counter() - t0
    n_tok = sum(len(results[r]["tokens"]) for r in rids)
    print(f"arch={cfg.name} paged={engine.paged} page={engine.page} "
          f"slots={engine.max_slots} device={device}")
    print(f"{args.requests} requests, {n_tok} tokens in {wall:.2f}s "
          f"= {n_tok / wall:.1f} tok/s")
    print("sample output ids:", results[rids[0]]["tokens"][:16])
    return results


if __name__ == "__main__":
    main()
