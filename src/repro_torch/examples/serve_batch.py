"""Batched serving example: ragged prompts through the continuous-batching
engine.  Admission, paged KV allocation, prefill / decode interleaving and
eviction all live in ``repro_torch.serving.ServeEngine``; this example
only submits requests and reads tokens back.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \
        [--arch gemma-2b] [--device cpu]

The model is the architecture's reduced config with seeded random
weights; the prompts come from ``numpy.random.default_rng(1)``.
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
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    params = registry.init(cfg, torch.Generator(device=device).manual_seed(0),
                           device)

    # ragged prompts: each request keeps its own length and page table
    lens = [3, 7, 5, 9][:args.batch]
    max_len = max(lens) + args.new_tokens
    engine = ServeEngine(cfg, params, max_slots=args.batch, max_len=max_len,
                         page=8, device=device)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (args.batch, max(lens)))
    t0 = time.time()
    rids = [engine.submit(toks[i, :lens[i]].tolist(), args.new_tokens)
            for i in range(args.batch)]
    results = engine.run()
    dt = time.time() - t0

    n_tok = sum(len(results[r]["tokens"]) for r in rids)
    print(f"arch={cfg.name} batch={args.batch} ragged lens={lens} "
          f"paged={engine.paged} page={engine.page} device={device}")
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.0f} tok/s)")
    for i, rid in enumerate(rids):
        print(f"req{rid} len{lens[i]} ->", results[rid]["tokens"][:10])
    return results


if __name__ == "__main__":
    main()
