"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
        [--small] [--ckpt-dir DIR] [--device cpu]

Uses the stablelm family at a ~100M scale (d_model 512, 8 layers, vocab
8k) on the synthetic learnable stream, through ``launch.train``; with
``--ckpt-dir`` it checkpoints every 100 steps and resumes from that
directory on restart.  ``--small`` drops to a CPU-friendly size on the
same code path.  The configuration is registered in
``repro_torch.configs.ARCHS`` as ``lm-100m`` (or ``lm-tiny``).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.configs import stablelm_1_6b
from repro_torch.launch.train import main as train_main


def register_lm100m(small: bool):
    """A ~100M-param member of the stablelm family (the code path is the
    full 1.6b config's; only the shapes differ), registered by name."""
    base = stablelm_1_6b.full()
    if small:
        cfg = base.with_(name="lm-tiny", n_layers=2, d_model=128, n_heads=4,
                         n_kv_heads=4, head_dim=32, d_ff=384, vocab_size=512,
                         dtype="float32")
    else:
        cfg = base.with_(name="lm-100m", n_layers=8, d_model=512, n_heads=8,
                         n_kv_heads=8, head_dim=64, d_ff=1536,
                         vocab_size=8192, dtype="float32")

    class _Mod:
        ARCH_ID = cfg.name

        @staticmethod
        def full():
            return cfg

        @staticmethod
        def reduced():
            return cfg
    configs.ARCHS[cfg.name] = _Mod
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = register_lm100m(args.small)
    total, _ = cfg.param_count()
    print(f"training {cfg.name}: ~{total / 1e6:.0f}M params")
    ckpt = ["--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100"] \
        if args.ckpt_dir else []
    return train_main(["--arch", cfg.name, "--steps", str(args.steps),
                       "--batch", "8", "--seq", "64" if args.small else "256",
                       "--lr", "1e-3", "--warmup", "50", "--log-every", "10",
                       "--device", args.device] + ckpt)


if __name__ == "__main__":
    main()
