"""Deterministic synthetic LM data (``repro.data.pipeline``), numpy only:
the same batches as the reference for the same config, for the dense
family (tokens and targets; the reference's VLM/audio extras, host
shards and checkpoint state are not ported).

A batch is a pure function of (seed, step).  The stream is learnable (a
noisy affine token recurrence), so training shows a decreasing loss.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05            # fraction of tokens replaced with noise
    mult: int = 31                 # affine recurrence multiplier


class SyntheticLM:
    """tokens[t+1] = (mult * tokens[t] + row_offset) % vocab, with noise."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def global_batch(self, step: int) -> dict:
        c = self.cfg
        # the reference seeds (seed, step, shard); the global batch is shard 0
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step, 0]))
        rows = c.global_batch
        x0 = rng.integers(0, c.vocab_size, size=(rows, 1))
        offs = rng.integers(1, c.vocab_size, size=(rows, 1))
        toks = [x0]
        for _ in range(c.seq_len):
            toks.append((c.mult * toks[-1] + offs) % c.vocab_size)
        seq = np.concatenate(toks, axis=1)                 # (rows, seq+1)
        noise_mask = rng.random(seq.shape) < c.noise
        noise_vals = rng.integers(0, c.vocab_size, size=seq.shape)
        seq = np.where(noise_mask, noise_vals, seq).astype(np.int32)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
