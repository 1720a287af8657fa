"""Deterministic synthetic LM data (``repro.data.pipeline``), numpy only:
the same batches as the reference for the same config: tokens and
targets, and with an architecture the vlm family's ``patches`` or the
audio family's ``frames`` (the reference's host shards and checkpoint
state are not ported).

A batch is a pure function of (seed, step).  The stream is learnable (a
noisy affine token recurrence), so training shows a decreasing loss.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.common import ArchConfig


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05            # fraction of tokens replaced with noise
    mult: int = 31                 # affine recurrence multiplier


class SyntheticLM:
    """tokens[t+1] = (mult * tokens[t] + row_offset) % vocab, with noise;
    ``arch`` adds the stub frontends' inputs (f32 standard normals)."""

    def __init__(self, cfg: PipelineConfig, arch: ArchConfig | None = None):
        self.cfg = cfg
        self.arch = arch

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, shard]))

    def global_batch(self, step: int) -> dict:
        c = self.cfg
        # the reference seeds (seed, step, shard); the global batch's tokens
        # are shard 0, its extras a generator of their own (shard 2^20)
        rng = self._rng(step, 0)
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
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        extra = self._rng(step, 1 << 20)
        a = self.arch
        if a is not None and a.family == "vlm":
            batch["patches"] = extra.standard_normal(
                (rows, a.num_patches, a.d_model)).astype(np.float32)
        if a is not None and a.family == "audio":
            batch["frames"] = extra.standard_normal(
                (rows, a.encoder_seq, a.d_model)).astype(np.float32)
        return batch
