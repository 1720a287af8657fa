"""Deterministic, shardable, resumable synthetic LM data
(``repro.data.pipeline``), numpy only: the same batches as the reference
for the same config, bit for bit: tokens and targets, and with an
architecture the vlm family's ``patches`` or the audio family's
``frames``.

A batch is a pure function of (seed, step, shard), so

* any host can regenerate exactly its shard of any step (determinism
  across restarts and across re-sharding),
* the pipeline's checkpointed state is just the step counter
  (:meth:`SyntheticLM.state_dict` / :meth:`SyntheticLM.from_state`),
* the stream is learnable (a noisy affine token recurrence), so training
  shows a decreasing loss.

``global_batch(step)`` returns the whole batch; ``host_shard(step, shard,
n_shards)`` one host's slice of it.
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

    def _tokens(self, step: int, rows: int, shard: int = 0) -> np.ndarray:
        c = self.cfg
        rng = self._rng(step, shard)
        x0 = rng.integers(0, c.vocab_size, size=(rows, 1))
        offs = rng.integers(1, c.vocab_size, size=(rows, 1))
        toks = [x0]
        for _ in range(c.seq_len):
            toks.append((c.mult * toks[-1] + offs) % c.vocab_size)
        seq = np.concatenate(toks, axis=1)                 # (rows, seq+1)
        noise_mask = rng.random(seq.shape) < c.noise
        noise_vals = rng.integers(0, c.vocab_size, size=seq.shape)
        seq = np.where(noise_mask, noise_vals, seq)
        return seq.astype(np.int32)

    def _batch_from(self, seq: np.ndarray, rng: np.random.Generator) -> dict:
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        a = self.arch
        if a is not None and a.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (seq.shape[0], a.num_patches, a.d_model)).astype(np.float32)
        if a is not None and a.family == "audio":
            batch["frames"] = rng.standard_normal(
                (seq.shape[0], a.encoder_seq, a.d_model)).astype(np.float32)
        return batch

    def global_batch(self, step: int) -> dict:
        seq = self._tokens(step, self.cfg.global_batch, shard=0)
        return self._batch_from(seq, self._rng(step, 1 << 20))

    def host_shard(self, step: int, shard: int, n_shards: int) -> dict:
        """Rows ``[shard * rows, (shard + 1) * rows)`` of the step's tokens
        (the whole batch regenerated and sliced, so any sharding tiles the
        same global batch); the extras come from the shard's own
        generator, as the reference draws them."""
        if self.cfg.global_batch % n_shards:
            raise ValueError(f"{n_shards} shards do not divide the global "
                             f"batch of {self.cfg.global_batch}")
        rows = self.cfg.global_batch // n_shards
        full = self._tokens(step, self.cfg.global_batch, shard=0)
        seq = full[shard * rows:(shard + 1) * rows]
        return self._batch_from(seq, self._rng(step, (1 << 20) + shard))

    # -- checkpointable state --------------------------------------------
    @staticmethod
    def state_dict(step: int) -> dict:
        return {"data_step": int(step)}

    @staticmethod
    def from_state(state: dict) -> int:
        return int(state.get("data_step", 0))
