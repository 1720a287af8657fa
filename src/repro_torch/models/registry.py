"""Family dispatch (``repro.models.registry``): one interface over the
decoder LMs (``transformer``: dense, MLA, vlm, ssm, hybrid, moe) and the
encoder-decoder (``encdec``: the audio family).

    init(cfg, generator, device, trainable) -> params
    loss(params, cfg, batch)                -> (loss, metrics)
    prefill(params, cfg, batch)             -> (logits, cache)
    decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
    init_cache(cfg, batch, cache_len, dtype, device) -> decode cache

A batch is ``{"tokens", "targets"}`` (``targets`` for the loss), with the
vlm family's ``patches (B, P, d)`` or the audio family's ``frames (B,
encoder_seq, d)``.  The reference's ``input_specs`` and
``cache_logical_axes`` (dry-run stand-ins, cache sharding) are not ported
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models import encdec, transformer


def init(cfg: ArchConfig, generator: torch.Generator, device="cuda",
         trainable: bool = False):
    if cfg.family == "audio":
        return encdec.init_encdec(cfg, generator, device, trainable)
    return transformer.init_lm(cfg, generator, device, trainable)


def loss(params, cfg: ArchConfig, batch: dict):
    if cfg.family == "audio":
        return encdec.encdec_loss(params, cfg, batch["frames"],
                                  batch["tokens"], batch["targets"])
    return transformer.lm_loss(params, cfg, batch["tokens"],
                               batch["targets"],
                               patches=batch.get("patches"))


def prefill(params, cfg: ArchConfig, batch: dict):
    if cfg.family == "audio":
        return encdec.encdec_prefill(params, cfg, batch["frames"],
                                     batch["tokens"])
    return transformer.prefill(params, cfg, batch["tokens"],
                               patches=batch.get("patches"))


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor,
                pos: torch.Tensor, cache):
    if cfg.family == "audio":
        return encdec.encdec_decode_step(params, cfg, tokens, pos, cache)
    return transformer.decode_step(params, cfg, tokens, pos, cache)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda"):
    if cfg.family == "audio":
        return encdec.init_encdec_cache(cfg, batch, cache_len, dtype, device)
    return transformer.init_cache(cfg, batch, cache_len, dtype, device)
