"""Family dispatch (``repro.models.registry``): one interface over the
decoder LMs (``transformer``: dense, MLA, vlm, ssm, hybrid, moe) and the
encoder-decoder (``encdec``: the audio family).

    init(cfg, generator, device, trainable) -> params
    loss(params, cfg, batch)                -> (loss, metrics)
    prefill(params, cfg, batch)             -> (logits, cache)
    decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
    init_cache(cfg, batch, cache_len, dtype, device) -> decode cache

    param_axes(cfg)                         -> {group: {name: axes}}
    cache_logical_axes(cache)               -> the cache's axes, mirrored

A batch is ``{"tokens", "targets"}`` (``targets`` for the loss), with the
vlm family's ``patches (B, P, d)`` or the audio family's ``frames (B,
encoder_seq, d)``.  The reference's ``input_specs`` (the dry-run's
stand-ins) is not ported (ROADMAP.md, Queue 1).
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


def param_axes(cfg: ArchConfig) -> dict:
    """``{group: {name: logical axes}}`` of the family's parameters (the
    reference's axes tree from ``init``)."""
    if cfg.family == "audio":
        return encdec.param_axes(cfg)
    return transformer.param_axes(cfg)


def cache_logical_axes(cache):
    """The logical axes of a decode cache, mirroring its structure (a
    NamedTuple field by field, a dict by key, a list or tuple by item),
    keyed off each leaf's field name as the reference's: K / V ``(...,
    batch, kv_seq, kv_heads, hd)``, MLA's ``c_kv`` / ``k_pe`` ``(...,
    batch, kv_seq, rank)``, SSM ``state`` / ``conv``, RG-LRU ``h``."""
    def axes_for(name, leaf) -> tuple:
        nd = leaf.dim()
        lead = lambda used: (None,) * (nd - used)
        if name in ("k", "v"):
            return lead(4) + ("batch", "kv_seq", "kv_heads", None)
        if name in ("c_kv", "k_pe"):
            return lead(3) + ("batch", "kv_seq", None)
        if name == "state":
            return lead(4) + ("batch", "ssm_heads", None, None)
        if name == "conv":
            return lead(3) + ("batch", None, "d_inner")
        if name == "h":
            return lead(2) + ("batch", "lru")
        return (None,) * nd

    def walk(node, name=None):
        if isinstance(node, torch.Tensor):
            return axes_for(name, node)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f), f)
                                for f in node._fields))
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return None
    return walk(cache)
