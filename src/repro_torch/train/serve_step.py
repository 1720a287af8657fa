"""Serving steps (``repro.train.serve_step``): prefill, decode, and the
batched greedy generation loop.

    prefill = make_prefill(cfg)      # prefill(params, {"tokens"}) -> (logits, cache)
    decode = make_decode(cfg)        # decode(params, tokens, pos, cache)
    out = greedy_generate(params, cfg, prompt, n_new, cache_len)

``greedy_generate`` ingests the prompt as the reference does for each
family: the dense (full attention) and ssm families in one prefill whose
cache is re-laid as the decode cache (``transformer.
prefill_cache_to_decode``: the dense K/V padded to ``cache_len``, the ssm
state as it is); the hybrid family, whose ring caches and grouped layers
have no forward-layout equivalent, and the moe family, whose forward cache
the reference does not re-lay either, token by token through
``decode_step``.
Positions are device tensors and the argmax runs on the device, so a step
reads nothing back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models import transformer


def make_prefill(cfg: ArchConfig):
    def prefill_step(params, batch: dict):
        return transformer.prefill(params, cfg, batch["tokens"])
    return prefill_step


def make_decode(cfg: ArchConfig):
    def decode(params, tokens: torch.Tensor, pos: torch.Tensor, cache):
        return transformer.decode_step(params, cfg, tokens, pos, cache)
    return decode


def greedy_generate(params, cfg: ArchConfig, prompt: torch.Tensor,
                    n_new: int, cache_len: int) -> torch.Tensor:
    """``prompt (B, S0)`` int, on the parameters' device -> ``(B, S0 +
    n_new)``: the prompt, then ``n_new`` greedy tokens.  Each new token is
    one ``decode_step``, as in the reference (whose last step's logits go
    unused)."""
    b, s0 = prompt.shape
    dev = prompt.device
    decode = make_decode(cfg)
    if transformer.has_prefill_decode_relayout(cfg):
        logits, fwd = make_prefill(cfg)(params, {"tokens": prompt})
        cache = transformer.prefill_cache_to_decode(cfg, fwd, cache_len)
    else:
        cache = transformer.init_cache(cfg, b, cache_len,
                                       dtype=getattr(torch, str(cfg.dtype)),
                                       device=dev)
        logits = torch.zeros((b, cfg.vocab_size), device=dev)
        for t in range(s0):
            pos = torch.full((b,), t, dtype=torch.int32, device=dev)
            logits, cache = decode(params, prompt[:, t], pos, cache)
    toks = []
    for i in range(n_new):
        tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
        pos = torch.full((b,), s0 + i, dtype=torch.int32, device=dev)
        logits, cache = decode(params, tok, pos, cache)
        toks.append(tok)
    return torch.cat([prompt, *(t[:, None] for t in toks)], dim=1)
