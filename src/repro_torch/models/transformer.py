"""Decoder-LM assembly (``repro.models.transformer``) for the dense family
with full attention and the attention-free ssm (Mamba-2) family.

Parameters are a nested ``nn.ModuleDict`` of ``nn.ParameterDict``s with the
reference's names and layouts — layer stacks keep their leading ``layers``
axis (``layers.attn.wq`` is ``(L, d, h, hd)``, ``layers.mixer.w_in`` is
``(L, d, 2 d_inner + 2 n + h)``, ``embed.table`` is ``(V, d)``) — so
carrying weights across from the JAX package is a copy with no transposes
(``repro_torch.convert``).  The reference scans its layer stacks; here a
Python loop indexes the stacked tensors.

Entry points:

    init_lm(cfg, generator, device, trainable) -> params
    forward(params, cfg, tokens, want_cache)   -> (hidden, cache)
    lm_loss(params, cfg, tokens, targets)      -> (loss, metrics)
    prefill(params, cfg, tokens)               -> (logits, cache)
    dense:  init_paged_pools(cfg, pool_tokens, ...) -> {"k", "v"}
            decode_step_paged_batched(params, cfg, tokens, pos, pools,
                                      tables, page)    -> logits
    ssm:    init_cache(cfg, batch, cache_len, ...)  -> {"layers": SSMCache}
            prefill_cache_to_decode(cfg, cache, cache_len) -> decode cache
            decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       logits_from_hidden)

DENSE, SSM = ("dense", "full"), ("ssm", "none")


def _check_family(cfg: ArchConfig, what: str,
                  ported: tuple = (DENSE, SSM)) -> None:
    if (cfg.family, cfg.attention) not in ported:
        raise NotImplementedError(
            f"{what}: the port covers {' and '.join(map(str, ported))} as "
            f"(family, attention); family={cfg.family!r} "
            f"attention={cfg.attention!r} is not ported yet (ROADMAP.md, "
            f"Queue 1)")
    if cfg.use_bias or cfg.norm != "rmsnorm" or cfg.parallel_block:
        raise NotImplementedError(
            f"{what}: biases, layernorm and parallel blocks are not ported "
            f"yet (ROADMAP.md, Queue 1)")


def param_shapes(cfg: ArchConfig) -> dict:
    """``{group: {name: (shape, init scale, "ones" or "zeros")}}`` of the
    LM, in the reference's ``Collector`` order and scales."""
    _check_family(cfg, "param_shapes")
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    if cfg.family == "ssm":
        shapes = {"embed": {"table": ((cfg.vocab_size, d), d ** -0.5)}}
        if not cfg.tie_embeddings:
            shapes["unembed"] = {"w": ((d, cfg.vocab_size), d ** -0.5)}
        shapes["final_norm"] = {"scale": ((d,), "ones")}
        shapes["layers.ln1"] = {"scale": ((L, d), "ones")}
        shapes["layers.mixer"] = ssm.param_shapes(cfg, (L,))
        return shapes
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    wi = 2 * f if cfg.mlp in ("swiglu", "geglu") else f
    shapes = {
        "embed": {"table": ((cfg.vocab_size, d), d ** -0.5)},
        "final_norm": {"scale": ((d,), "ones")},
        "layers.ln1": {"scale": ((L, d), "ones")},
        "layers.ln2": {"scale": ((L, d), "ones")},
        "layers.attn": {"wq": ((L, d, h, hd), d ** -0.5),
                        "wk": ((L, d, kv, hd), d ** -0.5),
                        "wv": ((L, d, kv, hd), d ** -0.5),
                        "wo": ((L, h, hd, d), (h * hd) ** -0.5)},
        "layers.mlp": {"wi": ((L, d, wi), d ** -0.5),
                       "wo": ((L, f, d), f ** -0.5)},
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = {"w": ((d, cfg.vocab_size), d ** -0.5)}
    return shapes


def build_params(tensors: dict, trainable: bool = False) -> nn.ModuleDict:
    """Nest ``{"group.sub": {name: tensor}}`` into the parameter tree.
    Serving keeps the parameters frozen; ``trainable`` makes them
    require gradients."""
    root = nn.ModuleDict()
    for group, leaves in tensors.items():
        node = root
        parts = group.split(".")
        for part in parts[:-1]:
            if part not in node:
                node[part] = nn.ModuleDict()
            node = node[part]
        node[parts[-1]] = nn.ParameterDict(
            {n: nn.Parameter(t, requires_grad=trainable)
             for n, t in leaves.items()})
    return root


def init_lm(cfg: ArchConfig, generator: torch.Generator,
            device="cuda", trainable: bool = False) -> nn.ModuleDict:
    """Random parameters with the reference's shapes and scales: normal(0,
    scale) drawn in f32 from ``generator`` on ``device``, then cast to
    ``cfg.dtype``; norm scales are ones, biases zeros.  (``jax.random`` and torch draw
    different numbers from one seed: tests carry the JAX draw across with
    ``convert.params_from_numpy`` instead.)  ``trainable`` as in
    :func:`build_params`."""
    device = resolve_device(device)
    dtype = getattr(torch, str(cfg.dtype))
    tensors = {}
    for group, leaves in param_shapes(cfg).items():
        tensors[group] = {}
        for name, (shape, scale) in leaves.items():
            if scale == "ones":
                t = torch.ones(shape, dtype=dtype, device=device)
            elif scale == "zeros":
                t = torch.zeros(shape, dtype=dtype, device=device)
            else:
                t = torch.randn(shape, generator=generator,
                                dtype=torch.float32, device=device)
                t = t.mul_(scale).to(dtype)
            tensors[group][name] = t
    return build_params(tensors, trainable)


def _layers(params) -> list[dict]:
    """Each layer's slices of the stacked parameters, as plain dicts.
    ``unbind`` makes the slices in one op, so under autograd the stacked
    gradient is one ``stack`` of the per-layer gradients, not a
    full-size zero tensor per layer."""
    cols = {name: {k: t.unbind(0) for k, t in group.items()}
            for name, group in params["layers"].items()}
    return [{name: {k: ts[i] for k, ts in group.items()}
             for name, group in cols.items()}
            for i in range(len(cols["ln1"]["scale"]))]


def _block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, want_cache: bool):
    """One pre-norm dense layer: returns the new residual and its K/V."""
    h = apply_norm(lp["ln1"], x, cfg)
    a_out, kv = attn.attention_fwd(lp["attn"], h, cfg, positions=positions,
                                   window=cfg.local_window)
    x = x + a_out
    h2 = apply_norm(lp["ln2"], x, cfg)
    return x + apply_mlp(lp["mlp"], h2, cfg), kv


def _ssm_block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, want_cache: bool):
    """One pre-norm Mamba-2 layer: the new residual and its SSMCache (None
    unless ``want_cache``)."""
    out, c = ssm.apply_mamba2(lp["mixer"], apply_norm(lp["ln1"], x, cfg),
                              cfg, want_cache)
    return x + out, c


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            want_cache: bool = True):
    """Full-sequence forward: ``(hidden (B, S, d), cache)``.  The cache
    is the per-layer state stacked on a leading layer axis: K/V ``(L, B,
    S, KV, hd)`` each (dense), or an ``SSMCache`` of ``conv (L, B, W-1,
    conv_dim)`` and ``state (L, B, H, p, N)`` (ssm); None when not
    ``want_cache`` (the loss: under ``jax.jit`` the reference's XLA drops
    what the loss does not read, and eager PyTorch would compute it).

    Under autograd, ``cfg.remat`` rematerializes each layer (the
    reference's ``jax.checkpoint`` around its scanned body): only the
    layer inputs are kept, and the backward reruns each layer's forward,
    kernels included.  ``remat_policy="dots"`` is not ported."""
    _check_family(cfg, "forward")
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported; the port "
            f"rematerializes whole layers (remat_policy='full')")
    block = _ssm_block if cfg.family == "ssm" else _block
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    caches = []
    for lp in _layers(params):
        if remat:
            x, c = checkpoint(block, lp, x, cfg, positions, want_cache,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, c = block(lp, x, cfg, positions, want_cache)
        caches.append(c)
    x = apply_norm(params["final_norm"], x, cfg)
    if not want_cache:
        return x, None
    kind = ssm.SSMCache if cfg.family == "ssm" else attn.KV
    return x, kind(*(torch.stack(t) for t in zip(*caches)))


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, attn.KV]:
    """Full-prompt forward; returns ``(last-position logits (B, vocab),
    the per-layer cache in forward layout)``."""
    hidden, cache = forward(params, cfg, tokens)
    logits = logits_from_hidden(params, hidden[:, -1:], cfg)[:, 0]
    return logits, cache


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The ssm family's decode cache: ``{"layers": SSMCache}`` of zeros,
    stacked over the layers (its size does not depend on ``cache_len``).
    The dense family decodes through paged pools (``init_paged_pools``)."""
    _check_family(cfg, "init_cache", (SSM,))
    c = ssm.init_ssm_cache(cfg, batch, dtype, device)
    return {"layers": ssm.SSMCache(
        *(t[None].repeat(cfg.n_layers, *(1,) * t.dim()) for t in c))}


def prefill_cache_to_decode(cfg: ArchConfig, cache, cache_len: int) -> dict:
    """Re-lay a prefill cache as a decode cache: the ssm cache carries
    forward unchanged (the final state IS the decode state)."""
    _check_family(cfg, "prefill_cache_to_decode", (SSM,))
    return {"layers": cache}


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, pos,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step of the ssm family.  ``tokens (B,)`` int on the
    device; ``pos`` (absolute positions) is unused, as in the reference:
    the state carries the position.  Returns ``(logits (B, vocab), the new
    cache)``; the step reads nothing back to the host."""
    _check_family(cfg, "decode_step", (SSM,))
    x = embed_tokens(params, tokens[:, None], cfg)
    old = cache["layers"]
    new = []
    for i, lp in enumerate(_layers(params)):
        out, c = ssm.decode_mamba2(
            lp["mixer"], apply_norm(lp["ln1"], x, cfg),
            ssm.SSMCache(old.conv[i], old.state[i]), cfg)
        x = x + out
        new.append(c)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = logits_from_hidden(params, x, cfg)[:, 0]
    return logits, {"layers": ssm.SSMCache(
        *(torch.stack(t) for t in zip(*new)))}


def init_paged_pools(cfg: ArchConfig, pool_tokens: int,
                     dtype=torch.float32, device="cuda") -> dict:
    """Per-layer stacked K/V slab pools ``(L, pool_tokens, KV, hd)`` for
    paged decode.  A sequence's cache is the view its page table describes
    (shared across layers: every layer writes the same positions)."""
    _check_family(cfg, "init_paged_pools", (DENSE,))
    device = resolve_device(device)
    shape = (cfg.n_layers, pool_tokens, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step_paged_batched(params, cfg: ArchConfig, tokens: torch.Tensor,
                              pos: torch.Tensor, pools: dict, *,
                              tables: torch.Tensor, page: int
                              ) -> torch.Tensor:
    """One decode step for every serving slot through the paged view: one
    K5 launch per layer covers all slots.

    tokens/pos: (slots,) int32 on the device; a dead slot carries pos -1
    (its K/V write drops and no key folds, whatever its table row says).
    ``tables``: (slots, width) int32 view->slab map on the device.  The
    pools are updated IN PLACE.  Returns logits (slots, vocab); dead rows
    are garbage the engine drops."""
    _check_family(cfg, "decode_step_paged_batched", (DENSE,))
    x = embed_tokens(params, tokens[:, None], cfg)
    for i, lp in enumerate(_layers(params)):
        h = apply_norm(lp["ln1"], x, cfg)
        a_out = attn.attention_decode_paged_batched(
            lp["attn"], h, pools["k"][i], pools["v"][i], pos, cfg,
            tables=tables, page=page, window=cfg.local_window)
        x = x + a_out
        h2 = apply_norm(lp["ln2"], x, cfg)
        x = x + apply_mlp(lp["mlp"], h2, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, x, cfg)[:, 0]


def lm_loss(params, cfg: ArchConfig, tokens: torch.Tensor,
            targets: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL (``repro.models.transformer.lm_loss`` for the
    dense and ssm families): f32 ``log_softmax`` of the logits, the NLL of
    each target, its mean.  Their MoE aux terms are zero, so the loss is
    the NLL; the metrics keep the reference's keys."""
    hidden, _ = forward(params, cfg, tokens, want_cache=False)
    logits = logits_from_hidden(params, hidden, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    loss = nll.mean()
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"nll": loss.detach(), "moe_aux": zero, "moe_z": zero,
                  "dropped": zero}
