"""Decoder-LM assembly for the dense family (``repro.models.transformer``).

Parameters are a nested ``nn.ModuleDict`` of ``nn.ParameterDict``s with the
reference's names and layouts — layer stacks keep their leading ``layers``
axis (``layers.attn.wq`` is ``(L, d, h, hd)``, ``embed.table`` is ``(V,
d)``) — so carrying weights across from the JAX package is a copy with no
transposes (``repro_torch.convert``).  The reference scans its layer
stacks; here a Python loop indexes the stacked tensors.

Entry points:

    init_lm(cfg, generator, device, trainable) -> params
    forward(params, cfg, tokens)               -> (hidden, cache)
    lm_loss(params, cfg, tokens, targets)      -> (loss, metrics)
    prefill(params, cfg, tokens)               -> (logits, cache)
    init_paged_pools(cfg, pool_tokens, ...)    -> {"k", "v"}
    decode_step_paged_batched(params, cfg, tokens, pos, pools, tables, page)
                                               -> logits
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       logits_from_hidden)


def _check_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family != "dense" or cfg.attention != "full":
        raise NotImplementedError(
            f"{what}: the port covers the dense family with full attention; "
            f"family={cfg.family!r} attention={cfg.attention!r} is not "
            f"ported yet (ROADMAP.md, Queue 1)")
    if cfg.use_bias or cfg.norm != "rmsnorm" or cfg.parallel_block:
        raise NotImplementedError(
            f"{what}: biases, layernorm and parallel blocks are not ported "
            f"yet (ROADMAP.md, Queue 1)")


def param_shapes(cfg: ArchConfig) -> dict:
    """``{group: {name: (shape, init scale or "ones")}}`` of a dense LM,
    in the reference's ``Collector`` order and scales."""
    _check_family(cfg, "param_shapes")
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
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
    ``cfg.dtype``; norm scales are ones.  (``jax.random`` and torch draw
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
    layers = params["layers"]
    cols = {name: {k: t.unbind(0) for k, t in layers[name].items()}
            for name in ("ln1", "ln2", "attn", "mlp")}
    return [{name: {k: ts[i] for k, ts in group.items()}
             for name, group in cols.items()}
            for i in range(len(cols["ln1"]["scale"]))]


def _block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor):
    """One pre-norm dense layer: returns the new residual and its K/V."""
    h = apply_norm(lp["ln1"], x, cfg)
    a_out, kv = attn.attention_fwd(lp["attn"], h, cfg, positions=positions,
                                   window=cfg.local_window)
    x = x + a_out
    h2 = apply_norm(lp["ln2"], x, cfg)
    return x + apply_mlp(lp["mlp"], h2, cfg), kv


def forward(params, cfg: ArchConfig, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, attn.KV]:
    """Full-sequence forward: ``(hidden (B, S, d), cache)`` where the
    cache is the per-layer K/V stacked on a leading layer axis, ``(L, B,
    S, KV, hd)`` each.

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
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs = [], []
    for lp in _layers(params):
        if remat:
            x, kv = checkpoint(_block, lp, x, cfg, positions,
                               use_reentrant=False, preserve_rng_state=False)
        else:
            x, kv = _block(lp, x, cfg, positions)
        ks.append(kv.k)
        vs.append(kv.v)
    x = apply_norm(params["final_norm"], x, cfg)
    return x, attn.KV(torch.stack(ks), torch.stack(vs))


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, attn.KV]:
    """Full-prompt forward; returns ``(last-position logits (B, vocab),
    the per-layer cache in forward layout)``."""
    hidden, cache = forward(params, cfg, tokens)
    logits = logits_from_hidden(params, hidden[:, -1:], cfg)[:, 0]
    return logits, cache


def init_paged_pools(cfg: ArchConfig, pool_tokens: int,
                     dtype=torch.float32, device="cuda") -> dict:
    """Per-layer stacked K/V slab pools ``(L, pool_tokens, KV, hd)`` for
    paged decode.  A sequence's cache is the view its page table describes
    (shared across layers: every layer writes the same positions)."""
    _check_family(cfg, "init_paged_pools")
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
    _check_family(cfg, "decode_step_paged_batched")
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
    dense family): f32 ``log_softmax`` of the logits, the NLL of each
    target, its mean.  The dense family's MoE aux terms are zero, so the
    loss is the NLL; the metrics keep the reference's keys."""
    hidden, _ = forward(params, cfg, tokens)
    logits = logits_from_hidden(params, hidden, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    loss = nll.mean()
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"nll": loss.detach(), "moe_aux": zero, "moe_z": zero,
                  "dropped": zero}
