"""Decoder-LM assembly (``repro.models.transformer``) for the dense family
with full attention (RMSNorm or LayerNorm, with or without biases,
sequential or parallel blocks), the attention-free ssm (Mamba-2) family,
the hybrid (RG-LRU + local attention) family and the moe family without a
``layer_pattern`` (deepseek: dense first layers, then attention + MoE FFN
layers).

Parameters are a nested ``nn.ModuleDict`` of ``nn.ParameterDict``s with the
reference's names and layouts — layer stacks keep their leading ``layers``
axis (``layers.attn.wq`` is ``(L, d, h, hd)``, ``layers.mixer.w_in`` is
``(L, d, 2 d_inner + 2 n + h)``, ``embed.table`` is ``(V, d)``), the
hybrid's groups their ``(groups, n_rec)`` / ``(groups, n_att)`` axes
(``groups.rec.w_x`` is ``(g, n_rec, d, lru)``, ``groups.att.wq`` ``(g,
n_att, d, h, hd)``) and its recurrent tail a ``(tail,)`` axis
(``tail.rec.*``), the moe family's ``dense_layers.*`` ``(nd,)`` and
``layers.*`` ``(L - nd,)`` stacks (``layers.moe.wi`` is ``(L - nd, e, d,
2 f)``, its router f32) — so carrying weights across from the JAX package
is a copy with no transposes (``repro_torch.convert``).  The reference
scans its layer stacks (the hybrid its layer groups); here a Python loop
indexes the stacked tensors.

Entry points:

    init_lm(cfg, generator, device, trainable) -> params
    forward(params, cfg, tokens, want_cache, with_aux)
                                               -> (hidden, cache[, aux])
    lm_loss(params, cfg, tokens, targets)      -> (loss, metrics)
    prefill(params, cfg, tokens)               -> (logits, cache)
    init_cache(cfg, batch, cache_len, ...)     -> decode cache
    decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
    dense, ssm:
            prefill_cache_to_decode(cfg, cache, cache_len) -> decode cache
    dense:  init_paged_pools(cfg, pool_tokens, ...) -> {"k", "v"}
            decode_step_paged(params, cfg, tokens, pos, pools, table,
                              page)            -> logits  (one sequence)
            decode_step_paged_batched(params, cfg, tokens, pos, pools,
                                      tables, page)    -> logits
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, rglru, ssm
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       logits_from_hidden)

DENSE, SSM, HYBRID, MOE = (("dense", "full"), ("ssm", "none"),
                           ("hybrid", "full"), ("moe", "full"))


def _check_family(cfg: ArchConfig, what: str,
                  ported: tuple = (DENSE, SSM, HYBRID, MOE)) -> None:
    if (cfg.family, cfg.attention) not in ported:
        raise NotImplementedError(
            f"{what}: the port covers {' and '.join(map(str, ported))} as "
            f"(family, attention); family={cfg.family!r} "
            f"attention={cfg.attention!r} is not ported yet (ROADMAP.md, "
            f"Queue 1)")
    if cfg.family == "moe" and cfg.layer_pattern:
        raise NotImplementedError(
            f"{what}: a moe config with a layer_pattern (llama4's grouped "
            f"local and full layers) is not ported yet (ROADMAP.md, Queue "
            f"1, MoE)")


class Aux(NamedTuple):
    """The MoE terms of a forward (``repro.models.transformer.Aux``): the
    load-balance and z losses summed over the MoE layers, the dropped share
    averaged over them; zeros for the other families."""
    moe_aux: torch.Tensor
    moe_z: torch.Tensor
    dropped: torch.Tensor


def _attn_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    shapes = {"wq": (lead + (d, h, hd), d ** -0.5),
              "wk": (lead + (d, kv, hd), d ** -0.5),
              "wv": (lead + (d, kv, hd), d ** -0.5),
              "wo": (lead + (h, hd, d), (h * hd) ** -0.5)}
    if cfg.use_bias:
        shapes.update({"bq": (lead + (h, hd), "zeros"),
                       "bk": (lead + (kv, hd), "zeros"),
                       "bv": (lead + (kv, hd), "zeros"),
                       "bo": (lead + (d,), "zeros")})
    return shapes


def _mlp_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    wi = 2 * f if cfg.mlp in ("swiglu", "geglu") else f
    shapes = {"wi": (lead + (d, wi), d ** -0.5),
              "wo": (lead + (f, d), f ** -0.5)}
    if cfg.use_bias:
        shapes.update({"bi": (lead + (wi,), "zeros"),
                       "bo": (lead + (d,), "zeros")})
    return shapes


def _norm_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    shapes = {"scale": (lead + (cfg.d_model,), "ones")}
    if cfg.norm == "layernorm" and cfg.use_bias:
        shapes["bias"] = (lead + (cfg.d_model,), "zeros")
    return shapes


def hybrid_layout(cfg: ArchConfig) -> tuple[int, int, int, int]:
    """``(groups, tail, n_rec, n_att)`` of a hybrid stack: ``groups``
    repeats of ``cfg.layer_pattern`` (``n_rec`` RG-LRU and ``n_att`` local
    attention layers each), then ``tail`` RG-LRU layers."""
    pat = cfg.layer_pattern
    g = cfg.n_layers // len(pat)
    n_rec = sum(1 for k in pat if k == "rglru")
    return g, cfg.n_layers - g * len(pat), n_rec, len(pat) - n_rec


def param_shapes(cfg: ArchConfig) -> dict:
    """``{group: {name: (shape, init scale, "ones" or "zeros"[, dtype])}}``
    of the LM, in the reference's ``Collector`` order and scales; a leaf
    with a dtype (the MoE router's ``"float32"``) keeps it whatever
    ``cfg.dtype`` is."""
    _check_family(cfg, "param_shapes")
    d, L = cfg.d_model, cfg.n_layers
    shapes = {"embed": {"table": ((cfg.vocab_size, d), d ** -0.5)}}
    if not cfg.tie_embeddings:
        shapes["unembed"] = {"w": ((d, cfg.vocab_size), d ** -0.5)}
    shapes["final_norm"] = _norm_shapes(cfg, ())
    if cfg.family == "ssm":
        shapes["layers.ln1"] = _norm_shapes(cfg, (L,))
        shapes["layers.mixer"] = ssm.param_shapes(cfg, (L,))
    elif cfg.family == "moe":
        nd = cfg.first_dense_layers
        if nd:
            shapes.update({"dense_layers.ln1": _norm_shapes(cfg, (nd,)),
                           "dense_layers.ln2": _norm_shapes(cfg, (nd,)),
                           "dense_layers.attn": _attn_shapes(cfg, (nd,)),
                           "dense_layers.mlp": _mlp_shapes(cfg, (nd,))})
        lead = (L - nd,)
        shapes.update({"layers.ln1": _norm_shapes(cfg, lead),
                       "layers.ln2": _norm_shapes(cfg, lead),
                       "layers.attn": _attn_shapes(cfg, lead),
                       "layers.moe": moe.moe_shapes(cfg, lead)})
    elif cfg.family == "hybrid":
        g, tail, n_rec, n_att = hybrid_layout(cfg)
        rec, att = (g, n_rec), (g, n_att)
        shapes.update({
            "groups.rec_ln1": _norm_shapes(cfg, rec),
            "groups.rec_ln2": _norm_shapes(cfg, rec),
            "groups.rec": rglru.param_shapes(cfg, rec),
            "groups.rec_mlp": _mlp_shapes(cfg, rec),
            "groups.att_ln1": _norm_shapes(cfg, att),
            "groups.att_ln2": _norm_shapes(cfg, att),
            "groups.att": _attn_shapes(cfg, att),
            "groups.att_mlp": _mlp_shapes(cfg, att)})
        if tail:
            shapes.update({"tail.ln1": _norm_shapes(cfg, (tail,)),
                           "tail.ln2": _norm_shapes(cfg, (tail,)),
                           "tail.rec": rglru.param_shapes(cfg, (tail,)),
                           "tail.mlp": _mlp_shapes(cfg, (tail,))})
    else:
        shapes["layers.ln1"] = _norm_shapes(cfg, (L,))
        if not cfg.parallel_block:
            shapes["layers.ln2"] = _norm_shapes(cfg, (L,))
        shapes.update({"layers.attn": _attn_shapes(cfg, (L,)),
                       "layers.mlp": _mlp_shapes(cfg, (L,))})
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
    ``cfg.dtype`` (or the leaf's own dtype); norm scales are ones, biases
    zeros.  (``jax.random`` and torch draw
    different numbers from one seed: tests carry the JAX draw across with
    ``convert.params_from_numpy`` instead.)  ``trainable`` as in
    :func:`build_params`."""
    device = resolve_device(device)
    dtype = getattr(torch, str(cfg.dtype))
    tensors = {}
    for group, leaves in param_shapes(cfg).items():
        tensors[group] = {}
        for name, (shape, scale, *own) in leaves.items():
            dt = getattr(torch, own[0]) if own else dtype
            if scale == "ones":
                t = torch.ones(shape, dtype=dt, device=device)
            elif scale == "zeros":
                t = torch.zeros(shape, dtype=dt, device=device)
            else:
                # a leaf of over 2^32 elements (deepseek-moe-16b's stacked
                # experts) is drawn a leading slice at a time, so that its
                # f32 draw never holds the whole leaf
                t = torch.empty(shape, dtype=dt, device=device)
                for part in (t.unbind(0) if t.numel() > 2 ** 32 else (t,)):
                    part.copy_(torch.randn(
                        part.shape, generator=generator, dtype=torch.float32,
                        device=device).mul_(scale))
            tensors[group][name] = t
    return build_params(tensors, trainable)


def _unbind(t: torch.Tensor, depth: int) -> list[torch.Tensor]:
    """The slices of ``t`` over its ``depth`` leading axes, in index
    order."""
    parts = [t]
    for _ in range(depth):
        parts = [p for part in parts for p in part.unbind(0)]
    return parts


def _slices(groups, depth: int) -> list[dict]:
    """``{name: {leaf: stacked tensor}}`` as per-layer plain dicts, split
    along the ``depth`` leading stack axes.  ``unbind`` makes the slices
    in one op, so under autograd the stacked gradient is one ``stack`` of
    the per-layer gradients, not a full-size zero tensor per layer."""
    cols = {name: {k: _unbind(t, depth) for k, t in group.items()}
            for name, group in groups.items()}
    n = len(next(iter(next(iter(cols.values())).values())))
    return [{name: {k: ts[i] for k, ts in group.items()}
             for name, group in cols.items()} for i in range(n)]


def _layers(params) -> list[dict]:
    """Each layer's slices of the ``layers`` stack (dense, ssm)."""
    return _slices(params["layers"], 1)


def _hybrid_layers(params, cfg: ArchConfig) -> list[tuple[str, dict]]:
    """The hybrid stack's layers in order as ``(kind, params)``: each
    group's pattern, then the tail.  An RG-LRU layer's params are ``{ln1,
    ln2, rec, mlp}``, a local attention layer's ``{ln1, ln2, attn, mlp}``
    (the dense layer's names)."""
    g, tail, _, _ = hybrid_layout(cfg)
    grp = params["groups"]
    rec = iter(_slices({"ln1": grp["rec_ln1"], "ln2": grp["rec_ln2"],
                        "rec": grp["rec"], "mlp": grp["rec_mlp"]}, 2))
    att = iter(_slices({"ln1": grp["att_ln1"], "ln2": grp["att_ln2"],
                        "attn": grp["att"], "mlp": grp["att_mlp"]}, 2))
    out = [(kind, next(rec) if kind == "rglru" else next(att))
           for _ in range(g) for kind in cfg.layer_pattern]
    if tail:
        out += [("rglru", lp) for lp in _slices(params["tail"], 1)]
    return out


def _moe_layers(params, cfg: ArchConfig) -> list[tuple[str, dict]]:
    """The moe stack's layers in order as ``(kind, params)``: the dense
    first layers (``{ln1, ln2, attn, mlp}``, kind ``"dense"``), then the
    MoE layers (``{ln1, ln2, attn, moe}``, kind ``"moe"``)."""
    out = []
    if cfg.first_dense_layers:
        out = [("dense", lp) for lp in _slices(params["dense_layers"], 1)]
    return out + [("moe", lp) for lp in _layers(params)]


def _with_mlp(lp: dict, x: torch.Tensor, h: torch.Tensor,
              a_out: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The residual after an attention layer's MLP: ``x + a_out +
    mlp(h)`` on the attention's normed input ``h`` (``parallel_block``),
    else ``x + a_out`` then its MLP behind the second norm."""
    if cfg.parallel_block:
        return x + a_out + apply_mlp(lp["mlp"], h, cfg)
    x = x + a_out
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)


def _block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, want_cache: bool):
    """One pre-norm attention layer (dense, or the hybrid's local layer):
    returns the new residual and its K/V."""
    h = apply_norm(lp["ln1"], x, cfg)
    a_out, kv = attn.attention_fwd(lp["attn"], h, cfg, positions=positions,
                                   window=cfg.local_window)
    return _with_mlp(lp, x, h, a_out, cfg), kv


def _ssm_block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, want_cache: bool):
    """One pre-norm Mamba-2 layer: the new residual and its SSMCache (None
    unless ``want_cache``)."""
    out, c = ssm.apply_mamba2(lp["mixer"], apply_norm(lp["ln1"], x, cfg),
                              cfg, want_cache)
    return x + out, c


def _rglru_block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, want_cache: bool):
    """One pre-norm RG-LRU layer and its MLP: the new residual and its
    RGLRUCache."""
    out, c = rglru.apply_rglru(lp["rec"], apply_norm(lp["ln1"], x, cfg), cfg)
    x = x + out
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg), c


def _moe_block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, want_cache: bool):
    """One pre-norm attention layer with the MoE FFN: the new residual and
    ``(K/V, MoEStats)``."""
    a_out, kv = attn.attention_fwd(lp["attn"], apply_norm(lp["ln1"], x, cfg),
                                   cfg, positions=positions,
                                   window=cfg.local_window)
    x = x + a_out
    m_out, stats = moe.apply_moe(lp["moe"], apply_norm(lp["ln2"], x, cfg),
                                 cfg)
    return x + m_out, (kv, stats)


_BLOCKS = {"dense": _block, "local": _block, "ssm": _ssm_block,
           "rglru": _rglru_block, "moe": _moe_block}


def _stacked(caches: list, lead: tuple[int, ...]):
    """The per-layer caches (NamedTuples of one type) as one, each field
    stacked into the ``lead`` stack axes."""
    return type(caches[0])(*(torch.stack(t).reshape(*lead, *t[0].shape)
                             for t in zip(*caches)))


def _cache_slices(cache, depth: int) -> list:
    """A stacked cache (NamedTuple) as per-layer caches, over its ``depth``
    leading stack axes."""
    return [type(cache)(*fields)
            for fields in zip(*(_unbind(t, depth) for t in cache))]


def _stack_caches(cfg: ArchConfig, caches: list):
    """``[(kind, cache)]`` per layer, in order, as the family's cache: one
    stack over the layers (dense K/V, ssm), the moe family's ``{"dense":
    (nd, ...), "moe": (L - nd, ...)}`` K/V, or the hybrid's ``{"rec": (g,
    n_rec, ...), "att": (g, n_att, ...), "tail": (tail, ...)}``."""
    if cfg.family == "moe":
        out = {}
        for kind in ("dense", "moe"):
            layer = [c for k, c in caches if k == kind]
            if layer:
                out[kind] = _stacked(layer, (len(layer),))
        return out
    if cfg.family != "hybrid":
        return _stacked([c for _, c in caches], (len(caches),))
    g, tail, n_rec, n_att = hybrid_layout(cfg)
    body = caches[:len(caches) - tail]
    out = {"rec": _stacked([c for k, c in body if k == "rglru"], (g, n_rec)),
           "att": _stacked([c for k, c in body if k != "rglru"], (g, n_att))}
    if tail:
        out["tail"] = _stacked([c for _, c in caches[-tail:]], (tail,))
    return out


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            want_cache: bool = True, with_aux: bool = False):
    """Full-sequence forward: ``(hidden (B, S, d), cache)``, and the
    forward's :class:`Aux` as a third element when ``with_aux``.  The cache
    is the per-layer state stacked on the leading stack axes: K/V ``(L, B,
    S, KV, hd)`` each (dense), an ``SSMCache`` of ``conv (L, B, W-1,
    conv_dim)`` and ``state (L, B, H, p, N)`` (ssm), the moe family's
    ``{"dense": KV (nd, ...), "moe": KV (L - nd, ...)}``, or the hybrid's
    ``{"rec": RGLRUCache, "att": KV, "tail": RGLRUCache}`` (``h (g, n_rec,
    B, lru)``, ``conv (g, n_rec, B, W-1, lru)``, K/V ``(g, n_att, B, S, KV,
    hd)``, the tail's on a ``(tail,)`` axis); None when not
    ``want_cache`` (the loss: under ``jax.jit`` the reference's XLA drops
    what the loss does not read, and eager PyTorch would compute it).

    Under autograd, ``cfg.remat`` rematerializes each layer: only the
    layer inputs are kept, and the backward reruns each layer's forward,
    kernels included.  The reference checkpoints its scanned body (the
    hybrid's whole 3-layer group, its 2 tail layers not at all); per layer
    is the same function.  ``remat_policy="dots"`` is not ported."""
    _check_family(cfg, "forward")
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported; the port "
            f"rematerializes whole layers (remat_policy='full')")
    if cfg.family == "hybrid":
        layers = _hybrid_layers(params, cfg)
    elif cfg.family == "moe":
        layers = _moe_layers(params, cfg)
    else:
        layers = [(cfg.family, lp) for lp in _layers(params)]
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    caches, stats = [], []
    for kind, lp in layers:
        block = _BLOCKS[kind]
        if remat:
            x, c = checkpoint(block, lp, x, cfg, positions, want_cache,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, c = block(lp, x, cfg, positions, want_cache)
        if kind == "moe":
            c, st = c
            stats.append(st)
        caches.append((kind, c))
    x = apply_norm(params["final_norm"], x, cfg)
    out = (x, _stack_caches(cfg, caches) if want_cache else None)
    if not with_aux:
        return out
    if not stats:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return out + (Aux(zero, zero, zero),)
    aux, z, dropped = (torch.stack(t) for t in zip(*stats))
    return out + (Aux(aux.sum(), z.sum(), dropped.mean()),)


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor):
    """Full-prompt forward; returns ``(last-position logits (B, vocab),
    the per-layer cache in forward layout)``."""
    hidden, cache = forward(params, cfg, tokens)
    logits = logits_from_hidden(params, hidden[:, -1:], cfg)[:, 0]
    return logits, cache


def _repeat(cache, lead: tuple[int, ...]):
    return type(cache)(*(t.repeat(*lead, *(1,) * t.dim()) for t in cache))


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The contiguous decode cache, zeros.  The dense family's is
    ``{"layers": KV}``, k/v ``(L, B, cache_len, KV, hd)`` (with a
    ``local_window`` it is read as a RING of ``cache_len`` slots, as in the
    reference); the ssm family's ``{"layers": SSMCache}`` stacked over the
    layers (its size does not depend on ``cache_len``); the hybrid's
    ``{"rec": RGLRUCache (g, n_rec, ...), "att": KV (g, n_att, B, W, KV,
    hd), "tail": RGLRUCache (tail, ...)}``, the local layers' ring caches
    ``W = min(local_window, cache_len)`` long; the moe family's ``{"dense":
    KV (nd, B, cache_len, KV, hd), "moe": KV (L - nd, ...)}``."""
    _check_family(cfg, "init_cache")
    def kv(n: int) -> attn.KV:
        t = torch.zeros((n, batch, cache_len, cfg.n_kv_heads, cfg.head_dim_),
                        dtype=dtype, device=resolve_device(device))
        return attn.KV(t, t.clone())

    if cfg.family == "dense":
        return {"layers": kv(cfg.n_layers)}
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        return {"moe": kv(cfg.n_layers - nd), **({"dense": kv(nd)} if nd
                                                  else {})}
    if cfg.family == "ssm":
        return {"layers": _repeat(
            ssm.init_ssm_cache(cfg, batch, dtype, device), (cfg.n_layers,))}
    g, tail, n_rec, n_att = hybrid_layout(cfg)
    rc = rglru.init_rglru_cache(cfg, batch, dtype, device)
    wlen = min(cfg.local_window, cache_len) if cfg.local_window else \
        cache_len
    kv = torch.zeros((g, n_att, batch, wlen, cfg.n_kv_heads, cfg.head_dim_),
                     dtype=dtype, device=rc.h.device)
    out = {"rec": _repeat(rc, (g, n_rec)), "att": attn.KV(kv, kv.clone())}
    if tail:
        out["tail"] = _repeat(rc, (tail,))
    return out


def has_prefill_decode_relayout(cfg: ArchConfig) -> bool:
    """True when :func:`prefill_cache_to_decode` can re-lay this family's
    prefill cache (a rule on the config alone, as in the reference)."""
    return ((cfg.family == "dense" and not cfg.local_window)
            or cfg.family == "ssm")


def prefill_cache_to_decode(cfg: ArchConfig, cache, cache_len: int) -> dict:
    """Re-lay a prefill cache as a decode cache: the dense family's K/V
    ``(L, B, S, KV, hd)`` padded with zeros along the sequence to
    ``cache_len`` (later positions stay masked until written); the ssm
    cache carries forward unchanged (the final state IS the decode state).
    The windowed dense and the hybrid families have no such re-layout in
    the reference (ring caches, grouped layers): they ingest their prompt
    token by token (``train.serve_step.greedy_generate``), as does the moe
    family, whose forward cache the reference does not re-lay either."""
    if cfg.family == "moe":
        raise NotImplementedError(
            "prefill_cache_to_decode: the moe family has no forward->decode "
            "cache re-layout in the reference (src/repro/models/"
            "transformer.py:542-560 returns None); ingest the prompt token "
            "by token (greedy_generate)")
    _check_family(cfg, "prefill_cache_to_decode", (DENSE, SSM))
    if not has_prefill_decode_relayout(cfg):
        raise NotImplementedError(
            "prefill_cache_to_decode: windowed dense layers decode from "
            "ring caches, which have no prefill re-layout in the reference; "
            "ingest the prompt token by token (greedy_generate)")
    if cfg.family == "ssm":
        return {"layers": cache}
    pad = lambda t: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, cache_len - t.shape[2]))
    return {"layers": attn.KV(pad(cache.k), pad(cache.v))}


def _hybrid_decode_layer(kind: str, lp: dict, x: torch.Tensor, cache,
                         pos: torch.Tensor, cfg: ArchConfig):
    """One hybrid layer's decode step (RG-LRU or ring-cache local
    attention, then the MLP): the new residual and the layer's cache."""
    h = apply_norm(lp["ln1"], x, cfg)
    if kind == "rglru":
        out, c = rglru.decode_rglru(lp["rec"], h, cache, cfg)
    else:
        out, c = attn.attention_decode_ring(lp["attn"], h, cache, pos, cfg)
    x = x + out
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg), c


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, pos,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step over contiguous caches.  ``tokens (B,)`` int on the
    device; ``pos (B,)`` the new tokens' absolute positions on the device,
    which the dense and moe caches and the hybrid's ring caches read (the ssm
    family's state carries the position, and ``pos`` is unused, as in the
    reference).  Returns ``(logits (B, vocab), the new cache)``; the step
    reads nothing back to the host."""
    _check_family(cfg, "decode_step")
    x = embed_tokens(params, tokens[:, None], cfg)
    new = []
    if cfg.family == "dense":
        for lp, c in zip(_layers(params), _cache_slices(cache["layers"], 1)):
            h = apply_norm(lp["ln1"], x, cfg)
            if cfg.local_window:
                a_out, c = attn.attention_decode_ring(lp["attn"], h, c, pos,
                                                      cfg)
            else:
                a_out, c = attn.attention_decode(lp["attn"], h, c, pos, cfg)
            x = _with_mlp(lp, x, h, a_out, cfg)
            new.append(("dense", c))
        new_cache = {"layers": _stack_caches(cfg, new)}
    elif cfg.family == "moe":
        caches = [c for key in ("dense", "moe") if key in cache
                  for c in _cache_slices(cache[key], 1)]
        for (kind, lp), c in zip(_moe_layers(params, cfg), caches):
            h = apply_norm(lp["ln1"], x, cfg)
            a_out, c = attn.attention_decode(lp["attn"], h, c, pos, cfg)
            if kind == "dense":
                x = _with_mlp(lp, x, h, a_out, cfg)
            else:
                x = x + a_out
                m_out, _ = moe.apply_moe(
                    lp["moe"], apply_norm(lp["ln2"], x, cfg), cfg)
                x = x + m_out
            new.append((kind, c))
        new_cache = _stack_caches(cfg, new)
    elif cfg.family == "ssm":
        for lp, c in zip(_layers(params), _cache_slices(cache["layers"], 1)):
            out, c = ssm.decode_mamba2(
                lp["mixer"], apply_norm(lp["ln1"], x, cfg), c, cfg)
            x = x + out
            new.append(("ssm", c))
        new_cache = {"layers": _stack_caches(cfg, new)}
    else:
        rec = _cache_slices(cache["rec"], 2)
        if "tail" in cache:
            rec += _cache_slices(cache["tail"], 1)
        rec, att = iter(rec), iter(_cache_slices(cache["att"], 2))
        for kind, lp in _hybrid_layers(params, cfg):
            x, c = _hybrid_decode_layer(kind, lp, x,
                                        next(rec if kind == "rglru" else att),
                                        pos, cfg)
            new.append((kind, c))
        new_cache = _stack_caches(cfg, new)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = logits_from_hidden(params, x, cfg)[:, 0]
    return logits, new_cache


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


def decode_step_paged(params, cfg: ArchConfig, tokens: torch.Tensor,
                      pos: torch.Tensor, pools: dict, *, table: torch.Tensor,
                      page: int) -> torch.Tensor:
    """One decode step of ONE sequence through its paged view: one K5
    launch (at one slot) per layer.

    tokens/pos: (1,) on the device (pos int32); ``table``: (width,) int32
    view->slab map on the device.  The pools are updated IN PLACE.
    Returns logits (1, vocab)."""
    _check_family(cfg, "decode_step_paged", (DENSE,))
    x = embed_tokens(params, tokens[:, None], cfg)
    for i, lp in enumerate(_layers(params)):
        h = apply_norm(lp["ln1"], x, cfg)
        a_out = attn.attention_decode_paged(
            lp["attn"], h, pools["k"][i], pools["v"][i], pos, cfg,
            table=table, page=page, window=cfg.local_window)
        x = _with_mlp(lp, x, h, a_out, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, x, cfg)[:, 0]


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
        x = _with_mlp(lp, x, h, a_out, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, x, cfg)[:, 0]


def lm_loss(params, cfg: ArchConfig, tokens: torch.Tensor,
            targets: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """``repro.models.transformer.lm_loss``: the mean next-token NLL (f32
    ``log_softmax`` of the logits, the NLL of each target, its mean) plus
    0.01 x the MoE load-balance loss and 1e-3 x its z-loss (the
    reference's default weights), which are zero but for the moe family;
    the metrics are the reference's (``nll``, ``moe_aux``, ``moe_z``,
    ``dropped``).  The moe
    family's gradient needs K1's expert VJP forms, which the card does
    not have yet (``ops.expert_matmul``)."""
    hidden, _, aux = forward(params, cfg, tokens, want_cache=False,
                             with_aux=True)
    logits = logits_from_hidden(params, hidden, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mean = nll.mean()
    loss = mean
    if cfg.family == "moe":
        loss = mean + 0.01 * aux.moe_aux + 1e-3 * aux.moe_z
    return loss, {"nll": mean.detach(), "moe_aux": aux.moe_aux.detach(),
                  "moe_z": aux.moe_z.detach(), "dropped": aux.dropped.detach()}
