"""Decoder-LM assembly (``repro.models.transformer``) for the dense family
with full attention (RMSNorm or LayerNorm, with or without biases,
sequential or parallel blocks) or MLA (multi-head latent attention,
minicpm3-4b), the vlm family (paligemma-3b: the dense stack behind a
``frontend.adapter`` over stub patch embeddings, prefix-LM attention over
the patches), the attention-free ssm (Mamba-2) family,
the hybrid (RG-LRU + local attention) family and the moe family
(deepseek: dense first layers, then attention + MoE FFN layers; llama4:
groups of a ``layer_pattern`` of local (windowed) and full attention
layers, each with the MoE FFN).

Parameters are a nested ``nn.ModuleDict`` of ``nn.ParameterDict``s with the
reference's names and layouts — layer stacks keep their leading ``layers``
axis (``layers.attn.wq`` is ``(L, d, h, hd)``, MLA's ``layers.attn.wkv_b``
``(L, kv_rank, h, nope + vd)``, ``layers.mixer.w_in`` is
``(L, d, 2 d_inner + 2 n + h)``, ``embed.table`` is ``(V, d)``), the
hybrid's groups their ``(groups, n_rec)`` / ``(groups, n_att)`` axes
(``groups.rec.w_x`` is ``(g, n_rec, d, lru)``, ``groups.att.wq`` ``(g,
n_att, d, h, hd)``) and its recurrent tail a ``(tail,)`` axis
(``tail.rec.*``), the moe family's ``dense_layers.*`` ``(nd,)`` and
``layers.*`` ``(L - nd,)`` stacks (``layers.moe.wi`` is ``(L - nd, e, d,
2 f)``, its router f32) or, with a ``layer_pattern``, its ``groups.{ln1,
ln2, attn, moe}`` ``(g, len(pattern))`` stacks — so carrying weights
across from the JAX package is a copy with no transposes
(``repro_torch.convert``).  The reference
scans its layer stacks (the hybrid its layer groups); here a Python loop
indexes the stacked tensors.

Entry points:

    init_lm(cfg, generator, device, trainable) -> params
    forward(params, cfg, tokens, want_cache, with_aux, patches)
                                               -> (hidden, cache[, aux])
    lm_loss(params, cfg, tokens, targets, patches) -> (loss, metrics)
    prefill(params, cfg, tokens, patches)      -> (logits, cache)
    init_cache(cfg, batch, cache_len, ...)     -> decode cache
    decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
    all:    prefill_cache_to_decode(cfg, cache, cache_len)
                                -> decode cache (dense, ssm) or None
    dense, vlm:
            init_paged_pools(cfg, pool_tokens, ...) -> {"k", "v"}
            decode_step_paged(params, cfg, tokens, pos, pools, table,
                              page)            -> logits  (one sequence)
            decode_step_paged_batched(params, cfg, tokens, pos, pools,
                                      tables, page)    -> logits
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.common import ArchConfig
from repro_torch.device import cache_device, resolve_device
from repro_torch.distributed import fsdp
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe, rglru, ssm
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       logits_from_hidden, token_nll)

DENSE, MLA, SSM, HYBRID, MOE, VLM = (("dense", "full"), ("dense", "mla"),
                                     ("ssm", "none"), ("hybrid", "full"),
                                     ("moe", "full"), ("vlm", "full"))


def _check_family(cfg: ArchConfig, what: str,
                  ported: tuple = (DENSE, MLA, SSM, HYBRID, MOE, VLM)
                  ) -> None:
    if (cfg.family, cfg.attention) not in ported:
        raise NotImplementedError(
            f"{what}: the port covers {' and '.join(map(str, ported))} as "
            f"(family, attention); family={cfg.family!r} "
            f"attention={cfg.attention!r} is not ported yet (ROADMAP.md, "
            f"Queue 1)")


class Aux(NamedTuple):
    """The MoE terms of a forward (``repro.models.transformer.Aux``): the
    load-balance and z losses summed over the MoE layers, the dropped share
    averaged over them; zeros for the other families."""
    moe_aux: torch.Tensor
    moe_z: torch.Tensor
    dropped: torch.Tensor


def _mla_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    """The reference's ``init_mla`` tree: the q latent's down and up
    projections and norm, the kv latent's (plus the shared rotary key),
    and the output projection."""
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr, nope, rope, vd = attn.MLA_DIMS
    return {"wq_a": (lead + (d, qr), d ** -0.5),
            "q_norm": (lead + (qr,), "ones"),
            "wq_b": (lead + (qr, h, nope + rope), qr ** -0.5),
            "wkv_a": (lead + (d, kvr + rope), d ** -0.5),
            "kv_norm": (lead + (kvr,), "ones"),
            "wkv_b": (lead + (kvr, h, nope + vd), kvr ** -0.5),
            "wo": (lead + (h, vd, d), (h * vd) ** -0.5)}


def _attn_shapes(cfg: ArchConfig, lead: tuple[int, ...]) -> dict:
    if cfg.attention == "mla":
        return _mla_shapes(cfg, lead)
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


def moe_groups(cfg: ArchConfig) -> tuple[int, int, int]:
    """``(groups, n_local, n_full)`` of a moe stack with a
    ``layer_pattern`` (llama4): ``groups`` repeats of the pattern, each of
    ``n_local`` local and ``n_full`` full attention layers."""
    pat = cfg.layer_pattern
    n_local = sum(1 for k in pat if k == "local")
    return cfg.n_layers // len(pat), n_local, len(pat) - n_local


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
    elif cfg.family == "moe" and cfg.layer_pattern:
        lead = (moe_groups(cfg)[0], len(cfg.layer_pattern))
        shapes.update({"groups.ln1": _norm_shapes(cfg, lead),
                       "groups.ln2": _norm_shapes(cfg, lead),
                       "groups.attn": _attn_shapes(cfg, lead),
                       "groups.moe": moe.moe_shapes(cfg, lead)})
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
        if cfg.family == "vlm":
            shapes["frontend"] = {"adapter": ((d, d), d ** -0.5)}
    return shapes


#: each leaf's logical axes past its stack axes (the reference's
#: ``Collector`` axes), by the kind of the group it sits in
_LEAF_AXES = {
    "norm": {"scale": ("d_model",), "bias": ("d_model",)},
    "attn": {"wq": ("d_model", "heads", None),
             "wk": ("d_model", "kv_heads", None),
             "wv": ("d_model", "kv_heads", None),
             "wo": ("heads", None, "d_model"),
             "bq": ("heads", None), "bk": ("kv_heads", None),
             "bv": ("kv_heads", None), "bo": ("d_model",)},
    "mla": {"wq_a": ("d_model", None), "q_norm": (None,),
            "wq_b": (None, "heads", None), "wkv_a": ("d_model", None),
            "kv_norm": (None,), "wkv_b": (None, "heads", None),
            "wo": ("heads", None, "d_model")},
    "mlp": {"wi": ("d_model", "d_ff"), "wo": ("d_ff", "d_model"),
            "bi": ("d_ff",), "bo": ("d_model",)},
    "moe": {"router": ("d_model", "experts"),
            "wi": ("experts", "d_model", "moe_ff"),
            "wo": ("experts", "moe_ff", "d_model"),
            "shared_wi": ("d_model", "d_ff"),
            "shared_wo": ("d_ff", "d_model")},
    "rglru": {"w_x": ("d_model", "lru"), "w_gate": ("d_model", "lru"),
              "conv_w": (None, "lru"), "conv_b": ("lru",),
              "wa": (None, "lru"), "wi": (None, "lru"), "ba": ("lru",),
              "bi": ("lru",), "lam": ("lru",), "w_out": ("lru", "d_model")},
    "ssm": {"w_in": ("d_model", "d_inner"), "conv_w": (None, "d_inner"),
            "conv_b": ("d_inner",), "A_log": ("ssm_heads",),
            "D": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "norm_scale": ("d_inner",), "w_out": ("d_inner", "d_model")},
    "embed": {"table": ("vocab", "d_model")},
    "unembed": {"w": ("d_model", "vocab")},
    "frontend": {"adapter": ("d_model", None)},
}


def _group_kind(group: str, cfg: ArchConfig) -> str:
    last = group.split(".")[-1]
    if last in ("embed", "unembed", "frontend", "moe"):
        return last
    if last in ("attn", "att", "self_attn", "cross_attn"):
        return "mla" if cfg.attention == "mla" else "attn"
    if last.endswith("mlp"):
        return "mlp"
    if last == "rec":
        return "rglru"
    if last == "mixer":
        return "ssm"
    return "norm"                 # ln1, ln2, ln_x, *_ln1, final_norm, ...


def axes_of(shapes: dict, cfg: ArchConfig) -> dict:
    """``{group: {name: logical axes}}`` beside ``shapes`` (as
    :func:`param_shapes` gives them), in its order: a stacked leaf's
    first stack axis is ``"layers"``, any further one None."""
    out = {}
    for group, leaves in shapes.items():
        table = _LEAF_AXES[_group_kind(group, cfg)]
        out[group] = {}
        for name, spec in leaves.items():
            tail = table[name]
            lead = len(spec[0]) - len(tail)
            out[group][name] = (("layers",) + (None,) * (lead - 1)
                                if lead else ()) + tail
    return out


def param_axes(cfg: ArchConfig) -> dict:
    """Each leaf's logical axes (the reference's ``Collector`` axes tree),
    beside :func:`param_shapes`; ``distributed.sharding`` places them."""
    return axes_of(param_shapes(cfg), cfg)


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


def _draw_parts(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` as leading slices of at most 2^32 elements, in index order
    (``t`` itself when it is that small)."""
    if t.numel() <= 2 ** 32:
        return [t]
    return [p for part in t.unbind(0) for p in _draw_parts(part)]


def init_lm(cfg: ArchConfig, generator: torch.Generator,
            device="cuda", trainable: bool = False) -> nn.ModuleDict:
    """Random parameters with the reference's shapes and scales: normal(0,
    scale) drawn in f32 from ``generator`` on ``device``, then cast to
    ``cfg.dtype`` (or the leaf's own dtype); norm scales are ones, biases
    zeros.  (``jax.random`` and torch draw
    different numbers from one seed: tests carry the JAX draw across with
    ``convert.params_from_numpy`` instead.)  ``trainable`` as in
    :func:`build_params`."""
    return draw_params(param_shapes(cfg), cfg, generator, device, trainable)


def draw_params(shapes: dict, cfg: ArchConfig, generator: torch.Generator,
                device="cuda", trainable: bool = False) -> nn.ModuleDict:
    """The parameter tree of ``shapes`` (as :func:`param_shapes` gives
    them), drawn in their order as :func:`init_lm` describes."""
    device = resolve_device(device)
    dtype = getattr(torch, str(cfg.dtype))
    tensors = {}
    for group, leaves in shapes.items():
        tensors[group] = {}
        for name, (shape, scale, *own) in leaves.items():
            dt = getattr(torch, own[0]) if own else dtype
            if scale == "ones":
                t = torch.ones(shape, dtype=dt, device=device)
            elif scale == "zeros":
                t = torch.zeros(shape, dtype=dt, device=device)
            else:
                # a leaf of over 2^32 elements (the moe family's stacked
                # experts) is drawn a leading slice at a time, each of at
                # most 2^32, so that its f32 draw never holds the whole leaf
                t = torch.empty(shape, dtype=dt, device=device)
                for part in _draw_parts(t):
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
    MoE layers (``{ln1, ln2, attn, moe}``, kind ``"moe"``); with a
    ``layer_pattern``, each group's layers in pattern order, kind
    ``"moe_local"`` or ``"moe_full"``."""
    if cfg.layer_pattern:
        pat = cfg.layer_pattern
        return [(f"moe_{pat[i % len(pat)]}", lp)
                for i, lp in enumerate(_slices(params["groups"], 2))]
    out = []
    if cfg.first_dense_layers:
        out = [("dense", lp) for lp in _slices(params["dense_layers"], 1)]
    return out + [("moe", lp) for lp in _layers(params)]


def layer_params(params, cfg: ArchConfig) -> list[tuple[str, dict]]:
    """The stack's layers in order as ``(kind, params)``, each layer's
    slices named as its block reads them (the hybrid's
    :func:`_hybrid_layers`, the moe family's :func:`_moe_layers`, else
    the ``layers`` stack with the family as its kind).  The slicing only
    ``unbind``s each leaf, so any leaf that has ``unbind`` passes."""
    if cfg.family == "hybrid":
        return _hybrid_layers(params, cfg)
    if cfg.family == "moe":
        return _moe_layers(params, cfg)
    return [(cfg.family, lp) for lp in _layers(params)]


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
           positions: torch.Tensor, want_cache: bool, prefix_len: int = 0):
    """One pre-norm attention layer (dense or vlm, with the prefix-LM's
    ``prefix_len``; or the hybrid's local layer): returns the new residual
    and its K/V (MLA: its ``MLACache``)."""
    h = apply_norm(lp["ln1"], x, cfg)
    if cfg.attention == "mla":
        a_out, kv = attn.mla_fwd(lp["attn"], h, cfg, positions=positions)
    else:
        a_out, kv = attn.attention_fwd(lp["attn"], h, cfg,
                                       positions=positions,
                                       window=cfg.local_window,
                                       prefix_len=prefix_len)
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
               positions: torch.Tensor, want_cache: bool, window: int = 0):
    """One pre-norm attention layer (full, or windowed by ``window``) with
    the MoE FFN: the new residual and ``(K/V, MoEStats)``."""
    a_out, kv = attn.attention_fwd(lp["attn"], apply_norm(lp["ln1"], x, cfg),
                                   cfg, positions=positions, window=window)
    x = x + a_out
    m_out, stats = moe.apply_moe(lp["moe"], apply_norm(lp["ln2"], x, cfg),
                                 cfg)
    return x + m_out, (kv, stats)


def _moe_local_block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                     positions: torch.Tensor, want_cache: bool):
    """llama4's local layer: the MoE layer windowed by ``local_window``."""
    return _moe_block(lp, x, cfg, positions, want_cache, cfg.local_window)


_BLOCKS = {"dense": _block, "vlm": _block, "local": _block, "ssm": _ssm_block,
           "rglru": _rglru_block, "moe": _moe_block, "moe_full": _moe_block,
           "moe_local": _moe_local_block}


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
    (nd, ...), "moe": (L - nd, ...)}`` K/V (with a ``layer_pattern``, one
    K/V over ``(g, len(pattern))``, as the reference's scanned groups
    stack it), or the hybrid's ``{"rec": (g, n_rec, ...), "att": (g,
    n_att, ...), "tail": (tail, ...)}``."""
    if cfg.family == "moe" and cfg.layer_pattern:
        return _stacked([c for _, c in caches],
                        (moe_groups(cfg)[0], len(cfg.layer_pattern)))
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


def _embed_inputs(params, cfg: ArchConfig, tokens: torch.Tensor,
                  patches: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """The embedded sequence and its prefix length: the token embeddings,
    behind the adapted patches (``patches @ frontend.adapter`` on K1, in
    the model's dtype) for the vlm family, whose prefix they are."""
    x = embed_tokens(params, tokens, cfg)
    if cfg.family != "vlm":
        return x, 0
    if patches is None:
        raise ValueError("the vlm family's forward takes patches (B, P, d) "
                         "beside the tokens")
    pe = ops.matmul(patches.to(x.dtype),
                    fsdp.gather(params["frontend"]["adapter"]),
                    out_dtype=x.dtype)
    return torch.cat([pe, x], dim=1), patches.shape[1]


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            want_cache: bool = True, with_aux: bool = False,
            patches: torch.Tensor | None = None):
    """Full-sequence forward: ``(hidden (B, S, d), cache)``, and the
    forward's :class:`Aux` as a third element when ``with_aux``.  The vlm
    family takes ``patches (B, P, d)``: the sequence is the P adapted
    patches, then the tokens (S = P + the tokens), and every layer
    attends to it with the prefix-LM mask of ``prefix_len = P``.  The cache
    is the per-layer state stacked on the leading stack axes: K/V ``(L, B,
    S, KV, hd)`` each (dense; MLA an ``MLACache`` of ``c_kv (L, B, S,
    kv_rank)`` and ``k_pe (L, B, S, rope)``), an ``SSMCache`` of ``conv
    (L, B, W-1, conv_dim)`` and ``state (L, B, H, p, N)`` (ssm), the moe
    family's
    ``{"dense": KV (nd, ...), "moe": KV (L - nd, ...)}`` (with a
    ``layer_pattern``, K/V ``(g, len(pattern), B, S, KV, hd)``), or the
    hybrid's
    ``{"rec": RGLRUCache, "att": KV, "tail": RGLRUCache}`` (``h (g, n_rec,
    B, lru)``, ``conv (g, n_rec, B, W-1, lru)``, K/V ``(g, n_att, B, S, KV,
    hd)``, the tail's on a ``(tail,)`` axis); None when not
    ``want_cache`` (the loss: under ``jax.jit`` the reference's XLA drops
    what the loss does not read, and eager PyTorch would compute it).

    The sharded train step's parameters arrive at their stored chunks:
    each layer gathers its slices at the top of its block
    (``distributed.fsdp.gathering``, inside the remat ``checkpoint``, so
    the rerun gathers again; with remat off the gathered weights autograd
    saves are regathered in the backward, ``fsdp.regather_saved``), the
    leaves outside the stacks at their use.

    Under autograd, ``cfg.remat`` rematerializes each layer: only the
    layer inputs are kept, and the backward reruns each layer's forward,
    kernels included.  The reference checkpoints its scanned body (the
    hybrid's whole 3-layer group, its 2 tail layers not at all); per layer
    is the same function (the reference also checkpoints each sublayer
    of a moe group).  ``remat_policy="dots"`` also keeps the outputs of
    the layer's 2-D K1 products (``ops.matmul``), which the backward's
    rerun replays instead of launching them again
    (``ops.dots_contexts``); attention, norms, activations and the expert
    and head products run again.  Either policy computes the same values.

    The :class:`Aux` sums the MoE layers' load-balance and z losses; its
    dropped share is their mean, except with a ``layer_pattern``, where
    (as the reference sums each group's terms before its mean over the
    groups) it is the sum over a group's layers averaged over groups."""
    _check_family(cfg, "forward")
    remat = cfg.remat and torch.is_grad_enabled()
    context = ({"context_fn": ops.dots_contexts}
               if cfg.remat_policy == "dots" else {})
    layers = layer_params(params, cfg)
    x, prefix_len = _embed_inputs(params, cfg, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    caches, stats = [], []
    for kind, lp in layers:
        block = fsdp.gathering(_BLOCKS[kind])
        if prefix_len:
            block = functools.partial(block, prefix_len=prefix_len)
        if remat:
            x, c = checkpoint(block, lp, x, cfg, positions, want_cache,
                              use_reentrant=False, preserve_rng_state=False,
                              **context)
        else:
            with fsdp.regather_saved():
                x, c = block(lp, x, cfg, positions, want_cache)
        if kind.startswith("moe"):
            c, st = c
            stats.append(st)
        caches.append((kind, c))
    x = apply_norm(fsdp.gather_group("final_norm", params["final_norm"]), x,
                   cfg)
    out = (x, _stack_caches(cfg, caches) if want_cache else None)
    if not with_aux:
        return out
    if not stats:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return out + (Aux(zero, zero, zero),)
    aux, z, dropped = (torch.stack(t) for t in zip(*stats))
    if cfg.layer_pattern:
        dropped = dropped.reshape(moe_groups(cfg)[0], -1).sum(1)
    return out + (Aux(aux.sum(), z.sum(), dropped.mean()),)


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            patches: torch.Tensor | None = None):
    """Full-prompt forward (the vlm family's with its ``patches``);
    returns ``(last-position logits (B, vocab), the per-layer cache in
    forward layout)``."""
    hidden, cache = forward(params, cfg, tokens, patches=patches)
    logits = logits_from_hidden(params, hidden[:, -1:], cfg)[:, 0]
    return logits, cache


def _repeat(cache, lead: tuple[int, ...]):
    return type(cache)(*(t.repeat(*lead, *(1,) * t.dim()) for t in cache))


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """The contiguous decode cache, zeros.  The dense family's is
    ``{"layers": KV}``, k/v ``(L, B, cache_len, KV, hd)`` (with a
    ``local_window`` it is read as a RING of ``cache_len`` slots, as in the
    reference), MLA's ``{"layers": MLACache}``, c_kv ``(L, B, cache_len,
    kv_rank)`` and k_pe ``(L, B, cache_len, rope)``; the ssm family's ``{"layers": SSMCache}`` stacked over the
    layers (its size does not depend on ``cache_len``); the hybrid's
    ``{"rec": RGLRUCache (g, n_rec, ...), "att": KV (g, n_att, B, W, KV,
    hd), "tail": RGLRUCache (tail, ...)}``, the local layers' ring caches
    ``W = min(local_window, cache_len)`` long; the moe family's ``{"dense":
    KV (nd, B, cache_len, KV, hd), "moe": KV (L - nd, ...)}``, or with a
    ``layer_pattern`` ``{"local": KV (g, n_local, B, W, KV, hd), "full":
    KV (g, n_full, B, cache_len, KV, hd)}``, the local layers' ring
    caches ``W`` long."""
    _check_family(cfg, "init_cache")
    def kv(*lead: int, length: int = cache_len) -> attn.KV:
        t = torch.zeros((*lead, batch, length, cfg.n_kv_heads,
                         cfg.head_dim_), dtype=dtype,
                        device=cache_device(device))
        return attn.KV(t, t.clone())

    if cfg.family in ("dense", "vlm") and cfg.attention == "mla":
        _, kvr, _, rope, _ = attn.MLA_DIMS
        zeros = lambda n: torch.zeros((cfg.n_layers, batch, cache_len, n),
                                      dtype=dtype,
                                      device=cache_device(device))
        return {"layers": attn.MLACache(zeros(kvr), zeros(rope))}
    if cfg.family in ("dense", "vlm"):
        return {"layers": kv(cfg.n_layers)}
    if cfg.family == "moe" and cfg.layer_pattern:
        g, nl, nf = moe_groups(cfg)
        wlen = min(cfg.local_window, cache_len) if cfg.local_window else \
            cache_len
        return {"local": kv(g, nl, length=wlen), "full": kv(g, nf)}
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


def prefill_cache_to_decode(cfg: ArchConfig, cache, cache_len: int
                            ) -> dict | None:
    """Re-lay a prefill cache as a decode cache: the dense family's K/V
    ``(L, B, S, KV, hd)`` (MLA's ``MLACache``, ``(L, B, S, rank)`` each)
    padded with zeros along the sequence to ``cache_len`` (later
    positions stay masked until written); the ssm
    cache carries forward unchanged (the final state IS the decode state).
    None, as in the reference, for every other family: the windowed dense
    and hybrid ring caches, the moe family's grouped layers, vlm (its
    prefill takes patches) and audio have no such re-layout, and ingest
    their prompt token by token (``train.serve_step.greedy_generate``)."""
    if not has_prefill_decode_relayout(cfg):
        return None
    if cfg.family == "ssm":
        return {"layers": cache}
    pad = lambda t: torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 3) + (0, cache_len - t.shape[2]))
    return {"layers": type(cache)(*(pad(t) for t in cache))}


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
    if cfg.family in ("dense", "vlm"):
        for lp, c in zip(_layers(params), _cache_slices(cache["layers"], 1)):
            h = apply_norm(lp["ln1"], x, cfg)
            if cfg.attention == "mla":
                a_out, c = attn.mla_decode(lp["attn"], h, c, pos, cfg)
            elif cfg.local_window:
                a_out, c = attn.attention_decode_ring(lp["attn"], h, c, pos,
                                                      cfg)
            else:
                a_out, c = attn.attention_decode(lp["attn"], h, c, pos, cfg)
            x = _with_mlp(lp, x, h, a_out, cfg)
            new.append(("dense", c))
        new_cache = {"layers": _stack_caches(cfg, new)}
    elif cfg.family == "moe" and cfg.layer_pattern:
        g, nl, nf = moe_groups(cfg)
        local = iter(_cache_slices(cache["local"], 2))
        full = iter(_cache_slices(cache["full"], 2))
        new_local, new_full = [], []
        for kind, lp in _moe_layers(params, cfg):
            h = apply_norm(lp["ln1"], x, cfg)
            if kind == "moe_local":
                a_out, c = attn.attention_decode_ring(lp["attn"], h,
                                                      next(local), pos, cfg)
                new_local.append(c)
            else:
                a_out, c = attn.attention_decode(lp["attn"], h, next(full),
                                                 pos, cfg)
                new_full.append(c)
            x = x + a_out
            m_out, _ = moe.apply_moe(lp["moe"], apply_norm(lp["ln2"], x, cfg),
                                     cfg)
            x = x + m_out
        new_cache = {"local": _stacked(new_local, (g, nl)),
                     "full": _stacked(new_full, (g, nf))}
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


def _check_paged(cfg: ArchConfig, what: str) -> None:
    """The paged decode covers the dense and vlm families' K/V heads, as
    the reference's three paged entries do (``src/repro/models/
    transformer.py:568``, ``:586``, ``:627``); MLA's latent cache has no
    paged view, and the reference refuses it too.  (The engine still
    never pages vlm: its prefill takes patches.)"""
    if cfg.attention == "mla":
        raise ValueError(f"{what}: paged pools cover dense/vlm GQA decode, "
                         f"not family={cfg.family!r} attention="
                         f"{cfg.attention!r}")
    _check_family(cfg, what, (DENSE, VLM))


def init_paged_pools(cfg: ArchConfig, pool_tokens: int,
                     dtype=torch.float32, device="cuda") -> dict:
    """Per-layer stacked K/V slab pools ``(L, pool_tokens, KV, hd)`` for
    paged decode.  A sequence's cache is the view its page table describes
    (shared across layers: every layer writes the same positions)."""
    _check_paged(cfg, "init_paged_pools")
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
    _check_paged(cfg, "decode_step_paged")
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
    _check_paged(cfg, "decode_step_paged_batched")
    x = embed_tokens(params, tokens[:, None], cfg)
    for i, lp in enumerate(_layers(params)):
        h = apply_norm(lp["ln1"], x, cfg)
        a_out = attn.attention_decode_paged_batched(
            lp["attn"], h, pools["k"][i], pools["v"][i], pos, cfg,
            tables=tables, page=page, window=cfg.local_window)
        x = _with_mlp(lp, x, h, a_out, cfg)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params, x, cfg)[:, 0]


def tie_gathered(params, cfg: ArchConfig):
    """``params`` with a tied table that arrives at its stored chunk
    gathered once (``distributed.fsdp.gather``), the copy the lookup and
    the head both read, so that their gradients sum on it before its one
    reduce-scatter; else ``params``."""
    from torch.distributed.tensor import DTensor
    table = params["embed"]["table"]
    if not cfg.tie_embeddings or not isinstance(table, DTensor):
        return params
    return dict(params.items(),
                embed={"table": fsdp.gather(table, keep_model=True)})


def lm_loss(params, cfg: ArchConfig, tokens: torch.Tensor,
            targets: torch.Tensor, patches: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """``repro.models.transformer.lm_loss``: the mean next-token NLL (f32
    ``log_softmax`` of the logits, the NLL of each target, its mean) plus
    0.01 x the MoE load-balance loss and 1e-3 x its z-loss (the
    reference's default weights), which are zero but for the moe family;
    the metrics are the reference's (``nll``, ``moe_aux``, ``moe_z``,
    ``dropped``).  The vlm family (with its ``patches``) is scored on the
    text positions only.  Where a planned mesh shards the head's columns
    over ``"model"``, the log-softmax is vocabulary-parallel
    (``layers.token_nll``)."""
    params = tie_gathered(params, cfg)
    hidden, _, aux = forward(params, cfg, tokens, want_cache=False,
                             with_aux=True, patches=patches)
    if cfg.family == "vlm":
        hidden = hidden[:, patches.shape[1]:]
    nll = token_nll(logits_from_hidden(params, hidden, cfg,
                                       vocab_shard=True), targets)
    mean = nll.mean()
    loss = mean
    if cfg.family == "moe":
        loss = mean + 0.01 * aux.moe_aux + 1e-3 * aux.moe_z
    return loss, {"nll": mean.detach(), "moe_aux": aux.moe_aux.detach(),
                  "moe_z": aux.moe_z.detach(), "dropped": aux.dropped.detach()}
