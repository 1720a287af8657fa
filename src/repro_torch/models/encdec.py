"""Encoder-decoder transformer (``repro.models.encdec``, the whisper
backbone).  [arXiv:2212.04356]

The conv audio frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings ``(B, n_frames, d_model)`` through a linear
``frontend.adapter`` on K1.  Positions are sinusoidal on both sides
(``layers.sinusoid_positions``; no rotary).  The encoder attends
bidirectionally and the decoder's cross-attention reads K/V projected
from the encoder's output; both run on K2's bidirectional form
(``causal=False``; the reference takes them in einsums), the decoder's
self-attention on its causal form.  Every product is on K1.

Parameters (a nested ``nn.ModuleDict``, the reference's names and
layouts): ``embed.table (V, d)``, ``frontend.adapter (d, d)``,
``encoder.{ln1, ln2, attn, mlp}`` stacked over the E encoder layers,
``encoder_norm``, ``final_norm``, and ``decoder.{ln1, ln_x, ln2,
self_attn, cross_attn, mlp}`` stacked over the L decoder layers.

Entry points:

    init_encdec(cfg, generator, device, trainable)  -> params
    encode(params, cfg, frames)                      -> encoder states
    decoder_forward(params, cfg, tokens, enc)        -> (hidden, self K/V)
    encdec_loss(params, cfg, frames, tokens, targets) -> (loss, metrics)
    init_encdec_cache(cfg, batch, cache_len, ...)    -> EncDecCache
    encdec_prefill(params, cfg, frames, tokens)      -> (logits, cache)
    encdec_decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.common import ArchConfig
from repro_torch.device import cache_device
from repro_torch.distributed import comm, fsdp
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tt
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       logits_from_hidden,
                                       sinusoid_positions, token_nll)


def param_shapes(cfg: ArchConfig) -> dict:
    """``{group: {name: (shape, init scale or "ones" / "zeros")}}`` in the
    reference's ``init_encdec`` order and scales."""
    if cfg.family != "audio":
        raise ValueError(f"the encoder-decoder is the audio family, not "
                         f"{cfg.family!r}")
    d, E, L = cfg.d_model, cfg.encoder_layers, cfg.n_layers
    shapes = {"embed": {"table": ((cfg.vocab_size, d), d ** -0.5)}}
    if not cfg.tie_embeddings:
        shapes["unembed"] = {"w": ((d, cfg.vocab_size), d ** -0.5)}
    shapes["frontend"] = {"adapter": ((d, d), d ** -0.5)}
    shapes.update({"encoder.ln1": tt._norm_shapes(cfg, (E,)),
                   "encoder.ln2": tt._norm_shapes(cfg, (E,)),
                   "encoder.attn": tt._attn_shapes(cfg, (E,)),
                   "encoder.mlp": tt._mlp_shapes(cfg, (E,)),
                   "encoder_norm": tt._norm_shapes(cfg, ()),
                   "final_norm": tt._norm_shapes(cfg, ()),
                   "decoder.ln1": tt._norm_shapes(cfg, (L,)),
                   "decoder.ln_x": tt._norm_shapes(cfg, (L,)),
                   "decoder.ln2": tt._norm_shapes(cfg, (L,)),
                   "decoder.self_attn": tt._attn_shapes(cfg, (L,)),
                   "decoder.cross_attn": tt._attn_shapes(cfg, (L,)),
                   "decoder.mlp": tt._mlp_shapes(cfg, (L,))})
    return shapes


def param_axes(cfg: ArchConfig) -> dict:
    """Each leaf's logical axes beside :func:`param_shapes`
    (``transformer.axes_of``)."""
    return tt.axes_of(param_shapes(cfg), cfg)


def init_encdec(cfg: ArchConfig, generator: torch.Generator,
                device="cuda", trainable: bool = False) -> nn.ModuleDict:
    """Random parameters with the reference's shapes and scales, drawn as
    ``transformer.init_lm`` draws them."""
    return tt.draw_params(param_shapes(cfg), cfg, generator, device,
                          trainable)


def _remat(cfg: ArchConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _positions(s: int, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """``x`` plus the sinusoids of positions ``0 .. s-1``, in x's dtype."""
    pos = torch.arange(s, device=x.device)
    return x + sinusoid_positions(pos, cfg.d_model).to(x.dtype)[None]


def _encoder_layer(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    h = apply_norm(lp["ln1"], x, cfg)
    a, _ = attn.attention_fwd(lp["attn"], h, cfg, positions=positions,
                              causal=False)
    x = x + a
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)


def encode(params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """``frames (B, n_frames, d)`` stub embeddings -> the encoder states
    ``(B, n_frames, d)`` in ``cfg.dtype``: the adapter (K1), the
    sinusoids, the bidirectional layers (each rematerialized under
    autograd when ``cfg.remat``), the encoder norm."""
    dtype = getattr(torch, str(cfg.dtype))
    x = ops.matmul(frames.to(dtype), fsdp.gather(params["frontend"]
                                                 ["adapter"]),
                   out_dtype=dtype)
    s = x.shape[1]
    x = _positions(s, cfg, x)
    positions = torch.arange(s, device=x.device)[None, :]
    layer = fsdp.gathering(_encoder_layer)
    for lp in tt._slices(params["encoder"], 1):
        if _remat(cfg):
            x = checkpoint(layer, lp, x, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            with fsdp.regather_saved():
                x = layer(lp, x, cfg, positions)
    return apply_norm(fsdp.gather_group("encoder_norm",
                                        params["encoder_norm"]), x, cfg)


def _cross_kv(lp, enc: torch.Tensor, cfg: ArchConfig) -> attn.KV:
    """The cross-attention K/V ``(B, Senc, KV, hd)`` each of the encoder
    states, with their biases (``use_bias``), in enc's dtype: this rank's
    K/V heads where the layer's heads are over ``"model"``
    (``attention.local_heads``)."""
    heads = attn.local_heads(lp)
    if heads is not None:
        lp = heads.p
        enc = comm.replicated_in(enc, heads.group)
    k = attn._proj(enc, lp["wk"])
    v = attn._proj(enc, lp["wv"])
    if "bk" in lp:
        k = k + lp["bk"].to(enc.dtype)
        v = v + lp["bv"].to(enc.dtype)
    return attn.KV(k, v)


def _decoder_layer(lp: dict, x: torch.Tensor, enc: torch.Tensor,
                   cfg: ArchConfig, positions: torch.Tensor):
    """One decoder layer: causal self-attention, cross-attention over
    ``enc`` (its K/V projected here, in every layer, as the reference's
    scanned body does), the MLP.  Returns the new residual and the
    self-attention's K/V."""
    h = apply_norm(lp["ln1"], x, cfg)
    a, kv = attn.attention_fwd(lp["self_attn"], h, cfg, positions=positions)
    x = x + a
    hx = apply_norm(lp["ln_x"], x, cfg)
    ca, _ = attn.attention_fwd(lp["cross_attn"], hx, cfg,
                               positions=positions, causal=False,
                               kv_override=_cross_kv(lp["cross_attn"], enc,
                                                     cfg))
    x = x + ca
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg), kv


def decoder_forward(params, cfg: ArchConfig, tokens: torch.Tensor,
                    enc: torch.Tensor, want_cache: bool = True):
    """The teacher-forced decoder pass: ``(hidden (B, S, d) after the
    final norm, self K/V (L, B, S, KV, hd) each)``; the K/V None unless
    ``want_cache`` (the loss reads none)."""
    x = embed_tokens(params, tokens, cfg)
    s = x.shape[1]
    x = _positions(s, cfg, x)
    positions = torch.arange(s, device=x.device)[None, :]
    kvs = []
    layer = fsdp.gathering(_decoder_layer)
    for lp in tt._slices(params["decoder"], 1):
        if _remat(cfg):
            x, kv = checkpoint(layer, lp, x, enc, cfg, positions,
                               use_reentrant=False, preserve_rng_state=False)
        else:
            with fsdp.regather_saved():
                x, kv = layer(lp, x, enc, cfg, positions)
        kvs.append(kv)
    cache = tt._stacked(kvs, (len(kvs),)) if want_cache else None
    return apply_norm(fsdp.gather_group("final_norm", params["final_norm"]),
                      x, cfg), cache


def encdec_loss(params, cfg: ArchConfig, frames: torch.Tensor,
                tokens: torch.Tensor, targets: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """The mean next-token NLL of the decoder over the encoded frames (f32
    ``log_softmax``; vocabulary-parallel where a planned mesh shards the
    head's columns, ``layers.token_nll``), and the reference's metrics
    (``nll``)."""
    params = tt.tie_gathered(params, cfg)
    enc = encode(params, cfg, frames)
    hidden, _ = decoder_forward(params, cfg, tokens, enc, want_cache=False)
    nll = token_nll(logits_from_hidden(params, hidden, cfg,
                                       vocab_shard=True), targets)
    loss = nll.mean()
    return loss, {"nll": loss.detach()}


class EncDecCache(NamedTuple):
    self_kv: attn.KV          # (L, B, S, KV, hd)
    cross_kv: attn.KV         # (L, B, Senc, KV, hd)


def init_encdec_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device="cuda") -> EncDecCache:
    """The decode cache, zeros: the decoder's self-attention K/V of
    ``cache_len`` positions and the cross-attention K/V of
    ``cfg.encoder_seq`` encoder rows."""
    device = cache_device(device)
    hd, kv, L = cfg.head_dim_, cfg.n_kv_heads, cfg.n_layers
    mk = lambda s: attn.KV(
        torch.zeros((L, batch, s, kv, hd), dtype=dtype, device=device),
        torch.zeros((L, batch, s, kv, hd), dtype=dtype, device=device))
    return EncDecCache(self_kv=mk(cache_len), cross_kv=mk(cfg.encoder_seq))


def encdec_prefill(params, cfg: ArchConfig, frames: torch.Tensor,
                   tokens: torch.Tensor
                   ) -> tuple[torch.Tensor, EncDecCache]:
    """Encode, then the teacher-forced pass over the prompt: the last
    position's logits ``(B, vocab)`` and the cache (the self K/V of the
    prompt; the cross K/V of every layer, projected once more from the
    encoder states, as the reference does)."""
    enc = encode(params, cfg, frames)
    hidden, self_kv = decoder_forward(params, cfg, tokens, enc)
    cross = tt._stacked([_cross_kv(lp["cross_attn"], enc, cfg)
                         for lp in tt._slices(params["decoder"], 1)],
                        (cfg.n_layers,))
    logits = logits_from_hidden(params, hidden[:, -1:], cfg)[:, 0]
    return logits, EncDecCache(self_kv=self_kv, cross_kv=cross)


def _cross_decode(p, x: torch.Tensor, ckv: attn.KV,
                  cfg: ArchConfig) -> torch.Tensor:
    """One token's cross-attention over every encoder row of ``ckv``: the
    reference's jnp ``_attend`` with an all-true mask, in plain PyTorch
    (its projections on K1)."""
    b = x.shape[0]
    hd = p["wq"].shape[-1]
    q = attn._proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    kvh = ckv.k.shape[2]
    qg = q.reshape(b, 1, kvh, q.shape[2] // kvh, hd)
    mask = torch.ones((1, 1, 1, 1, ckv.k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = attn._attend(qg, ckv.k, ckv.v, mask, hd ** -0.5)
    return attn._out(p, out, cfg, x.dtype)


def encdec_decode_step(params, cfg: ArchConfig, tokens: torch.Tensor,
                       pos: torch.Tensor, cache: EncDecCache
                       ) -> tuple[torch.Tensor, EncDecCache]:
    """One decoder token.  ``tokens (B,)`` int and ``pos (B,)`` the new
    tokens' absolute positions, both on the device.  Self-attention on
    the contiguous cache (``attention.attention_decode``), cross-attention
    over the cached encoder K/V.  Returns ``(logits (B, vocab), the new
    cache)``; the input cache is not written, and nothing is read back to
    the host."""
    x = embed_tokens(params, tokens[:, None], cfg)
    x = x + sinusoid_positions(pos[:, None], cfg.d_model).to(x.dtype)
    new_self = []
    for lp, skv, ckv in zip(tt._slices(params["decoder"], 1),
                            tt._cache_slices(cache.self_kv, 1),
                            tt._cache_slices(cache.cross_kv, 1)):
        h = apply_norm(lp["ln1"], x, cfg)
        a, skv = attn.attention_decode(lp["self_attn"], h, skv, pos, cfg)
        x = x + a
        x = x + _cross_decode(lp["cross_attn"],
                              apply_norm(lp["ln_x"], x, cfg), ckv, cfg)
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
        new_self.append(skv)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = logits_from_hidden(params, x, cfg)[:, 0]
    return logits, EncDecCache(
        self_kv=tt._stacked(new_self, (len(new_self),)),
        cross_kv=cache.cross_kv)
