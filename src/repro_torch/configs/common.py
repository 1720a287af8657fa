"""The model-configuration schema: a torch-free copy of the reference's
``ArchConfig`` (``repro.models.common``), field for field, so one config
describes the same model to both packages."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | ssm | moe | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention flavor
    attention: str = "full"          # full | mla | none (ssm)
    local_window: int = 0            # >0 enables windowed attention layers
    layer_pattern: tuple[str, ...] = ()
    rope_theta: float = 10000.0
    rope_pct: float = 1.0            # partial rotary (stablelm: 0.25)

    # MLP
    mlp: str = "swiglu"              # swiglu | geglu | gelu
    use_bias: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    parallel_block: bool = False     # attn+mlp in parallel (command-r style)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba-2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (hybrid)
    lru_width: int = 0               # 0 -> d_model

    # encoder-decoder (audio) / VLM stub frontends
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_patches: int = 0

    train_microbatches: int = 0
    dtype: Any = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    scan_unroll: bool = False
    attn_chunk_min_seq: int = 8192
    attn_chunk: int = 1024
    attn_q_chunk: int = 0
    attn_sharding: str = "sp"
    attn_impl: str = "xla"           # the port always runs its flash kernel

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts, analytic."""
        d, v, hd = self.d_model, self.vocab_size, self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.attention == "mla":
            att = (d * 768 + 768 * self.n_heads * 96
                   + d * (256 + 32) + 256 * self.n_heads * (64 + 64)
                   + self.n_heads * 64 * d)
        mlp_mult = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.mlp]
        dense_mlp = mlp_mult * d * self.d_ff
        total = emb
        active = emb
        n_att_layers = self.n_layers
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            n_h = d_in // self.ssm_head_dim
            per = (d * (2 * d_in + 2 * self.ssm_state * 1 + n_h)
                   + d_in * d)
            total += self.n_layers * per
            active = total
            return int(total), int(active)
        if self.layer_pattern:
            n_rec = sum(1 for p in self.layer_pattern if p == "rglru")
            frac_rec = n_rec / len(self.layer_pattern)
            lw = self.lru_width or d
            rec_per = 2 * d * lw + lw * d + 2 * lw
            total += int(self.n_layers * frac_rec) * (rec_per + dense_mlp)
            n_att_layers = self.n_layers - int(self.n_layers * frac_rec)
        if self.moe:
            moe_layers = self.n_layers - self.first_dense_layers
            expert_mlp = mlp_mult * d * self.moe_ff
            shared = self.n_shared_experts * expert_mlp
            router = d * self.n_experts
            total += moe_layers * (att + self.n_experts * expert_mlp + shared + router)
            total += self.first_dense_layers * (att + dense_mlp)
            active += moe_layers * (att + self.top_k * expert_mlp + shared + router)
            active += self.first_dense_layers * (att + dense_mlp)
            return int(total), int(active)
        total += n_att_layers * (att + dense_mlp)
        if self.encoder_layers:
            total += self.encoder_layers * (att + dense_mlp) \
                + self.n_layers * (d * 2 * (self.n_kv_heads * hd) + 0)
        active = total
        return int(total), int(active)
