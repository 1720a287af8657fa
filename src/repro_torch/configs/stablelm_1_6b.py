"""stablelm-1.6b [dense]: 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352 — LayerNorm + qkv biases, partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "stablelm-1.6b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=5632, vocab_size=100352,
        mlp="swiglu", norm="layernorm", use_bias=True, rope_pct=0.25,
        attn_sharding="heads",     # kv=32 divides the 16-way model axis
        train_microbatches=2,
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        head_dim=32, d_ff=256, vocab_size=512)
