"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared — chunked local attention
(3 local : 1 full, iRoPE-style) makes the 500k cell sub-quadratic.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "llama4-scout-17b-a16e"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        moe=True, n_experts=16, n_shared_experts=1, top_k=1, moe_d_ff=8192,
        layer_pattern=("local", "local", "local", "full"), local_window=8192,
        mlp="swiglu", norm="rmsnorm",
        train_microbatches=16,
        attn_chunk_min_seq=4096,   # 40-head 4k scores don't fit otherwise
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=32, d_ff=128, moe_d_ff=128, vocab_size=512,
                        n_experts=4, local_window=8)
