"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias, parallel attn+FFN block, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "command-r-plus-104b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=33792, vocab_size=256000,
        mlp="swiglu", norm="layernorm", use_bias=False, parallel_block=True,
        tie_embeddings=True, rope_theta=75_000_000.0,
        attn_chunk_min_seq=4096,   # chunked attention needed to fit train_4k
        train_microbatches=16,     # 104B on 16GiB chips: 4k tokens/device/microbatch
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        head_dim=32, d_ff=256, vocab_size=512)
