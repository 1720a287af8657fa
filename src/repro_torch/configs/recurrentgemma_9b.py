"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, pattern (rglru, rglru, local) with a
2-layer recurrent tail (38 = 12x3 + 2); window 2048.  [arXiv:2402.19427;
unverified]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "recurrentgemma-9b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000,
        layer_pattern=("rglru", "rglru", "local"), local_window=2048,
        lru_width=4096, conv_width=4,
        mlp="geglu", norm="rmsnorm", tie_embeddings=True,
        train_microbatches=4,
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=5, d_model=128, n_heads=4, n_kv_heads=1,
                        head_dim=32, d_ff=256, vocab_size=512,
                        local_window=8, lru_width=128)
