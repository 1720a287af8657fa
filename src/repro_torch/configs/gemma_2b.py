"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000 —
GeGLU, head_dim=256, tied embeddings.  [arXiv:2403.08295; hf]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "gemma-2b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=256000,
        mlp="geglu", norm="rmsnorm", tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
                        head_dim=32, d_ff=256, vocab_size=512)
