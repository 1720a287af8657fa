"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216
— the SigLIP frontend is a stub (256 precomputed patch embeddings through
a (d, d) adapter); gemma backbone with prefix-LM attention over the
patches.  [arXiv:2407.07726; hf]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "paligemma-3b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=257216,
        mlp="geglu", norm="rmsnorm", tie_embeddings=True, num_patches=256,
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
                        head_dim=32, d_ff=256, vocab_size=512, num_patches=8)
