"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — encoder-decoder; the conv frontend is a stub (1500
precomputed frame embeddings through a (d, d) adapter).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "whisper-base"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="audio",
        n_layers=6, encoder_layers=6, encoder_seq=1500,
        d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=51865,
        mlp="gelu", norm="layernorm", use_bias=True, tie_embeddings=True,
        rope_pct=0.0,                       # sinusoidal positions, no rope
        train_microbatches=4,
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=2, encoder_layers=2, encoder_seq=16,
                        d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                        d_ff=256, vocab_size=512)
