"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA
(multi-head latent attention, absorbed decode over the compressed cache).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "minicpm3-4b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", attention="mla",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
        d_ff=6400, vocab_size=73448,
        mlp="swiglu", norm="rmsnorm",
        attn_chunk_min_seq=4096,   # absorbed-MLA chunked attention (+47% frac at train_4k)
        train_microbatches=16,
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=256, vocab_size=512)
