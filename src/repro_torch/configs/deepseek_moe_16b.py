"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) expert d_ff=1408
vocab=102400 — 2 shared + 64 routed top-6 fine-grained experts, first layer
dense.  [arXiv:2401.06066; hf]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "deepseek-moe-16b"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=11264,                      # dense first layer (~(6+2)x1408)
        vocab_size=102400,
        moe=True, n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
        first_dense_layers=1,
        mlp="swiglu", norm="rmsnorm",
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
                        head_dim=32, d_ff=256, moe_d_ff=64, vocab_size=512,
                        n_experts=8, top_k=2, n_shared_experts=1)
