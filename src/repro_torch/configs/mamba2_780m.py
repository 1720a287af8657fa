"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality), chunked train / recurrent decode.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.common import ArchConfig

ARCH_ID = "mamba2-780m"


def full() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="ssm", attention="none",
        n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=64,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        norm="rmsnorm",
        train_microbatches=4,      # SSD intra-chunk (b,c,h,q,q) working set
    )


def reduced() -> ArchConfig:
    return full().with_(dtype="float32", n_layers=2, d_model=64, vocab_size=512,
                        ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
