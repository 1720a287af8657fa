"""Model configurations the port serves (one module per architecture, as
in ``repro.configs``)."""
from repro_torch.configs import (command_r_plus_104b, deepseek_moe_16b,
                                 gemma_2b, llama4_scout_17b_a16e,
                                 mamba2_780m, minicpm3_4b, paligemma_3b,
                                 recurrentgemma_9b, stablelm_1_6b,
                                 whisper_base)
from repro_torch.configs.common import ArchConfig

ARCHS = {m.ARCH_ID: m for m in (gemma_2b, stablelm_1_6b, command_r_plus_104b,
                                minicpm3_4b, mamba2_780m, recurrentgemma_9b,
                                deepseek_moe_16b, llama4_scout_17b_a16e,
                                paligemma_3b, whisper_base)}


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{sorted(ARCHS)}")
    m = ARCHS[arch_id]
    return m.reduced() if reduced else m.full()
