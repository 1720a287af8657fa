"""Model configurations the port serves (one module per architecture, as
in ``repro.configs``), and the dry-run's cells: ``ARCH_IDS`` in the
reference's order (its ``_MODULES``), ``SUBQUADRATIC``,
``cell_applicable`` and ``all_cells`` over ``SHAPES``."""
from repro_torch.configs import (command_r_plus_104b, deepseek_moe_16b,
                                 gemma_2b, llama4_scout_17b_a16e,
                                 mamba2_780m, minicpm3_4b, paligemma_3b,
                                 recurrentgemma_9b, stablelm_1_6b,
                                 whisper_base)
from repro_torch.configs.common import ArchConfig
from repro_torch.models.common import SHAPES, ShapeConfig  # noqa: F401

ARCHS = {m.ARCH_ID: m for m in (gemma_2b, stablelm_1_6b, command_r_plus_104b,
                                minicpm3_4b, mamba2_780m, recurrentgemma_9b,
                                deepseek_moe_16b, llama4_scout_17b_a16e,
                                paligemma_3b, whisper_base)}


#: the reference's ``_MODULES`` order, which its cells come in
ARCH_IDS = tuple(m.ARCH_ID for m in (
    command_r_plus_104b, minicpm3_4b, gemma_2b, stablelm_1_6b, mamba2_780m,
    llama4_scout_17b_a16e, deepseek_moe_16b, paligemma_3b,
    recurrentgemma_9b, whisper_base))


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{sorted(ARCHS)}")
    m = ARCHS[arch_id]
    return m.reduced() if reduced else m.full()


# (arch, shape) applicability: long_500k requires sub-quadratic attention.
SUBQUADRATIC = {"mamba2-780m", "recurrentgemma-9b", "llama4-scout-17b-a16e"}


def cell_applicable(arch_id: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch_id not in SUBQUADRATIC:
        return False, ("full-attention arch: 512k dense-attention decode is "
                       "skipped per task statement (see DESIGN.md)")
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
