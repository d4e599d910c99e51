"""Assigned-architecture configs (exact published dims) + registry: the
port's own copies of ``repro.configs``."""

from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, get_config, all_configs

from repro_torch.configs.gemma3_1b import GEMMA3_1B
from repro_torch.configs.qwen3_14b import QWEN3_14B
from repro_torch.configs.minicpm3_4b import MINICPM3_4B
from repro_torch.configs.qwen2_1_5b import QWEN2_1_5B
from repro_torch.configs.internvl2_26b import INTERNVL2_26B
from repro_torch.configs.hymba_1_5b import HYMBA_1_5B
from repro_torch.configs.llama4_maverick_400b import LLAMA4_MAVERICK
from repro_torch.configs.deepseek_moe_16b import DEEPSEEK_MOE_16B
from repro_torch.configs.whisper_small import WHISPER_SMALL
from repro_torch.configs.mamba2_370m import MAMBA2_370M

ARCH_IDS = [
    "gemma3-1b", "qwen3-14b", "minicpm3-4b", "qwen2-1.5b", "internvl2-26b",
    "hymba-1.5b", "llama4-maverick-400b-a17b", "deepseek-moe-16b",
    "whisper-small", "mamba2-370m",
]

__all__ = [
    "ArchConfig", "ShapeSpec", "SHAPES", "get_config", "all_configs", "ARCH_IDS",
]
