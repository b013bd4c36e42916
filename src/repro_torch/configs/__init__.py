"""Config registry: ``get_config(name)`` (``repro.configs``).

``ASSIGNED``, ``PAPER_MODELS`` and ``REGISTRY`` copy the reference's
(``configs/archs.py:29-47``): the dense and MoE configs, sliding-window
``gemma2-2b``, Mamba-1 ``falcon-mamba-7b``, hybrid ``zamba2-2.7b``, the
encoder-decoder ``whisper-tiny`` and the vision-patch ``pixtral-12b``.
"""

from typing import Dict

from repro_torch.configs.base import (
    LONG_CONTEXT_ARCHS,
    SHAPES,
    InputShape,
    ModelConfig,
    cache_specs,
    empty_inputs,
    input_specs,
    shape_supported,
)
from repro_torch.configs.dsv2 import CONFIG as DSV2
from repro_torch.configs.dsv2_lite import CONFIG as DSV2_LITE
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.gemma2_2b import CONFIG as GEMMA2_2B
from repro_torch.configs.gemma_7b import CONFIG as GEMMA_7B
from repro_torch.configs.phi3_5_moe_42b import CONFIG as PHI35_MOE_42B
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI_38B
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A27B
from repro_torch.configs.scaled_ds_1 import CONFIG as SCALED_DS_1
from repro_torch.configs.scaled_ds_2 import CONFIG as SCALED_DS_2
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.yi_34b import CONFIG as YI_34B
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_27B

ASSIGNED: Dict[str, ModelConfig] = {
    c.name: c
    for c in (GEMMA_7B, YI_34B, PIXTRAL_12B, FALCON_MAMBA_7B, GEMMA2_2B, PHI4_MINI_38B, QWEN2_MOE_A27B,
              ZAMBA2_27B, WHISPER_TINY, PHI35_MOE_42B)
}

PAPER_MODELS: Dict[str, ModelConfig] = {
    c.name: c for c in (DSV2_LITE, DSV2, SCALED_DS_1, SCALED_DS_2)
}

REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return REGISTRY[name[: -len("-reduced")]].reduced()
    return REGISTRY[name]


__all__ = [
    "ASSIGNED",
    "InputShape",
    "LONG_CONTEXT_ARCHS",
    "PAPER_MODELS",
    "REGISTRY",
    "SHAPES",
    "ModelConfig",
    "cache_specs",
    "empty_inputs",
    "get_config",
    "input_specs",
    "shape_supported",
]
