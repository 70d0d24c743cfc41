"""Architecture registry: the 10 assigned configs (data-only copies of
``repro.configs``).

Every module exports CONFIG (full size) and smoke() (a reduced config of the
same family that runs on the CPU); every family runs in the port
(``models.registry``).
"""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell, cell_applicable, input_specs

from repro_torch.configs import (  # noqa: E402
    llama_3_2_vision_11b,
    mixtral_8x22b,
    llama4_maverick_400b_a17b,
    qwen1_5_4b,
    llama3_2_3b,
    deepseek_7b,
    qwen2_72b,
    xlstm_125m,
    zamba2_7b,
    whisper_small,
)

_MODULES = {
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "mixtral-8x22b": mixtral_8x22b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "qwen1.5-4b": qwen1_5_4b,
    "llama3.2-3b": llama3_2_3b,
    "deepseek-7b": deepseek_7b,
    "qwen2-72b": qwen2_72b,
    "xlstm-125m": xlstm_125m,
    "zamba2-7b": zamba2_7b,
    "whisper-small": whisper_small,
}

ARCHS: dict[str, ModelConfig] = {name: m.CONFIG for name, m in _MODULES.items()}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].smoke()


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeCell", "get_config", "get_smoke",
           "cell_applicable", "input_specs"]
