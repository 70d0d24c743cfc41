"""Family dispatch: one uniform interface over the model families.

    param_specs(cfg)                 -> SpecTree
    init_params(cfg, generator)      -> params on the generator's device
    forward(cfg, params, tokens)     -> (logits, aux)

Only the ``dense`` family is ported; every other family raises (ROADMAP
item 10).  ``cache_specs`` / ``prefill`` / ``decode_step`` arrive with the
generate path (slice 2b).
"""
from __future__ import annotations

import torch

from repro_torch.common import SpecTree, init_params as _init
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILY = {"dense": transformer}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet (ROADMAP item 10)")
    return _FAMILY[cfg.family]


def param_specs(cfg: ModelConfig) -> SpecTree:
    return module_for(cfg).param_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    return _init(param_specs(cfg), generator)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor):
    return module_for(cfg).forward(params, tokens, cfg=cfg)
