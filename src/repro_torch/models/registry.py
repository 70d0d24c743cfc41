"""Family dispatch: one uniform interface over the model families.

    param_specs(cfg)                                  -> SpecTree
    init_params(cfg, generator)                       -> params on the generator's device
    forward(cfg, params, tokens, extra=..., remat=...) -> (logits, aux)
    cache_specs(cfg, batch, max_seq)                  -> SpecTree
    init_cache(cfg, batch, max_seq)                   -> zeroed KV cache
    prefill(cfg, params, tokens, cache, extra=...)    -> (logits, cache)
    decode_step(cfg, params, tokens, cache, cache_len, extra=...) -> (logits, cache)

``extra`` carries a request's other inputs (the VLM's
``{"image_embeds": [B, num_image_tokens, d]}``, whisper's
``{"audio_frames": [B, num_audio_frames, d]}``).  Every family of the
reference is served: ``dense``, ``moe`` and ``vlm`` by
``models/transformer.py``, ``audio`` by ``models/encdec.py``, ``ssm`` by
``models/xlstm_lm.py`` and ``hybrid`` by ``models/hybrid.py``.  Each writes
the cache it is given in place and returns it.  The ``ssm`` and ``hybrid``
caches are recurrent states, which a prefill leaves after its last token:
the engine prefills them at a prompt's true length (``RECURRENT``).
``remat=True`` rematerializes each block in the backward pass when the
config's ``remat`` is set and autograd is recording (the train step's
forward); prefill and decode never do.
"""
from __future__ import annotations

import torch

from repro_torch.common import SpecTree, init_params as _init, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.device import current_device
from repro_torch.models import encdec, hybrid, transformer, xlstm_lm

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "audio": encdec,
    "ssm": xlstm_lm,
    "hybrid": hybrid,
}
# families whose cache is a recurrent state: a pad token would enter it
RECURRENT = frozenset({"ssm", "hybrid"})


def module_for(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def param_specs(cfg: ModelConfig) -> SpecTree:
    return module_for(cfg).param_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    return _init(param_specs(cfg), generator)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *, extra=None, remat=False):
    return module_for(cfg).forward(params, tokens, cfg=cfg, extra=extra, remat=remat)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> SpecTree:
    return module_for(cfg).cache_specs(cfg, batch, max_seq)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device=None) -> dict:
    """A zeroed cache on ``device`` (default ``repro_torch.current_device()``)."""
    device = current_device() if device is None else device
    specs = cache_specs(cfg, batch, max_seq)
    return unflatten({p: torch.zeros(s.shape, dtype=s.dtype, device=device)
                      for p, s in specs.items()})


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache, *, extra=None,
            last_only=False):
    return module_for(cfg).prefill(params, tokens, cache, cfg=cfg, extra=extra,
                                   last_only=last_only)


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, cache_len, *,
                extra=None):
    return module_for(cfg).decode_step(params, tokens, cache, cache_len, cfg=cfg,
                                       extra=extra)
