"""The model runner of the inference engine: one forward pass per scoring
batch.

The reference's ``ModelRunner`` also owns a KV cache and jitted prefill /
decode steps for generation; those arrive with the generate path (slice
2b), so this runner allocates no cache.  PyTorch runs eagerly, so there is
nothing to compile.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry


class ModelRunner:
    """Owns the params of one model; scores whole token sequences."""

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.device = params["embed"]["embedding"].device

    @torch.inference_mode()
    def logprobs(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: [B,T] -> log-probs [B,T,V] (teacher-forced), f32."""
        t = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        logits, _ = registry.forward(self.cfg, self.params, t)
        return torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
