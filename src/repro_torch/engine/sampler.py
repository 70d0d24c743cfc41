"""Token samplers over final-position logits (numpy-side, per-slot).

A copy of the reference's: the same logits and seed draw the same tokens
in both packages (``np.random.default_rng``)."""
from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, temperature: float = 0.0, top_k: int = 0, seed: int = 0):
        self.temperature = temperature
        self.top_k = top_k
        self.rng = np.random.default_rng(seed)

    def __call__(self, logits: np.ndarray) -> np.ndarray:
        """logits: [B, V] -> token ids [B]."""
        if self.temperature <= 0.0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits / self.temperature
        if self.top_k:
            kth = np.partition(z, -self.top_k, axis=-1)[:, -self.top_k][:, None]
            z = np.where(z < kth, -np.inf, z)
        z = z - z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        return np.array([self.rng.choice(len(row), p=row) for row in p], np.int32)


def logprobs_of(logits: np.ndarray, token_ids) -> np.ndarray:
    """Log-softmax of ``logits`` ([..., V]) gathered at ``token_ids``."""
    z = logits - logits.max(axis=-1, keepdims=True)
    lse = np.log(np.exp(z).sum(axis=-1, keepdims=True))
    logp = z - lse
    return logp[..., token_ids]
