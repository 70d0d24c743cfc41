"""Model-backend protocol consumed by the semantic operators.

The paper's world model M (oracle), proxy A, and embedder are all expressed
through this interface; the inference engine (``engine/``, a later slice of
the port) provides the real-model
implementation and `simulated.SimulatedBackend` the ground-truth-plus-noise
implementation used to validate the statistical machinery.
"""
from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np

from repro_torch.core import accounting


class PredicateModel(Protocol):
    def predicate(self, prompts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (bool [n], score [n] in [0,1]: P(True))."""


class GenerativeModel(PredicateModel, Protocol):
    def generate(self, prompts: Sequence[str]) -> list[str]: ...
    def compare(self, prompts: Sequence[str]) -> np.ndarray:
        """-> bool [n]: option A preferred."""
    def choose(self, prompts: Sequence[str], n_options: int) -> np.ndarray:
        """-> int [n] in [0, n_options)."""


class EmbeddingModel(Protocol):
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """-> unit vectors [n, d]."""


# ---------------------------------------------------------------------------
# Accounting wrappers — every operator talks to models through these.
# ---------------------------------------------------------------------------


class CountedModel:
    """Wraps a model, attributing calls to the active operator's OpStats.

    Every call kind is attributed to the wrapping role (oracle/proxy) so
    role-level counts cover generative ops too; generate/compare additionally
    keep their per-kind breakdown columns."""

    def __init__(self, model, role: str):
        assert role in ("oracle", "proxy", "audit")
        self._m = model
        self.role = role

    def predicate(self, prompts):
        accounting.record(self.role, len(prompts))
        return self._m.predicate(prompts)

    def generate(self, prompts):
        accounting.record(self.role, len(prompts))
        accounting.record("generate", len(prompts))
        return self._m.generate(prompts)

    def compare(self, prompts):
        accounting.record(self.role, len(prompts))
        accounting.record("compare", len(prompts))
        return self._m.compare(prompts)

    def choose(self, prompts, n_options):
        accounting.record(self.role, len(prompts))
        return self._m.choose(prompts, n_options)


class CountedEmbedder:
    def __init__(self, embedder):
        self._e = embedder

    @property
    def dim(self):
        return self._e.dim

    @property
    def index_key(self):
        """Identity of the backend model (index-registry sharing key)."""
        from repro_torch.index.backend import embedder_key
        return embedder_key(self._e)

    def embed(self, texts):
        accounting.record("embed", len(texts))
        return self._e.embed(texts)
