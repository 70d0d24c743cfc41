"""Backend adapter: the semantic operators over the port's inference engine.

``EngineModel`` gives an ``InferenceEngine`` the ``GenerativeModel``
protocol (predicate, generate, compare, choose), so an operator such as
``sem_map(records, langex, EngineModel(engine))`` or ``sem_search(...,
n_rerank=..., rerank_model=EngineModel(engine))`` drives the real model.
With random weights the plumbing (prompt construction, log-prob scores,
continuous batching) is that of a trained deployment.  ``make_session``
arrives with the plan layer's ``Session``.
"""
from __future__ import annotations

from repro_torch.engine.engine import InferenceEngine


class EngineModel:
    """GenerativeModel protocol over an InferenceEngine."""

    def __init__(self, engine: InferenceEngine, *, max_new_tokens: int = 24):
        self.engine = engine
        self.max_new_tokens = max_new_tokens

    def predicate(self, prompts):
        return self.engine.predicate(list(prompts))

    def generate(self, prompts):
        return self.engine.generate(list(prompts), max_new_tokens=self.max_new_tokens)

    def compare(self, prompts):
        return self.engine.compare(list(prompts))

    def choose(self, prompts, n_options):
        return self.engine.choose(list(prompts), n_options)
