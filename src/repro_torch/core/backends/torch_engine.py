"""Backend adapter: the semantic operators over the port's inference engine.

``EngineModel`` gives an ``InferenceEngine`` the ``GenerativeModel``
protocol's scoring methods (predicate, compare, choose), so an operator
such as ``sem_search(..., n_rerank=..., rerank_model=EngineModel(engine))``
drives the real model.  With random weights the plumbing (prompt
construction, log-prob scores, batched inference) is that of a trained
deployment.  ``generate`` arrives with the generate path (slice 2b), and
``make_session`` with the plan layer's ``Session``.
"""
from __future__ import annotations

from repro_torch.engine.engine import InferenceEngine


class EngineModel:
    """The scoring half of the GenerativeModel protocol over an InferenceEngine."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine

    def predicate(self, prompts):
        return self.engine.predicate(list(prompts))

    def compare(self, prompts):
        return self.engine.compare(list(prompts))

    def choose(self, prompts, n_options):
        return self.engine.choose(list(prompts), n_options)
