"""Backend adapter: the semantic operators over the port's inference engine.

``EngineModel`` gives an ``InferenceEngine`` the ``GenerativeModel``
protocol (predicate, generate, compare, choose), so an operator such as
``sem_map(records, langex, EngineModel(engine))`` or ``sem_search(...,
n_rerank=..., rerank_model=EngineModel(engine))`` drives the real model.
With random weights the plumbing (prompt construction, log-prob scores,
continuous batching) is that of a trained deployment.  ``make_session``
wires an oracle engine, a proxy engine and the E5 ``Embedder`` into a
SemFrame ``Session``, as the reference's does.
"""
from __future__ import annotations

from repro_torch.configs import ModelConfig, get_smoke
from repro_torch.core.frame import Session
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.embed.encoder import E5_SMALL, Embedder
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


def make_session(oracle_cfg: ModelConfig | None = None,
                 proxy_cfg: ModelConfig | None = None, *,
                 max_seq: int = 512, seed: int = 0, **session_kw) -> Session:
    """Build a Session over the port's models: oracle + proxy engines + the
    encoder embedder, all on ``repro_torch.current_device()``.

    Defaults mirror the paper's pipeline shape at smoke scale: a larger
    oracle (llama-family) and a smaller proxy (the Llama-8B/TinyLlama role).
    """
    oracle_cfg = oracle_cfg or get_smoke("llama3.2-3b").with_(
        vocab_size=TOKENIZER.vocab_size, num_layers=4, d_model=128, d_ff=256)
    proxy_cfg = proxy_cfg or get_smoke("llama3.2-3b").with_(
        vocab_size=TOKENIZER.vocab_size, num_layers=2, d_model=64, d_ff=128)
    oracle = EngineModel(InferenceEngine(oracle_cfg, max_seq=max_seq, seed=seed))
    proxy = EngineModel(InferenceEngine(proxy_cfg, max_seq=max_seq, seed=seed + 1))
    embedder = Embedder(E5_SMALL.with_(num_layers=2, d_model=64, num_heads=4,
                                       num_kv_heads=4, d_ff=128), seed=seed + 2)
    return Session(oracle=oracle, proxy=proxy, embedder=embedder, **session_kw)
