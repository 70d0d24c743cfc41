"""sem_filter (§2.3, §3.1).

Gold algorithm: one oracle predicate call per tuple (batched row-wise pass —
avoids long-context degradation by never packing multiple tuples per prompt).

Optimized: Algorithm 1 proxy-oracle cascade with (gamma_R, gamma_P, delta)
guarantees.  The proxy is either a cheaper LLM's True-token probability
(paper's Llama-8B / TinyLlama setting) or an embedding-similarity scorer.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import accounting
from repro_torch.core.langex import as_langex
from repro_torch.core.optimizer import cascades
from repro_torch.obs import audit as _audit

PREDICATE_INSTRUCTION = (
    "Claim: {claim}\nIs the claim true for this input? Answer <true> or <false>.\nAnswer:")


def predicate_prompt(langex, tup, right=None) -> str:
    return PREDICATE_INSTRUCTION.format(claim=as_langex(langex).render(tup, right))


def sem_filter_gold(records: list[dict], langex, oracle) -> tuple[np.ndarray, dict]:
    """Returns (mask [N] bool, stats)."""
    lx = as_langex(langex)
    with accounting.track("sem_filter_gold") as st:
        prompts = [predicate_prompt(lx, t) for t in records]
        passed, _ = oracle.predicate(prompts)
        return np.asarray(passed, bool), st.as_dict()


def sem_filter_cascade(records: list[dict], langex, oracle, proxy, *,
                       recall_target: float = 0.9, precision_target: float = 0.9,
                       delta: float = 0.2, sample_size: int = 100, seed: int = 0
                       ) -> tuple[np.ndarray, dict]:
    """Algorithm 1. Proxy scores all tuples; oracle labels the sample plus the
    undecided mid-region."""
    lx = as_langex(langex)
    with accounting.track("sem_filter") as st:
        prompts = [predicate_prompt(lx, t) for t in records]
        _, scores = proxy.predicate(prompts)

        def oracle_fn(indices):
            passed, _ = oracle.predicate([prompts[i] for i in indices])
            return passed

        res = cascades.run_cascade(
            np.asarray(scores, float), oracle_fn,
            recall_target=recall_target, precision_target=precision_target,
            delta=delta, sample_size=sample_size, seed=seed)
        _audit.emit_cascade("Filter", lx.template, res,
                            lambda idx: [prompts[i] for i in idx],
                            recall_target=recall_target,
                            precision_target=precision_target)
        st.details.update(tau_plus=res.tau_plus, tau_minus=res.tau_minus,
                          oracle_calls_cascade=res.oracle_calls,
                          auto_accepted=res.auto_accepted,
                          auto_rejected=res.auto_rejected,
                          oracle_region=res.oracle_region)
        return res.passed, st.as_dict()
