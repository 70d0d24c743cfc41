"""InferenceEngine: the facade over the model that the semantic operators
consume, through ``core.backends.torch_engine.EngineModel``.

Four primitives, as the reference's:

  generate(prompts)          -> free-text generations            (sem_map/agg)
  predicate(prompts)         -> bool + True-vs-False probability (sem_filter/join;
                                the probability is the cascade proxy score)
  compare(prompts)           -> A/B choice                       (sem_topk)
  choose(prompts, n_opts)    -> argmax over the option digit ids (sem_group_by)

Predicate/compare/choose need one output token, so they are served by one
teacher-forced forward pass over a padded batch; generate() runs through
the continuous-batching scheduler.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common import tree_to
from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.device import current_device
from repro_torch.engine.runner import ModelRunner
from repro_torch.engine.sampler import Sampler
from repro_torch.engine.scheduler import ContinuousBatchScheduler, Request
from repro_torch.models import registry


@dataclasses.dataclass
class EngineStats:
    lm_calls: int = 0
    generated_tokens: int = 0
    prompt_tokens: int = 0

    def add(self, calls: int, prompt: int, gen: int) -> None:
        self.lm_calls += calls
        self.prompt_tokens += prompt
        self.generated_tokens += gen


class InferenceEngine:
    """``params`` (a nested dict of tensors, e.g. from
    ``common.params_from_numpy``) are moved to ``repro_torch.current_device()``;
    without them, random weights are drawn there from ``seed``."""

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 0,
                 max_slots: int = 8, max_seq: int = 512, temperature: float = 0.0):
        self.cfg = cfg
        device = current_device()
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = registry.init_params(cfg, gen)
        else:
            params = tree_to(params, device)
        self.runner = ModelRunner(cfg, params, max_slots=max_slots, max_seq=max_seq)
        self.sampler = Sampler(temperature=temperature, seed=seed)
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    def generate(self, prompts: list[str], *, max_new_tokens: int = 48,
                 fault_hook=None) -> list[str]:
        sched = ContinuousBatchScheduler(self.runner, sampler=self.sampler,
                                         fault_hook=fault_hook)
        for i, p in enumerate(prompts):
            toks = np.asarray(TOKENIZER.encode(p)[: self.runner.max_seq - max_new_tokens - 1],
                              np.int32)
            sched.submit(Request(rid=i, tokens=toks, max_new_tokens=max_new_tokens,
                                 stop_id=TOKENIZER.eos_id))
        done = sched.run_to_completion()
        self.stats.add(len(prompts), sum(len(r.tokens) for r in done),
                       sum(len(r.out_tokens) for r in done))
        by_id = {r.rid: r for r in done}
        return [TOKENIZER.decode([t for t in by_id[i].out_tokens if t != TOKENIZER.eos_id])
                if i in by_id and not by_id[i].failed else ""
                for i in range(len(prompts))]

    # ------------------------------------------------------------------
    def _last_logits(self, prompts: list[str]) -> np.ndarray:
        """One forward pass; per-row logits at the last real token. [B, V]."""
        seqs = [TOKENIZER.encode(p)[: self.runner.max_seq] for p in prompts]
        out = []
        bs = 32
        for i in range(0, len(seqs), bs):
            chunk = seqs[i:i + bs]
            width = max(16, max(len(s) for s in chunk))
            toks = TOKENIZER.pad_batch(chunk, width)
            lp = self.runner.logprobs(toks)  # [b, T, V] log-softmax
            idx = np.asarray([min(len(s), width) - 1 for s in chunk])
            out.append(lp[np.arange(len(chunk)), idx])
            self.stats.add(len(chunk), sum(len(s) for s in chunk), len(chunk))
        return np.concatenate(out, axis=0)

    def predicate(self, prompts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Returns (passes [B] bool, score [B]: p(True | {True,False}))."""
        if not prompts:
            return np.zeros(0, bool), np.zeros(0, np.float32)
        logp = self._last_logits(prompts)
        lt, lf = logp[:, TOKENIZER.true_id], logp[:, TOKENIZER.false_id]
        score = 1.0 / (1.0 + np.exp(-(lt - lf)))  # calibrated True-vs-False prob
        return lt > lf, score.astype(np.float32)

    def compare(self, prompts: list[str]) -> np.ndarray:
        """Returns [B] bool: True if option A preferred over option B."""
        if not prompts:
            return np.zeros(0, bool)
        logp = self._last_logits(prompts)
        return logp[:, TOKENIZER.a_id] > logp[:, TOKENIZER.b_id]

    def choose(self, prompts: list[str], n_options: int) -> np.ndarray:
        """Returns [B] int in [0, n_options): argmax over the option labels.

        Options map to their single-token digit ids ("0", "1", ...); beyond
        10 options the leading digit is shared, so ties collapse to the
        first option of each decade, as in the reference."""
        logp = self._last_logits(prompts)
        option_token_ids = [TOKENIZER.encode(str(min(i, 9)), bos=False)[0]
                            for i in range(n_options)]
        return np.argmax(logp[:, option_token_ids], axis=-1)
