"""``sem_filter_gold(records, langex, EngineModel(InferenceEngine(cfg,
max_seq)))`` over successive slices of the table.

The check judges each sampled row's answer, its verdict and its score
p(<true> | {<true>, <false>}), as one signed log-odds: the score's
log-odds, with the sign the verdict gives it (a verdict that contradicts
its score turns it over).  Against the reference's logit(<true>) -
logit(<false>) at the row's last token:
  answer_gap   the widest gap over the sampled rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench.lib import check, traffic
from bench.lib.adapter import Base


def logodds(score: float) -> float:
    if not 0.0 < score < 1.0:
        return math.copysign(math.inf, score - 0.5) if math.isfinite(score) else math.nan
    return math.log(score) - math.log1p(-score)


def answer_gap(ref_lo: np.ndarray, prog_lo: np.ndarray, verdicts: np.ndarray) -> float:
    """The widest |signed answer - reference log-odds| over the rows."""
    if not len(ref_lo):
        return math.inf
    signed = np.where(verdicts, 1.0, -1.0) * np.abs(prog_lo)
    gap = np.abs(signed - ref_lo)
    return float(np.max(np.where(np.isfinite(gap), gap, math.inf)))


class Adapter(Base):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        from repro_torch.core.backends.torch_engine import EngineModel
        from repro_torch.engine.engine import InferenceEngine
        self.engine = InferenceEngine(self.cfg, self.params, max_seq=self.mix["engine"]["max_seq"])
        self.model = EngineModel(self.engine)
        runner = self.engine.runner
        runner.logprobs = self.spans.wrap(
            "logprobs", runner.logprobs,
            attrs=lambda args, kw: {"rows": int(args[0].shape[0]), "width": int(args[0].shape[1])})
        self._scores: list[np.ndarray] = []
        predicate = self.model.predicate

        def keep_scores(prompts):
            passed, score = predicate(prompts)
            self._scores.append(np.asarray(score, np.float64))
            return passed, score
        self.model.predicate = keep_scores

    def call(self, rows: list[dict]) -> None:
        from repro_torch.core.operators.filter import sem_filter_gold
        self._scores.clear()
        mask, _ = self.op_span(
            "sem_filter_gold",
            lambda: sem_filter_gold([self.fields(r) for r in rows], self.mix["langex"],
                                    self.model), rows)
        scores = np.concatenate(self._scores) if self._scores else np.zeros(0)
        self.calls.append({"ids": [r["id"] for r in rows], "tokens": [r["tokens"] for r in rows],
                           "verdict": np.asarray(mask, bool), "score": scores})

    # -- what the window did ---------------------------------------------
    def batches(self) -> list[list[int]]:
        """Real token counts of each scored batch (the engine scores each
        call's rows in order, ``engine.batch`` rows at a time)."""
        bs = int(self.mix["engine"]["batch"])
        return [c["tokens"][i:i + bs] for c in self.calls for i in range(0, len(c["tokens"]), bs)]

    def end_to_end(self, window_s: float) -> dict:
        return {"filter_rows_per_s": sum(len(c["ids"]) for c in self.calls) / window_s}

    def answers(self) -> dict[int, tuple[bool | None, float, int]]:
        """row id -> (verdict, score, padded width of its batch)."""
        bs = int(self.mix["engine"]["batch"])
        out = {}
        for c in self.calls:
            for i, rid in enumerate(c["ids"]):
                chunk = c["tokens"][(i // bs) * bs:(i // bs + 1) * bs]
                score = float(c["score"][i]) if i < len(c["score"]) else math.nan
                verdict = bool(c["verdict"][i]) if i < len(c["verdict"]) else None
                out[rid] = (verdict, score, max(16, max(chunk)))
        return out

    def attempted_failed(self) -> tuple[int, int]:
        ans = self.answers()
        return len(ans), sum(1 for v, s, _ in ans.values() if v is None or not np.isfinite(s))

    # -- the check -------------------------------------------------------
    def _ref_logodds(self, precision: str) -> np.ndarray:
        ref = self.fam.reference.Reference(self.weights, self.arch, precision=precision)
        dev = self.weights["embedding"].device
        t, f = self.mix["labels"]["true"], self.mix["labels"]["false"]
        seqs = [torch.tensor(traffic.prompt_ids(self.mix, r), device=dev) for r in self._rows]
        pos = [torch.tensor([len(s) - 1], device=dev) for s in seqs]
        out = ref.logits(seqs, pos, cap_lens=self._caps)
        return np.array([float(o[0, t] - o[0, f]) for o in out])

    def check(self, table: list[dict], seed: int) -> dict:
        ans = self.answers()
        ids = sorted(ans)
        self._rows, self._caps, self._ref_lo = [], None, np.zeros(0)
        if not ids:
            return {"answer_gap": math.inf}
        by_id = {r["id"]: r for r in table}
        longest = max(ids, key=lambda i: (by_id[i]["tokens"], -i))
        pick = check.sample(ids, int(self.mix["check"]["rows"]), seed, longest)
        self._rows = [by_id[i] for i in pick]
        self._caps = [ans[i][2] for i in pick] if self.arch.is_moe else None
        self._ref_lo = self._ref_logodds("f32")
        prog = np.array([logodds(ans[i][1]) for i in pick])
        verdicts = np.array([bool(ans[i][0]) for i in pick])   # a missing verdict reads False
        return {"answer_gap": answer_gap(self._ref_lo, prog, verdicts)}

    def control(self) -> dict:
        lo8 = self._ref_logodds("fp8")
        return {"answer_gap": answer_gap(self._ref_lo, lo8, lo8 > 0)}


def plant_fault():
    """The labels swapped where the engine scores them."""
    from repro_torch.engine.engine import InferenceEngine
    orig = InferenceEngine.predicate

    def altered(self, prompts):
        passed, score = orig(self, prompts)
        return ~passed, (1.0 - score).astype(score.dtype)
    InferenceEngine.predicate = altered
    return lambda: setattr(InferenceEngine, "predicate", orig)
