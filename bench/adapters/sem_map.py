"""``sem_map(records, langex, EngineModel(InferenceEngine(cfg, max_slots,
max_seq), max_new_tokens))`` over successive slices of the table.

Each request's tokens come from the scheduler's finished requests (the
return value of ``run_to_completion``); their times from the model-step
calls: a request's first token is its prefill's, its j-th the (j-1)-th
decode step after that prefill, where the slot's length is prompt + j - 2
(checked).

The check teacher-forces each sampled request's served tokens through the
reference over its prompt:
  served_gap   the widest gap by which a served token's reference logit
               lies below the reference's best at its position (greedy);
  logit_gap    for the requests whose step logits were kept
               (``check.held`` of the first call's rows), the widest
               |program logit - reference logit| over the vocabulary at
               each served position.
The control, at each position of the same prompts and tokens, takes the
token the float8 reference puts first, and its logits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench.lib import check, traffic
from bench.lib.adapter import Base


def served_gap(ref_logits: torch.Tensor, tokens: list[int]) -> float:
    """Widest ``max(ref) - ref[token]`` over the positions ([n, V] logits)."""
    tok = torch.tensor(tokens, device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    return float((best - ref_logits.gather(1, tok[:, None])[:, 0]).max())


def _key(mix, row) -> bytes:
    return np.asarray(traffic.prompt_ids(mix, row), np.int64).tobytes()


class Adapter(Base):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        from repro_torch.core.backends.torch_engine import EngineModel
        from repro_torch.engine import scheduler as sched_mod
        from repro_torch.engine.engine import InferenceEngine
        eng = self.mix["engine"]
        self.engine = InferenceEngine(self.cfg, self.params, max_slots=eng["max_slots"],
                                      max_seq=eng["max_seq"])
        self.model = EngineModel(self.engine, max_new_tokens=int(self.mix["max_new_tokens"]))
        self.captured: dict[bytes, list[np.ndarray]] = {}   # held prompts' step logits
        self._slot_capture: dict[int, list] = {}
        self._finished: list = []
        self._reqs: list[dict] | None = None
        runner = self.engine.runner

        def pre_attrs(args, kw):
            tokens, slot = args[0], int(args[1])
            key = np.asarray(tokens, np.int64).tobytes()
            cap = self.captured.get(key)
            if cap is not None:
                self._slot_capture[slot] = cap
            else:
                self._slot_capture.pop(slot, None)
            return {"slot": slot, "len": int(len(tokens)), "key": key}

        def pre_result(span, logits):
            cap = self._slot_capture.get(span["slot"])
            if cap is not None:
                cap.append(np.array(logits, np.float32))

        def dec_result(span, logits):
            limit = int(self.mix["max_new_tokens"])
            for slot, cap in self._slot_capture.items():
                if len(cap) < limit:
                    cap.append(np.array(logits[slot], np.float32))

        runner.prefill_into_slot = self.spans.wrap("prefill", runner.prefill_into_slot,
                                                   attrs=pre_attrs, result=pre_result)
        runner.decode = self.spans.wrap(
            "decode", runner.decode, attrs=lambda args, kw: {"lens": np.array(args[1], np.int64)},
            result=dec_result)
        cls = sched_mod.ContinuousBatchScheduler
        self._cls, self._orig_run = cls, cls.run_to_completion
        orig, finished = self._orig_run, self._finished

        def run_to_completion(sched, *args, **kwargs):
            done = orig(sched, *args, **kwargs)
            finished.extend(done)
            return done
        cls.run_to_completion = run_to_completion

    def capture(self, rows: list[dict]) -> None:
        """Keep the step logits of these rows' requests (the check's held sample)."""
        for r in rows:
            self.captured[_key(self.mix, r)] = []

    def call(self, rows: list[dict]) -> None:
        from repro_torch.core.operators.mapex import sem_map
        self._finished.clear()
        self._reqs = None
        first = len(self.spans.items)
        self.op_span("sem_map", lambda: sem_map([self.fields(r) for r in rows],
                                                self.mix["langex"], self.model), rows)
        self.calls.append({"rows": rows, "requests": list(self._finished), "first_span": first,
                           "last_span": len(self.spans.items)})

    def release(self) -> None:
        self._cls.run_to_completion = self._orig_run
        super().release()

    # -- what the window did ---------------------------------------------
    def requests(self) -> list[dict]:
        """One entry per request of the window: its row, prompt length,
        served tokens, failed flag, slot, the times of its tokens and the
        context (slot length) of each decode step that made one."""
        if self._reqs is None:
            self._reqs = self._attribute()
        return self._reqs

    def _attribute(self) -> list[dict]:
        out = []
        for c in self.calls:
            spans = self.spans.items[c["first_span"]:c["last_span"]]
            dec = [i for i, s in enumerate(spans) if s["name"] == "decode"]
            by_key = {s["key"]: i for i, s in enumerate(spans) if s["name"] == "prefill"}
            for r in c["requests"]:
                toks = [int(t) for t in r.out_tokens]
                entry = {"row": c["rows"][r.rid], "prompt": int(len(r.tokens)), "tokens": toks,
                         "failed": bool(r.failed), "times": [], "slot": None, "contexts": []}
                out.append(entry)
                if r.failed or not toks:
                    continue
                i = by_key.get(np.asarray(r.tokens, np.int64).tobytes())
                if i is None:
                    raise RuntimeError(f"request {r.rid}: no prefill of its prompt was seen")
                slot = entry["slot"] = spans[i]["slot"]
                entry["times"].append(spans[i]["t1"])
                after = [j for j in dec if j > i][: len(toks) - 1]
                if len(after) < len(toks) - 1:
                    raise RuntimeError(f"request {r.rid}: {len(toks)} tokens, "
                                       f"{len(after) + 1} steps after its prefill")
                for j, di in enumerate(after):
                    want = entry["prompt"] + j
                    got = int(spans[di]["lens"][slot])
                    if got != want:
                        raise RuntimeError(f"request {r.rid}: decode step {j + 1} saw slot "
                                           f"{slot} at length {got}, expected {want}")
                    entry["times"].append(spans[di]["t1"])
                    entry["contexts"].append(want)
        return out

    def decode_rows(self) -> list[list[int]]:
        """For each decode step of the window, the contexts of the rows it
        advanced (inactive slots left out)."""
        steps: dict[float, list[int]] = {}
        for r in self.requests():
            for t, ctx in zip(r["times"][1:], r["contexts"]):
                steps.setdefault(t, []).append(ctx)
        return [steps.get(s["t1"], []) for s in self.spans.of("decode")]

    def end_to_end(self, window_s: float) -> dict:
        from bench.lib.stats import percentile
        reqs = self.requests()
        tokens = sum(len(r["tokens"]) for r in reqs if not r["failed"])
        gaps = [b - a for r in reqs for a, b in zip(r["times"], r["times"][1:])]
        out = {"map_tokens_per_s": tokens / window_s}
        if gaps:
            out["map_itl_p95_ms"] = percentile(gaps, 95) * 1e3
        return out

    def attempted_failed(self) -> tuple[int, int]:
        reqs = self.requests()
        return len(reqs), sum(1 for r in reqs if r["failed"] or not r["tokens"])

    # -- the check -------------------------------------------------------
    def _ref(self, precision: str) -> list[torch.Tensor]:
        ref = self.fam.reference.Reference(self.weights, self.arch, precision=precision)
        dev = self.weights["embedding"].device
        seqs, pos = [], []
        for r in self._chosen:
            ids = traffic.prompt_ids(self.mix, r["row"]) + r["tokens"][:-1]
            seqs.append(torch.tensor(ids, device=dev))
            t = len(ids) - len(r["tokens"]) + 1
            pos.append(torch.arange(t - 1, t - 1 + len(r["tokens"]), device=dev))
        return ref.logits(seqs, pos)

    def check(self, table: list[dict], seed: int) -> dict:
        reqs = [r for r in self.requests() if not r["failed"] and r["tokens"]]
        self._chosen, self._ref_logits, self._held = [], [], 0
        if not reqs:
            return {"served_gap": math.inf, "logit_gap": math.inf}
        kept = {k: v for k, v in self.captured.items() if v}
        keyed = {_key(self.mix, r["row"]): r for r in reqs}
        held = [keyed[k] for k in kept if k in keyed]
        idx = list(range(len(reqs)))
        longest = max(idx, key=lambda i: (reqs[i]["prompt"] + len(reqs[i]["tokens"]), -i))
        drawn = [reqs[i] for i in check.sample(idx, int(self.mix["check"]["drawn"]), seed, longest)]
        self._chosen = held + [r for r in drawn if all(r is not h for h in held)]
        self._held = len(held)
        self._ref_logits = ref = self._ref("f32")
        served = max(served_gap(lg, r["tokens"]) for lg, r in zip(ref, self._chosen))
        logit = 0.0 if held else math.inf
        for lg, r in zip(ref, held):
            prog = kept[_key(self.mix, r["row"])][: len(r["tokens"])]
            if len(prog) != len(r["tokens"]):
                logit = math.inf
                continue
            prog = torch.from_numpy(np.stack(prog)).to(lg.device)
            logit = max(logit, float((prog - lg).abs().max()))
        return {"served_gap": served, "logit_gap": logit}

    def control(self) -> dict:
        if not self._chosen:
            return {"served_gap": math.inf, "logit_gap": math.inf}
        lowp = self._ref("fp8")
        ref = self._ref_logits
        served = max(served_gap(lg, lp.argmax(dim=-1).tolist()) for lg, lp in zip(ref, lowp))
        logit = max(float((lp - lg).abs().max()) for lg, lp in zip(ref, lowp))
        return {"served_gap": served, "logit_gap": logit}


def plant_fault():
    """Every tenth sampled token moved to the next id, where the sampler
    produces it."""
    from repro_torch.engine.sampler import Sampler
    orig = Sampler.__call__
    calls = [0]

    def altered(self, logits):
        tok = orig(self, logits)
        calls[0] += 1
        if calls[0] % 10 == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    Sampler.__call__ = altered
    return lambda: setattr(Sampler, "__call__", orig)
