"""The engine's spans (``engine/``, ``scheduler/``, ``runner/``) under a
``repro_torch.obs.trace.Tracer`` on the CPU at smoke size: none made and no
attribute set without a tracer, the same answers with and without one, the
spans' counts and attributes against the scheduler's and the engine's own
counters, and their epoch-clock ends against ``time.time_ns``."""
import time

import numpy as np
import pytest

import repro_torch
from repro_torch.configs import get_smoke
from repro_torch.core.backends.torch_engine import EngineModel
from repro_torch.core.operators.filter import sem_filter_gold
from repro_torch.core.operators.mapex import sem_map
from repro_torch.data.tokenizer import TOKENIZER
from repro_torch.engine import runner as runner_mod
from repro_torch.engine.engine import InferenceEngine
from repro_torch.engine.scheduler import ContinuousBatchScheduler, Request
from repro_torch.obs import trace

MAX_SEQ = 96
RECORDS = [{"title": f"paper {i}", "abstract": "word " * (3 + 5 * i)} for i in range(5)]
MAP_LANGEX = "the main finding of {title}: {abstract}"
FILTER_LANGEX = "{title} is about {abstract}"


@pytest.fixture(scope="module")
def engine():
    repro_torch.set_device("cpu")
    cfg = get_smoke("llama3.2-3b").with_(vocab_size=TOKENIZER.vocab_size, dtype="float32")
    yield InferenceEngine(cfg, seed=3, max_slots=3, max_seq=MAX_SEQ)
    repro_torch.set_device(None)


def _traced(fn):
    tracer = trace.Tracer()
    with trace.activate(tracer):
        out = fn()
    return out, tracer


def _prompts(n):
    rng = np.random.default_rng(n)
    return ["".join(chr(int(c)) for c in rng.integers(97, 123, int(m)))
            for m in rng.integers(3, 140, n)]


def _requests():
    rng = np.random.default_rng(5)
    return [Request(rid=i, tokens=rng.integers(1, 300, int(n)).astype(np.int32),
                    max_new_tokens=k)
            for i, (n, k) in enumerate([(9, 3), (40, 5), (17, 2), (33, 4), (5, 6)])]


def test_untraced_engine_makes_no_span_and_sets_no_attribute(engine, monkeypatch):
    made, set_calls = [], []

    class Counted(trace.Span):
        __slots__ = ()

        def __init__(self, *a, **k):
            made.append(a)
            super().__init__(*a, **k)

    monkeypatch.setattr(trace, "Span", Counted)
    monkeypatch.setattr(trace._NoopSpan, "set", lambda self, **kw: set_calls.append(kw))
    engine.generate(_prompts(4), max_new_tokens=3)
    engine.predicate(_prompts(35))
    assert set_calls == []          # the operators' own spans set theirs, so engine calls only
    sem_map(RECORDS, MAP_LANGEX, EngineModel(engine, max_new_tokens=3))
    sem_filter_gold(RECORDS, FILTER_LANGEX, EngineModel(engine))
    assert made == []
    _, tracer = _traced(lambda: engine.generate(_prompts(2), max_new_tokens=2))
    assert len(made) == len(tracer.spans()) > 0      # the patch does see spans


def test_traced_and_untraced_give_the_same_answers(engine):
    class Scores(EngineModel):
        def predicate(self, prompts):
            passed, score = super().predicate(prompts)
            self.scores.append(score)
            return passed, score

    def run():
        oracle = Scores(engine)
        oracle.scores = []
        texts, _ = sem_map(RECORDS, MAP_LANGEX, EngineModel(engine, max_new_tokens=4))
        mask, _ = sem_filter_gold(RECORDS * 8, FILTER_LANGEX, oracle)
        return texts, mask, np.concatenate(oracle.scores)

    plain = run()
    (texts, mask, scores), tracer = _traced(run)
    assert texts == plain[0]
    np.testing.assert_array_equal(mask, plain[1])
    np.testing.assert_array_equal(scores, plain[2])
    names = {s.name for s in tracer.spans()}
    engine_names = {n for n in names if n.split("/")[0] in ("engine", "scheduler", "runner")}
    assert engine_names == {"engine/score", "scheduler/step", "runner/prefill",
                            "runner/decode", "runner/enqueue", "runner/to_host"}


def test_scheduler_and_runner_spans(engine):
    sched = ContinuousBatchScheduler(engine.runner)
    reqs = _requests()
    for r in reqs:
        sched.submit(r)
    done, tracer = _traced(sched.run_to_completion)
    spans = tracer.spans()
    kids = tracer.children_index()
    by_id = {s.span_id: s for s in spans}
    pre = [s for s in spans if s.name == "runner/prefill"]
    dec = [s for s in spans if s.name == "runner/decode"]
    assert len(pre) == sched.prefill_steps == len(reqs)
    assert len(dec) == sched.decode_steps > 0
    for s in pre:
        t = s.attrs["tokens"]
        assert s.attrs["bucket"] == min(runner_mod._bucket(t), MAX_SEQ)
    assert sorted(s.attrs["tokens"] for s in pre) == sorted(len(r.tokens) for r in reqs)
    for s in pre + dec:
        step = by_id[s.parent_id]
        assert step.name == "scheduler/step"
        assert step.attrs["phase"] == s.name.split("/")[1]
        enq, host = kids[s.span_id]
        assert (enq.name, host.name) == ("runner/enqueue", "runner/to_host")
        assert 0 <= enq.t0 - s.t0 < 1e-3 and 0 <= host.t0 - enq.t1 < 1e-3
        assert 0 <= s.t1 - host.t1 < 1e-3
    steps = [s for s in spans if s.name == "scheduler/step"]
    assert len(steps) == len(pre) + len(dec)
    for s in steps:
        rids = s.attrs["rids"]
        assert len(set(rids)) == len(rids) > 0
        assert len(rids) == 1 if s.attrs["phase"] == "prefill" else \
            len(rids) <= engine.runner.max_slots
    for r in done:
        mine = [s.attrs["phase"] for s in steps if r.rid in s.attrs["rids"]]
        assert mine.count("prefill") == 1
        assert mine.count("decode") == len(r.out_tokens) - 1


def test_engine_spans_count_the_engines_tokens(engine):
    prompts = _prompts(45)                         # two batches: 32 + 13
    before = engine.stats.prompt_tokens
    _, tracer = _traced(lambda: engine.predicate(prompts))
    score = [s for s in tracer.spans() if s.name == "engine/score"]
    assert [s.attrs["rows"] for s in score] == [32, 13]
    assert sum(s.attrs["tokens"] for s in score) == engine.stats.prompt_tokens - before
    lens = [min(len(TOKENIZER.encode(p)), MAX_SEQ) for p in prompts]
    for s, chunk in zip(score, (lens[:32], lens[32:])):
        assert s.attrs["width"] == max(16, max(chunk))
        assert s.attrs["tokens"] == sum(chunk) < s.attrs["rows"] * s.attrs["width"]
    assert tracer.children_index() == {}      # the scoring forward opens no span of its own


def test_wall_clock_brackets_time_ns_inside_the_span():
    tracer = trace.Tracer()
    with trace.activate(tracer):
        with trace.span("outer") as sp:
            time.sleep(0.002)
            a = time.time_ns()
            time.sleep(0.002)
            b = time.time_ns()
            time.sleep(0.002)
    assert sp.wall0_ns < a < b < sp.wall1_ns
    assert sp.wall1_ns - sp.wall0_ns == pytest.approx(sp.dur_s * 1e9, abs=2)
    tracer.reset()
    with trace.activate(tracer):
        with trace.span("again") as sp2:
            time.sleep(0.001)
            c = time.time_ns()
            time.sleep(0.001)
    assert sp2.wall0_ns < c < sp2.wall1_ns
