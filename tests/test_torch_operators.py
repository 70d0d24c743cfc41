"""The port's eager operators and their optimizer against ``repro``'s.

``core/optimizer/{stats,cascades,blocks}.py`` are numpy copies: their
functions must give identical outputs (prompt text identical, floats within
1e-12).  ``sem_filter``, ``sem_join`` (gold, the cascade under each
``force_plan``, the block join with declared and detected equivalence) and
``sem_group_by`` (gold, cascade) run over the same synthetic worlds, built
by each package's own ``synth`` from the same seed, on the deterministic
``SimulatedBackend``.  Masks, records, ``tau_plus``/``tau_minus``, the
accounting ``details`` and the bills must be identical (everything but the
wall clock).

The cascade join and the cascade group-by read their thresholds from
cosine planes, which the frameworks compute to within ``SCORE_TIE``; where
tied scores change order between them (``torch_parity.with_planes`` prints
them), the port is held to identical outputs on the reference's planes.
"""
import dataclasses
import functools

import numpy as np
import pytest

import repro_torch
from repro.core import frame as jframe
from repro.core.backends import synth as jsynth
from repro.core.langex import Langex as JLangex
from repro.core.operators import filter as jfilter
from repro.core.operators import groupby as jgroupby
from repro.core.operators import join as jjoin
from repro.core.optimizer import blocks as jblocks
from repro.core.optimizer import cascades as jcascades
from repro.core.optimizer import stats as jstats
from repro_torch.core import frame as tframe
from repro_torch.core.backends import synth as tsynth
from repro_torch.core.langex import Langex as TLangex
from repro_torch.core.operators import filter as tfilter
from repro_torch.core.operators import groupby as tgroupby
from repro_torch.core.operators import join as tjoin
from repro_torch.core.optimizer import blocks as tblocks
from repro_torch.core.optimizer import cascades as tcascades
from repro_torch.core.optimizer import stats as tstats
from torch_parity import SCORE_TIE, no_wall, with_planes

FLOAT_TOL = 1e-12    # the optimizer's numpy arithmetic is the same code
JOIN = "the {abstract} reports the {reaction:right}"
ENTITY = "the {mention} refers to the same entity as {entity:right}"


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _close(a, b) -> bool:
    """Equal structure; floats (and float arrays) within FLOAT_TOL."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            return a.shape == b.shape and np.allclose(a, b, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                                      equal_nan=True)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= FLOAT_TOL * max(1.0, abs(a))
    return a == b


def _sessions(t, j, **kw):
    """One Session per package from the (oracle, proxy, embedder) of each
    package's world."""
    return (tframe.Session(oracle=t[0], proxy=t[1], embedder=t[2], **kw),
            jframe.Session(oracle=j[0], proxy=j[1], embedder=j[2], **kw))


# ---------------------------------------------------------------------------
# optimizer/stats.py
# ---------------------------------------------------------------------------


def _stats_sample(pkg, seed: int, n: int = 300, s: int = 120):
    rng = np.random.default_rng(seed)
    truth = rng.random(n) < 0.4
    scores = np.clip(0.55 * truth + 0.45 * rng.random(n), 0, 1)
    probs = pkg.defensive_importance_probs(scores)
    idx = pkg.importance_sample(np.random.default_rng(seed + 1), probs, s)
    return pkg.Sample(idx=idx, probs=probs, labels=truth[idx], scores=scores[idx]), \
        scores, truth


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_functions_match_reference(seed, guard, monkeypatch):
    monkeypatch.setattr(tstats, "FINITE_SAMPLE_GUARD", guard)
    monkeypatch.setattr(jstats, "FINITE_SAMPLE_GUARD", guard)
    ts, scores, truth = _stats_sample(tstats, seed)
    js, _, _ = _stats_sample(jstats, seed)
    assert _close(ts.idx, js.idx) and _close(ts.probs, js.probs)
    assert _close(ts.weights, js.weights)
    for power in (0.5, 16.0):
        assert _close(tstats.defensive_importance_probs(scores, power=power),
                      jstats.defensive_importance_probs(scores, power=power))
    for g in (0.5, 0.8, 0.9, 0.99):
        for d in (0.05, 0.2):
            assert _close(tstats.rt_threshold(ts, g, d), jstats.rt_threshold(js, g, d))
            assert _close(tstats.pt_threshold(ts, g, d), jstats.pt_threshold(js, g, d))
            correct = truth[ts.idx]
            assert _close(tstats.accuracy_threshold(ts.scores, correct, g, d),
                          jstats.accuracy_threshold(js.scores, correct, g, d))
    num, den = ts.weights * ts.labels, ts.weights
    assert _close(tstats._ratio_lcb(num, den, 0.05), jstats._ratio_lcb(num, den, 0.05))
    for p, n in ((0.3, 5.0), (1.0, 2.0), (0.0, 0.0)):
        assert _close(tstats._wilson_lcb(p, n, 0.05), jstats._wilson_lcb(p, n, 0.05))
    for sc in (None, scores):
        ti, tp = tstats.shared_sample_indices(len(scores), 50, seed, sc)
        ji, jp = jstats.shared_sample_indices(len(scores), 50, seed, sc)
        assert _close(ti, ji) and _close(tp, jp)
        assert _close(tstats.estimate_selectivity(ti, tp, truth[ti]),
                      jstats.estimate_selectivity(ji, jp, truth[ji]))


# ---------------------------------------------------------------------------
# optimizer/cascades.py
# ---------------------------------------------------------------------------


def _result(r) -> dict:
    return dataclasses.asdict(r)


@pytest.mark.parametrize("calibrate", [True, False])
@pytest.mark.parametrize("seed", [3, 4])
def test_run_cascade_matches_reference(seed, calibrate):
    rng = np.random.default_rng(seed)
    truth = rng.random(400) < 0.3
    scores = np.clip(0.5 * truth + 0.5 * rng.random(400), 0, 1)
    calls = {"t": [], "j": []}

    def oracle(tag):
        def fn(idx):
            calls[tag].append(np.asarray(idx).tolist())
            return truth[np.asarray(idx)]
        return fn
    kw = dict(recall_target=0.9, precision_target=0.85, delta=0.2, sample_size=80,
              seed=seed, calibrate=calibrate)
    t = tcascades.run_cascade(scores, oracle("t"), **kw)
    j = jcascades.run_cascade(scores, oracle("j"), **kw)
    assert _close(_result(t), _result(j))
    assert calls["t"] == calls["j"]


@pytest.mark.parametrize("seed", [5, 6])
def test_estimate_and_execute_plan_match_reference(seed):
    ts, scores, truth = _stats_sample(tstats, seed, n=500, s=150)
    js, _, _ = _stats_sample(jstats, seed, n=500, s=150)
    label_of = {int(i): bool(truth[i]) for i in np.unique(ts.idx)}
    tp = tcascades.estimate_plan("p", scores, ts, label_of, recall_target=0.9,
                                 precision_target=0.9, delta=0.2, extra_lm_calls=7)
    jp = jcascades.estimate_plan("p", scores, js, label_of, recall_target=0.9,
                                 precision_target=0.9, delta=0.2, extra_lm_calls=7)
    assert (tp.tau_plus, tp.tau_minus, tp.est_oracle_calls, tp.total_cost) == \
        (jp.tau_plus, jp.tau_minus, jp.est_oracle_calls, jp.total_cost)
    oracle = lambda idx: truth[np.asarray(idx)]  # noqa: E731
    assert _close(_result(tcascades.execute_plan(tp, oracle)),
                  _result(jcascades.execute_plan(jp, oracle)))


class _StubOracle:
    """Pairwise truth from the pair numbers in a prompt; block responses
    from a script (one mode per generate wave)."""

    def __init__(self, truth_fn, script):
        self.truth, self.script = truth_fn, list(script)

    def generate(self, prompts):
        mode = self.script.pop(0) if self.script else "garbage"
        out = []
        for p in prompts:
            pairs = [ln for ln in p.splitlines()
                     if ln.strip() and ln.strip()[0].isdigit() and "." in ln.split()[0]]
            n = len(pairs)
            if mode == "garbage":
                out.append("I cannot answer that.")
            elif mode == "truncated":
                out.append("\n".join(f"{k}: YES" for k in range(1, n)))
            elif mode == "inverted":
                out.append("\n".join(f"{k}: {'NO' if self.truth(ln) else 'YES'}"
                                     for k, ln in enumerate(pairs, 1)))
            else:
                out.append("\n".join(f"{k}: {'YES' if self.truth(ln) else 'NO'}"
                                     for k, ln in enumerate(pairs, 1)))
        return out

    def predicate(self, prompts):
        v = np.asarray([self.truth(p) for p in prompts], bool)
        return v, v.astype(float)


def _truth(text: str) -> bool:
    i, j = text.rsplit("pair:", 1)[1].split()[0].split(",")
    return (int(i) + int(j)) % 3 == 0


def _judge(pkg, lx_cls, script, n=12, block_size=5):
    left = [{"a": f"L{i}"} for i in range(n)]
    right = [{"b": f"R{j}"} for j in range(n)]
    lx = lx_cls("{a} matches {b:right}")
    prompt = lambda prs: [f"pair:{i},{j}" for i, j in prs]  # noqa: E731
    return pkg.BlockJudge(_StubOracle(_truth, script), lx, left, right, prompt,
                          block_size=block_size)


@pytest.mark.parametrize("script", [["valid"], ["truncated", "valid"],
                                    ["garbage", "garbage"], ["inverted"]])
def test_block_judge_and_labeled_sample_match_reference(script, monkeypatch):
    # the stub renders every pair as its own "pair:i,j" line, so both
    # packages' block prompts carry the numbers the stub oracle reads
    def render(lx, left, right, pairs, *, strict=False):
        return "\n".join(f"{k}. pair:{i},{j}" for k, (i, j) in enumerate(pairs, 1))
    monkeypatch.setattr(tblocks, "build_block_prompt", render)
    monkeypatch.setattr(jblocks, "build_block_prompt", render)
    pairs = [(i, (3 * i + 1) % 12) for i in range(12)] + [(i, i) for i in range(12)]
    tj, jj = _judge(tblocks, TLangex, script), _judge(jblocks, JLangex, script)
    assert tj.judge_pairs(pairs).tolist() == jj.judge_pairs(pairs).tolist()
    assert tj.stats.as_dict() == jj.stats.as_dict()
    gold = lambda prs: np.asarray([(i + j) % 3 == 0 for i, j in prs])  # noqa: E731
    tj, jj = _judge(tblocks, TLangex, script), _judge(jblocks, JLangex, script)
    tc = tcascades.block_labeled_sample(pairs, tj, gold, rng=np.random.default_rng(0))
    jc = jcascades.block_labeled_sample(pairs, jj, gold, rng=np.random.default_rng(0))
    assert _close(dataclasses.asdict(tc), dataclasses.asdict(jc))


# ---------------------------------------------------------------------------
# optimizer/blocks.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text,n", [
    ("1: YES\n2: NO\n3: YES", 3),
    ("Sure, here are my verdicts:\n1. yes\n2) no match\n3 - TRUE\nHope that helps!", 3),
    ("1: YES\n2: NO", 4), ("", 2), (None, 2), ("1: YES\n2: NO\n3: NO", 2),
    ("1: YES\n1: NO\n2: YES", 3), ("0: YES\n1: NO", 2), ("1: YES\n7: NO", 2),
    ("1: MAYBE\n2: NO", 2), ("1 - false\n2: match", 2),
])
def test_parse_block_response_matches_reference(text, n):
    assert tblocks.parse_block_response(text, n) == jblocks.parse_block_response(text, n)


@pytest.mark.parametrize("strict", [False, True])
def test_block_prompt_matches_reference(strict):
    left, right, *_ = tsynth.make_entity_world(6, 5, 3, seed=1)
    pairs = [(0, 1), (2, 3), (5, 4), (1, 1)]
    assert tblocks.build_block_prompt(TLangex(ENTITY), left, right, pairs, strict=strict) \
        == jblocks.build_block_prompt(JLangex(ENTITY), left, right, pairs, strict=strict)
    assert [tblocks.blocking_k(n) for n in (1, 100, 160, 161, 24000)] == \
        [jblocks.blocking_k(n) for n in (1, 100, 160, 161, 24000)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_inference_and_equivalence_match_reference(seed):
    rng = np.random.default_rng(seed)
    cls_l, cls_r = rng.integers(0, 4, 15), rng.integers(0, 4, 12)
    obs = [(int(i), int(j)) for i, j in zip(rng.integers(0, 15, 60), rng.integers(0, 12, 60))]
    t, j = tblocks.MatchInference(15, 12), jblocks.MatchInference(15, 12)
    for a, b in obs:
        v = bool(cls_l[a] == cls_r[b])
        t.observe(a, b, v)
        j.observe(a, b, v)
    grid = [(a, b) for a in range(15) for b in range(12)]
    assert [t.resolve(a, b) for a, b in grid] == [j.resolve(a, b) for a, b in grid]
    assert (t.inferred, t.observed, t.n_classes()) == (j.inferred, j.observed, j.n_classes())
    assert np.array_equal(t.implied_matrix(), j.implied_matrix())
    labels = [bool(cls_l[a] == cls_r[b]) for a, b in obs]
    flipped = [not v if k % 7 == 0 else v for k, v in enumerate(labels)]
    for lab in (labels, flipped):
        assert tblocks.detect_equivalence(obs, lab) == jblocks.detect_equivalence(obs, lab)


# ---------------------------------------------------------------------------
# operators: sem_filter, sem_join, sem_group_by
# ---------------------------------------------------------------------------


def _filter_worlds(n, seed, alpha=2.0):
    t = tsynth.make_filter_world(n, proxy_alpha=alpha, seed=seed)
    j = jsynth.make_filter_world(n, proxy_alpha=alpha, seed=seed)
    return (t[0], t[2:]), (j[0], j[2:])


def test_sem_filter_gold_matches_reference():
    (trecs, tw), (jrecs, jw) = _filter_worlds(300, 5)
    ts, js = _sessions(tw, jw)
    tm, tst = tfilter.sem_filter_gold(trecs, "{claim} holds", ts.oracle)
    jm, jst = jfilter.sem_filter_gold(jrecs, "{claim} holds", js.oracle)
    assert tm.tolist() == jm.tolist() and no_wall(tst) == no_wall(jst)
    assert tst["oracle_calls"] == 300
    assert tfilter.predicate_prompt(TLangex("{claim} holds"), trecs[3]) == \
        jfilter.predicate_prompt(JLangex("{claim} holds"), jrecs[3])


@pytest.mark.parametrize("alpha,seed", [(2.5, 1000), (1.0, 1001), (0.8, 2003)])
def test_sem_filter_cascade_matches_reference(alpha, seed):
    (trecs, tw), (jrecs, jw) = _filter_worlds(400, seed, alpha)
    ts, js = _sessions(tw, jw)
    kw = dict(recall_target=0.9, precision_target=0.9, delta=0.2, sample_size=100, seed=7)
    tm, tst = tfilter.sem_filter_cascade(trecs, "{claim} holds", ts.oracle, ts.proxy, **kw)
    jm, jst = jfilter.sem_filter_cascade(jrecs, "{claim} holds", js.oracle, js.proxy, **kw)
    assert tm.tolist() == jm.tolist()
    assert no_wall(tst) == no_wall(jst)
    assert tst["proxy_calls"] == 400 and "tau_plus" in tst


@functools.lru_cache(maxsize=None)
def _join_worlds(n1, n2, seed, labels_per_left=2, sim_correlation=0.8):
    """Both packages' join world; cached, since the worlds are read-only to
    the operators and a world of uncorrelated topics takes seconds to make."""
    kw = dict(labels_per_left=labels_per_left, sim_correlation=sim_correlation)
    t = tsynth.make_join_world(n1, n2, seed=seed, **kw)
    j = jsynth.make_join_world(n1, n2, seed=seed, **kw)
    return t, j


def test_sem_join_gold_matches_reference():
    t, j = _join_worlds(12, 9, 6)
    ts, js = _sessions(t[3:], j[3:])
    tm, tst = tjoin.sem_join_gold(t[0], t[1], JOIN, ts.oracle, batch=11)
    jm, jst = jjoin.sem_join_gold(j[0], j[1], JOIN, js.oracle, batch=11)
    assert tm.tolist() == jm.tolist() and no_wall(tst) == no_wall(jst)
    assert tst["oracle_calls"] == 12 * 9
    pairs = [(0, 1), (3, 4), (11, 8)]
    assert tjoin._pair_prompts(TLangex(JOIN), t[0], t[1], pairs) == \
        jjoin._pair_prompts(JLangex(JOIN), j[0], j[1], pairs)


@pytest.mark.parametrize("force_plan", [None, "sim-filter", "project-sim-filter"])
@pytest.mark.parametrize("sim_correlation,seed", [(0.0, 3000), (0.8, 3001), (0.0, 3005)])
def test_sem_join_cascade_matches_reference(force_plan, sim_correlation, seed, monkeypatch):
    t, j = _join_worlds(30, 20, seed, labels_per_left=1, sim_correlation=sim_correlation)
    kw = dict(recall_target=0.8, precision_target=0.8, delta=0.2, sample_size=150,
              seed=seed, force_plan=force_plan)

    def run(mod):
        w, sess = (t, tframe.Session) if mod is tjoin else (j, jframe.Session)
        s = sess(oracle=w[3], proxy=w[4], embedder=w[5])
        mask, st = mod.sem_join_cascade(w[0], w[1], JOIN, s.oracle, s.embedder, **kw)
        return mask.tolist(), no_wall(st)
    got, want, replayed, ties = with_planes(monkeypatch, run, tjoin, jjoin)
    assert replayed == want
    assert want[1]["plan"] == (force_plan or want[1]["plan"])
    if not ties:
        assert got == want


def _entity_worlds(n1, n2, c, seed):
    return (tsynth.make_entity_world(n1, n2, c, seed=seed),
            jsynth.make_entity_world(n1, n2, c, seed=seed))


@pytest.mark.parametrize("case", ["detected", "declared", "pinned_k", "empty_left",
                                  "empty_right", "biodex"])
def test_sem_join_block_matches_reference(case):
    if case == "biodex":
        t, j = _join_worlds(40, 60, 9)
        lx = JOIN
    else:
        t, j = _entity_worlds(48, 30, 10, 5)
        lx = ENTITY
    ts, js = _sessions(t[3:], j[3:])
    tl, tr, jl, jr = t[0], t[1], j[0], j[1]
    if case == "empty_left":
        tl, jl = [], []
    if case == "empty_right":
        tr, jr = [], []
    kw = dict(recall_target=0.9, precision_target=0.9, sample_size=80, seed=3)
    if case == "pinned_k":
        kw.update(candidate_k=4, block_size=7)
    tlx, jlx = (TLangex(lx, equivalence=True), JLangex(lx, equivalence=True)) \
        if case == "declared" else (lx, lx)
    tm, tst = tjoin.sem_join_block(tl, tr, tlx, ts.oracle, ts.embedder, **kw)
    jm, jst = jjoin.sem_join_block(jl, jr, jlx, js.oracle, js.embedder, **kw)
    assert tm.tolist() == jm.tolist()
    assert no_wall(tst) == no_wall(jst)
    if case in ("detected", "declared"):
        assert tst["equivalence"] is True and tst["block_prompts"] >= 1


@pytest.mark.parametrize("cascade", [False, True])
@pytest.mark.parametrize("seed", [4000, 4003])
def test_sem_group_by_matches_reference(cascade, seed, monkeypatch):
    t = tsynth.make_topic_world(200, 4, seed=seed)
    j = jsynth.make_topic_world(200, 4, seed=seed)

    def run(mod):
        w, sess = (t, tframe.Session) if mod is tgroupby else (j, jframe.Session)
        s = sess(oracle=w[2], embedder=w[3])
        if cascade:
            r = mod.sem_group_by_cascade(w[0], "the topic of {paper}", 4, s.oracle,
                                         s.embedder, accuracy_target=0.85, delta=0.2,
                                         sample_size=80, seed=seed)
        else:
            r = mod.sem_group_by_gold(w[0], "the topic of {paper}", 4, s.oracle,
                                      s.embedder, seed=seed)
        return r.labels, r.assignment.tolist(), no_wall(r.stats)
    got, want, replayed, ties = with_planes(monkeypatch, run, tgroupby, jgroupby)
    assert replayed == want
    if cascade and not ties:
        # tau is a raw cosine score (not a rank): within SCORE_TIE
        assert abs(got[2]["tau"] - want[2]["tau"]) <= SCORE_TIE or \
            got[2]["tau"] == want[2]["tau"]
        got[2]["tau"] = want[2]["tau"]
    if not ties:
        assert got == want
