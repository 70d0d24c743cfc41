"""The port's ``sem_topk`` algorithms and ``langex`` against ``repro``'s, on
the deterministic ``SimulatedBackend``: each package's own ``synth`` builds
the same rank world from the same seed, so the same comparisons get the
same answers.  Order, compare bill and accounting ``details`` must be
identical (everything but the wall clock)."""
import pytest

import repro_torch
from repro.core import accounting as jaccounting
from repro.core import langex as jlangex
from repro.core.backends import synth as jsynth
from repro.core.backends.base import CountedModel as JCounted
from repro.core.operators import topk as jtopk
from repro_torch.core import accounting as taccounting
from repro_torch.core import langex as tlangex
from repro_torch.core.backends import synth as tsynth
from repro_torch.core.backends.base import CountedModel as TCounted
from repro_torch.core.operators import topk as ttopk


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _details(st: dict) -> dict:
    return {k: v for k, v in st.items() if k != "wall_s"}


def _worlds(n, noise, seed):
    t = tsynth.make_rank_world(n, compare_noise=noise, seed=seed)
    j = jsynth.make_rank_world(n, compare_noise=noise, seed=seed)
    return ((t[0], TCounted(t[2], "oracle"), t[4]),
            (j[0], JCounted(j[2], "oracle"), j[4]))


@pytest.mark.parametrize("noise,seed", [(0.08, 3), (1e-9, 4), (0.2, 5)])
@pytest.mark.parametrize("pivot", [False, True])
@pytest.mark.parametrize("k", [1, 7, 12])
def test_quickselect_matches_reference(noise, seed, pivot, k):
    (trecs, tmodel, tpiv), (jrecs, jmodel, jpiv) = _worlds(60, noise, seed)
    kw_t = {"pivot_scores": tpiv} if pivot else {}
    kw_j = {"pivot_scores": jpiv} if pivot else {}
    tidx, tst = ttopk.sem_topk_quickselect(trecs, "{abstract}", k, tmodel, seed=seed, **kw_t)
    jidx, jst = jtopk.sem_topk_quickselect(jrecs, "{abstract}", k, jmodel, seed=seed, **kw_j)
    assert list(tidx) == list(jidx) and len(tidx) == k
    assert tst["compare_calls"] == jst["compare_calls"] > 0
    assert _details(tst) == _details(jst)


@pytest.mark.parametrize("name", ["sem_topk_quadratic", "sem_topk_heap"])
def test_table7_baselines_match_reference(name):
    (trecs, tmodel, _), (jrecs, jmodel, _) = _worlds(30, 0.08, 6)
    tidx, tst = getattr(ttopk, name)(trecs, "{abstract}", 5, tmodel)
    jidx, jst = getattr(jtopk, name)(jrecs, "{abstract}", 5, jmodel)
    assert [int(i) for i in tidx] == [int(i) for i in jidx]
    assert _details(tst) == _details(jst)


def test_comparator_prompts_each_unordered_pair_once():
    """A repeated or mirrored pair is asked once; the mirror is negated."""
    (trecs, tmodel, _), (jrecs, jmodel, _) = _worlds(10, 0.08, 7)
    pairs = [(0, 1), (1, 0), (0, 1), (2, 3), (3, 2), (4, 4)]
    with taccounting.track("cmp") as tst:
        got = ttopk._Comparator(trecs, "{abstract}", tmodel).batch(pairs).tolist()
    with jaccounting.track("cmp") as jst:
        want = jtopk._Comparator(jrecs, "{abstract}", jmodel).batch(pairs).tolist()
    assert got == want and got[0] != got[1] and got[3] != got[4]
    assert tst.as_dict()["compare_calls"] == jst.as_dict()["compare_calls"] == 3
    assert ttopk.compare_prompt(None, "c", "a", "b") == jtopk.compare_prompt(None, "c", "a", "b")


@pytest.mark.parametrize("template,tup,right", [
    ("The {abstract} is about ML", {"abstract": "x"}, None),
    ("The paper {abstract:left} uses the {dataset:right}.", {"abstract": "a"},
     {"dataset": "d"}),
    ("the topic of each {paper}", {"paper": 3}, None),
])
def test_langex_matches_reference(template, tup, right):
    t, j = tlangex.as_langex(template), jlangex.as_langex(template)
    assert [(f.name, f.side) for f in t.fields] == [(f.name, f.side) for f in j.fields]
    assert t.is_binary == j.is_binary
    assert t.render(tup, right) == j.render(tup, right)
    with pytest.raises(KeyError):
        t.validate(["nothing"], ["nothing"])
