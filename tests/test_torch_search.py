"""The port's similarity operators against ``repro``'s: ``sem_index``,
``sem_search`` and ``sem_sim_join`` over ``SimulatedEmbedder`` worlds built
by each package's own ``synth`` from the same seeds.  Hits, ids and the
accounting ``details`` must be identical (everything but the wall clock),
scores allclose at 1e-5 (f32 dot products of unit vectors summed in another
order)."""
import numpy as np
import pytest

import repro_torch
from repro.core.backends import synth as jsynth
from repro.core.operators import search as jsearch
from repro_torch.core import accounting
from repro_torch.core.backends import synth as tsynth
from repro_torch.core.backends.base import CountedEmbedder
from repro_torch.core.operators import search as tsearch

TOL = dict(rtol=1e-5, atol=1e-5)

INDEXES = [("exact", {}), ("ivf", {"n_clusters": 8, "nprobe": 2}),
           ("ivf", {"n_clusters": 8, "nprobe": 2, "quantize": "int8"}),
           ("ivf", {"recall_target": 0.9})]


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _worlds(name: str):
    """The same world built by both packages -> (port, ref) of
    (texts, query texts, embedder)."""
    out = []
    for s in (tsynth, jsynth):
        if name == "filter":
            recs, _, _, _, emb = s.make_filter_world(400, seed=3)
            texts = [r["claim"] for r in recs]
            queries = texts[::37]
        elif name == "join":
            left, right, _, _, _, emb = s.make_join_world(60, 300, seed=4)
            texts = [r["reaction"] for r in right]
            queries = [r["abstract"] for r in left]
        elif name == "entity":
            left, right, _, _, _, emb = s.make_entity_world(50, 250, 12, seed=5)
            texts = [r["entity"] for r in right]
            queries = [r["mention"] for r in left]
        else:
            recs, _, _, emb = s.make_topic_world(350, 6, seed=6)
            texts = [r["paper"] for r in recs]
            queries = texts[::29] + ["an untagged query text"]
        out.append((texts, queries, emb))
    return out


def _details(st: dict) -> dict:
    return {k: v for k, v in st.items() if k != "wall_s"}


@pytest.mark.parametrize("world", ["filter", "join", "entity", "topic"])
@pytest.mark.parametrize("kind,kw", INDEXES)
def test_sem_search_matches_reference(world, kind, kw):
    (tt, tq, temb), (jt, jq, jemb) = _worlds(world)
    tidx = tsearch.sem_index(tt, temb, index=kind, **kw)
    jidx = jsearch.sem_index(jt, jemb, index=kind, **kw)
    assert tidx.describe() == jidx.describe()
    for q in tq[:6]:
        th, tst = tsearch.sem_search(tidx, q, temb, k=7)
        jh, jst = jsearch.sem_search(jidx, q, jemb, k=7)
        assert th == jh
        assert _details(tst) == _details(jst)


@pytest.mark.parametrize("world", ["filter", "join", "entity", "topic"])
@pytest.mark.parametrize("kind,kw", INDEXES)
def test_sem_sim_join_matches_reference(world, kind, kw):
    (tt, tq, temb), (jt, jq, jemb) = _worlds(world)
    tidx = tsearch.sem_index(tt, temb, index=kind, **kw)
    jidx = jsearch.sem_index(jt, jemb, index=kind, **kw)
    ts, ti, tst = tsearch.sem_sim_join(tq, tidx, temb, k=3)
    js, ji, jst = jsearch.sem_sim_join(jq, jidx, jemb, k=3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)
    assert _details(tst) == _details(jst)


def test_sem_index_persists_in_the_reference_format(tmp_path):
    """A sem_index saved by the port loads through the reference's
    load_sem_index and answers the same query the same way."""
    (tt, tq, temb), (jt, jq, jemb) = _worlds("filter")
    tidx = tsearch.sem_index(tt, temb, index="ivf", n_clusters=8,
                             path=str(tmp_path / "ix"))
    jidx = jsearch.load_sem_index(str(tmp_path / "ix"))
    assert tsearch.load_sem_index(str(tmp_path / "ix")).kind == "ivf"
    th, _ = tsearch.sem_search(tidx, tq[0], temb, k=5)
    jh, _ = jsearch.sem_search(jidx, jq[0], jemb, k=5)
    assert th == jh


def test_operator_stats_roll_up_and_count_embed_calls():
    """Nested operators roll their numeric details up into the parent, and
    the embedder is billed once per embedded text, as in the reference."""
    (tt, tq, temb), _ = _worlds("join")
    idx = tsearch.sem_index(tt, temb, index="ivf", n_clusters=8, nprobe=2)
    emb = CountedEmbedder(temb)
    with accounting.track("outer") as outer:
        tsearch.sem_search(idx, tq[0], emb, k=4)
        _, _, st = tsearch.sem_sim_join(tq[:5], idx, emb, k=2)
    assert outer.embed_calls == 6 and st["embed_calls"] == 5
    assert outer.details["scored_vectors"] > st["scored_vectors"] > 0
    assert outer.details["index"] == "ivf"
