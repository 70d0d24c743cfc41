"""The port's plan layer and ``SemFrame`` against ``repro``'s.

Every case builds the same world with each package's own ``synth`` from the
same seed and runs the same pipeline through each package's ``SemFrame``
(eager and lazy), optimizer, executors (plain, partitioned, adaptive),
``BatchedModelCache`` and ``explain_analyze``, on the deterministic
``SimulatedBackend``.  Records, the stats log (bills, thresholds, details;
everything but the wall clock), the applied rewrites, ``explain_plan``
text, cache hits, re-plans and ``explain_analyze`` text (wall times masked)
must be identical; a sim-join record's ``sim_score`` agrees to
``torch_parity.SIM_TOL``.  The BioDEX cascade join and the topic cascade group-by
read their thresholds from cosine planes, so they run through
``torch_parity.with_planes`` (see there).  Partitioned and sharded plans run
at one device in both packages (the port's ``ops._n_devices`` is 1 on the
CPU), the reference's ref path.
"""
import re
import types

import pytest

import repro_torch
from repro.core import accounting as jaccounting
from repro.core import frame as jframe
from repro.core.backends import synth as jsynth
from repro.core.backends.base import CountedModel as JCounted
from repro.core.operators import groupby as jgroupby
from repro.core.operators import join as jjoin
from repro.core.operators import topk as jtopk
from repro.core.plan import execute as jexecute
from repro.core.plan import nodes as jnodes
from repro.core.plan import optimize as joptimize
from repro.core.plan import parallel as jparallel
from repro.core.plan.adaptive import AdaptivePlanExecutor as JAdaptive
from repro.core.plan.cache import BatchedModelCache as JCache
from repro.obs.analyze import explain_analyze as jexplain_analyze
from repro.obs.stats_store import StatsStore as JStore
from repro_torch.core import accounting as taccounting
from repro_torch.core import frame as tframe
from repro_torch.core.backends import synth as tsynth
from repro_torch.core.backends.base import CountedModel as TCounted
from repro_torch.core.operators import groupby as tgroupby
from repro_torch.core.operators import join as tjoin
from repro_torch.core.operators import topk as ttopk
from repro_torch.core.plan import execute as texecute
from repro_torch.core.plan import nodes as tnodes
from repro_torch.core.plan import optimize as toptimize
from repro_torch.core.plan import parallel as tparallel
from repro_torch.core.plan.adaptive import AdaptivePlanExecutor as TAdaptive
from repro_torch.core.plan.cache import BatchedModelCache as TCache
from repro_torch.obs import explain_analyze as texplain_analyze
from repro_torch.obs.stats_store import StatsStore as TStore
from torch_parity import logs, same_records, with_planes

T = types.SimpleNamespace(
    synth=tsynth, frame=tframe, acc=taccounting, Counted=TCounted, Cache=TCache,
    N=tnodes, opt=toptimize, par=tparallel, exe=texecute, topk=ttopk, join=tjoin,
    Adaptive=TAdaptive, Store=TStore, analyze=texplain_analyze)
J = types.SimpleNamespace(
    synth=jsynth, frame=jframe, acc=jaccounting, Counted=JCounted, Cache=JCache,
    N=jnodes, opt=joptimize, par=jparallel, exe=jexecute, topk=jtopk, join=jjoin,
    Adaptive=JAdaptive, Store=JStore, analyze=jexplain_analyze)

JOIN = "the {abstract} reports the {reaction:right}"
PART_KW = dict(n_partitions=4, partition_min_rows=8)
_WALL = re.compile(r"wall [0-9.]+ms")


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _session(p, world, *, with_proxy=False, sample_size=60):
    return p.frame.Session(
        oracle=p.synth.SimulatedModel(world, "oracle"),
        proxy=p.synth.SimulatedModel(world, "proxy") if with_proxy else None,
        embedder=p.synth.SimulatedEmbedder(world), sample_size=sample_size)


def _frame(p, records, world, log=None, **kw):
    return p.frame.SemFrame(records, _session(p, world, **kw), log)


def _both(case):
    """-> (case(T), case(J))."""
    return case(T), case(J)


def _assert_same(got: dict, want: dict) -> None:
    """Each key of a case's output: ``records`` compared by
    ``same_records``, everything else identical."""
    assert got.keys() == want.keys()
    for k in got:
        if k == "records":
            assert same_records(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def _lazy(lz, **kw) -> dict:
    """explain(), then collect(), of one lazy frame -> comparable output."""
    text = lz.explain(**kw)
    out = lz.collect(**kw)
    return dict(records=out.records, log=logs(lz.stats_log), text=text,
                rewrites=[str(r) for r in lz.last_rewrites])


# ---------------------------------------------------------------------------
# eager SemFrame (test_operators_gold.py, test_paper_surface.py)
# ---------------------------------------------------------------------------


def _eager_case(name):
    def case(p):
        log: list = []
        if name == "filter":
            recs, world, *_ = p.synth.make_filter_world(300, seed=5)
            out = _frame(p, recs, world, log).sem_filter("{claim} holds")
        elif name == "join":
            left, right, world, *_ = p.synth.make_join_world(12, 9, seed=6)
            out = _frame(p, left, world, log).sem_join(right, JOIN)
        elif name == "topk":
            recs, world, *_ = p.synth.make_rank_world(60, compare_noise=1e-9, seed=7)
            out = _frame(p, recs, world, log).sem_topk("{abstract}", 8,
                                                      pivot_query="highest accuracy")
        elif name == "search":
            recs, world, *_ = p.synth.make_topic_world(50, 5, seed=11)
            sf = _frame(p, recs, world, log)
            idx = sf.sem_index("paper")
            hits = sf.sem_search("paper", recs[7]["paper"], k=3, index=idx)
            out = p.frame.SemFrame(recs[:5], sf.session, log).sem_sim_join(
                hits.records + recs, "paper", "paper", k=2)
        elif name == "map_extract":
            recs, world, *_ = p.synth.make_topic_world(10, 3, seed=12)
            sf = _frame(p, recs, world, log).sem_map("classify {paper}")
            out = sf.sem_extract("find the paper id in {paper}", source_field="paper")
        elif name == "agg":
            recs, world, *_ = p.synth.make_topic_world(40, 3, seed=10)
            for i, t in enumerate(recs):
                t["bucket"] = f"b{i % 3}"
            sf = _frame(p, recs, world, log)
            return dict(answers=[sf.sem_agg("summarize {paper}", fanout=4),
                                 sf.sem_agg("summarize {paper}", group_by="bucket")],
                        log=logs(log))
        else:
            recs, world, *_ = p.synth.make_topic_world(150, 4, seed=44)
            out = _frame(p, recs, world, log).sem_group_by(
                "the topic of each {paper}", 4)
        return dict(records=out.records, log=logs(log))
    return case


@pytest.mark.parametrize("name", ["filter", "join", "topk", "search", "map_extract",
                                  "agg", "group_by"])
def test_eager_semframe_matches_reference(name):
    got, want = _both(_eager_case(name))
    _assert_same(got, want)
    assert got.get("records", got.get("answers"))


# ---------------------------------------------------------------------------
# lazy pipelines and rewrites (test_plan.py)
# ---------------------------------------------------------------------------


def _plan_case(name):
    def case(p):
        if name in ("unoptimized", "optimized", "prefilter", "pushdown"):
            left, right, world, *_ = p.synth.make_join_world(40, 10, seed=12)
            p.synth.add_phrase_predicate(world, left, "is checkable", 0.2, seed=12)
            p.synth.add_phrase_predicate(world, left, "is in English", 0.85, seed=12)
            lz = _frame(p, left, world, []).lazy()
            if name == "pushdown":
                lz = lz.sem_join(right, JOIN).sem_filter("the {abstract} is checkable")
            else:
                lz = (lz.sem_filter("the {abstract} is in English")
                      .sem_filter("the {abstract} is checkable").sem_join(right, JOIN))
            if name == "unoptimized":
                out = lz.collect(optimize=False)
                return dict(records=out.records, log=logs(lz.stats_log))
            return _lazy(lz, **({"prefilter_threshold": 100} if name == "prefilter" else {}))
        if name == "fusion":
            recs, world, *_ = p.synth.make_filter_world(30, seed=15)
            lz = (_frame(p, recs, world, []).lazy()
                  .sem_map("a query for {claim}", out_column="q")
                  .sem_map("a title for {claim}", out_column="t"))
            return _lazy(lz)
        recs, world, *_ = p.synth.make_filter_world(80, seed=24)
        p.synth.add_phrase_predicate(world, recs, "is rare", 0.1, seed=24)
        p.synth.add_phrase_predicate(world, recs, "is common", 0.9, seed=24)
        lz = (_frame(p, recs, world, [], with_proxy=name == "proxy").lazy()
              .sem_filter("the {claim} is common").sem_filter("the {claim} is rare"))
        return _lazy(lz)
    return case


@pytest.mark.parametrize("name", ["unoptimized", "optimized", "prefilter", "pushdown",
                                  "fusion", "reorder", "proxy"])
def test_lazy_pipeline_matches_reference(name):
    got, want = _both(_plan_case(name))
    _assert_same(got, want)
    if name != "unoptimized":
        assert got["rewrites"], got["text"]


@pytest.mark.parametrize("name", ["unoptimized", "optimized", "pushdown"])
def test_lazy_equals_eager_in_the_port(name):
    """The port's lazy records equal its eager records (the reference's own
    contract, test_plan.py), here for the as-written pipelines."""
    left, right, world, *_ = tsynth.make_join_world(40, 10, seed=12)
    tsynth.add_phrase_predicate(world, left, "is checkable", 0.2, seed=12)
    tsynth.add_phrase_predicate(world, left, "is in English", 0.85, seed=12)
    eager = _frame(T, left, world)
    lazy = eager.lazy()
    if name == "pushdown":
        eager = eager.sem_join(right, JOIN).sem_filter("the {abstract} is checkable")
        lazy = lazy.sem_join(right, JOIN).sem_filter("the {abstract} is checkable")
    else:
        for lx in ("the {abstract} is in English", "the {abstract} is checkable"):
            eager, lazy = eager.sem_filter(lx), lazy.sem_filter(lx)
        eager, lazy = eager.sem_join(right, JOIN), lazy.sem_join(right, JOIN)
    assert lazy.collect(optimize=name != "unoptimized").records == eager.records


def test_plan_ir_matches_reference():
    def case(p):
        left, right, world, *_ = p.synth.make_join_world(5, 4, seed=20)
        plan = p.N.Join(p.N.Filter(p.N.Scan(left), "the {abstract} holds"),
                        p.N.Scan(right), JOIN)
        recs, fworld, *_ = p.synth.make_filter_world(10, seed=16)
        dep = p.N.Map(p.N.Map(p.N.Scan(recs), "a query for {claim}", out_column="q"),
                      "rewrite {q}", out_column="t")
        opt = p.opt.PlanOptimizer(_session(p, fworld))
        optimized = opt.optimize(dep)
        with pytest.raises(KeyError):
            _frame(p, recs, fworld).lazy().sem_filter("the {nope} holds")
        return dict(columns=sorted(plan.columns()), labels=[plan.label(), dep.label()],
                    text=p.opt.explain_plan(optimized), cost=p.opt.total_cost(plan),
                    applied=[str(r) for r in opt.applied])
    got, want = _both(case)
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# BatchedModelCache
# ---------------------------------------------------------------------------


def test_batched_model_cache_matches_reference():
    def case(p):
        recs, world, *_ = p.synth.make_filter_world(20, seed=18)
        model = lambda: p.Counted(p.synth.SimulatedModel(world, "oracle"), "oracle")  # noqa: E731
        prompts = [f"the {t['claim']} holds" for t in recs]
        out = []
        cache = p.Cache(model())
        for batch in (prompts + prompts[:5], prompts, prompts[3:9]):
            with p.acc.track("probe") as st:
                b, s = cache.predicate(batch)
            out.append((b.tolist(), s.tolist(), st.oracle_calls, st.cache_hits))
        small = p.Cache(model(), capacity=3)
        out.append(small.generate(prompts[:8]))
        for batch in ([prompts[0]], [prompts[1]], [prompts[0]], [prompts[2]],
                      [prompts[0], prompts[2]], [prompts[1]]):
            with p.acc.track("lru") as st:
                small.predicate(batch)
            out.append((st.oracle_calls, st.cache_hits))
        trecs, _, tmodel, _ = p.synth.make_topic_world(6, 3, seed=19)
        choose = p.Cache(p.Counted(tmodel, "oracle"))
        cp = [f"item {t['paper']}\n0. a\n1. b" for t in trecs]
        out.append((choose.choose(cp, 2).tolist(), choose.choose(cp, 3).tolist()))
        out.append((cache.hits, cache.misses, small.hits, small.misses, choose.misses))
        return dict(out=out)
    got, want = _both(case)
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# partitioned execution and sem_topk_partitioned (test_partition.py)
# ---------------------------------------------------------------------------


def _partition_case(name):
    def case(p):
        if name in ("filter", "cascade"):
            recs, world, *_ = p.synth.make_filter_world(120, seed=32)
            p.synth.add_phrase_predicate(world, recs, "is checkable", 0.4, seed=32)
            kw = dict(recall_target=0.9, precision_target=0.85) if name == "cascade" else {}
            lz = (_frame(p, recs, world, [], with_proxy=True).lazy()
                  .sem_filter("the {claim} is checkable", **kw))
            return _lazy(lz, **PART_KW, fragment_workers=4)
        if name == "topk":
            recs, world, *_ = p.synth.make_rank_world(64, compare_noise=0.0, seed=33)
            lz = _frame(p, recs, world, []).lazy().sem_topk("most accurate {abstract}", 6)
            return _lazy(lz, **PART_KW, fragment_workers=4)
        if name in ("agg", "group_agg"):
            recs, world, *_ = p.synth.make_topic_world(130, 3, seed=35)
            for i, t in enumerate(recs):
                t["bucket"] = 1 if i % 8 == 0 else 1.0 if i % 8 == 4 else f"b{i % 4}"
            lz = _frame(p, recs, world, []).lazy().sem_agg(
                "summarize {paper}", **({"group_by": "bucket"} if name == "group_agg" else {}))
            return _lazy(lz, **PART_KW, fragment_workers=4)
        left, right, world, *_ = p.synth.make_join_world(36, 9, seed=37)
        lz = _frame(p, left, world, []).lazy()
        if name == "simjoin":
            lz = lz.sem_sim_join(right, "abstract", "reaction", k=2, index_kind="exact")
            return _lazy(lz, **PART_KW, fragment_workers=4, shards=4)
        lz = lz.sem_join(right, JOIN)
        kw = {"broadcast_max_rows": 4} if name == "grid" else {}
        return _lazy(lz, **PART_KW, fragment_workers=4, **kw)
    return case


@pytest.mark.parametrize("name", ["filter", "cascade", "topk", "agg", "group_agg",
                                  "broadcast", "grid", "simjoin"])
def test_partitioned_execution_matches_reference(name):
    got, want = _both(_partition_case(name))
    _assert_same(got, want)
    assert any("partition" in r or "Exchange" in r or "fragment" in r
               for r in got["rewrites"]) or name == "simjoin", got["rewrites"]


def test_sem_topk_partitioned_matches_reference():
    def case(p):
        recs, world, model, *_ = p.synth.make_rank_world(40, compare_noise=0.08, seed=34)
        out = []
        for parts in ([list(range(0, 20)), list(range(20, 40))],
                      [list(range(0, 40, 3)), list(range(1, 40, 3)), list(range(2, 40, 3))]):
            counted = p.Counted(model, "oracle")
            idx, st = p.topk.sem_topk_partitioned(recs, "most accurate {abstract}", 5,
                                                  counted, parts, seed=1)
            out.append((idx, {k: v for k, v in st.items() if k != "wall_s"}))
        return dict(out=out)
    got, want = _both(case)
    _assert_same(got, want)
    assert got["out"][0][1]["n_partitions"] == 2


def test_partition_plumbing_matches_reference():
    def case(p):
        recs = [{"g": f"k{i % 5}", "v": (i * 7) % 20} for i in range(40)]
        mixed = [{"g": 1}, {"g": 1.0}, {"g": 2}, {"g": True}]
        splits = [p.par.contiguous_partitions(10, 4), p.par.hash_partitions(recs, 3, "g"),
                  p.par.hash_partitions(mixed, 3, "g"), p.par.range_partitions(recs, 4, "v"),
                  p.par.subtree_partitions(100, 8, 4), p.par.subtree_partitions(6, 8, 4)]
        frecs, world, *_ = p.synth.make_filter_world(80, seed=41)
        p.synth.add_phrase_predicate(world, frecs, "is rare", 0.2, seed=41)
        text = (_frame(p, frecs, world).lazy().sem_filter("the {claim} is rare")
                .explain(**PART_KW))
        trecs, tworld, *_ = p.synth.make_topic_world(100, 3, seed=45)
        opt = p.opt.PlanOptimizer(_session(p, tworld), n_partitions=4, partition_min_rows=8)
        plan = opt.optimize(p.N.Agg(p.N.Scan(trecs), "summarize {paper}", fanout=8))
        marked = p.N.Exchange(p.N.Filter(p.N.Partition(p.N.Scan(frecs), 4),
                                         "the {claim} is rare"), "gather", 4)
        return dict(splits=[[list(map(int, s)) for s in sp] for sp in splits], text=text,
                    agg=(p.opt.explain_plan(plan), [str(r) for r in opt.applied]),
                    records=p.exe.PlanExecutor(_session(p, world)).run(marked))
    got, want = _both(case)
    _assert_same(got, want)
    assert "Exchange[gather, P=4]" in got["text"]


# ---------------------------------------------------------------------------
# adaptive re-optimization (test_adaptive.py, test_block_join.py)
# ---------------------------------------------------------------------------


def _drift_world(p, n=80, seed=7):
    recs, world, *_ = p.synth.make_filter_world(n, seed=seed)
    p.synth.add_phrase_predicate(world, recs, "is broad", 0.9, seed=seed)
    p.synth.add_phrase_predicate(world, recs, "is narrow", 0.05, seed=seed)
    return recs, world


def _chain(frame, *filters):
    lz = frame.lazy().sem_map("a short note on {claim}", out_column="note")
    for lx in filters or ("the {claim} is broad", "the {claim} is narrow"):
        lz = lz.sem_filter(lx) if isinstance(lx, str) else lz.sem_filter(lx[0], **lx[1])
    return lz


def _replans(lz) -> list:
    ex = lz._exec_pair[2]
    return [(type(ex).__name__, e.kind, e.reason) for e in getattr(ex, "replans", [])]


def _adaptive_case(name):
    def case(p):
        out = {}
        if name in ("cold", "warm", "barrier"):
            recs, world = _drift_world(p, n=60 if name == "barrier" else 80,
                                       seed=9 if name == "barrier" else 7)
            filters = ()
            if name == "barrier":
                p.synth.add_phrase_predicate(world, recs, "is plausible", 0.5, seed=9)
                filters = ("the {claim} is broad",
                           ("the {claim} is plausible",
                            dict(recall_target=0.9, precision_target=0.85)),
                           "the {claim} is narrow")
            store = p.Store()
            if name != "cold":
                _chain(_frame(p, recs, world, with_proxy=True), *filters).collect(
                    stats_store=store)
            for adaptive in (False, True):
                log: list = []
                lz = _chain(_frame(p, recs, world, log, with_proxy=True), *filters)
                kw = dict(adaptive=True, stats_store=store) if adaptive else {}
                out[adaptive] = dict(records=lz.collect(**kw).records, log=logs(log),
                                     replans=_replans(lz))
        elif name == "retrieval":
            recs, world, *_ = p.synth.make_filter_world(400, seed=27)
            p.synth.add_phrase_predicate(world, recs, "is narrow", 0.04, seed=27)
            for adaptive in (False, True):
                log: list = []
                lz = (_frame(p, recs, world, log).lazy()
                      .sem_map("a short note on {claim}", out_column="note")
                      .sem_filter("the {claim} is narrow").sem_search("claim", "claim text 3",
                                                                      k=30))
                recs_out = lz.collect(adaptive=adaptive, index_min_corpus=100,
                                      index_shared=True).records
                out[adaptive] = dict(records=recs_out, log=logs(log), replans=_replans(lz),
                                     rewrites=[str(r) for r in lz.last_rewrites])
        elif name == "resize":
            recs, world = _drift_world(p, n=200, seed=5)
            for adaptive in (False, True):
                log: list = []
                lz = _chain(_frame(p, recs, world, log), "the {claim} is narrow",
                            "the {claim} is broad")
                out[adaptive] = dict(records=lz.collect(adaptive=adaptive,
                                                        n_partitions=4).records,
                                     log=logs(log), replans=_replans(lz))
        elif name == "zoo":
            left, right, world, *_ = p.synth.make_join_world(24, 8, seed=21)
            p.synth.add_phrase_predicate(world, left, "is checkable", 0.5, seed=21)
            for adaptive in (False, True):
                a = (_frame(p, left, world).lazy().sem_filter("the {abstract} is checkable")
                     .sem_join(right, JOIN).collect(adaptive=adaptive))
                s = (_frame(p, left, world).lazy()
                     .sem_sim_join(right, "abstract", "reaction", k=2)
                     .collect(adaptive=adaptive))
                rrecs, rworld, *_ = p.synth.make_rank_world(32, compare_noise=0.0, seed=23)
                r = (_frame(p, rrecs, rworld, sample_size=30).lazy()
                     .sem_topk("most accurate {abstract}", k=8)
                     .sem_map("a group for {abstract}", out_column="bucket")
                     .sem_agg("summarize: {abstract}", group_by="bucket", fanout=4)
                     .collect(adaptive=adaptive))
                out[adaptive] = dict(records=a.records + s.records + r.records)
        else:   # join strategy switched on drift
            left, right, world, *_ = p.synth.make_entity_world(200, 150, 12, seed=6)
            lx = "the {mention} refers to the same entity as {entity:right}"
            for pinned in (False, True):
                sess = _session(p, world)
                ex = p.Adaptive(sess, stats_log=[], oracle=sess.oracle,
                                embedder=sess.embedder)
                node = p.N.Join(p.N.Scan(left), p.N.Scan(right), lx, recall_target=0.9,
                                strategy="block", strategy_auto=not pinned)
                mask, st = ex._join_dispatch(node, left[:10], right[:8])
                out[pinned] = dict(mask=mask.tolist(), log=logs([st]),
                                   replans=[(e.kind, e.reason) for e in ex.replans])
        return out
    return case


@pytest.mark.parametrize("name", ["cold", "warm", "barrier", "retrieval", "resize", "zoo",
                                  "join_strategy"])
def test_adaptive_execution_matches_reference(name):
    got, want = _both(_adaptive_case(name))
    assert got.keys() == want.keys()
    for k in got:
        _assert_same(got[k], want[k])
    if name in ("warm", "retrieval", "resize"):
        assert got[True]["replans"], got[True]
    if "records" in got.get(False, {}) and name != "join_strategy":
        assert same_records(got[True]["records"], got[False]["records"])


def test_explain_surfaces_match_reference(monkeypatch):
    """explain_plan with observed selectivity, explain_analyze (wall times
    masked) plain and adaptive, and the REPRO_ADAPTIVE default."""
    def case(p):
        recs, world = _drift_world(p, n=60, seed=13)
        p.synth.add_phrase_predicate(world, recs, "is typical", 0.5, seed=13)
        filters = ("the {claim} is broad", "the {claim} is narrow", "the {claim} is typical")
        store = p.Store()
        rep1 = p.analyze(_chain(_frame(p, recs, world), *filters), stats_store=store)
        rep2 = p.analyze(_chain(_frame(p, recs, world), *filters), stats_store=store,
                         adaptive=True)
        left, right, jworld, *_ = p.synth.make_join_world(30, 8, seed=7)
        p.synth.add_phrase_predicate(jworld, left, "is checkable", 0.4, seed=7)
        pipe = lambda: (_frame(p, left, jworld, sample_size=40).lazy()  # noqa: E731
                        .sem_filter("the {abstract} is checkable").sem_join(right, JOIN))
        rep3 = p.analyze(pipe(), tolerance=1e-6)
        rep4 = p.analyze(pipe(), optimize=False)
        kinds = []
        for flag in ("1", "0"):
            monkeypatch.setenv("REPRO_ADAPTIVE", flag)
            f = _frame(p, recs, world).lazy().sem_filter("the {claim} is broad")
            f.collect()
            kinds.append(type(f._exec_pair[2]).__name__)
        monkeypatch.delenv("REPRO_ADAPTIVE")
        return dict(records=rep1.records + rep2.records + rep3.records + rep4.records,
                    text=[_WALL.sub("wall <t>", r.render()) for r in (rep1, rep2, rep3, rep4)],
                    sel_obs=_chain(_frame(p, recs, world), *filters).explain(stats_store=store),
                    kinds=kinds)
    got, want = _both(case)
    _assert_same(got, want)
    assert ">> replanned:" in got["text"][1] and "sel_obs=" in got["sel_obs"]
    assert got["kinds"] == ["AdaptivePlanExecutor", "PartitionedExecutor"]


# ---------------------------------------------------------------------------
# end-to-end simulated pipelines (test_system.py)
# ---------------------------------------------------------------------------


def _system_case(name):
    def case(p):
        log: list = []
        if name == "factcheck":
            recs, world, oracle, proxy, emb = p.synth.make_filter_world(
                300, positive_rate=0.45, proxy_alpha=2.5, seed=42)
            sess = p.frame.Session(oracle=oracle, proxy=proxy, embedder=emb, sample_size=150)
            mapped = p.frame.SemFrame(recs, sess, log).sem_map(
                "write a search query for {claim}", out_column="query")
            out = mapped.sem_filter("the {claim} is supported", recall_target=0.9,
                                    precision_target=0.9, delta=0.2)
        elif name == "ranking":
            recs, world, model, emb, _ = p.synth.make_rank_world(80, seed=45)
            sess = p.frame.Session(oracle=model, embedder=emb)
            out = p.frame.SemFrame(recs, sess, log).sem_topk(
                "the {abstract} reports the highest accuracy", 10,
                pivot_query="highest accuracy")
        else:
            recs, world, model, emb = p.synth.make_topic_world(40, 3, seed=46)
            with p.acc.track("outer") as outer:
                out = p.frame.SemFrame(recs, p.frame.Session(oracle=model, embedder=emb),
                                       log).sem_map("label {paper}")
            log.append(outer.as_dict())
        return dict(records=out.records, log=logs(log))
    return case


@pytest.mark.parametrize("name", ["factcheck", "ranking", "nested"])
def test_system_pipeline_matches_reference(name):
    got, want = _both(_system_case(name))
    _assert_same(got, want)


@pytest.mark.parametrize("name", ["biodex", "topics"])
def test_planes_pipeline_matches_reference(name, monkeypatch):
    """test_system.py's BioDEX join (a cascade over the projected plane,
    whose true pairs tie at 1.0) and topic analysis (a cascade group-by whose
    centres are copies of candidate labels' own vectors, so they too tie at
    1.0) through SemFrame: identical on the reference's planes, and on the
    port's own wherever no tie changed order."""
    tmod, jmod = (tjoin, jjoin) if name == "biodex" else (tgroupby, jgroupby)
    if name == "biodex":
        worlds = [p.synth.make_join_world(40, 30, labels_per_left=2, sim_correlation=0.0,
                                          seed=43) for p in (T, J)]
    else:
        worlds = [p.synth.make_topic_world(150, 4, seed=44) for p in (T, J)]

    def run(mod):
        p, w = (T, worlds[0]) if mod is tmod else (J, worlds[1])
        log: list = []
        if name == "biodex":
            left, right, world, oracle, proxy, emb = w
            sess = p.frame.Session(oracle=oracle, proxy=proxy, embedder=emb, sample_size=150)
            out = p.frame.SemFrame(left, sess, log).sem_join(
                right, JOIN, recall_target=0.8, precision_target=0.8, delta=0.2)
            return dict(records=out.records, log=logs(log))
        recs, world, model, emb = w
        sess = p.frame.Session(oracle=model, embedder=emb, sample_size=60)
        grouped = p.frame.SemFrame(recs, sess, log).sem_group_by(
            "the topic of each {paper}", 4, accuracy_target=0.85, delta=0.2)
        return dict(records=grouped.records, log=logs(log),
                    agg=grouped.sem_agg("summarize: {paper}", group_by="group_label"))
    got, want, replayed, ties = with_planes(monkeypatch, run, tmod, jmod)
    _assert_same(replayed, want)
    if not ties:
        _assert_same(got, want)
    if name == "biodex":
        assert want["log"][-1]["plan"] in ("sim-filter", "project-sim-filter")
    assert want["records"]
