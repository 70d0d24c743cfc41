"""The port's serving layer, held to the reference's own serving tests.

Each test of ``tests/test_serve.py`` runs here unchanged but for its
imports, which name ``repro_torch``, and a timeout on each thread join: dispatcher fusion, shared-cache
TTL/eviction/persistence, gateway admission/fairness/cancellation/deadlines,
per-session accounting, ``CountedModel`` role attribution and the
scheduler's retry reset.  The parity tests at the end run the same
simulated sessions through both packages' gateways and hold the port to the
reference's records and bills.
"""
import threading
import time
import types

import numpy as np
import pytest

import repro_torch
from repro.core.backends import synth as jsynth
from repro.core.backends.testing import CountingBackend as JCounting
from repro.core.frame import SemFrame as JSemFrame
from repro.core.frame import Session as JSession
from repro.serve import Gateway as JGateway
from repro.serve import SharedSemanticCache as JStore
from repro_torch.core import accounting
from repro_torch.core.backends import synth
from repro_torch.core.backends.base import CountedModel
from repro_torch.core.backends.testing import CountingBackend
from repro_torch.core.frame import SemFrame, Session
from repro_torch.core.plan.cache import BatchedModelCache
from repro_torch.engine.scheduler import ContinuousBatchScheduler, Request
from repro_torch.serve import (AdmissionError, DispatchError, Gateway,
                               MicroBatchDispatcher, SessionCancelled,
                               SessionDeadlineExceeded, SharedSemanticCache)
from repro_torch.serve.dispatch import DispatchedModel


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _world(n=24, seed=3):
    left, right, world, *_ = synth.make_join_world(n, 8, seed=seed)
    synth.add_phrase_predicate(world, left, "is checkable", 0.4, seed=seed)
    synth.add_phrase_predicate(world, left, "is recent", 0.3, seed=seed)
    return left, right, world


def _session(world, *, oracle=None):
    return Session(oracle=oracle or synth.SimulatedModel(world, "oracle"),
                   embedder=synth.SimulatedEmbedder(world), sample_size=30)


def _pipeline(records, right, session):
    return (SemFrame(records, session).lazy()
            .sem_filter("the {abstract} is checkable")
            .sem_join(right, "the {abstract} reports the {reaction:right}"))


# ---------------------------------------------------------------------------
# dispatcher: cross-query micro-batch fusion
# ---------------------------------------------------------------------------


def test_dispatcher_fuses_concurrent_calls_into_one_backend_batch():
    left, _, world = _world()
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"))
    d = MicroBatchDispatcher(oracle=backend, window_s=0.05, max_batch=1000)
    prompts_a = [f"the {t['abstract']} is checkable" for t in left[:10]]
    prompts_b = [f"the {t['abstract']} is checkable" for t in left[10:20]]
    out = {}

    def call(name, ps):
        out[name] = DispatchedModel(d, "oracle", tag=name).predicate(ps)

    threads = [threading.Thread(target=call, args=("a", prompts_a)),
               threading.Thread(target=call, args=("b", prompts_b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    d.close()
    assert len(backend.batches) == 1            # one fused backend batch
    assert backend.n_prompts == 20
    # each caller got rows for exactly its own prompts, in its own order
    direct = synth.SimulatedModel(world, "oracle")
    np.testing.assert_array_equal(out["a"][0], direct.predicate(prompts_a)[0])
    np.testing.assert_array_equal(out["b"][0], direct.predicate(prompts_b)[0])
    assert d.stats()["fused_calls"] == 2 and d.stats()["fused_batches"] == 1


def test_dispatcher_dedups_shared_prompts_and_attributes_owners():
    left, _, world = _world()
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"))
    d = MicroBatchDispatcher(oracle=backend, window_s=0.05, max_batch=1000)
    shared = [f"the {t['abstract']} is checkable" for t in left[:12]]
    results = {}

    def call(name):
        with accounting.track(name) as st:
            DispatchedModel(d, "oracle", tag=name).predicate(shared)
        results[name] = st

    threads = [threading.Thread(target=call, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    d.close()
    assert backend.n_prompts == 12              # dedup across the two callers
    sts = [results["a"], results["b"]]
    assert sorted(st.oracle_calls for st in sts) == [0, 12]   # one owner pays
    assert sorted(st.cache_hits for st in sts) == [0, 12]     # one rides free
    assert d.stats()["cross_shared"] == 12


def test_dispatcher_size_trigger_flushes_before_window():
    left, _, world = _world()
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"))
    d = MicroBatchDispatcher(oracle=backend, window_s=5.0, max_batch=8)
    prompts = [f"the {t['abstract']} is checkable" for t in left[:8]]
    t0 = time.monotonic()
    DispatchedModel(d, "oracle").predicate(prompts)
    elapsed = time.monotonic() - t0
    d.close()
    assert elapsed < 1.0                        # did not wait out the window
    assert backend.n_prompts == 8


def test_dispatcher_propagates_backend_errors_to_all_callers():
    class Exploding:
        def predicate(self, prompts):
            raise RuntimeError("backend down")

    d = MicroBatchDispatcher(oracle=Exploding(), window_s=0.02)
    errors = []

    def call():
        try:
            DispatchedModel(d, "oracle").predicate(["p1", "p2"])
        except DispatchError as exc:
            errors.append(exc)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    d.close()
    assert len(errors) == 2


def test_dispatcher_buckets_choose_by_n_options():
    records, _world2, model, _emb = synth.make_topic_world(6, 3, seed=9)
    backend = CountingBackend(model)
    d = MicroBatchDispatcher(oracle=backend, window_s=0.02)
    h = DispatchedModel(d, "oracle")
    prompts = [f"item {t['paper']}\n0. a\n1. b" for t in records]
    a = h.choose(prompts, 2)
    b = h.choose(prompts, 3)
    d.close()
    assert a.shape == b.shape == (6,)
    assert len(backend.batches) == 2            # separate buckets per arity


# ---------------------------------------------------------------------------
# shared semantic cache: TTL, eviction, namespaces, persistence
# ---------------------------------------------------------------------------


def test_store_ttl_expiry_forces_reissue():
    clock = {"t": 0.0}
    store = SharedSemanticCache(ttl_s=10.0, clock=lambda: clock["t"])
    store.put(("oracle", "predicate", "p"), [True, 0.9], owner="s1")
    assert store.get(("oracle", "predicate", "p"))[0]
    clock["t"] = 9.9
    assert store.get(("oracle", "predicate", "p"))[0]   # still fresh
    clock["t"] = 20.0
    found, _ = store.get(("oracle", "predicate", "p"))
    assert not found and store.expirations == 1


def test_store_lru_eviction_order():
    store = SharedSemanticCache(capacity=2)
    store.put(("oracle", "g", "a"), 1)
    store.put(("oracle", "g", "b"), 2)
    store.get(("oracle", "g", "a"))             # refresh a; b is now LRU
    store.put(("oracle", "g", "c"), 3)
    assert ("oracle", "g", "a") in store
    assert ("oracle", "g", "b") not in store    # evicted
    assert ("oracle", "g", "c") in store
    assert store.evictions == 1


def test_store_namespaces_isolate_roles():
    store = SharedSemanticCache()
    store.put(("oracle", "predicate", "p"), [True, 0.99])
    assert not store.get(("proxy", "predicate", "p"))[0]


def test_store_persistence_roundtrip(tmp_path):
    path = str(tmp_path / "semcache.jsonl")
    s1 = SharedSemanticCache(persist_path=path)
    s1.put(("oracle", "predicate", "p1"), [True, 0.9], owner="runA")
    s1.put(("oracle", "generate", "p2"), "answer", owner="runA")
    s1.put(("embed", "embed", "p3"), [0.1, 0.2])    # memory-only namespace
    s1.close()
    s2 = SharedSemanticCache(persist_path=path)
    assert s2.loaded == 2
    found, row = s2.get(("oracle", "predicate", "p1"), requester="runB")
    assert found and row == [True, 0.9]
    assert s2.cross_hits == 1                   # owner runA != requester runB
    assert not s2.get(("embed", "embed", "p3"))[0]
    s2.close()


def test_batched_cache_shared_store_two_executors(tmp_path):
    """Satellite: two executors over one store — the second pays nothing,
    and TTL expiry makes it pay again."""
    records, world, *_ = synth.make_filter_world(15, seed=31)
    clock = {"t": 0.0}
    store = SharedSemanticCache(ttl_s=100.0, clock=lambda: clock["t"])
    prompts = [f"the {t['claim']} holds" for t in records]

    def run(requester):
        cached = BatchedModelCache(
            CountedModel(synth.SimulatedModel(world, "oracle"), "oracle"),
            store=store, namespace="oracle", requester=requester)
        with accounting.track(requester) as st:
            passed, _ = cached.predicate(prompts)
        return passed, st

    b1, st1 = run("exec1")
    b2, st2 = run("exec2")
    assert st1.oracle_calls == 15 and st1.cache_hits == 0
    assert st2.oracle_calls == 0 and st2.cache_hits == 15   # shared hits
    assert store.cross_hits == 15
    np.testing.assert_array_equal(b1, b2)
    clock["t"] = 200.0                          # everything expires
    b3, st3 = run("exec3")
    assert st3.oracle_calls == 15 and st3.cache_hits == 0   # re-issued
    np.testing.assert_array_equal(b1, b3)


# ---------------------------------------------------------------------------
# gateway: concurrency, admission, fairness, cancellation, deadlines
# ---------------------------------------------------------------------------


def test_gateway_concurrent_sessions_match_serial_results():
    left, right, world = _world(n=30, seed=7)
    serial = []
    for _ in range(4):
        serial.append(_pipeline(left, right, _session(world)).collect().records)

    with Gateway(_session(world), max_inflight=4, window_s=0.02) as gw:
        handles = [gw.submit(_pipeline(left, right, gw.session))
                   for _ in range(4)]
        rows = [h.result(timeout=60) for h in handles]
        snap = gw.snapshot()
    assert rows == serial
    assert snap["completed"] == 4 and snap["failed"] == 0
    assert snap["p95_latency_s"] is not None


def test_gateway_cross_query_sharing_beats_serial_backend_cost():
    left, right, world = _world(n=30, seed=8)
    serial_backend = CountingBackend(synth.SimulatedModel(world, "oracle"))
    for _ in range(4):
        _pipeline(left, right, _session(world, oracle=serial_backend)).collect()
    serial_prompts = serial_backend.n_prompts

    shared_backend = CountingBackend(synth.SimulatedModel(world, "oracle"))
    with Gateway(_session(world, oracle=shared_backend), max_inflight=4,
                 window_s=0.02) as gw:
        handles = [gw.submit(_pipeline(left, right, gw.session))
                   for _ in range(4)]
        for h in handles:
            h.result(timeout=60)
        snap = gw.snapshot()
    assert shared_backend.n_prompts < serial_prompts
    assert shared_backend.n_prompts <= serial_prompts / 2   # ~4x sharing
    assert snap["cross_query_hit_rate"] > 0


def test_gateway_admission_rejects_when_queue_full():
    left, right, world = _world(n=12, seed=10)
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"),
                              slow_marker="<rec:", slow_s=0.4)
    gw = Gateway(_session(world, oracle=backend), max_inflight=1,
                 max_pending=1, window_s=0.005)
    try:
        first = gw.submit(_pipeline(left, right, gw.session))
        backend.first_prompt.wait(5.0)          # worker is now busy
        second = gw.submit(_pipeline(left, right, gw.session))  # fills queue
        with pytest.raises(AdmissionError):
            gw.submit(_pipeline(left, right, gw.session))
        assert gw.snapshot()["rejected"] == 1
        first.result(timeout=60)
        second.result(timeout=60)
    finally:
        gw.close()


def test_gateway_fairness_round_robin_across_tenants():
    left, right, world = _world(n=10, seed=11)
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"),
                              slow_marker="<rec:", slow_s=0.05)
    gw = Gateway(_session(world, oracle=backend), max_inflight=1,
                 window_s=0.002)
    try:
        plan = lambda: _pipeline(left, right, gw.session)  # noqa: E731
        blocker = gw.submit(plan(), tenant="A")
        backend.first_prompt.wait(5.0)
        a2 = gw.submit(plan(), tenant="A")
        a3 = gw.submit(plan(), tenant="A")
        b1 = gw.submit(plan(), tenant="B")      # submitted last, tenant B
        for h in (blocker, a2, a3, b1):
            h.result(timeout=60)
        # round-robin: B's first session starts before A's backlog drains
        assert b1.started_at < a3.started_at
    finally:
        gw.close()


def test_gateway_cancel_queued_session():
    left, right, world = _world(n=10, seed=12)
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"),
                              slow_marker="<rec:", slow_s=0.3)
    gw = Gateway(_session(world, oracle=backend), max_inflight=1,
                 window_s=0.005)
    try:
        blocker = gw.submit(_pipeline(left, right, gw.session))
        backend.first_prompt.wait(5.0)
        victim = gw.submit(_pipeline(left, right, gw.session))
        victim.cancel()
        with pytest.raises(SessionCancelled):
            victim.result(timeout=60)
        assert victim.status == "cancelled"
        blocker.result(timeout=60)
        assert gw.snapshot()["cancelled"] == 1
    finally:
        gw.close()


def test_gateway_cancel_running_session_between_stages():
    left, right, world = _world(n=10, seed=13)
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"),
                              slow_marker="is checkable", slow_s=0.3)
    gw = Gateway(_session(world, oracle=backend), max_inflight=1,
                 window_s=0.005)
    try:
        # filter (slow) then join: cancel lands at the stage boundary
        sess = gw.submit(_pipeline(left, right, gw.session), optimize=False)
        backend.first_prompt.wait(5.0)          # stage 1 model work started
        sess.cancel()
        with pytest.raises(SessionCancelled):
            sess.result(timeout=60)
        assert not backend.saw("reports the")   # join stage never issued
    finally:
        gw.close()


def test_gateway_deadline_expires_session():
    left, right, world = _world(n=10, seed=14)
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"),
                              slow_marker="<rec:", slow_s=0.4)
    gw = Gateway(_session(world, oracle=backend), max_inflight=1,
                 window_s=0.005)
    try:
        blocker = gw.submit(_pipeline(left, right, gw.session))
        backend.first_prompt.wait(5.0)
        doomed = gw.submit(_pipeline(left, right, gw.session), deadline_s=0.05)
        with pytest.raises(SessionDeadlineExceeded):
            doomed.result(timeout=60)
        assert doomed.status == "expired"
        blocker.result(timeout=60)
        assert gw.snapshot()["expired"] == 1
    finally:
        gw.close()


def test_gateway_per_session_stats_rollup():
    left, right, world = _world(n=20, seed=15)
    with Gateway(_session(world), max_inflight=2, window_s=0.01) as gw:
        handles = [gw.submit(_pipeline(left, right, gw.session))
                   for _ in range(3)]
        for h in handles:
            h.result(timeout=60)
    for h in handles:
        assert h.stats is not None
        # every prompt a session asked for was either paid for or shared
        assert h.stats.oracle_calls + h.stats.cache_hits > 0
        assert h.stats.wall_s > 0
        assert h.summary()["stats"]["oracle_calls"] == h.stats.oracle_calls
    # sharing means the 3 sessions together paid for one session's prompts
    paid = sum(h.stats.oracle_calls for h in handles)
    asked = [h.stats.oracle_calls + h.stats.cache_hits for h in handles]
    assert paid <= min(asked) + 5               # probes/races tolerance


# ---------------------------------------------------------------------------
# satellites: CountedModel attribution, scheduler retry reset
# ---------------------------------------------------------------------------


def test_counted_model_attributes_all_kinds_to_role():
    records, world, *_ = synth.make_filter_world(6, seed=40)
    oracle = CountedModel(synth.SimulatedModel(world, "oracle"), "oracle")
    prompts = [f"the {t['claim']} holds" for t in records]
    with accounting.track("op") as st:
        oracle.predicate(prompts)
        oracle.generate(prompts)
        oracle.compare([f"{p} vs {p}" for p in prompts])
        oracle.choose([f"{p}\n0. a\n1. b" for p in prompts], 2)
    assert st.oracle_calls == 24                # all four kinds attributed
    assert st.generate_calls == 6               # per-kind columns preserved
    assert st.compare_calls == 6
    assert st.lm_calls == 24                    # no double counting


class _StubRunner:
    max_slots = 2
    max_seq = 64

    def prefill_into_slot(self, tokens, slot, extra=None):
        return np.eye(8)[3] * 5.0               # always argmax -> token 3

    def decode(self, slot_next, slot_len):
        return np.tile(np.eye(8)[4] * 5.0, (self.max_slots, 1))


def test_scheduler_prefill_failure_resets_retry_state():
    fail = {"n": 2}

    def flaky():
        if fail["n"] > 0:
            fail["n"] -= 1
            raise RuntimeError("injected prefill fault")

    sched = ContinuousBatchScheduler(_StubRunner(), fault_hook=flaky,
                                     max_retries=3)
    req = Request(rid=0, tokens=np.array([1, 2], np.int32), max_new_tokens=3)
    req.out_tokens = [9, 9]                     # stale state from a past life
    req.started_at = time.monotonic() - 999.0
    sched.submit(req)
    done = sched.run_to_completion()
    assert len(done) == 1 and done[0].done and not done[0].failed
    assert done[0].retries == 2
    # retry reset: no stale tokens leaked into the final output
    assert done[0].out_tokens == [3, 4, 4]


def test_scheduler_exhausted_retries_reports_failure_with_clean_state():
    def always_fail():
        raise RuntimeError("injected fault")

    sched = ContinuousBatchScheduler(_StubRunner(), fault_hook=always_fail,
                                     max_retries=1)
    req = Request(rid=0, tokens=np.array([1, 2], np.int32), max_new_tokens=3)
    sched.submit(req)
    done = sched.run_to_completion()
    assert len(done) == 1 and done[0].failed and not done[0].done
    assert done[0].out_tokens == [] and done[0].started_at is None


# ---------------------------------------------------------------------------
# parity with the reference: the same sessions through both gateways
# ---------------------------------------------------------------------------

J = types.SimpleNamespace(synth=jsynth, Counting=JCounting, SemFrame=JSemFrame,
                          Session=JSession, Gateway=JGateway, Store=JStore)
T = types.SimpleNamespace(synth=synth, Counting=CountingBackend, SemFrame=SemFrame,
                          Session=Session, Gateway=Gateway, Store=SharedSemanticCache)
_JOIN = "the {abstract} reports the {reaction:right}"
_PREDICATES = ("the {abstract} is checkable", "the {abstract} is recent")


def _served(p, *, max_inflight, n_sessions=6, cascade=False):
    """``n_sessions`` pipelines over two tenants, alternating between two
    predicates (so sessions share prompts across queries), through ``p``'s
    Gateway -> (records per session, bills, snapshot, counting backend)."""
    left, right, world, *_ = p.synth.make_join_world(30, 8, seed=17)
    p.synth.add_phrase_predicate(world, left, "is checkable", 0.4, seed=17)
    p.synth.add_phrase_predicate(world, left, "is recent", 0.3, seed=17)
    backend = p.Counting(p.synth.SimulatedModel(world, "oracle"))
    sess = p.Session(oracle=backend,
                     proxy=p.synth.SimulatedModel(world, "proxy", alpha=2.5),
                     embedder=p.synth.SimulatedEmbedder(world), sample_size=30)
    targets = {"recall_target": 0.9, "precision_target": 0.9} if cascade else {}
    with p.Gateway(sess, max_inflight=max_inflight, window_s=0.01) as gw:
        handles = [gw.submit(p.SemFrame(left, gw.session).lazy()
                             .sem_filter(_PREDICATES[i % 2], **targets)
                             .sem_join(right, _JOIN), tenant=f"t{i % 2}")
                   for i in range(n_sessions)]
        rows = [h.result(timeout=60) for h in handles]
        bills = [{k: v for k, v in h.summary()["stats"].items()
                  if k not in ("wall_s", "operator")} for h in handles]
        assert [h.status for h in handles] == ["done"] * n_sessions
        snap = gw.snapshot()
    return rows, bills, snap, backend


def _asked(bill: dict) -> int:
    return bill["lm_calls"] + bill["cache_hits"]


@pytest.mark.parametrize("cascade", [False, True], ids=["gold", "cascade"])
def test_concurrent_gateway_matches_reference(cascade):
    """Four sessions at once: which session pays for a shared prompt depends
    on thread timing, so the parity is on records, on what each session
    asked for, and on the backend's unique prompts (each exactly once)."""
    jrows, jbills, jsnap, jback = _served(J, max_inflight=4, cascade=cascade)
    trows, tbills, tsnap, tback = _served(T, max_inflight=4, cascade=cascade)
    assert trows == jrows
    assert [_asked(b) for b in tbills] == [_asked(b) for b in jbills]
    for back in (jback, tback):
        sent = [p for b in back.batches for p in b]
        assert len(sent) == len(set(sent))          # no prompt reached it twice
    assert sorted(p for b in tback.batches for p in b) == \
        sorted(p for b in jback.batches for p in b)
    for key in ("completed", "failed", "rejected", "cancelled", "expired"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["dispatch"]["backend_prompts"] == jsnap["dispatch"]["backend_prompts"]
    assert tsnap["cache"]["entries"] == jsnap["cache"]["entries"]


@pytest.mark.parametrize("cascade", [False, True], ids=["gold", "cascade"])
def test_serial_gateway_bills_match_reference(cascade):
    """One session at a time: ownership is deterministic, so every bill and
    the dispatcher's and cache's counters equal the reference's."""
    jrows, jbills, jsnap, jback = _served(J, max_inflight=1, cascade=cascade)
    trows, tbills, tsnap, tback = _served(T, max_inflight=1, cascade=cascade)
    assert trows == jrows
    assert tbills == jbills
    assert tback.batches == jback.batches
    for key in ("backend_prompts", "requested_prompts", "cross_shared"):
        assert tsnap["dispatch"][key] == jsnap["dispatch"][key], key
    assert tsnap["cache"] == jsnap["cache"]


def test_store_persisted_log_reads_back_in_the_reference(tmp_path):
    """The JSONL log one package writes, the other loads: same rows, same
    counts."""
    for write, read in ((T, J), (J, T)):
        path = str(tmp_path / f"{id(write)}.jsonl")
        s1 = write.Store(persist_path=path)
        s1.put(("oracle", "predicate", "p1"), [True, 0.75], owner="a")
        s1.put(("oracle", "generate", "p2"), "text", owner="a")
        s1.put(("oracle", "choose", 3, "p3"), 2, owner="a")
        s1.put(("embed", "embed", "p4"), [0.5])       # memory-only namespace
        s1.close()
        s2 = read.Store(persist_path=path)
        assert s2.loaded == 3
        assert s2.get(("oracle", "predicate", "p1"), requester="b") == (True, [True, 0.75])
        assert s2.get(("oracle", "choose", 3, "p3")) == (True, 2)
        assert not s2.get(("embed", "embed", "p4"))[0]
        s2.close()
