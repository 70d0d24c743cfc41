"""The port's streaming layer, held to the reference's own streaming tests.

Each test of ``tests/test_stream.py`` runs here unchanged but for its
imports, which name ``repro_torch``, and a timeout on each thread join: ``CorpusTable`` versioning and delta
log, incremental index maintenance (exact append, IVF delta buffer, drift
retrain), the versioned ``IndexRegistry``, continuous queries through the
gateway, store log compaction, registry eviction and nprobe interpolation.
The parity tests at the end run the same table, commits and continuous
queries through both packages and hold the port to the reference's
emissions and registry counts.
"""
import gc
import os
import threading
import types
import weakref

import numpy as np
import pytest

import repro_torch
from repro.core.backends import synth as jsynth
from repro.core.frame import SemFrame as JSemFrame
from repro.core.frame import Session as JSession
from repro.kernels import ref as jref
from repro.serve import Gateway as JGateway
from repro.stream import CorpusTable as JTable
from repro_torch.core.backends import synth
from repro_torch.core.backends.testing import CountingBackend
from repro_torch.core.frame import SemFrame, Session
from repro_torch.core.plan import nodes as N
from repro_torch.index import IVFIndex, VectorIndex, build_index, nprobe_for_recall
from repro_torch.kernels import ops as kops
from repro_torch.serve import Gateway, IndexRegistry, SharedSemanticCache
from repro_torch.stream import CorpusTable, pin_stream_scans


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _clustered(n, d=32, n_centers=16, noise=0.15, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(n_centers, size=n)
    x = centers[lab] + noise * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return np.asarray(x, np.float32)


class _LookupEmbedder:
    """texts are integer strings indexing a fixed vector matrix."""

    index_key = "lookup@test"

    def __init__(self, vectors):
        self.vectors = vectors
        self.calls = 0

    @property
    def dim(self):
        return self.vectors.shape[1]

    def embed(self, texts):
        self.calls += len(texts)
        return self.vectors[[int(t) for t in texts]]


def _filter_world(n=40, seed=7):
    records, world, *_ = synth.make_filter_world(n, seed=seed)
    return records, world


def _new_rows(world, start, n, *, rate=0.5, seed=123):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(start, start + n):
        rid = f"claim{i}"
        world.filter_truth[rid] = bool(rng.random() < rate)
        rows.append({"id": rid, "claim": f"claim text {i} {synth.tag(rid)}"})
    return rows


# ---------------------------------------------------------------------------
# CorpusTable: versions, snapshots, delta log
# ---------------------------------------------------------------------------


def test_table_versions_snapshots_and_delta():
    t = CorpusTable([{"a": 1}, {"a": 2}])
    assert t.version == 1 and len(t) == 2
    v2 = t.append([{"a": 3}])
    rid = t.row_ids()[0]
    v3 = t.update(rid, {"a": 10})
    v4 = t.delete(t.row_ids()[1])
    assert (v2, v3, v4) == (2, 3, 4)
    # historical snapshots replay the log exactly
    assert [r["a"] for r in t.snapshot(1)] == [1, 2]
    assert [r["a"] for r in t.snapshot(2)] == [1, 2, 3]
    assert [r["a"] for r in t.snapshot(3)] == [10, 2, 3]
    assert [r["a"] for r in t.snapshot()] == [10, 3]
    # net delta over the whole range: the updated row, the deleted row, the
    # appended row
    d = t.delta(1)
    assert [r["a"] for _, r in d.added] == [3]
    assert [r["a"] for _, r in d.updated] == [10]
    assert len(d.deleted) == 1 and not d.appends_only
    # appends-only window satisfies the alignment contract
    d12 = t.delta(1, 2)
    assert d12.appends_only
    assert t.snapshot(2) == t.snapshot(1) + [r for _, r in d12.added]


def test_table_add_then_delete_cancels_and_listeners_fire():
    t = CorpusTable([{"a": 1}])
    seen = []
    t.add_listener(seen.append)
    v = t.append([{"a": 2}])
    rid = t.row_ids()[-1]
    t.delete(rid)
    d = t.delta(v - 1)
    assert not d.added and not d.deleted and not d.updated  # net no-op
    assert seen == [2, 3]
    t.remove_listener(seen.append)
    t.append([{"a": 4}])
    assert seen == [2, 3]


# ---------------------------------------------------------------------------
# incremental index maintenance
# ---------------------------------------------------------------------------


def test_exact_index_add_matches_fresh_build():
    x = _clustered(600, seed=1)
    base = VectorIndex(x[:500])
    base.add(x[500:])
    fresh = VectorIndex(x)
    q = x[500:508] + 0.01
    s1, i1 = base.search(q, 10)
    s2, i2 = fresh.search(q, 10)
    assert np.array_equal(i1, i2) and np.allclose(s1, s2)


def test_ivf_append_search_recall_contract():
    x = _clustered(4400, seed=2)
    ivf = IVFIndex(x[:4000], seed=3, retrain="off")
    ivf.add(x[4000:])
    assert ivf.delta_rows == 400 and ivf.drift() == pytest.approx(0.1)
    q = x[4000:4016] + 0.01
    _, ei = VectorIndex(x).search(q, 10)
    _, ii = ivf.search(q, 10)
    recall = np.mean([len(set(ei[r]) & set(ii[r])) / 10 for r in range(len(q))])
    # delta rows are exact-scanned: queries near them must recover them
    assert recall >= 0.95
    st = ivf.last_stats
    assert st["delta_rows"] == 400 and st["delta_scored"] == len(q) * 400
    assert st["scored_vectors"] < len(q) * len(x)  # still pruned vs exact


def test_ivf_degenerate_with_delta_is_exact():
    x = _clustered(1000, seed=5)
    ivf = IVFIndex(x[:900], n_clusters=24, seed=5, retrain="off")
    ivf.add(x[900:])
    q = x[::173][:6] + 0.01
    _, de = VectorIndex(x).search(q, 8)
    _, dv = ivf.search(q, 8, nprobe=ivf.n_clusters)
    assert np.array_equal(de, dv)


def test_ivf_spill_then_retrain_equivalent_to_fresh_build():
    x = _clustered(3000, seed=4)
    ivf = IVFIndex(x[:2500], seed=9, retrain="sync", spill_threshold=0.10)
    ivf.add(x[2500:])                       # 20% spill -> sync retrain
    assert ivf.retrains == 1 and ivf.delta_rows == 0
    fresh = IVFIndex(x, seed=9)
    assert np.allclose(ivf.centroids, fresh.centroids)
    assert np.array_equal(ivf.assign, fresh.assign)
    q = x[::311][:8] + 0.01
    s1, i1 = ivf.search(q, 10)
    s2, i2 = fresh.search(q, 10)
    assert np.array_equal(i1, i2) and np.allclose(s1, s2)


def test_ivf_background_retrain_swaps_atomically():
    x = _clustered(3000, seed=6)
    ivf = IVFIndex(x[:2500], seed=6, retrain="background",
                   spill_threshold=0.10)
    ivf.add(x[2500:])
    ivf.wait_retrain(timeout=60.0)
    assert ivf.retrains == 1 and ivf.delta_rows == 0
    _, i1 = ivf.search(x[:4] + 0.01, 5)
    _, i2 = IVFIndex(x, seed=6).search(x[:4] + 0.01, 5)
    assert np.array_equal(i1, i2)


def test_search_max_pos_cutoff_bounds_results_to_snapshot():
    x = _clustered(1000, seed=19)
    exact_prefix = VectorIndex(x[:700])
    q = x[690:698] + 0.01
    se, ie = exact_prefix.search(q, 8)
    # exact: cutoff == searching the prefix corpus
    full = VectorIndex(x)
    sc, ic = full.search(q, 8, max_pos=700)
    assert np.array_equal(ic, ie) and np.allclose(sc, se)
    # IVF degenerate (nprobe=all, delta buffer included): cutoff == exact
    # over the prefix
    ivf = IVFIndex(x[:900], n_clusters=16, seed=19, retrain="off")
    ivf.add(x[900:])
    si, ii = ivf.search(q, 8, nprobe=ivf.n_clusters, max_pos=700)
    assert np.array_equal(ii, ie)
    assert (ii < 700).all()


def test_max_pos_probe_floor_still_yields_k_results():
    # delta rows beyond the cutoff must not count toward the k-candidate
    # probe floor: a version-pinned search still has to fill k slots from
    # the main store
    from repro_torch.index.backend import MASKED_SCORE
    x = _clustered(60, n_centers=10, seed=23)
    ivf = IVFIndex(x[:50], n_clusters=10, nprobe=1, seed=23, retrain="off")
    ivf.add(x[50:])                               # nd = 10 = k
    s, i = ivf.search(x[:4] + 0.01, 10, max_pos=50)
    assert (i < 50).all()
    assert (s > MASKED_SCORE / 2).all()           # every slot filled
    assert all(len(set(row.tolist())) == 10 for row in i)


def test_ivf_delta_search_matches_jnp_reference():
    x = _clustered(1200, seed=8)
    ivf = IVFIndex(x[:1000], n_clusters=16, seed=8, retrain="off")
    ivf.add(x[1000:])
    q = x[:5] + 0.02
    s_op, p_op = kops.ivf_delta_search(
        q, ivf.centroids, ivf.store, ivf.store_mask, ivf._delta_unit,
        nprobe=4, block_q=ivf.block_q)
    # the reference's jnp version on the same numpy inputs
    s_ref, p_ref = jref.ivf_delta_search_ref(
        q, ivf.centroids, ivf.store, ivf.store_mask, ivf._delta_unit,
        nprobe=4, block_q=ivf.block_q)
    assert np.array_equal(p_op, np.asarray(p_ref))
    np.testing.assert_allclose(s_op, np.asarray(s_ref), rtol=1e-5, atol=1e-5)


def test_ivf_save_load_preserves_delta_buffer(tmp_path):
    x = _clustered(1200, seed=11)
    ivf = IVFIndex(x[:1000], n_clusters=16, seed=11, retrain="off")
    ivf.add(x[1000:])
    path = os.path.join(tmp_path, "ivf")
    ivf.save(path)
    from repro_torch.index import load_index
    back = load_index(path)
    assert isinstance(back, IVFIndex)
    assert back.delta_rows == 200 and len(back) == 1200
    q = x[1000:1004] + 0.01
    s1, i1 = ivf.search(q, 6)
    s2, i2 = back.search(q, 6)
    assert np.array_equal(i1, i2) and np.allclose(s1, s2)


# ---------------------------------------------------------------------------
# versioned IndexRegistry
# ---------------------------------------------------------------------------


def _reg_fixture(n=800, n_delta=80, seed=13):
    x = _clustered(n + n_delta, seed=seed)
    emb = _LookupEmbedder(x)
    table = CorpusTable([{"t": str(i)} for i in range(n)])
    reg = IndexRegistry()

    def builder(records):
        return build_index(emb.embed([r["t"] for r in records]), kind="exact")

    def updater(index, added):
        index.add(emb.embed([r["t"] for r in added]))

    return x, emb, table, reg, builder, updater


def test_registry_applies_only_the_delta_on_append():
    x, emb, table, reg, builder, updater = _reg_fixture()
    i0 = reg.get_or_update(table, emb, kind="exact", builder=builder,
                           updater=updater)
    assert emb.calls == 800
    table.append([{"t": str(i)} for i in range(800, 880)])
    i1 = reg.get_or_update(table, emb, kind="exact", builder=builder,
                           updater=updater)
    assert i1 is i0 and len(i1) == 880
    assert emb.calls == 880                     # delta rows only
    m = reg.metrics()
    assert m["index_builds"] == 1 and m["index_updates"] == 1
    assert m["index_delta_rows"] == 80
    # delta results match a fresh build (exact backend: identical)
    fresh = VectorIndex(x[:880])
    q = x[800:804]
    assert np.array_equal(i1.search(q, 5)[1], fresh.search(q, 5)[1])


def test_stream_key_stable_as_corpus_grows():
    # the size-derived auto nprobe must NOT land in the stream key: corpus
    # growth would churn the key and turn every append into a full rebuild
    records, world = _filter_world(40, seed=33)
    table = CorpusTable(records)
    sess = Session(oracle=synth.SimulatedModel(world, "oracle"),
                   embedder=synth.SimulatedEmbedder(world))
    with Gateway(sess, max_inflight=1,
                 optimizer_kw={"index_min_corpus": 10}) as gw:
        q = "claim text 3"
        gw.submit(table.lazy(sess).sem_search("claim", q, k=3,
                                              index_kind="ivf")
                  ).result(timeout=120)
        table.append(_new_rows(world, 40, 25, seed=44))   # sqrt(n) shifts
        gw.submit(table.lazy(sess).sem_search("claim", q, k=3,
                                              index_kind="ivf")
                  ).result(timeout=120)
        m = gw.snapshot()
        assert m["index_builds"] == 1 and m["index_updates"] == 1
        assert m["index_delta_rows"] == 25


def test_registry_rebuilds_on_update_or_delete():
    _, emb, table, reg, builder, updater = _reg_fixture()
    reg.get_or_update(table, emb, kind="exact", builder=builder, updater=updater)
    table.update(table.row_ids()[0], {"t": "7"})
    i1 = reg.get_or_update(table, emb, kind="exact", builder=builder,
                           updater=updater)
    assert reg.metrics()["index_builds"] == 2 and len(i1) == 800


def test_registry_pinned_old_version_never_sees_future_rows():
    _, emb, table, reg, builder, updater = _reg_fixture()
    v0 = table.version
    reg.get_or_update(table, emb, kind="exact", builder=builder, updater=updater)
    table.append([{"t": str(i)} for i in range(800, 880)])
    reg.get_or_update(table, emb, kind="exact", builder=builder, updater=updater)
    old = reg.get_or_update(table, emb, kind="exact", builder=builder,
                            updater=updater, version=v0)
    assert len(old) == 800                      # fresh, uncached, at v0
    assert reg.metrics()["index_stale_misses"] == 1


def test_registry_one_update_under_concurrent_sessions():
    _, emb, table, reg, builder, updater = _reg_fixture()
    reg.get_or_update(table, emb, kind="exact", builder=builder, updater=updater)
    table.append([{"t": str(i)} for i in range(800, 880)])
    gate = threading.Event()
    applied = []

    def slow_updater(index, added):
        gate.wait(5.0)
        applied.append(len(added))
        updater(index, added)

    results = [None] * 6

    def worker(i):
        results[i] = reg.get_or_update(table, emb, kind="exact",
                                       builder=builder, updater=slow_updater)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert applied == [80]                      # exactly one delta application
    assert all(r is results[0] for r in results)
    assert reg.metrics()["index_updates"] == 1


def test_registry_eviction_releases_pins_and_latches():
    reg = IndexRegistry(capacity=2)
    x = _clustered(64, seed=17)

    class Emb:
        def __init__(self, key):
            self.index_key = key

    embs = [Emb(f"e{i}") for i in range(4)]
    for i, e in enumerate(embs):
        reg.get_or_build([f"t{i}"], e, kind="exact",
                         builder=lambda: VectorIndex(x))
    assert reg.metrics()["indexes_resident"] == 2
    assert reg.metrics()["index_evictions"] == 2
    # evicted keys must not keep their embedder pinned or a stale latch
    assert len(reg._pins) == 2 and not reg._building
    live_keys = set(reg._indexes)
    assert set(reg._pins) == live_keys
    # the evicted embedders are collectable (no registry pin holds them)
    refs = [weakref.ref(e) for e in embs[:2]]
    del embs
    gc.collect()
    assert all(r() is None for r in refs)
    reg.clear()
    assert not reg._pins and not reg._versions and not reg._building


# ---------------------------------------------------------------------------
# satellite: nprobe interpolation
# ---------------------------------------------------------------------------


def test_nprobe_for_recall_interpolates_between_calibration_points():
    # calibration points themselves are unchanged
    assert nprobe_for_recall(200, 0.95) == 20     # 0.10 * 200
    assert nprobe_for_recall(200, 0.90) == 10     # 0.05 * 200
    # between points: linear, not a jump to the next point's fraction
    mid = nprobe_for_recall(200, 0.91)
    assert 10 < mid < 20
    assert mid == 12                              # 0.05 + 0.2*(0.10-0.05) = 0.06
    # monotone over a fine sweep, every cluster at 1.0
    sweep = [nprobe_for_recall(200, r) for r in np.linspace(0.5, 0.999, 40)]
    assert sweep == sorted(sweep)
    assert nprobe_for_recall(200, 1.0) == 200


# ---------------------------------------------------------------------------
# satellite: store log compaction
# ---------------------------------------------------------------------------


def _lines(path):
    with open(path) as fh:
        return [line for line in fh if line.strip()]


def test_store_compacts_dead_log_on_close(tmp_path):
    path = os.path.join(tmp_path, "cache.jsonl")
    store = SharedSemanticCache(persist_path=path)
    keys = [("oracle", "predicate", f"p{i}") for i in range(10)]
    for round_ in range(5):                     # 4 dead lines per key
        store.put_many(keys, [[True, float(round_)]] * len(keys), owner="s1")
    store.flush()
    assert len(_lines(path)) == 50
    store.close()
    assert store.compactions == 1
    lines = _lines(path)
    assert len(lines) == 10                     # live entries only
    # a reload serves the latest values
    back = SharedSemanticCache(persist_path=path)
    got = back.get_many(keys)
    assert all(hit for hit, _ in got)
    assert all(row == [True, 4.0] for _, row in got)
    back.close()
    assert back.compactions == 0                # nothing dead: no rewrite


def test_store_close_without_dead_majority_keeps_log(tmp_path):
    path = os.path.join(tmp_path, "cache.jsonl")
    store = SharedSemanticCache(persist_path=path)
    keys = [("oracle", "predicate", f"p{i}") for i in range(6)]
    store.put_many(keys, [[True, 1.0]] * 6, owner="s1")
    store.put(keys[0], [False, 0.0], owner="s1")   # 1 dead of 7: live majority
    store.close()
    assert store.compactions == 0 and len(_lines(path)) == 7


# ---------------------------------------------------------------------------
# continuous queries through the gateway
# ---------------------------------------------------------------------------


def test_subscription_emits_initial_and_delta_only_oracle_traffic():
    records, world = _filter_world(40)
    table = CorpusTable(records)
    backend = CountingBackend(synth.SimulatedModel(world, "oracle"))
    sess = Session(oracle=backend, embedder=synth.SimulatedEmbedder(world))
    with Gateway(sess, max_inflight=2) as gw:
        sub = gw.subscribe(table.lazy(sess)
                           .sem_filter("the {claim} is supported"))
        em0 = sub.poll(timeout=60)
        assert em0.error is None and em0.version == 1
        assert backend.n_prompts == 40
        table.append(_new_rows(world, 40, 10))
        em1 = sub.poll(timeout=60)
        assert em1.error is None and em1.version == 2
        # monotone op: only the 10 delta rows reach the oracle; the shared
        # cache covers every already-judged row
        assert backend.n_prompts == 50
        new_tags = {synth.tag(f"claim{i}") for i in range(40, 50)}
        late = [p for b in backend.batches[1:] for p in b]
        assert late and all(any(t in p for t in new_tags) for p in late)
        # emitted records are identical to a from-scratch run at v2
        fresh_sess = Session(oracle=synth.SimulatedModel(world, "oracle"),
                             embedder=synth.SimulatedEmbedder(world))
        fresh = SemFrame(table.snapshot(), fresh_sess).sem_filter(
            "the {claim} is supported")
        assert em1.records == fresh.records
        assert set(map(str, em1.added)) <= set(map(str, fresh.records))
        snap = gw.snapshot()
        assert snap["subscriptions"] == 1 and snap["emissions"] == 2


def test_subscription_update_and_delete_reflected_in_emissions():
    records, world = _filter_world(20, seed=9)
    # make row 0 pass so we can watch it disappear
    world.filter_truth["claim0"] = True
    world.filter_truth["claim1"] = True
    table = CorpusTable(records)
    sess = Session(oracle=synth.SimulatedModel(world, "oracle"),
                   embedder=synth.SimulatedEmbedder(world))
    with Gateway(sess, max_inflight=1) as gw:
        sub = gw.subscribe(table.lazy(sess)
                           .sem_filter("the {claim} is supported"))
        em0 = sub.poll(timeout=60)
        assert any(r["id"] == "claim0" for r in em0.records)
        table.delete(table.row_ids()[0])        # drop claim0
        em1 = sub.poll(timeout=60)
        assert not any(r["id"] == "claim0" for r in em1.records)
        assert any(r["id"] == "claim0" for r in em1.removed)
        # records still identical to a from-scratch run after the delete
        fresh_sess = Session(oracle=synth.SimulatedModel(world, "oracle"),
                             embedder=synth.SimulatedEmbedder(world))
        fresh = SemFrame(table.snapshot(), fresh_sess).sem_filter(
            "the {claim} is supported")
        assert em1.records == fresh.records


def test_subscription_coalesces_rapid_commits():
    records, world = _filter_world(16, seed=4)
    table = CorpusTable(records)
    sess = Session(oracle=synth.SimulatedModel(world, "oracle"),
                   embedder=synth.SimulatedEmbedder(world))
    with Gateway(sess, max_inflight=1) as gw:
        sub = gw.subscribe(table.lazy(sess)
                           .sem_filter("the {claim} is supported"),
                           emit_initial=False)
        for i in range(5):                      # 5 commits in a burst
            table.append(_new_rows(world, 16 + i, 1, seed=100 + i))
        # the subscription catches up to the LATEST version; burst commits
        # coalesce instead of producing one emission each
        deadline_emissions = []
        em = sub.poll(timeout=60)
        while em is not None:
            deadline_emissions.append(em)
            if em.version == table.version:
                break
            em = sub.poll(timeout=60)
        assert deadline_emissions[-1].version == table.version
        assert len(deadline_emissions) <= 5
        assert len(deadline_emissions[-1].records) >= 0
        sub.cancel()
        assert sub.cancelled


def test_subscription_cancel_discards_gateway_reference():
    records, world = _filter_world(8, seed=2)
    table = CorpusTable(records)
    sess = Session(oracle=synth.SimulatedModel(world, "oracle"))
    with Gateway(sess, max_inflight=1) as gw:
        sub = gw.subscribe(table.lazy(sess)
                           .sem_filter("the {claim} is supported"),
                           emit_initial=False)
        assert sub in gw._subscriptions
        sub.cancel()
        assert sub not in gw._subscriptions       # no leak across cycles


def test_subscription_requires_a_stream_scan():
    records, world = _filter_world(8)
    sess = Session(oracle=synth.SimulatedModel(world, "oracle"))
    with Gateway(sess, max_inflight=1) as gw:
        with pytest.raises(ValueError, match="CorpusTable"):
            gw.subscribe(SemFrame(records, sess).lazy()
                         .sem_filter("the {claim} is supported"))


def test_pin_stream_scans_freezes_floating_versions():
    records, _ = _filter_world(6)
    table = CorpusTable(records)
    plan = N.Filter(N.StreamScan(table), "the {claim} is supported")
    pinned = pin_stream_scans(plan)
    assert pinned.child.version == table.version
    table.append([{"id": "x", "claim": "x"}])
    assert pinned.child.version == table.version - 1   # still the old pin
    repinned = pin_stream_scans(plan, {table.table_id: table.version})
    assert repinned.child.version == table.version
    assert len(pinned.child.records) == 6
    assert len(repinned.child.records) == 7


# ---------------------------------------------------------------------------
# executor delta routing: stream search through the versioned registry
# ---------------------------------------------------------------------------


def test_stream_search_reuses_base_index_and_embeds_only_delta():
    n, nd = 60, 12
    records, world = _filter_world(n, seed=21)
    table = CorpusTable(records)
    sess = Session(oracle=synth.SimulatedModel(world, "oracle"),
                   embedder=synth.SimulatedEmbedder(world))
    with Gateway(sess, max_inflight=1) as gw:
        q = "claim text 3"
        h0 = gw.submit(table.lazy(sess).sem_search("claim", q, k=5,
                                                   index_kind="exact"))
        r0 = h0.result(timeout=120)
        assert len(r0) == 5
        m0 = gw.snapshot()
        assert m0["index_builds"] == 1 and m0["index_updates"] == 0
        table.append(_new_rows(world, n, nd, seed=77))
        h1 = gw.submit(table.lazy(sess).sem_search("claim", q, k=5,
                                                   index_kind="exact"))
        r1 = h1.result(timeout=120)
        assert len(r1) == 5
        m1 = gw.snapshot()
        # appended corpus re-used the base index: delta rows only
        assert m1["index_builds"] == 1 and m1["index_updates"] == 1
        assert m1["index_delta_rows"] == nd
        # result identical to a frozen-corpus run of the same search
        frozen = SemFrame(table.snapshot(), sess).sem_search(
            "claim", q, k=5, index_kind="exact")
        assert [r["id"] for r in r1] == [r["id"] for r in frozen.records]


# ---------------------------------------------------------------------------
# parity with the reference: the same table, commits and continuous queries
# ---------------------------------------------------------------------------

J = types.SimpleNamespace(synth=jsynth, SemFrame=JSemFrame,
                          Session=JSession, Gateway=JGateway, Table=JTable)
T = types.SimpleNamespace(synth=synth, SemFrame=SemFrame,
                          Session=Session, Gateway=Gateway, Table=CorpusTable)
SIM_TOL = 1e-5      # a sim-join record's ``sim_score`` (f32 sums in another order)


def _emitted(em) -> tuple:
    assert em is not None and em.error is None, em
    return sorted(em.versions.values()), em.records, em.added, em.removed


def _commits(table, world):
    """Append, update, delete, then an append that lands beside a delete."""
    table.append(_new_rows(world, 40, 10, seed=5))
    yield
    table.update(table.row_ids()[3], {"claim": "claim text 3 revised"})
    yield
    table.delete(table.row_ids()[0])
    yield
    table.append(_new_rows(world, 50, 6, seed=6))
    yield


def _subscribed_filter(p):
    records, world, *_ = p.synth.make_filter_world(40, seed=7)
    world.filter_truth["claim0"] = True
    table = p.Table(records)
    sess = p.Session(oracle=p.synth.SimulatedModel(world, "oracle"),
                     embedder=p.synth.SimulatedEmbedder(world))
    with p.Gateway(sess, max_inflight=1) as gw:
        sub = gw.subscribe(table.lazy(sess).sem_filter("the {claim} is supported"))
        ems = [_emitted(sub.poll(timeout=60))]
        for _ in _commits(table, world):
            ems.append(_emitted(sub.poll(timeout=60)))
        snap = gw.snapshot()
    return ems, {k: snap[k] for k in ("subscriptions", "emissions", "completed")}


def test_subscription_emissions_match_reference():
    """Every emission of a continuous filter (initial, append, update,
    delete, append) has the reference's version, records, added and
    removed rows."""
    jems, jsnap = _subscribed_filter(J)
    tems, tsnap = _subscribed_filter(T)
    assert [e[0] for e in tems] == [[1], [2], [3], [4], [5]]
    assert tems == jems
    assert tsnap == jsnap


def _same_rows(got: list, want: list) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if {k: v for k, v in g.items() if k != "sim_score"} != \
                {k: v for k, v in w.items() if k != "sim_score"}:
            return False
        if abs(g["sim_score"] - w["sim_score"]) > SIM_TOL:
            return False
    return True


def _subscribed_sim_join(p, kind, x):
    """A continuous ``sem_sim_join`` of 12 queries over a clustered table
    (vectors through a lookup embedder), through four appends."""
    emb = _LookupEmbedder(x)
    table = p.Table([{"id": i, "t": str(i)} for i in range(600)])
    queries = [{"qid": j, "q": str(900 + j)} for j in range(12)]
    sess = p.Session(oracle=None, embedder=emb)
    with p.Gateway(sess, max_inflight=1) as gw:
        plan = p.SemFrame(queries, sess).lazy().sem_sim_join(
            table.lazy(sess), "q", "t", k=5, index_kind=kind, quantize="none")
        sub = gw.subscribe(plan)
        ems = [sub.poll(timeout=60)]
        for c in range(4):
            table.append([{"id": i, "t": str(i)} for i in range(600 + 25 * c, 625 + 25 * c)])
            ems.append(sub.poll(timeout=60))
        snap = gw.snapshot()
    for em in ems:
        assert em is not None and em.error is None, em
    counts = {k: snap[k] for k in ("index_builds", "index_updates", "index_delta_rows",
                                   "emissions")}
    return ems, counts, emb.calls


@pytest.mark.parametrize("kind", ["exact", "ivf"])
def test_continuous_sim_join_matches_reference(kind):
    """Each emission of a continuous sim-join over a growing table equals
    the reference's (``sim_score`` within SIM_TOL); both registries build
    once and apply each commit's delta, and both embed only new rows."""
    x = _clustered(1000, d=32, seed=12)
    jems, jcounts, jcalls = _subscribed_sim_join(J, kind, x)
    tems, tcounts, tcalls = _subscribed_sim_join(T, kind, x)
    assert [e.version for e in tems] == [1, 2, 3, 4, 5]
    for te, je in zip(tems, jems):
        assert te.version == je.version
        assert len(te.records) == 12 * 5
        assert _same_rows(te.records, je.records)
    assert tcounts == jcounts
    assert tcounts["index_builds"] == 1 and tcounts["index_updates"] == 4
    assert tcounts["index_delta_rows"] == 100
    assert tcalls == jcalls == 700 + 12
