"""The port's metrics plane, held to the reference's tests of it.

The gateway, metrics-registry and exposition tests of ``tests/test_audit.py``
(bill identity with auditing on and off, drift recalibration through the
gateway, a valid Prometheus exposition, registry rendering, label isolation
under threads, the IVF delta and int8 audits) and the latency histogram,
snapshot, gateway tracing and stats-store persistence tests of
``tests/test_obs.py`` run here unchanged but for their imports, which name
``repro_torch``, and a timeout on each thread join.  The parity tests at the end run the same audited sessions
through both packages' gateways and hold the port's exposition to the
reference's metric families and label sets.
"""
import json
import re
import threading
import types

import numpy as np
import pytest

import repro_torch
from repro.core.backends import synth as jsynth
from repro.core.frame import SemFrame as JSemFrame
from repro.core.frame import Session as JSession
from repro.obs import audit as JA
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.metrics import parse_exposition as jparse_exposition
from repro.serve import Gateway as JGateway
from repro_torch.core.backends import synth
from repro_torch.core.frame import SemFrame, Session
from repro_torch.index import IVFIndex
from repro_torch.obs import StatsStore, Tracer
from repro_torch.obs import audit as A
from repro_torch.obs import trace as T
from repro_torch.obs.metrics import MetricsRegistry, parse_exposition
from repro_torch.serve import Gateway
from repro_torch.serve.metrics import GatewayMetrics, LatencyHistogram


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")


def _filter_worlds(n=400, seed=7):
    """(records, live world, drifted world): same corpus, inverted truth."""
    records, world, oracle, proxy, _ = synth.make_filter_world(
        n, proxy_alpha=2.5, seed=seed)
    _, drifted, *_ = synth.make_filter_world(n, proxy_alpha=2.5, seed=seed)
    for rid in drifted.filter_truth:
        drifted.filter_truth[rid] = not drifted.filter_truth[rid]
    return records, world, drifted, oracle, proxy


# ---------------------------------------------------------------------------
# gateway integration: recalibration + metrics plane + bill identity
# ---------------------------------------------------------------------------


def _gw_session(world):
    return Session(oracle=synth.SimulatedModel(world, "oracle"),
                   proxy=synth.SimulatedModel(world, "proxy", alpha=2.5),
                   embedder=synth.SimulatedEmbedder(world), sample_size=100)


def _cascade_pipeline(records, session):
    return (SemFrame(records, session).lazy()
            .sem_filter("{claim} holds", recall_target=0.9,
                        precision_target=0.9))


def test_gateway_bill_identity_and_recalibration():
    records, world, drifted, *_ = _filter_worlds()

    def run(audit):
        gw = Gateway(_gw_session(world), max_inflight=2, window_s=0.005,
                     audit=audit)
        if audit and gw.auditor is not None:
            # point the audit role's gold oracle at the drifted world
            from repro_torch.core.backends.base import CountedModel
            gw.auditor._oracle = CountedModel(
                synth.SimulatedModel(drifted, "oracle"), "audit")
        h = gw.submit(_cascade_pipeline(records, gw.session),
                      tenant="acme")
        recs = h.result(timeout=30.0)
        bill = dict(h.summary()["stats"])
        if gw.auditor is not None:
            gw.auditor.drain()
        snap = gw.snapshot()
        inval = gw.store.stats()["invalidations"]
        text = gw.metrics_text()
        gw.close()
        return recs, bill, snap, inval, text

    recs_off, bill_off, _, _, _ = run(False)
    recs_on, bill_on, snap, inval, text = run(
        A.AuditPolicy(sample_fraction=1.0, min_samples=8, seed=1))
    assert recs_off == recs_on
    for b in (bill_off, bill_on):          # sid and wall differ run to run
        b.pop("wall_s"), b.pop("operator")
    assert bill_off == bill_on              # satellite 1: identical bills
    # drifted gold => violation => gateway purged the predicate's cache rows
    assert snap["audit"]["violations"].get("precision", 0) >= 1
    assert snap["violations"] >= 1
    assert inval > 0
    # per-tenant SLO series reached the exposition
    samples = parse_exposition(text)
    assert samples[
        'repro_tenant_sessions_total{tenant="acme",status="completed"}'] == 1
    assert samples['repro_guarantee_violations_total{kind="precision"}'] >= 1


def test_gateway_metrics_text_is_valid_exposition():
    records, world, *_ = _filter_worlds(n=120)
    gw = Gateway(_gw_session(world), max_inflight=2, window_s=0.005,
                 audit=A.AuditPolicy(sample_fraction=0.5, seed=0))
    h = gw.submit(_cascade_pipeline(records, gw.session), tenant="t0")
    h.result(timeout=30.0)
    gw.auditor.drain()
    text = gw.metrics_text()
    gw.close()
    samples = parse_exposition(text)       # raises on malformed exposition
    for name in ("repro_gateway_sessions_total", "repro_gateway_latency_seconds",
                 "repro_dispatch_prompts_total", "repro_cache_events_total",
                 "repro_audit_oracle_calls_total", "repro_tenant_latency_seconds",
                 "repro_tenant_latency_quantile_seconds"):
        assert any(k == name or k.startswith(name + "{")
                   or k.startswith(name + "_") for k in samples), \
            f"missing family {name}"
    # histogram invariants: cumulative buckets end at +Inf == _count
    buckets = [(k, v) for k, v in samples.items()
               if k.startswith("repro_gateway_latency_seconds_bucket")]
    assert buckets and buckets[-1][0].endswith('le="+Inf"}')
    vals = [v for _, v in buckets]
    assert all(a <= b for a, b in zip(vals, vals[1:]))
    assert vals[-1] == samples["repro_gateway_latency_seconds_count"] == 1


# ---------------------------------------------------------------------------
# metrics registry unit behavior
# ---------------------------------------------------------------------------


def test_metrics_registry_render_and_parse_roundtrip():
    reg = MetricsRegistry()
    c = reg.counter("jobs_total", "jobs processed", ("status",))
    c.inc(status="ok")
    c.inc(2, status="err")
    g = reg.gauge("queue_depth", "pending jobs")
    g.set(7)
    hst = reg.histogram("latency_seconds", "op latency",
                        buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        hst.observe(v)
    text = reg.render()
    assert "# TYPE jobs_total counter" in text
    samples = parse_exposition(text)
    assert samples['jobs_total{status="err"}'] == 2.0
    assert samples['jobs_total{status="ok"}'] == 1.0
    assert samples["queue_depth"] == 7.0
    assert samples['latency_seconds_bucket{le="0.1"}'] == 1.0
    assert samples['latency_seconds_bucket{le="+Inf"}'] == 4.0
    assert samples["latency_seconds_count"] == 4.0
    assert samples["latency_seconds_sum"] == pytest.approx(55.55)


def test_metrics_registry_label_isolation_and_thread_safety():
    reg = MetricsRegistry()
    c = reg.counter("hits_total", "hits", ("shard",))

    def worker(shard):
        for _ in range(500):
            c.inc(shard=shard)

    threads = [threading.Thread(target=worker, args=(f"s{i}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i in range(4):
        assert c.value(shard=f"s{i}") == 500
    # re-registering the same family returns the same collector
    assert reg.counter("hits_total", "hits", ("shard",)) is c


def test_parse_exposition_rejects_garbage():
    with pytest.raises(ValueError):
        parse_exposition("this is not prometheus\n")
    with pytest.raises(ValueError):
        parse_exposition("# TYPE x bogus_kind\nx 1\n")


def _vectors(n=600, d=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_ivf_delta_and_int8_paths_are_audited():
    x = _vectors()
    q = _vectors(30, seed=13)
    aud = A.GuaranteeAuditor(
        None, policy=A.AuditPolicy(search_sample_fraction=1.0, seed=2))
    idx = IVFIndex(x[:500], n_clusters=12, recall_target=0.5, seed=4,
                   quantize="int8")
    idx.add(x[500:])                       # rows land in the delta buffer
    with A.activate_ctx(aud):
        idx.search(q, 10, nprobe=12)
    assert aud.drain()
    est = {e["key"]: e for e in aud.report()["searches"]}
    assert "ivf/int8" in est               # quantized path keyed separately
    assert est["ivf/int8"]["queries_audited"] == 30
    aud.close()


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# gateway tracing, latency histogram and the stats store (tests/test_obs.py)
# ---------------------------------------------------------------------------


def _session(world, *, with_proxy=False, sample_size=40):
    return Session(
        oracle=synth.SimulatedModel(world, "oracle"),
        proxy=synth.SimulatedModel(world, "proxy") if with_proxy else None,
        embedder=synth.SimulatedEmbedder(world), sample_size=sample_size)


def _join_world(n=30, m=8, seed=7):
    left, right, world, *_ = synth.make_join_world(n, m, seed=seed)
    synth.add_phrase_predicate(world, left, "is checkable", 0.4, seed=seed)
    return left, right, world


def _pipeline(left, right, world):
    return (SemFrame(left, _session(world)).lazy()
            .sem_filter("the {abstract} is checkable")
            .sem_join(right, "the {abstract} reports the {reaction:right}"))


# ---------------------------------------------------------------------------


def test_latency_histogram_percentiles_within_bucket_error(rng):
    h = LatencyHistogram()
    xs = rng.lognormal(mean=-2.0, sigma=1.0, size=5000)
    for x in xs:
        h.record(x)
    for q in (50, 95, 99):
        exact = float(np.percentile(xs, q))
        got = h.percentile(q)
        assert abs(got - exact) / exact < 0.08   # half-bucket ≈ 3.7%
    assert len(h) == 5000
    assert h.percentile(0) <= h.percentile(50) <= h.percentile(100)


def test_latency_histogram_clamps_out_of_range():
    h = LatencyHistogram()
    h.record(1e-9)
    h.record(1e9)
    assert h.percentile(0) == LatencyHistogram.LO
    assert h.percentile(100) == LatencyHistogram.HI


def test_metrics_snapshot_keeps_field_names_and_adds_p99():
    m = GatewayMetrics()
    for x in (0.01, 0.02, 0.04, 0.08, 0.5):
        m.on_finish("done", x, 1)
    snap = m.snapshot()
    assert {"p50_latency_s", "p95_latency_s", "p99_latency_s"} <= set(snap)
    assert snap["p50_latency_s"] == pytest.approx(0.04, rel=0.1)
    assert snap["completed"] == 5
    empty = GatewayMetrics().snapshot()
    assert empty["p50_latency_s"] is None and empty["p99_latency_s"] is None


# ---------------------------------------------------------------------------
# gateway integration
# ---------------------------------------------------------------------------


def test_gateway_tracing_off_by_default():
    left, right, world = _join_world()
    with Gateway(_session(world), max_inflight=2) as gw:
        sess = gw.submit(_pipeline(left, right, world))
        assert sess.result(timeout=30.0)
        assert gw.tracer is None
        assert "stages" not in gw.snapshot()
        with pytest.raises(RuntimeError):
            gw.export_trace("/dev/null")


def test_gateway_trace_spans_sessions_and_exports(tmp_path):
    left, right, world = _join_world()
    with Gateway(_session(world), max_inflight=2, trace=True) as gw:
        s1 = gw.submit(_pipeline(left, right, world))
        s2 = gw.submit(_pipeline(left, right, world), tenant="b")
        r1, r2 = s1.result(timeout=30.0), s2.result(timeout=30.0)
        assert r1 == r2
        # one root session span per serve session, tagged with its sid
        roots = gw.tracer.session_spans()
        assert {s.attrs["sid"] for s in roots} == {s1.sid, s2.sid}
        # the session subtree spans layers: plan stages, operators, and the
        # dispatcher's fused batches (which run on the dispatcher thread)
        kinds = {s.kind for s in gw.session_trace(s1.sid)}
        assert {"session", "plan_stage", "operator"} <= kinds
        all_kinds = {s.kind for s in gw.tracer.spans()}
        assert "dispatch_batch" in all_kinds
        assert "cache_lookup" in all_kinds
        for sp in gw.tracer.spans(kind="dispatch_batch"):
            assert "fused_calls" in sp.attrs
        # snapshot carries the span-derived stage breakdown
        stages = gw.snapshot()["stages"]
        assert any(k.startswith("session/") for k in stages)
        assert any(k.startswith("operator/") for k in stages)
        # exports: JSONL lines and a Perfetto-loadable chrome trace
        pj = tmp_path / "gw.jsonl"
        pc = tmp_path / "gw.json"
        n = gw.export_trace(str(pj))
        assert n == len(gw.tracer.spans())
        assert all(json.loads(l) for l in pj.read_text().splitlines())
        gw.export_trace(str(pc), fmt="chrome")
        doc = json.loads(pc.read_text())
        assert len(doc["traceEvents"]) == n


def test_gateway_persists_stats_store_next_to_cache(tmp_path):
    left, right, world = _join_world()
    persist = str(tmp_path / "cache.json")
    with Gateway(_session(world), max_inflight=1,
                 persist_path=persist) as gw:
        gw.submit(_pipeline(left, right, world)).result(timeout=30.0)
        assert len(gw.stats_store) >= 1
    saved = StatsStore(persist + ".stats.json")
    assert len(saved) >= 1
    assert any(e["selectivity"] is not None for e in saved.snapshot())
    # a second gateway warm-starts from the persisted observations
    with Gateway(_session(world), max_inflight=1,
                 persist_path=persist) as gw2:
        assert len(gw2.stats_store) >= 1


def test_traced_run_is_record_identical_to_untraced():
    left, right, world = _join_world(seed=13)
    untraced = _pipeline(left, right, world).collect()
    tr = Tracer()
    with T.activate(tr):
        traced = _pipeline(left, right, world).collect()
    assert traced.records == untraced.records
    assert tr.spans(kind="plan_stage")


# ---------------------------------------------------------------------------
# parity with the reference: metric families, label sets, exposition
# ---------------------------------------------------------------------------

J = types.SimpleNamespace(synth=jsynth, SemFrame=JSemFrame, Session=JSession, A=JA,
                          Gateway=JGateway, Registry=JRegistry, parse=jparse_exposition)
P = types.SimpleNamespace(synth=synth, SemFrame=SemFrame, Session=Session, A=A,
                          Gateway=Gateway, Registry=MetricsRegistry, parse=parse_exposition)
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _families(text: str) -> dict:
    """{family: its TYPE} from the exposition's ``# TYPE`` lines."""
    return dict(line.split()[2:4] for line in text.splitlines()
                if line.startswith("# TYPE "))


def _label_sets(samples: dict) -> dict:
    """{sample name: {(label names, ...), ...}} over every sample."""
    out: dict = {}
    for key in samples:
        name, labels = _SAMPLE.match(key).groups()
        names = tuple(sorted(k for k, _ in _LABEL.findall(labels or "")))
        out.setdefault(name, set()).add(names)
    return out


def _audited_run(p):
    records, world, *_ = p.synth.make_filter_world(200, proxy_alpha=2.5, seed=7)
    sess = p.Session(oracle=p.synth.SimulatedModel(world, "oracle"),
                     proxy=p.synth.SimulatedModel(world, "proxy", alpha=2.5),
                     embedder=p.synth.SimulatedEmbedder(world), sample_size=100)
    gw = p.Gateway(sess, max_inflight=2, window_s=0.005,
                   audit=p.A.AuditPolicy(sample_fraction=1.0, min_samples=8, seed=1))
    try:
        handles = [gw.submit(p.SemFrame(records, gw.session).lazy()
                             .sem_filter("{claim} holds", recall_target=0.9,
                                         precision_target=0.9), tenant=f"t{i % 2}")
                   for i in range(3)]
        rows = [h.result(timeout=60) for h in handles]
        assert gw.auditor.drain(timeout=60)
        report = gw.auditor.report()
        text = gw.metrics_text()
    finally:
        gw.close()
    return rows, report, text


def test_gateway_exposition_families_and_labels_match_reference():
    """Three audited cascade sessions over two tenants through each
    package's gateway: the same metric families with the same types, the
    same samples with the same label sets, and the same records and audit
    report (the auditor's draws are seeded)."""
    jrows, jreport, jtext = _audited_run(J)
    trows, treport, ttext = _audited_run(P)
    assert trows == jrows
    jsamples, tsamples = jparse_exposition(jtext), parse_exposition(ttext)
    assert _families(ttext) == _families(jtext)
    assert all(name.startswith("repro_") for name in _families(ttext))
    assert _label_sets(tsamples) == _label_sets(jsamples)
    assert set(tsamples) == set(jsamples)
    strip = lambda r: {k: v for k, v in r.items() if k != "budget"}  # noqa: E731
    assert strip(treport) == strip(jreport)
    assert treport["cascades"] and treport["cascades"][0]["audited"] > 0


def _registry_text(p) -> str:
    reg = p.Registry()
    c = reg.counter("jobs_total", "jobs processed", ("status", "tenant"))
    c.inc(status="ok", tenant="a")
    c.inc(3, status="err", tenant='b"q')
    reg.gauge("queue_depth", "pending jobs").set(2.5)
    h = reg.histogram("latency_seconds", "op latency", ("tenant",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v, tenant="a")
    return reg.render()


def test_registry_render_and_parse_match_reference():
    """The same registry calls render the same text, and each package's
    parser reads the other's exposition to the same samples."""
    jtext, ttext = _registry_text(J), _registry_text(P)
    assert ttext == jtext
    assert parse_exposition(jtext) == jparse_exposition(ttext) == jparse_exposition(jtext)
