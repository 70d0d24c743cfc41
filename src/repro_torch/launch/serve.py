"""Serving gateway CLI: run many concurrent semantic pipelines as tenant
sessions through one shared runtime — cross-query micro-batching, a shared
semantic cache (optionally persisted across runs), fair multi-tenant
scheduling, and gateway metrics.

    # simulated backend (no weights needed): 8 sessions, 2 tenants
    PYTHONPATH=src python -m repro_torch.launch.serve --sessions 8 --tenants 2

    # the port's engines on the card under the dispatcher (smoke-scale
    # random weights)
    PYTHONPATH=src python -m repro_torch.launch.serve --backend engine --sessions 4

    # persist the semantic cache: the second run answers from disk
    PYTHONPATH=src python -m repro_torch.launch.serve --persist /tmp/semcache.jsonl
"""
from __future__ import annotations

import argparse
import json
import time


def _sim_session(n_records: int, seed: int):
    from repro_torch.core.backends import synth
    from repro_torch.core.frame import SemFrame, Session

    left, right, world, *_ = synth.make_join_world(n_records, 10, seed=seed)
    synth.add_phrase_predicate(world, left, "is checkable", 0.3, seed=seed)
    synth.add_phrase_predicate(world, left, "is in English", 0.85, seed=seed)
    # proxy quality / sample size chosen so guaranteed cascades calibrate
    # real auto-accept/reject regions (--audit then has decisions to sample)
    sess = Session(oracle=synth.SimulatedModel(world, "oracle"),
                   proxy=synth.SimulatedModel(world, "proxy", alpha=2.5),
                   embedder=synth.SimulatedEmbedder(world), sample_size=100,
                   seed=seed)
    return sess, left, right, SemFrame


def _engine_session(n_records: int, max_seq: int):
    from repro_torch.core.backends.torch_engine import make_session
    from repro_torch.core.frame import SemFrame

    sess = make_session(max_seq=max_seq)
    left = [{"id": f"rec{i}",
             "doc": f"record {i}: component-{i % 5} paired with module-{i % 3}"}
            for i in range(n_records)]
    right = [{"id": f"mod{j}", "module": f"module-{j}"} for j in range(3)]
    return sess, left, right, SemFrame


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("sim", "engine"), default="sim")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--records", type=int, default=40)
    ap.add_argument("--max-inflight", type=int, default=4)
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--window-ms", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--cache-ttl", type=float, default=None,
                    help="shared-cache TTL in seconds (default: no expiry)")
    ap.add_argument("--cache-capacity", type=int, default=100_000)
    ap.add_argument("--persist", type=str, default=None,
                    help="JSONL path for the persistent semantic cache")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-session deadline in seconds")
    ap.add_argument("--no-optimize", action="store_true")
    ap.add_argument("--audit", action="store_true",
                    help="enable online guarantee auditing (background gold "
                         "re-judgments of sampled cascade decisions)")
    ap.add_argument("--metrics-dump", type=str, default=None, metavar="PATH",
                    help="write the Prometheus text exposition of all "
                         "gateway/audit metrics to PATH before shutdown")
    ap.add_argument("--max-seq", type=int, default=256, help="engine backend")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from repro_torch.serve import AdmissionError, Gateway

    t0 = time.time()
    if args.backend == "sim":
        sess, left, right, SemFrame = _sim_session(args.records, args.seed)
    else:
        sess, left, right, SemFrame = _engine_session(args.records, args.max_seq)
    print(f"[serve] {args.backend} backend ready in {time.time()-t0:.1f}s")

    gw = Gateway(sess, max_inflight=args.max_inflight,
                 max_pending=args.max_pending,
                 window_s=args.window_ms / 1e3, max_batch=args.max_batch,
                 cache_ttl_s=args.cache_ttl,
                 cache_capacity=args.cache_capacity,
                 persist_path=args.persist,
                 audit=True if args.audit else None)

    def submit_with_backpressure(pipeline, **kw):
        while True:
            try:
                return gw.submit(pipeline, **kw)
            except AdmissionError:   # queue full: wait for capacity, retry
                time.sleep(0.01)

    def pipeline(i: int):
        sf = SemFrame(left, gw.session).lazy()
        if args.backend == "sim":
            # half the tenants share the checkable predicate — the
            # cross-query sharing regime; with --audit the filters run as
            # guaranteed cascades so the auditor has decisions to sample
            targets = ({"recall_target": 0.9, "precision_target": 0.9}
                       if args.audit else {})
            sf = sf.sem_filter("the {abstract} is checkable" if i % 2 == 0
                               else "the {abstract} is in English", **targets)
            return sf.sem_join(right,
                               "the {abstract} reports the {reaction:right}")
        return (sf.sem_map("one-line gist of {doc}", out_column="gist")
                  .sem_filter("the {doc} mentions a component"))

    try:
        t0 = time.time()
        handles = [submit_with_backpressure(
                       pipeline(i), tenant=f"tenant{i % args.tenants}",
                       optimize=not args.no_optimize,
                       deadline_s=args.deadline)
                   for i in range(args.sessions)]
        gw.wait_all()
        dt = time.time() - t0

        for h in handles:
            print("[serve]", json.dumps(h.summary()))
        snap = gw.snapshot()
        print(f"[serve] {snap['completed']}/{args.sessions} sessions in {dt:.2f}s "
              f"({snap['throughput_rps']:.2f}/s, p50 {snap['p50_latency_s']}s, "
              f"p95 {snap['p95_latency_s']}s)")
        print(f"[serve] cross-query hit rate {snap['cross_query_hit_rate']:.2f}, "
              f"dispatcher fused {snap['dispatch']['fused_calls']} calls into "
              f"{snap['dispatch']['fused_batches']} batches "
              f"({snap['dispatch']['backend_prompts']} backend prompts for "
              f"{snap['dispatch']['requested_prompts']} requested)")
        print("[serve]", json.dumps({k: v for k, v in snap.items()
                                     if k in ("cache", "dispatch")}))
        if gw.auditor is not None:
            gw.auditor.drain()
            print("[serve] audit", json.dumps(gw.auditor.report()))
        if args.metrics_dump:
            with open(args.metrics_dump, "w", encoding="utf-8") as fh:
                fh.write(gw.metrics_text())
            print(f"[serve] metrics exposition written to {args.metrics_dump}")
    finally:
        gw.close()


if __name__ == "__main__":
    main()
