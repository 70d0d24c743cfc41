"""Gateway-level serving metrics: throughput, latency tails, cache sharing.

One ``GatewayMetrics`` per gateway, fed by the worker threads as sessions
resolve; ``snapshot()`` folds in the shared store's and dispatcher's own
counters to report the serving headline numbers — sessions/s, p50/p95/p99
end-to-end latency, and the cross-query cache hit rate (the fraction of all
prompt lookups answered by another session's work, in-window or from the
shared store).

Latency percentiles come from a fixed-bucket log-scale histogram over the
gateway's *whole* life, not a sliding sample window: a ``deque(maxlen=N)``
silently biases the tail toward the most recent sessions once a long-lived
gateway wraps, while the histogram is O(buckets) memory with a bounded
relative error (each bucket spans ~7.5%, so a reported percentile is within
half a bucket of the true latency).
"""
from __future__ import annotations

import math
import threading
import time


class LatencyHistogram:
    """Log-scale fixed-bucket histogram over [LO, HI) seconds with under/
    overflow buckets; ``percentile()`` returns the geometric midpoint of the
    bucket holding the requested rank."""

    LO = 1e-4          # 100 µs
    HI = 1e4           # ~2.8 h
    PER_DECADE = 32    # bucket width ratio 10**(1/32) ≈ 1.075

    def __init__(self):
        self._n = int(math.ceil(math.log10(self.HI / self.LO)
                                * self.PER_DECADE))
        # [underflow] + self._n log buckets + [overflow]
        self.counts = [0] * (self._n + 2)
        self.total = 0
        self.sum = 0.0     # total observed seconds (Prometheus _sum export)
        self._log_lo = math.log10(self.LO)

    def _bucket(self, x: float) -> int:
        if x < self.LO:
            return 0
        if x >= self.HI:
            return self._n + 1
        return 1 + int((math.log10(x) - self._log_lo) * self.PER_DECADE)

    def record(self, x: float) -> None:
        self.counts[self._bucket(float(x))] += 1
        self.total += 1
        self.sum += float(x)

    def cumulative_leq(self, bounds) -> list[int]:
        """Samples at or below each bound (ascending), re-bucketed onto the
        coarse export bounds: the fine bucket containing a bound contributes
        whole, so each cumulative count is exact to within one fine bucket
        (~7.5% relative on the boundary) — the price of exporting a live
        log-scale histogram without a second per-bound counter array."""
        out = []
        for b in bounds:
            idx = self._bucket(float(b))
            out.append(int(sum(self.counts[: idx + 1])))
        return out

    def percentile(self, q: float) -> float | None:
        if not self.total:
            return None
        rank = q / 100.0 * (self.total - 1)
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc > rank:
                if i == 0:
                    return self.LO
                if i == self._n + 1:
                    return self.HI
                lo = 10 ** (self._log_lo + (i - 1) / self.PER_DECADE)
                hi = lo * 10 ** (1 / self.PER_DECADE)
                return math.sqrt(lo * hi)  # geometric midpoint
        return self.HI  # pragma: no cover - acc always exceeds rank

    def __len__(self) -> int:
        return self.total


class GatewayMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.started_at = time.monotonic()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.expired = 0
        self.rejected = 0
        self.rows_out = 0
        self.subscriptions = 0    # continuous queries registered
        self.emissions = 0        # continuous-query results emitted
        self.emission_errors = 0
        self.fragments_run = 0    # partition fragments executed
        self.partitioned_ops = 0  # operators that ran fragment-parallel
        self.replans = 0          # mid-query re-plan decisions (adaptive)
        # fast-join accounting (block-prompted sem_join path)
        self.join_candidate_pairs = 0   # pairs surviving IVF blocking
        self.join_pairs_pruned = 0      # verdicts inferred via transitivity
        self.join_block_prompts = 0     # multi-pair block prompts issued
        self.join_block_fallbacks = 0   # blocks that fell back pairwise
        self.violations = 0       # guarantee-audit CI violations (alerts)
        self.violations_by_kind: dict[str, int] = {}
        # O(1)-memory, unbiased over the gateway's whole life (see module
        # docstring); field name kept from the deque era
        self.latencies = LatencyHistogram()
        # per-tenant SLO series: admission, deadline hits, latency tails
        self._tenants: dict[str, dict] = {}

    def _tenant(self, tenant: str) -> dict:
        """Lock held."""
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = {
                "submitted": 0, "completed": 0, "failed": 0, "cancelled": 0,
                "deadline_hits": 0, "rejected": 0, "rows_out": 0,
                "latencies": LatencyHistogram()}
        return t

    def on_submit(self, *, tenant: str | None = None) -> None:
        with self._lock:
            self.submitted += 1
            if tenant is not None:
                self._tenant(tenant)["submitted"] += 1

    def on_reject(self, *, tenant: str | None = None) -> None:
        with self._lock:
            self.rejected += 1
            if tenant is not None:
                self._tenant(tenant)["rejected"] += 1

    def on_violation(self, kind: str) -> None:
        """Guarantee-audit alert counter (the violation's full payload goes
        to the auditor's event deque; this is the pageable number)."""
        with self._lock:
            self.violations += 1
            self.violations_by_kind[kind] = \
                self.violations_by_kind.get(kind, 0) + 1

    def on_subscribe(self) -> None:
        with self._lock:
            self.subscriptions += 1

    def on_emit(self, *, error: bool = False) -> None:
        with self._lock:
            self.emissions += 1
            if error:
                self.emission_errors += 1

    def on_replans(self, n: int) -> None:
        """Per-session re-plan roll-up (adaptive executor decisions)."""
        if not n:
            return
        with self._lock:
            self.replans += n

    def on_join_stats(self, details: dict) -> None:
        """Per-join roll-up from a session's stats-log entry (the worker
        scans entries carrying ``candidate_pairs`` after the session
        resolves — the same collect-on-demand treatment the search and
        fragment counters get)."""
        with self._lock:
            self.join_candidate_pairs += int(details.get("candidate_pairs", 0))
            self.join_pairs_pruned += \
                int(details.get("pairs_pruned_by_inference", 0))
            self.join_block_prompts += int(details.get("block_prompts", 0))
            self.join_block_fallbacks += int(details.get("block_fallbacks", 0))

    def on_fragments(self, n_fragments: int, n_ops: int) -> None:
        """Per-session partition-fragment roll-up (reported by the worker
        after the session's executor finishes)."""
        if not n_fragments and not n_ops:
            return
        with self._lock:
            self.fragments_run += n_fragments
            self.partitioned_ops += n_ops

    def on_finish(self, status: str, latency_s: float | None,
                  n_rows: int | None, *, tenant: str | None = None) -> None:
        with self._lock:
            if status == "done":
                self.completed += 1
                self.rows_out += n_rows or 0
            elif status == "cancelled":
                self.cancelled += 1
            elif status == "expired":
                self.expired += 1
            else:
                self.failed += 1
            if latency_s is not None:
                self.latencies.record(latency_s)
            if tenant is not None:
                t = self._tenant(tenant)
                key = {"done": "completed", "cancelled": "cancelled",
                       "expired": "deadline_hits"}.get(status, "failed")
                t[key] += 1
                if status == "done":
                    t["rows_out"] += n_rows or 0
                if latency_s is not None:
                    t["latencies"].record(latency_s)

    def tenant_snapshot(self) -> dict:
        """Per-tenant SLO numbers: admission, deadline hits, p50/p95/p99."""
        with self._lock:
            out = {}
            for tenant, t in sorted(self._tenants.items()):
                lat = t["latencies"]
                out[tenant] = {k: v for k, v in t.items()
                               if k != "latencies"}
                out[tenant].update(
                    p50_latency_s=lat.percentile(50) if len(lat) else None,
                    p95_latency_s=lat.percentile(95) if len(lat) else None,
                    p99_latency_s=lat.percentile(99) if len(lat) else None)
            return out

    def collect(self, registry, *, store=None, dispatcher=None) -> None:
        """Write the gateway's serving series into a ``MetricsRegistry``
        (collect-on-demand: the authoritative counters live here, the
        registry is rebuilt per scrape).  Includes the per-tenant SLO
        series, the violation alert counters, and — when given — the shared
        semantic cache's and dispatcher's own numbers."""
        from repro_torch.obs.metrics import DEFAULT_BUCKETS
        with self._lock:
            sessions = registry.counter(
                "repro_gateway_sessions_total",
                "sessions by terminal status", ("status",))
            for status, v in (("completed", self.completed),
                              ("failed", self.failed),
                              ("cancelled", self.cancelled),
                              ("expired", self.expired),
                              ("rejected", self.rejected)):
                sessions.set_total(v, status=status)
            registry.counter("repro_gateway_submitted_total",
                             "sessions admitted").set_total(self.submitted)
            registry.counter("repro_gateway_rows_out_total",
                             "result rows returned").set_total(self.rows_out)
            registry.counter("repro_gateway_replans_total",
                             "adaptive mid-query replans"
                             ).set_total(self.replans)
            registry.counter("repro_gateway_fragments_total",
                             "partition fragments executed"
                             ).set_total(self.fragments_run)
            registry.counter("repro_join_candidate_pairs_total",
                             "join pairs surviving the blocking stage"
                             ).set_total(self.join_candidate_pairs)
            registry.counter("repro_join_pairs_pruned_total",
                             "join verdicts inferred via transitivity"
                             ).set_total(self.join_pairs_pruned)
            blocks = registry.counter(
                "repro_join_block_prompts_total",
                "multi-pair block prompts by outcome", ("outcome",))
            blocks.set_total(
                self.join_block_prompts - self.join_block_fallbacks,
                outcome="ok")
            blocks.set_total(self.join_block_fallbacks, outcome="fallback")
            stream = registry.counter(
                "repro_gateway_emissions_total",
                "continuous-query emissions", ("outcome",))
            stream.set_total(self.emissions - self.emission_errors,
                             outcome="ok")
            stream.set_total(self.emission_errors, outcome="error")
            registry.counter("repro_gateway_subscriptions_total",
                             "continuous queries registered"
                             ).set_total(self.subscriptions)
            viol = registry.counter("repro_gateway_violations_total",
                                    "guarantee-audit alerts", ("kind",))
            for kind, v in sorted(self.violations_by_kind.items()):
                viol.set_total(v, kind=kind)
            lat = registry.histogram("repro_gateway_latency_seconds",
                                     "end-to-end session latency",
                                     buckets=DEFAULT_BUCKETS)
            lat.observe_buckets(
                self.latencies.cumulative_leq(DEFAULT_BUCKETS),
                self.latencies.total, self.latencies.sum)
            if self._tenants:
                t_sessions = registry.counter(
                    "repro_tenant_sessions_total",
                    "per-tenant sessions by terminal status",
                    ("tenant", "status"))
                t_lat = registry.histogram(
                    "repro_tenant_latency_seconds",
                    "per-tenant end-to-end latency", ("tenant",),
                    buckets=DEFAULT_BUCKETS)
                t_p = registry.gauge(
                    "repro_tenant_latency_quantile_seconds",
                    "per-tenant latency percentile (log-bucket midpoint)",
                    ("tenant", "quantile"))
                for tenant, t in sorted(self._tenants.items()):
                    for status in ("submitted", "completed", "failed",
                                   "cancelled", "deadline_hits", "rejected"):
                        t_sessions.set_total(t[status], tenant=tenant,
                                             status=status)
                    h = t["latencies"]
                    t_lat.observe_buckets(h.cumulative_leq(DEFAULT_BUCKETS),
                                          h.total, h.sum, tenant=tenant)
                    for q in (50, 95, 99):
                        p = h.percentile(q) if len(h) else None
                        if p is not None:
                            t_p.set(p, tenant=tenant, quantile=f"p{q}")
        if store is not None:
            cs = store.stats()
            cache = registry.counter("repro_cache_events_total",
                                     "shared semantic cache events",
                                     ("event",))
            for event in ("hits", "misses", "cross_hits", "evictions",
                          "expirations", "invalidations"):
                cache.set_total(cs.get(event, 0), event=event)
            registry.gauge("repro_cache_entries",
                           "live cache entries").set(cs["entries"])
        if dispatcher is not None:
            ds = dispatcher.stats()
            disp = registry.counter("repro_dispatch_prompts_total",
                                    "dispatcher prompt flow", ("stage",))
            disp.set_total(ds["requested_prompts"], stage="requested")
            disp.set_total(ds["backend_prompts"], stage="backend")
            disp.set_total(ds.get("audit_requested_prompts", 0),
                           stage="audit_requested")
            disp.set_total(ds.get("audit_backend_prompts", 0),
                           stage="audit_backend")
            registry.counter("repro_dispatch_batches_total",
                             "fused query batches"
                             ).set_total(ds["fused_batches"])
            registry.gauge("repro_dispatch_coalesce_ratio",
                           "parked calls per fused batch"
                           ).set(ds["coalesce_ratio"])

    def snapshot(self, *, store=None, dispatcher=None, tracer=None) -> dict:
        with self._lock:
            elapsed = max(time.monotonic() - self.started_at, 1e-9)
            lat = self.latencies
            out = {
                "submitted": self.submitted, "completed": self.completed,
                "failed": self.failed, "cancelled": self.cancelled,
                "expired": self.expired, "rejected": self.rejected,
                "rows_out": self.rows_out,
                "subscriptions": self.subscriptions,
                "emissions": self.emissions,
                "emission_errors": self.emission_errors,
                "fragments_run": self.fragments_run,
                "partitioned_ops": self.partitioned_ops,
                "replans": self.replans,
                "join_candidate_pairs": self.join_candidate_pairs,
                "join_pairs_pruned": self.join_pairs_pruned,
                "join_block_prompts": self.join_block_prompts,
                "join_block_fallbacks": self.join_block_fallbacks,
                "violations": self.violations,
                "elapsed_s": round(elapsed, 4),
                "throughput_rps": round(self.completed / elapsed, 4),
                "p50_latency_s": round(lat.percentile(50), 4)
                if len(lat) else None,
                "p95_latency_s": round(lat.percentile(95), 4)
                if len(lat) else None,
                "p99_latency_s": round(lat.percentile(99), 4)
                if len(lat) else None,
            }
        if tracer is not None:
            # span-derived per-stage wall/count/call breakdown (inclusive
            # wall per span kind/name; see Tracer.stage_summary)
            out["stages"] = tracer.stage_summary()
        if store is not None:
            out["cache"] = store.stats()
        if dispatcher is not None:
            out["dispatch"] = dispatcher.stats()
        if store is not None and dispatcher is not None:
            # cross-query sharing happens two ways: a hit on a store entry
            # another session wrote, or an in-window dupe fused by the
            # dispatcher; both are prompts this query never paid for
            cache, disp = out["cache"], out["dispatch"]
            total = cache["hits"] + cache["misses"]
            out["cross_query_hit_rate"] = (
                (cache["cross_hits"] + disp["cross_shared"]) / total
                if total else 0.0)
        elif store is not None:
            out["cross_query_hit_rate"] = out["cache"]["cross_query_hit_rate"]
        return out
