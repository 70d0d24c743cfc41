"""Gateway: multi-tenant admission + scheduling for concurrent semantic
pipelines over one shared runtime.

``submit()`` turns a lazy pipeline (``LazySemFrame`` or a raw plan node)
into a :class:`ServeSession` and parks it in the admission queue — FIFO
within a tenant, round-robin across tenants, so one chatty tenant cannot
starve the rest.  ``max_inflight`` worker threads pull sessions and execute
their plans through :class:`PlanExecutor` with three serving-specific
handles injected:

  * oracle/proxy: ``BatchedModelCache`` (per-session dedup, counted consult
    of the shared store) over ``DispatchedModel`` (cross-query micro-batch
    fusion in the :class:`MicroBatchDispatcher`);
  * embedder: ``DispatchedEmbedder`` (fused + store-backed, memory-only);
  * ``stage_hook``: the session's cancellation/deadline check, honored at
    every plan-node boundary.

A bounded queue (``max_pending``) sheds load with :class:`AdmissionError`
instead of building unbounded backlog; per-session accounting rolls up via
``accounting.session_scope`` so each session reports its own OpStats even
though backend calls are fused across sessions.

Partitioned execution: with ``n_partitions`` set (or passed through
``optimizer_kw``), each session's optimizer cuts big operators into
Exchange-bounded fragments and its :class:`PartitionedExecutor` schedules
them on the gateway's shared *fragment pool* — a second thread pool sized
``fragment_workers``, deliberately separate from the session workers so a
session waiting on its own fragments can never deadlock the pool that must
run them.  Fragment model calls carry the session's accounting context
(``accounting.capture``/``activate``), so per-partition work still rolls up
into the right ``session_scope``, and per-session fragment counts feed
``GatewayMetrics`` (``fragments_run`` / ``partitioned_ops``).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import uuid
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from repro_torch.core import accounting
from repro_torch.core.plan.adaptive import AdaptivePlanExecutor, AdaptivePolicy
from repro_torch.core.plan.cache import BatchedModelCache
from repro_torch.obs import StatsStore
from repro_torch.obs import audit as _audit
from repro_torch.obs import trace as _trace
from repro_torch.core.plan.execute import PartitionedExecutor
from repro_torch.core.plan.nodes import LogicalNode
from repro_torch.core.plan.optimize import PlanOptimizer
from repro_torch.serve.dispatch import (DispatchedEmbedder, DispatchedModel,
                                        MicroBatchDispatcher)
from repro_torch.serve.index_registry import IndexRegistry
from repro_torch.serve.matview import MatViewRegistry
from repro_torch.serve.metrics import GatewayMetrics
from repro_torch.serve.session import (CANCELLED, DONE, EXPIRED, FAILED,
                                       RUNNING, ServeSession, SessionCancelled,
                                       SessionDeadlineExceeded)
from repro_torch.serve.store import SharedSemanticCache
from repro_torch.stream.continuous import Subscription, pin_stream_scans


class AdmissionError(RuntimeError):
    """The gateway's pending queue is full; retry later or shed the query."""


def _raw(model):
    """Unwrap Session's Counted* layers: dispatched handles do their own
    per-session attribution, so the backend must not double-count."""
    return getattr(model, "_m", getattr(model, "_e", model))


class Gateway:
    def __init__(self, session, *, max_inflight: int = 4,
                 max_pending: int = 64, window_s: float = 0.002,
                 max_batch: int = 64, store: SharedSemanticCache | None = None,
                 cache_capacity: int = 100_000, cache_ttl_s: float | None = None,
                 persist_path: str | None = None,
                 optimizer_kw: dict | None = None,
                 history_limit: int = 1024,
                 index_registry: IndexRegistry | None = None,
                 n_partitions: int | None = None,
                 fragment_workers: int = 4,
                 trace: "bool | _trace.Tracer" = False,
                 stats_store: StatsStore | None = None,
                 stats_decay: float = 1.0,
                 stats_load_discount: float = 1.0,
                 adaptive: "bool | AdaptivePolicy" = False,
                 matview: "bool | MatViewRegistry" = False,
                 matview_capacity: int = 64,
                 audit: "bool | _audit.AuditPolicy | None" = None):
        self.session = session
        # trace=True builds a gateway-lifetime tracer (or pass your own);
        # spans from every layer — session, plan stage, operator, fragment,
        # dispatcher batch, kernel, index build, cache lookup — parent into
        # per-session roots, exportable via export_trace()/session_trace()
        if trace is True:
            self.tracer = _trace.Tracer()
        else:
            self.tracer = trace if isinstance(trace, _trace.Tracer) else None
        # observed operator statistics keyed by (operator, fingerprint),
        # persisted alongside the semantic cache when it persists
        self._stats_path = f"{persist_path}.stats.json" if persist_path \
            else None
        self.stats_store = stats_store if stats_store is not None \
            else StatsStore(self._stats_path, decay=stats_decay,
                            load_discount=stats_load_discount)
        # adaptive=True (or a policy) runs sessions on AdaptivePlanExecutor:
        # mid-query filter re-ranking, retrieval switching, fragment resizing
        # from observed cardinalities — record-identical by the strict-mode
        # contract (core.plan.adaptive)
        if isinstance(adaptive, AdaptivePolicy):
            self._adaptive_policy: AdaptivePolicy | None = adaptive
        else:
            self._adaptive_policy = AdaptivePolicy() if adaptive else None
        # matview=True (or a registry) shares materialized subplan results
        # across concurrent sessions by plan fingerprint
        if isinstance(matview, MatViewRegistry):
            self.matviews: MatViewRegistry | None = matview
        else:
            self.matviews = MatViewRegistry(capacity=matview_capacity) \
                if matview else None
        self.store = store if store is not None else SharedSemanticCache(
            capacity=cache_capacity, ttl_s=cache_ttl_s,
            persist_path=persist_path)
        # one retrieval index per (corpus, embedder, config) across ALL
        # sessions: concurrent pipelines over the same corpus build once
        self.index_registry = index_registry if index_registry is not None \
            else IndexRegistry()
        self.dispatcher = MicroBatchDispatcher(
            oracle=_raw(session.oracle),
            proxy=_raw(session.proxy) if session.proxy is not None else None,
            embedder=_raw(session.embedder)
            if session.embedder is not None else None,
            store=self.store, window_s=window_s, max_batch=max_batch,
            tracer=self.tracer)
        self.metrics = GatewayMetrics()
        # audit=True / an AuditPolicy turns on continuous guarantee auditing
        # (default: the REPRO_AUDIT env var).  The auditor's gold oracle is a
        # dispatcher handle on a dedicated background-priority `audit` role:
        # its traffic fuses into wide batches, never consults or warms the
        # query-visible cache, and bills to the `audit` accounting kind —
        # query results and oracle bills stay bit-identical with it on/off.
        if audit is None:
            audit = bool(os.environ.get("REPRO_AUDIT"))
        self._audit_path = f"{persist_path}.audit.json" if persist_path \
            else None
        if audit:
            policy = audit if isinstance(audit, _audit.AuditPolicy) \
                else _audit.AuditPolicy()
            self.dispatcher.add_backend("audit", _raw(session.oracle),
                                        background=True)
            self.auditor: _audit.GuaranteeAuditor | None = \
                _audit.GuaranteeAuditor(
                    DispatchedModel(self.dispatcher, "audit", tag="audit"),
                    policy=policy, stats_store=self.stats_store,
                    on_violation=self._on_violation, path=self._audit_path)
        else:
            self.auditor = None
        self.max_pending = max_pending
        self.optimizer_kw = dict(optimizer_kw or {})
        if n_partitions is not None:
            self.optimizer_kw.setdefault("n_partitions", n_partitions)
        # fragment pool, shared by every session's PartitionedExecutor:
        # fragments never spawn fragments, so a fixed pool cannot deadlock.
        # Only spun up when partition planning can actually emit fragments —
        # an unpartitioned gateway should not carry idle threads.
        partitioning = (self.optimizer_kw.get("n_partitions") or 0) >= 2
        self._fragment_pool = ThreadPoolExecutor(
            max_workers=fragment_workers, thread_name_prefix="gw-frag") \
            if partitioning and fragment_workers and fragment_workers > 1 \
            else None
        self._cv = threading.Condition()
        self._queues: dict[str, deque[ServeSession]] = {}
        self._tenants: list[str] = []
        self._rr = 0
        self._closed = False
        self._counter = 0
        # session ids must be unique across gateway instances AND runs:
        # the shared/persistent store attributes entry ownership by sid, so
        # a colliding id would hide genuine cross-run cache sharing
        self._gid = uuid.uuid4().hex[:6]
        # resolved sessions age out of this ring so a long-lived gateway
        # doesn't pin every result set ever produced; callers keep their own
        # handles, and wait_all() tracks only unresolved sessions
        self.sessions: deque[ServeSession] = deque(maxlen=history_limit)
        self._unresolved: dict[str, ServeSession] = {}
        self._subscriptions: list[Subscription] = []
        self._workers = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"gateway-worker-{i}")
                         for i in range(max_inflight)]
        for w in self._workers:
            w.start()

    # -- admission ---------------------------------------------------------
    def submit(self, pipeline, *, tenant: str = "default",
               optimize: bool = True, deadline_s: float | None = None,
               session_id: str | None = None) -> ServeSession:
        plan = pipeline.plan if hasattr(pipeline, "plan") else pipeline
        if not isinstance(plan, LogicalNode):
            raise TypeError("submit() takes a LazySemFrame or a plan node, "
                            f"got {type(pipeline).__name__}")
        with self._cv:
            if self._closed:
                raise RuntimeError("gateway is closed")
            pending = sum(len(q) for q in self._queues.values())
            if pending >= self.max_pending:
                self.metrics.on_reject(tenant=tenant)
                raise AdmissionError(
                    f"gateway queue full ({pending}/{self.max_pending} pending)")
            self._counter += 1
            sess = ServeSession(
                sid=session_id or f"{self._gid}-s{self._counter:04d}", plan=plan,
                tenant=tenant, optimize=optimize, deadline_s=deadline_s)
            self._queues.setdefault(tenant, deque()).append(sess)
            if tenant not in self._tenants:
                self._tenants.append(tenant)
            self.sessions.append(sess)
            self._unresolved[sess.sid] = sess
            self.metrics.on_submit(tenant=tenant)
            self._cv.notify()
        return sess

    def subscribe(self, pipeline, *, tenant: str = "default",
                  optimize: bool = True, emit_initial: bool = True
                  ) -> Subscription:
        """Register a continuous query: re-execute ``pipeline`` (whose plan
        must scan at least one ``CorpusTable``) on every table commit,
        through the normal admission path.  Returns the
        :class:`~repro_torch.stream.continuous.Subscription` emission handle; the
        shared semantic cache keeps re-executions delta-only (monotone ops
        pay the oracle for new rows, cached judgments cover the rest)."""
        plan = pipeline.plan if hasattr(pipeline, "plan") else pipeline
        sub = Subscription(self, plan, tenant=tenant, optimize=optimize,
                           emit_initial=emit_initial)
        with self._cv:
            closed = self._closed
            if not closed:
                self._subscriptions.append(sub)
        if closed:
            sub.cancel(wait=False)  # release the table listeners
            raise RuntimeError("gateway is closed")
        self.metrics.on_subscribe()
        return sub.start()

    def _discard_subscription(self, sub) -> None:
        """Called by Subscription.cancel(): a cancelled subscription must
        not stay referenced (plan + last result set) for the gateway's
        lifetime."""
        with self._cv:
            try:
                self._subscriptions.remove(sub)
            except ValueError:
                pass

    # -- scheduling --------------------------------------------------------
    def _pop_next(self) -> ServeSession | None:
        """Round-robin across tenants, FIFO within each (lock held)."""
        n = len(self._tenants)
        for i in range(n):
            tenant = self._tenants[(self._rr + i) % n]
            q = self._queues[tenant]
            if q:
                self._rr = (self._rr + i + 1) % n
                return q.popleft()
        return None

    def _worker(self) -> None:
        while True:
            with self._cv:
                sess = self._pop_next()
                while sess is None and not self._closed:
                    self._cv.wait()
                    sess = self._pop_next()
                if sess is None:
                    return
            self._run(sess)

    # -- guarantee auditing ------------------------------------------------
    def _on_violation(self, event) -> None:
        """Runs on the auditor's worker thread when a CI lower bound crosses
        its declared target: raise the alert counter and — when the policy
        asks for recalibration — purge the predicate's cached oracle/proxy
        answers, so the next query touching it re-scores, re-labels, and
        re-learns its cascade thresholds against current model behavior.
        (The auditor itself already poisoned the StatsStore fingerprint.)"""
        self.metrics.on_violation(event.kind)
        aud = self.auditor
        if aud is not None and aud.policy.recalibrate and event.match_token:
            self.store.invalidate(namespaces=("oracle", "proxy"),
                                  contains=event.match_token)

    # -- execution ---------------------------------------------------------
    def _handles(self, sid: str):
        oracle = BatchedModelCache(
            DispatchedModel(self.dispatcher, "oracle", tag=sid),
            store=self.store, namespace="oracle", requester=sid)
        proxy = None
        if self.session.proxy is not None:
            proxy = BatchedModelCache(
                DispatchedModel(self.dispatcher, "proxy", tag=sid),
                store=self.store, namespace="proxy", requester=sid)
        embedder = None
        if self.session.embedder is not None:
            embedder = DispatchedEmbedder(self.dispatcher, tag=sid)
        return oracle, proxy, embedder

    def _resolve(self, sess: ServeSession, status: str, *,
                 records: list | None = None,
                 error: BaseException | None = None) -> None:
        sess.finish(status, records=records, error=error)
        self.metrics.on_finish(status, sess.latency_s,
                               len(records) if records is not None else None,
                               tenant=sess.tenant)
        with self._cv:
            self._unresolved.pop(sess.sid, None)

    def _run(self, sess: ServeSession) -> None:
        try:
            sess.check()                 # cancelled / expired while queued
        except SessionCancelled as exc:
            self._resolve(sess, CANCELLED, error=exc)
            return
        except SessionDeadlineExceeded as exc:
            self._resolve(sess, EXPIRED, error=exc)
            return
        sess.status = RUNNING
        sess.started_at = time.monotonic()
        oracle, proxy, embedder = self._handles(sess.sid)
        exec_kw = {k: self.optimizer_kw[k]
                   for k in ("recall_target", "index_min_corpus")
                   if k in self.optimizer_kw}
        if self._adaptive_policy is not None:
            exec_cls = AdaptivePlanExecutor
            exec_kw["policy"] = self._adaptive_policy
        else:
            exec_cls = PartitionedExecutor
        executor = exec_cls(
            self.session, stats_log=sess.stats_log, oracle=oracle,
            proxy=proxy, embedder=embedder,
            stage_hook=lambda node: sess.check(),
            index_registry=self.index_registry,
            fragment_pool=self._fragment_pool,
            stats_store=self.stats_store, matviews=self.matviews, **exec_kw)
        try:
            # the tracer (when on) wraps the whole session in one root span;
            # fragment/dispatcher threads parent into it via the captured
            # accounting context / the dispatcher's tracer handle
            # the auditor context rides the worker thread (and fragment
            # threads, via accounting.capture) so every cascade/search this
            # session runs emits its auto-decisions for sampling
            with _trace.activate(self.tracer), \
                    _audit.activate_ctx(self.auditor), \
                    _trace.span_in(self.tracer, sess.sid, "session",
                                   sid=sess.sid, tenant=sess.tenant) as sp, \
                    accounting.session_scope(sess.sid) as st:
                sess.stats = st
                # pin floating StreamScans to the versions current NOW: one
                # run never sees two versions even while writers commit
                plan = pin_stream_scans(sess.plan)
                if sess.optimize:
                    # the registry shares builds across sessions, so the
                    # optimizer may amortize IVF build cost over traffic
                    optimizer = PlanOptimizer(
                        self.session, oracle=oracle, proxy=proxy,
                        seed=self.session.seed,
                        **{"index_shared": True,
                           "stats_store": self.stats_store,
                           **self.optimizer_kw})
                    if self._adaptive_policy is not None:
                        # re-plans reuse the planner's own knobs (partition
                        # counts, quantization policy)
                        executor.optimizer = optimizer
                    with accounting.track("plan_optimize") as opt_st:
                        plan = optimizer.optimize(plan)
                    opt_st.details.update(
                        rewrites=[str(r) for r in optimizer.applied])
                    sess.stats_log.append(opt_st.as_dict())
                records = executor.run(plan)
                sp.set(rows_out=len(records), status=DONE)
            self._resolve(sess, DONE, records=records)
        except SessionCancelled as exc:
            self._resolve(sess, CANCELLED, error=exc)
        except SessionDeadlineExceeded as exc:
            self._resolve(sess, EXPIRED, error=exc)
        except BaseException as exc:
            self._resolve(sess, FAILED, error=exc)
        finally:
            # per-session partition-fragment accounting (0/0 when the plan
            # ran single-partition)
            self.metrics.on_fragments(executor.fragments_run,
                                      executor.partitioned_ops)
            for entry in sess.stats_log:
                if isinstance(entry, dict) and "candidate_pairs" in entry:
                    self.metrics.on_join_stats(entry)
            replans = getattr(executor, "replans", ())
            if replans:
                self.metrics.on_replans(len(replans))
                sess.replans = [dataclasses.asdict(e) for e in replans]

    # -- lifecycle ---------------------------------------------------------
    def wait_all(self, timeout: float | None = None) -> bool:
        """Block until every outstanding session has resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            outstanding = list(self._unresolved.values())
        for sess in outstanding:
            left = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            if not sess.wait(left):
                return False
        return True

    def snapshot(self) -> dict:
        snap = self.metrics.snapshot(store=self.store,
                                     dispatcher=self.dispatcher,
                                     tracer=self.tracer)
        snap.update(self.index_registry.metrics())
        if self.matviews is not None:
            snap.update(self.matviews.metrics())
        if self.auditor is not None:
            snap["audit"] = self.auditor.report()
        return snap

    def metrics_registry(self):
        """Build a fresh ``MetricsRegistry`` and collect every subsystem's
        series into it: gateway throughput + per-tenant SLOs, cache,
        dispatcher, index/matview registries, and (when auditing is on) the
        guarantee CIs and violation counters."""
        from repro_torch.obs.metrics import MetricsRegistry
        reg = MetricsRegistry()
        self.metrics.collect(reg, store=self.store,
                             dispatcher=self.dispatcher)
        for prefix, counters in (("index", self.index_registry.metrics()),
                                 ("matview", self.matviews.metrics()
                                  if self.matviews is not None else {})):
            if not counters:
                continue
            g = reg.gauge(f"repro_{prefix}_registry",
                          f"{prefix} registry counters", ("counter",))
            for k, v in counters.items():
                g.set(v, counter=k)
        if self.auditor is not None:
            self.auditor.collect(reg)
        return reg

    def metrics_text(self) -> str:
        """The Prometheus text exposition of :meth:`metrics_registry`."""
        return self.metrics_registry().render()

    # -- trace / stats export ---------------------------------------------
    def export_trace(self, path: str, *, fmt: str = "jsonl") -> int:
        """Write every span recorded so far; ``fmt`` is ``"jsonl"`` (one
        span per line) or ``"chrome"`` (Perfetto-loadable trace_event
        JSON).  Returns the span count; raises if tracing is off."""
        if self.tracer is None:
            raise RuntimeError("gateway built without trace=True")
        if fmt == "chrome":
            return self.tracer.export_chrome(path)
        if fmt == "jsonl":
            return self.tracer.export_jsonl(path)
        raise ValueError(f"unknown trace format {fmt!r}")

    def session_trace(self, sid: str) -> list:
        """All spans belonging to one serve session (its root span plus
        every descendant, across worker/fragment threads)."""
        if self.tracer is None:
            raise RuntimeError("gateway built without trace=True")
        out = []
        for root in self.tracer.session_spans(sid):
            out.extend(self.tracer.subtree(root))
        return sorted(out, key=lambda s: s.t0)

    def close(self) -> None:
        # drain subscriptions BEFORE closing workers (in-flight runs still
        # resolve), looping until none appear: a subscribe() racing close()
        # either lands in the list (cancelled next pass) or observes
        # _closed and cancels itself
        while True:
            with self._cv:
                subs = list(self._subscriptions)
                self._subscriptions.clear()
                if not subs:
                    self._closed = True
                    break
            for sub in subs:
                sub.cancel(wait=True)
        with self._cv:
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout=10.0)
        if self._fragment_pool is not None:
            self._fragment_pool.shutdown(wait=True)
        if self.auditor is not None:
            # drain pending audit judgments through the still-open
            # dispatcher (its close() flushes remaining buckets), then
            # persist the audit accumulators next to the stats store
            self.auditor.close()
        self.dispatcher.close()
        if self._stats_path:
            # observed operator statistics persist next to the semantic
            # cache, so the next process prices plans from observed reality
            self.stats_store.save(self._stats_path)
        self.store.close()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
