"""Continuous queries: a subscribed pipeline re-executed on new table versions.

``Gateway.subscribe(pipeline)`` wraps a lazy plan whose leaves include at
least one :class:`~repro_torch.stream.table.CorpusTable` ``StreamScan``.  The
subscription listens to every table's change feed and, on each commit,
re-submits the plan *pinned* to the new versions through the normal gateway
admission path (tenant fairness, micro-batch fusion, and the shared
semantic cache all apply).  Delta-awareness is split by operator class:

  * **monotone** ops (sem_filter / sem_map / sem_extract / sem_search /
    sem_sim_join) issue oracle/proxy/embed prompts per row, so the
    re-execution's old-row prompts hit the :class:`SharedSemanticCache`
    and only the delta rows reach a model;
  * **non-monotone** ops (sem_topk / sem_agg / sem_group_by) recompute
    their result from cached per-row judgments (pairwise comparisons,
    per-row labels) plus fresh calls only where new rows create new
    comparisons.

Because each emission executes the pinned plan from scratch through the
same executor, its records are *identical* to a from-scratch run of the
pipeline at that version — the correctness contract ``tests/test_stream.py``
and ``benchmarks/stream_bench.py`` check.

Rapid commits coalesce: the subscription always re-runs at the *latest*
versions, so k commits during one in-flight run produce one catch-up
emission, not k.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from collections import Counter
from typing import Any

from repro_torch.core.plan import nodes as N
from repro_torch.obs import trace as _trace


def find_stream_tables(plan: N.LogicalNode) -> list:
    """All distinct CorpusTables under ``plan``'s StreamScan leaves."""
    out: dict[str, Any] = {}

    def walk(node: N.LogicalNode) -> None:
        if isinstance(node, N.StreamScan):
            out.setdefault(node.table.table_id, node.table)
        for c in node.children():
            walk(c)

    walk(plan)
    return list(out.values())


def pin_stream_scans(plan: N.LogicalNode,
                     versions: dict[str, int] | None = None) -> N.LogicalNode:
    """New plan with every floating StreamScan pinned: to ``versions`` (by
    table id) when given, else to each table's current version.  Pinning
    freezes the row set the whole run sees, so a commit landing mid-query
    cannot make two stages of one pipeline disagree about the corpus."""
    # only rebuild nodes whose subtree actually changed: a plan with no
    # floating StreamScan comes back untouched (every gateway run pins, so
    # pure batch plans must not pay a per-submit deep copy)
    mapping = {}
    for c in plan.children():
        pinned = pin_stream_scans(c, versions)
        if pinned is not c:
            mapping[id(c)] = pinned
    if mapping:
        plan = plan.replace_children(mapping)
    if isinstance(plan, N.StreamScan):
        v = (versions or {}).get(plan.table.table_id, plan.version)
        if v is None:
            v = plan.table.version
        if v != plan.version:
            plan = dataclasses.replace(plan, version=v)
    return plan


@dataclasses.dataclass
class Emission:
    """One continuous-query result: the full record set at ``versions`` plus
    the delta against the subscription's previous emission."""

    versions: dict[str, int]
    records: list | None
    added: list
    removed: list
    sid: str | None = None
    error: BaseException | None = None

    @property
    def version(self) -> int:
        """Single-table convenience: the (max) pinned version."""
        return max(self.versions.values()) if self.versions else 0

    def summary(self) -> dict:
        return {"versions": dict(self.versions), "sid": self.sid,
                "rows": len(self.records) if self.records is not None else None,
                "added": len(self.added), "removed": len(self.removed),
                "error": repr(self.error) if self.error is not None else None}


def _rec_key(rec: dict) -> tuple:
    return tuple(sorted((k, repr(v)) for k, v in rec.items()))


def _diff(prev: list | None, cur: list) -> tuple[list, list]:
    """(added, removed) by record content, multiset semantics."""
    if prev is None:
        return list(cur), []
    have = Counter(_rec_key(r) for r in prev)
    added = []
    for r in cur:
        k = _rec_key(r)
        if have[k] > 0:
            have[k] -= 1
        else:
            added.append(r)
    want = Counter(_rec_key(r) for r in cur)
    removed = []
    for r in prev:
        k = _rec_key(r)
        if want[k] > 0:
            want[k] -= 1
        else:
            removed.append(r)
    return added, removed


class Subscription:
    """A continuous query's handle: an emission queue plus cancellation.

    Created by ``Gateway.subscribe``; one daemon thread serializes this
    subscription's runs (per-version results arrive in version order)."""

    def __init__(self, gateway, plan: N.LogicalNode, *, tenant: str = "default",
                 optimize: bool = True, emit_initial: bool = True):
        if not isinstance(plan, N.LogicalNode):
            raise TypeError("subscribe() takes a LazySemFrame or a plan node, "
                            f"got {type(plan).__name__}")
        self.gateway = gateway
        self.plan = plan
        self.tenant = tenant
        self.optimize = optimize
        self.tables = find_stream_tables(plan)
        if not self.tables:
            raise ValueError("subscribe() needs a pipeline over a CorpusTable "
                             "(no StreamScan leaf in the plan); use submit() "
                             "for one-shot queries")
        self._cv = threading.Condition()
        self._dirty = emit_initial
        self._cancelled = False
        self._emissions: queue.Queue[Emission] = queue.Queue()
        self.last_records: list | None = None
        self._last_versions: dict[str, int] | None = None
        self.emitted = 0
        self.runs = 0
        for t in self.tables:
            t.add_listener(self._on_commit)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"subscription-{tenant}")

    def start(self) -> "Subscription":
        self._thread.start()
        return self

    # -- change feed ---------------------------------------------------------
    def _on_commit(self, version: int) -> None:
        with self._cv:
            self._dirty = True
            self._cv.notify_all()

    # -- the run loop --------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._dirty and not self._cancelled:
                    self._cv.wait()
                if self._cancelled:
                    return
                self._dirty = False
            versions = {t.table_id: t.version for t in self.tables}
            if versions == self._last_versions:
                continue  # version-aware memo: nothing new to compute
            self._run_once(versions)

    def _run_once(self, versions: dict[str, int]) -> None:
        # subscription threads run outside any session's trace context:
        # emission spans root on the gateway's tracer handle directly
        with _trace.span_in(getattr(self.gateway, "tracer", None),
                            f"emission/{self.tenant}", "emission",
                            tenant=self.tenant,
                            version=max(versions.values())) as sp:
            self._run_pinned(versions, sp)

    def _run_pinned(self, versions: dict[str, int], sp) -> None:
        from repro_torch.serve.gateway import AdmissionError
        pinned = pin_stream_scans(self.plan, versions)
        sess = None
        try:
            while True:
                try:
                    sess = self.gateway.submit(pinned, tenant=self.tenant,
                                               optimize=self.optimize)
                    break
                except AdmissionError:          # shed-load backpressure
                    with self._cv:
                        if self._cancelled:
                            return
                        self._cv.wait(timeout=0.02)
            while not sess.wait(0.05):
                with self._cv:
                    if self._cancelled:
                        sess.cancel()
            self.runs += 1
            records = sess.result(timeout=10.0)
        except BaseException as exc:
            with self._cv:
                if self._cancelled:
                    return                      # cancellation is not an error
            sp.set(sid=getattr(sess, "sid", None), error=repr(exc))
            self._push(Emission(versions=versions, records=None, added=[],
                                removed=[], sid=getattr(sess, "sid", None),
                                error=exc))
            return
        added, removed = _diff(self.last_records, records)
        self.last_records = records
        self._last_versions = versions
        sp.set(sid=sess.sid, rows_out=len(records), added=len(added),
               removed=len(removed))
        self._push(Emission(versions=versions, records=records, added=added,
                            removed=removed, sid=sess.sid))

    def _push(self, em: Emission) -> None:
        self._emissions.put(em)
        self.emitted += 1
        self.gateway.metrics.on_emit(error=em.error is not None)
        aud = getattr(self.gateway, "auditor", None)
        if aud is not None:
            aud.observe_emission(
                tenant=self.tenant,
                rows=len(em.records) if em.records is not None else 0,
                added=len(em.added), error=em.error is not None)

    # -- consumer side -------------------------------------------------------
    def poll(self, timeout: float | None = None) -> Emission | None:
        """Next emission, or None when ``timeout`` elapses."""
        try:
            return self._emissions.get(timeout=timeout)
        except queue.Empty:
            return None

    @property
    def pending(self) -> int:
        return self._emissions.qsize()

    @property
    def cancelled(self) -> bool:
        with self._cv:
            return self._cancelled

    def cancel(self, wait: bool = True) -> None:
        with self._cv:
            if self._cancelled:
                wait_thread = wait and self._thread.is_alive()
            else:
                self._cancelled = True
                wait_thread = wait and self._thread.is_alive()
            self._cv.notify_all()
        for t in self.tables:
            t.remove_listener(self._on_commit)
        discard = getattr(self.gateway, "_discard_subscription", None)
        if discard is not None:
            discard(self)
        if wait_thread and threading.current_thread() is not self._thread:
            self._thread.join(timeout=30.0)

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> None:
        self.cancel()

    def summary(self) -> dict:
        return {"tenant": self.tenant, "tables": [t.table_id for t in self.tables],
                "runs": self.runs, "emitted": self.emitted,
                "pending": self.pending, "cancelled": self.cancelled}
