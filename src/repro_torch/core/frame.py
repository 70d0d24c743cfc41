"""SemFrame: the LOTUS DataFrame-style public API (§4).

A SemFrame is a list of dict records plus a bound `Session` (oracle model,
optional proxy model, embedder).  Operators take a langex and optional
accuracy targets; passing targets engages the optimizer (cascades / proxy
plans / learned thresholds), omitting them runs the gold algorithm —
model-data independence in one switch.

    sess = Session(oracle=..., proxy=..., embedder=...)
    sf = SemFrame(records, sess)
    hits = sf.sem_filter("the {claim} is supported",
                         recall_target=0.9, precision_target=0.9, delta=0.2)

Execution is layered frame -> plan -> executor -> engine: every ``sem_*``
call builds a logical plan node (``repro_torch.core.plan.nodes``).  The default
eager path auto-collects the node immediately through ``PlanExecutor`` with
no rewrites and no cache — call-for-call identical to classic eager
semantics.  ``sf.lazy()`` instead accumulates the whole pipeline as a DAG;
``collect()`` runs the rule-based optimizer (filter reordering/pushdown, map
fusion, sim-join prefilters) and executes with prompt-dedup batching:

    out = (sf.lazy()
             .sem_filter("the {claim} is checkable")
             .sem_join(labels, "the {claim} matches the {label:right}")
             .collect())
    print(sf.lazy().sem_filter(...).explain())
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from repro_torch.core import accounting
from repro_torch.core.backends.base import CountedEmbedder, CountedModel
from repro_torch.core.langex import as_langex
from repro_torch.core.operators import search as _search
from repro_torch.core.plan import nodes as PN
from repro_torch.core.plan.adaptive import (AdaptivePlanExecutor, AdaptivePolicy,
                                            adaptive_default)
from repro_torch.core.plan.execute import PartitionedExecutor, PlanExecutor
from repro_torch.core.plan.optimize import PlanOptimizer, explain_plan, total_cost
from repro_torch.device import current_device


@dataclasses.dataclass
class Session:
    oracle: Any
    proxy: Any | None = None
    embedder: Any | None = None
    default_delta: float = 0.2
    sample_size: int = 100
    seed: int = 0

    def __post_init__(self):
        self.oracle = CountedModel(self.oracle, "oracle")
        if self.proxy is not None:
            self.proxy = CountedModel(self.proxy, "proxy")
        if self.embedder is not None:
            self.embedder = CountedEmbedder(self.embedder)


class SemFrame:
    def __init__(self, records: Sequence[dict], session: Session,
                 stats_log: list | None = None):
        current_device()   # CUDA unless set_device("cpu"); raises with no card
        self.records = list(records)
        self.session = session
        self.stats_log = stats_log if stats_log is not None else []

    # -- plumbing ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]

    @property
    def columns(self) -> set:
        return set(self.records[0].keys()) if self.records else set()

    def _child(self, records) -> "SemFrame":
        return SemFrame(records, self.session, self.stats_log)

    def last_stats(self) -> dict:
        return self.stats_log[-1] if self.stats_log else {}

    def lazy(self) -> "LazySemFrame":
        """Switch to lazy plan building: sem_* calls accumulate a logical DAG
        that ``collect()`` optimizes and executes (``explain()`` to inspect)."""
        return LazySemFrame(PN.Scan(self.records), self.session, self.stats_log)

    def _execute(self, node: PN.LogicalNode) -> list[dict]:
        """Eager auto-collect: run one plan node, no rewrites, no cache."""
        return PlanExecutor(self.session, stats_log=self.stats_log).run(node)

    def _scan(self) -> PN.Scan:
        return PN.Scan(self.records)

    # -- sem_filter -------------------------------------------------------
    def sem_filter(self, langex, *, recall_target: float | None = None,
                   precision_target: float | None = None,
                   delta: float | None = None) -> "SemFrame":
        as_langex(langex).validate(self.columns)
        node = PN.Filter(self._scan(), langex, recall_target=recall_target,
                         precision_target=precision_target, delta=delta)
        return self._child(self._execute(node))

    # -- sem_join ---------------------------------------------------------
    def sem_join(self, other: "SemFrame | Sequence[dict]", langex, *,
                 recall_target: float | None = None,
                 precision_target: float | None = None,
                 delta: float | None = None, project_fn: Callable | None = None,
                 force_plan: str | None = None,
                 strategy: str | None = None) -> "SemFrame":
        right = other.records if isinstance(other, SemFrame) else list(other)
        lx = as_langex(langex)
        lx.validate(self.columns, set(right[0].keys()) if right else set())
        node = PN.Join(self._scan(), PN.Scan(right), langex,
                       recall_target=recall_target,
                       precision_target=precision_target, delta=delta,
                       project_fn=project_fn, force_plan=force_plan,
                       strategy=strategy)
        return self._child(self._execute(node))

    # -- sem_topk ---------------------------------------------------------
    def sem_topk(self, langex, k: int, *, algorithm: str = "quickselect",
                 pivot_query: str | None = None, group_by: str | None = None
                 ) -> "SemFrame":
        node = PN.TopK(self._scan(), langex, k, algorithm=algorithm,
                       pivot_query=pivot_query, group_by=group_by)
        return self._child(self._execute(node))

    # -- sem_agg ----------------------------------------------------------
    def sem_agg(self, langex, *, fanout: int = 8, group_by: str | None = None,
                partitioner=None):
        node = PN.Agg(self._scan(), langex, fanout=fanout, group_by=group_by,
                      partitioner=partitioner)
        rows = self._execute(node)
        if group_by is not None:
            return {row[group_by]: row["aggregate"] for row in rows}
        return rows[0]["aggregate"]

    # -- sem_group_by -----------------------------------------------------
    def sem_group_by(self, langex, C: int, *, accuracy_target: float | None = None,
                     delta: float | None = None) -> "SemFrame":
        node = PN.GroupBy(self._scan(), langex, C,
                          accuracy_target=accuracy_target, delta=delta)
        return self._child(self._execute(node))

    # -- sem_map / sem_extract ---------------------------------------------
    def sem_map(self, langex, *, out_column: str = "mapped") -> "SemFrame":
        node = PN.Map(self._scan(), langex, out_column=out_column)
        return self._child(self._execute(node))

    def sem_extract(self, langex, *, source_field: str,
                    out_column: str = "extracted") -> "SemFrame":
        node = PN.Extract(self._scan(), langex, source_field=source_field,
                          out_column=out_column)
        return self._child(self._execute(node))

    # -- similarity family --------------------------------------------------
    def sem_index(self, column: str, *, path: str | None = None,
                  index: str = "exact", **index_kw):
        """Build a retrieval index over a column ("exact" | "ivf" | "auto");
        ``index_kw`` (n_clusters, nprobe, recall_target, ...) tunes IVF."""
        return _search.sem_index([str(t[column]) for t in self.records],
                                 self.session.embedder, path=path,
                                 index=index, **index_kw)

    def sem_search(self, column: str, query: str, *, k: int = 10,
                   n_rerank: int = 0, rerank_langex=None, index=None,
                   index_kind: str = "exact", nprobe: int | None = None,
                   quantize: str | None = None) -> "SemFrame":
        """Eager search defaults to the exact index (classic semantics);
        pass ``index_kind="ivf"`` (or "auto") to opt into ANN retrieval,
        and ``quantize="int8"`` for int8 IVF tiles + exact rerank.  The
        lazy path's optimizer makes both choices cost-based instead."""
        node = PN.Search(self._scan(), column, query, k=k, n_rerank=n_rerank,
                         rerank_langex=rerank_langex, index=index,
                         index_kind=index_kind, nprobe=nprobe,
                         quantize=quantize)
        return self._child(self._execute(node))

    def sem_sim_join(self, other: "SemFrame | Sequence[dict]", left_col: str,
                     right_col: str, *, k: int = 1, index_kind: str = "exact",
                     nprobe: int | None = None, quantize: str | None = None
                     ) -> "SemFrame":
        right = other.records if isinstance(other, SemFrame) else list(other)
        node = PN.SimJoin(self._scan(), PN.Scan(right), left_col, right_col,
                          k=k, index_kind=index_kind, nprobe=nprobe,
                          quantize=quantize)
        return self._child(self._execute(node))


class LazySemFrame:
    """A logical plan under construction; same sem_* surface as SemFrame but
    nothing executes until ``collect()``.

    ``collect(optimize=True)`` runs the rewrite passes and executes with the
    ``BatchedModelCache`` (prompt dedup across all pipeline stages);
    ``collect(optimize=False)`` executes the plan as written with no cache —
    record- and stats-identical to the eager path.  ``explain()`` returns the
    before/after plan trees plus the applied rewrites.
    """

    def __init__(self, plan: PN.LogicalNode, session: Session,
                 stats_log: list | None = None):
        current_device()   # CUDA unless set_device("cpu"); raises with no card
        self.plan = plan
        self.session = session
        self.stats_log = stats_log if stats_log is not None else []
        self.last_rewrites: list = []
        self._exec_pair: tuple | None = None  # (opt_kw, optimizer, executor)

    # -- plumbing ---------------------------------------------------------
    @property
    def columns(self) -> set:
        return self.plan.columns()

    def _child(self, plan: PN.LogicalNode) -> "LazySemFrame":
        return LazySemFrame(plan, self.session, self.stats_log)

    def _right_plan(self, other) -> PN.LogicalNode:
        if isinstance(other, LazySemFrame):
            return other.plan
        if isinstance(other, SemFrame):
            return PN.Scan(other.records)
        return PN.Scan(list(other))

    # -- operators (plan builders) ----------------------------------------
    def sem_filter(self, langex, *, recall_target: float | None = None,
                   precision_target: float | None = None,
                   delta: float | None = None) -> "LazySemFrame":
        as_langex(langex).validate(self.columns)
        return self._child(PN.Filter(self.plan, langex,
                                     recall_target=recall_target,
                                     precision_target=precision_target,
                                     delta=delta))

    def sem_join(self, other, langex, *, recall_target: float | None = None,
                 precision_target: float | None = None,
                 delta: float | None = None, project_fn: Callable | None = None,
                 force_plan: str | None = None,
                 strategy: str | None = None) -> "LazySemFrame":
        right = self._right_plan(other)
        as_langex(langex).validate(self.columns, right.columns())
        return self._child(PN.Join(self.plan, right, langex,
                                   recall_target=recall_target,
                                   precision_target=precision_target,
                                   delta=delta, project_fn=project_fn,
                                   force_plan=force_plan,
                                   strategy=strategy))

    def sem_topk(self, langex, k: int, *, algorithm: str = "quickselect",
                 pivot_query: str | None = None,
                 group_by: str | None = None) -> "LazySemFrame":
        return self._child(PN.TopK(self.plan, langex, k, algorithm=algorithm,
                                   pivot_query=pivot_query, group_by=group_by))

    def sem_agg(self, langex, *, fanout: int = 8, group_by: str | None = None,
                partitioner=None) -> "LazySemFrame":
        return self._child(PN.Agg(self.plan, langex, fanout=fanout,
                                  group_by=group_by, partitioner=partitioner))

    def sem_group_by(self, langex, C: int, *,
                     accuracy_target: float | None = None,
                     delta: float | None = None) -> "LazySemFrame":
        return self._child(PN.GroupBy(self.plan, langex, C,
                                      accuracy_target=accuracy_target,
                                      delta=delta))

    def sem_map(self, langex, *, out_column: str = "mapped") -> "LazySemFrame":
        return self._child(PN.Map(self.plan, langex, out_column=out_column))

    def sem_extract(self, langex, *, source_field: str,
                    out_column: str = "extracted") -> "LazySemFrame":
        return self._child(PN.Extract(self.plan, langex,
                                      source_field=source_field,
                                      out_column=out_column))

    def sem_search(self, column: str, query: str, *, k: int = 10,
                   n_rerank: int = 0, rerank_langex=None, index=None,
                   index_kind: str = "auto", nprobe: int | None = None,
                   quantize: str | None = None) -> "LazySemFrame":
        return self._child(PN.Search(self.plan, column, query, k=k,
                                     n_rerank=n_rerank,
                                     rerank_langex=rerank_langex, index=index,
                                     index_kind=index_kind, nprobe=nprobe,
                                     quantize=quantize))

    def sem_sim_join(self, other, left_col: str, right_col: str, *,
                     k: int = 1, index_kind: str = "auto",
                     nprobe: int | None = None, quantize: str | None = None
                     ) -> "LazySemFrame":
        return self._child(PN.SimJoin(self.plan, self._right_plan(other),
                                      left_col, right_col, k=k,
                                      index_kind=index_kind, nprobe=nprobe,
                                      quantize=quantize))

    # -- optimize / execute ------------------------------------------------
    def _optimizer_and_executor(self, **opt_kw):
        """One (optimizer, executor) pair per frame+options: explain() and a
        later collect() share the BatchedModelCache, so selectivity probes
        are paid once, not once per call.

        ``n_partitions=`` opts into partition planning (fragments run
        serially unless ``fragment_workers`` > 1 adds a private pool);
        results are identical either way — partitioned execution preserves
        single-partition outputs by construction."""
        key = tuple(sorted(opt_kw.items()))
        if self._exec_pair is not None and self._exec_pair[0] == key:
            return self._exec_pair[1], self._exec_pair[2]
        if self._exec_pair is not None:  # new options: release the old
            self._exec_pair[2].close(wait=False)  # executor's fragment pool
        opt_kw = dict(opt_kw)
        fragment_workers = opt_kw.pop("fragment_workers", 0)
        # adaptive=True (or adaptive_policy=...) swaps in the mid-query
        # re-optimizing executor; the REPRO_ADAPTIVE env flips the default
        policy = opt_kw.pop("adaptive_policy", None)
        adaptive = opt_kw.pop("adaptive", None)
        if adaptive is None:
            adaptive = policy is not None or adaptive_default()
        matviews = opt_kw.pop("matviews", None)
        # the executor's "auto" index builds (join sim-prefilter) must obey
        # the same retrieval knobs the optimizer plans with; the stats store
        # feeds both the executor (observation) and optimizer (costing)
        exec_kw = {k: opt_kw[k]
                   for k in ("recall_target", "index_min_corpus",
                             "stats_store")
                   if k in opt_kw}
        if adaptive:
            executor = AdaptivePlanExecutor(
                self.session, stats_log=self.stats_log, use_cache=True,
                fragment_workers=fragment_workers, matviews=matviews,
                policy=policy if isinstance(policy, AdaptivePolicy) else None,
                **exec_kw)
        else:
            executor = PartitionedExecutor(
                self.session, stats_log=self.stats_log, use_cache=True,
                fragment_workers=fragment_workers, matviews=matviews,
                **exec_kw)
        optimizer = PlanOptimizer(self.session, oracle=executor.oracle,
                                  proxy=executor.proxy,
                                  seed=self.session.seed, **opt_kw)
        if adaptive:
            executor.optimizer = optimizer
        self._exec_pair = (key, optimizer, executor)
        return optimizer, executor

    def collect(self, *, optimize: bool = True, **opt_kw) -> SemFrame:
        if not optimize:
            records = PlanExecutor(self.session,
                                   stats_log=self.stats_log).run(self.plan)
            self.last_rewrites = []
            return SemFrame(records, self.session, self.stats_log)
        optimizer, executor = self._optimizer_and_executor(**opt_kw)
        # probe calls (selectivity sampling) are real model traffic: account
        # for them as their own pipeline stage — they flow through the
        # executor's cache, so execution re-uses every probed label
        with accounting.track("plan_optimize") as st:
            plan = optimizer.optimize(self.plan)
        st.details.update(rewrites=[str(r) for r in optimizer.applied])
        self.stats_log.append(st.as_dict())
        self.last_rewrites = optimizer.applied
        records = executor.run(plan)
        return SemFrame(records, self.session, self.stats_log)

    def explain(self, *, optimize: bool = True, **opt_kw) -> str:
        store = opt_kw.get("stats_store")
        out = ["== logical plan (as written) ==",
               explain_plan(self.plan, stats_store=store),
               f"-- estimated oracle calls: {total_cost(self.plan):.0f}"]
        if optimize:
            optimizer, _ = self._optimizer_and_executor(**opt_kw)
            with accounting.track("plan_explain") as st:
                plan = optimizer.optimize(self.plan)
            if st.lm_calls or st.cache_hits:  # probes are real model traffic
                self.stats_log.append(st.as_dict())
            out += ["", "== optimized plan ==",
                    explain_plan(plan, stats_store=store),
                    f"-- estimated oracle calls: {total_cost(plan):.0f}",
                    "", "== applied rewrites =="]
            out += [f" * {r}" for r in optimizer.applied] or [" (none)"]
        return "\n".join(out)
