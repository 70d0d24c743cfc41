"""PlanExecutor: the batched physical layer under the plan IR.

Walks a (possibly optimized) logical DAG bottom-up and dispatches each node
to the gold/cascade operator implementations in ``repro_torch.core.operators``.
All model traffic goes through the executor's oracle/proxy handles; when the
executor is built with ``use_cache=True`` (the ``LazySemFrame.collect()``
path) those handles are ``BatchedModelCache`` wrappers, so a prompt answered
anywhere in the pipeline — including by the optimizer's selectivity probes —
is never re-issued to the backend.  The eager ``SemFrame`` path builds the
executor without the cache, which makes it call-for-call identical to the
pre-plan-layer behavior.

Partitioning: the base executor treats ``Partition``/``Exchange`` nodes as
transparent wrappers (single-partition semantics — by the IR contract that
fragmentation never changes results).  :class:`PartitionedExecutor` instead
executes each Exchange-bounded region as fragments over row partitions with
the guarantee-preserving merges of ``repro_torch.core.plan.parallel`` — serially
without a pool, concurrently on a fragment thread pool (its own, or one the
serving gateway shares across sessions).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core import accounting
from repro_torch.core.operators import agg as _agg
from repro_torch.obs import trace as _trace
from repro_torch.core.operators import filter as _filter
from repro_torch.core.operators import groupby as _groupby
from repro_torch.core.operators import join as _join
from repro_torch.core.operators import mapex as _mapex
from repro_torch.core.operators import search as _search
from repro_torch.core.operators import topk as _topk
from repro_torch.core.plan import nodes as N
from repro_torch.core.plan import parallel
from repro_torch.core.plan.cache import BatchedModelCache
from repro_torch.index.backend import MASKED_SCORE


class PlanExecutor:
    def __init__(self, session, *, stats_log: list | None = None,
                 use_cache: bool = False, oracle=None, proxy=None,
                 embedder=None, stage_hook=None, index_registry=None,
                 recall_target: float = 0.95,
                 index_min_corpus: int | None = None, stats_store=None,
                 matviews=None):
        self.session = session
        # cross-session observed-statistics feed (repro_torch.obs.StatsStore);
        # None -> no observation overhead
        self.stats_store = stats_store
        # semantic materialized-view registry (repro_torch.serve.matview): when
        # installed, every materializable subplan consults it by plan
        # fingerprint before executing, so concurrent sessions sharing a
        # subplan compute it once
        self.matviews = matviews
        self._matview_fp: dict[int, str | None] = {}
        self._matview_active: set[str] = set()
        self.stats_log = stats_log if stats_log is not None else []
        if oracle is None:
            oracle = BatchedModelCache(session.oracle) if use_cache else session.oracle
        if proxy is None and session.proxy is not None:
            proxy = BatchedModelCache(session.proxy) if use_cache else session.proxy
        self.oracle = oracle
        self.proxy = proxy
        self.embedder = embedder if embedder is not None else session.embedder
        # called before every node dispatch — the serving gateway's yield
        # point for cancellation / deadline checks between pipeline stages
        self.stage_hook = stage_hook
        # process-wide index sharing (the serving gateway passes one
        # IndexRegistry so concurrent sessions over the same corpus build
        # and embed once); None -> build per call (eager/lazy single-query)
        self.index_registry = index_registry
        # retrieval knobs for "auto" builds the optimizer didn't annotate
        # (e.g. the join sim-prefilter): recall_target=1.0 must force exact
        # everywhere for the record-identical contract to hold
        self.recall_target = recall_target
        self.index_min_corpus = index_min_corpus

    # -- retrieval plumbing ------------------------------------------------
    def _build_index(self, texts: list[str], *, kind: str = "auto",
                     nprobe: int | None = None, n_queries: int = 1,
                     shards: int | None = None, quantize: str | None = None):
        """Embed + index ``texts`` through the RetrievalBackend layer,
        consulting the shared IndexRegistry when one is installed.
        ``shards`` (optimizer-installed device layout) and ``quantize``
        (IVF tile precision) become build params, so the registry keys
        sharded/unsharded and int8/fp32 builds of the same corpus
        separately — a cached build never aliases across precisions."""
        from repro_torch.index.backend import (IVF_MIN_CORPUS,
                                               choose_retrieval_config)
        if kind == "auto":
            # a registry amortizes the IVF build across sessions; without
            # one the index dies with this call, so the build must pay for
            # itself against a single exact scan
            cfg = choose_retrieval_config(
                len(texts), max(n_queries, 1),
                recall_target=self.recall_target,
                min_corpus=self.index_min_corpus or IVF_MIN_CORPUS,
                shared=self.index_registry is not None)
            kind = cfg["kind"]
            nprobe = nprobe if nprobe is not None else cfg["nprobe"]
            quantize = quantize if quantize is not None else cfg["quantize"]
        kw = {"nprobe": nprobe} if (kind == "ivf" and nprobe) else {}
        if kind == "ivf" and quantize and quantize != "none":
            kw["quantize"] = quantize
        if shards and shards > 1:
            kw["shards"] = int(shards)
        if self.index_registry is None:
            return _search.sem_index(texts, self.embedder, index=kind, **kw)
        return self.index_registry.get_or_build(
            texts, self.embedder, kind=kind, params=kw,
            builder=lambda: _search.sem_index(texts, self.embedder,
                                              index=kind, **kw))

    def _build_stream_index(self, scan: N.StreamScan, column: str,
                            n_corpus: int, *, kind: str = "auto",
                            nprobe: int | None = None, n_queries: int = 1,
                            shards: int | None = None,
                            quantize: str | None = None):
        """Version-aware index for a StreamScan corpus: the registry keys on
        (table id, embedder, config) instead of a content fingerprint, so an
        appends-only commit reuses the cached base index and embeds/indexes
        only the delta rows (``IndexRegistry.get_or_update``)."""
        from repro_torch.index.backend import (IVF_MIN_CORPUS,
                                               choose_retrieval_config)
        table = scan.table
        version = scan.version if scan.version is not None else table.version
        if kind == "auto":
            cfg = choose_retrieval_config(
                n_corpus, max(n_queries, 1),
                recall_target=self.recall_target,
                min_corpus=self.index_min_corpus or IVF_MIN_CORPUS,
                shared=True)
            kind = cfg["kind"]
            quantize = quantize if quantize is not None else cfg["quantize"]
        # key by the recall target, NOT a size-derived nprobe: the derived
        # probe count shifts as the table grows, and a shifting key would
        # turn every append into a full rebuild; the index derives (and on
        # retrain re-derives) nprobe from the target itself.  A user-pinned
        # nprobe stays in the key — it is corpus-size-independent.
        if kind != "ivf":
            kw = {}
        elif nprobe is not None:
            kw = {"nprobe": nprobe}
        else:
            kw = {"recall_target": self.recall_target}
        if kind == "ivf" and quantize and quantize != "none":
            # tile precision is corpus-size-independent and changes stored
            # bytes + scores: it must live in the versioned key so int8 and
            # fp32 builds of the same table never alias
            kw["quantize"] = quantize
        if shards and shards > 1:
            # shard layout is corpus-size-independent (device count), so it
            # is safe in the versioned key — appends keep reusing the entry
            kw["shards"] = int(shards)

        def builder(records):
            return _search.sem_index([str(t[column]) for t in records],
                                     self.embedder, index=kind, **kw)

        def updater(index, added):
            with accounting.track("sem_index_delta") as st:
                texts = [str(t[column]) for t in added]
                index.add(self.embedder.embed(texts))
                st.details.update(index=index.kind, delta_rows=len(texts),
                                  table=table.table_id, version=version)
            self.stats_log.append(st.as_dict())

        return self.index_registry.get_or_update(
            table, self.embedder, version=version, kind=kind, params=kw,
            builder=builder, updater=updater)

    def _corpus_index(self, child: N.LogicalNode, texts: list[str], column: str,
                      *, kind: str = "auto", nprobe: int | None = None,
                      n_queries: int = 1, shards: int | None = None,
                      quantize: str | None = None, index_auto: bool = False):
        """Executor delta routing: a StreamScan corpus under a registry goes
        through the versioned reuse path; everything else builds (or fetches
        by content fingerprint) as before.  ``child`` is unwrapped through
        Partition/Exchange markers — fragmentation never changes what corpus
        an index covers.  ``index_auto`` flags an optimizer-estimated (not
        user-pinned) kind; the base executor honors the plan as written and
        the adaptive subclass may re-choose on observed corpus size."""
        child = N.plain(child)
        if self.index_registry is not None and isinstance(child, N.StreamScan):
            return self._build_stream_index(child, column, len(texts), kind=kind,
                                            nprobe=nprobe, n_queries=n_queries,
                                            shards=shards, quantize=quantize)
        return self._build_index(texts, kind=kind, nprobe=nprobe,
                                 n_queries=n_queries, shards=shards,
                                 quantize=quantize)

    # -- plumbing ---------------------------------------------------------
    def _log(self, stats: dict, node=None, *, n_in: int | None = None,
             n_out: int | None = None) -> dict:
        self.stats_log.append(stats)
        # observed cardinalities: annotate the active plan-stage span (for
        # explain_analyze) and feed the cross-session StatsStore
        if n_in is not None:
            sp = _trace.current_span()
            if sp is not None and sp.kind == "plan_stage":
                sp.set(rows_in=n_in, rows_out=n_out)
            if self.stats_store is not None and node is not None:
                self.stats_store.observe_node(node, stats, rows_in=n_in,
                                              rows_out=n_out or 0)
        # every operator logs right after its model work: together with the
        # descent-time check in run() this yields between pipeline stages,
        # so a cancellation lands before the *next* stage's model calls
        if self.stage_hook is not None:
            self.stage_hook(None)
        return stats

    def _targets(self, node) -> dict:
        s = self.session
        return dict(
            recall_target=node.recall_target or 0.9,
            precision_target=node.precision_target or 0.9,
            delta=node.delta if node.delta is not None else s.default_delta,
            sample_size=s.sample_size, seed=s.seed)

    def run(self, node: N.LogicalNode) -> list[dict]:
        if self.stage_hook is not None:
            self.stage_hook(node)
        fn = getattr(self, f"_run_{type(node).__name__.lower()}")
        if self.matviews is not None:
            inner = fn
            fn = lambda n: self._matview_dispatch(n, inner)
        if _trace.current_tracer() is None:
            return fn(node)
        # one span per plan node; node_id keys the explain_analyze join
        # between the executed span tree and the optimized plan tree
        with _trace.span(type(node).__name__, kind="plan_stage",
                         label=node.label(), node_id=id(node)) as sp:
            out = fn(node)
            sp.set(rows_out=len(out))
            return out

    def _matview_dispatch(self, node: N.LogicalNode, inner) -> list[dict]:
        """Consult the materialized-view registry before executing a
        materializable subplan.  Exchange/Partition wrappers fingerprint as
        their wrapped operator, so the consult happens at the outermost
        wrapper; ``_matview_active`` keeps the in-progress key from being
        re-consulted by the nested run() of the same subplan (the compute
        path descends through the very nodes that produced the key)."""
        key = self.matviews.key_for(node, memo=self._matview_fp)
        if key is None or key in self._matview_active:
            return inner(node)
        self._matview_active.add(key)
        try:
            records, hit = self.matviews.get_or_compute(
                key, lambda: inner(node), wait_hook=self.stage_hook)
        finally:
            self._matview_active.discard(key)
        if hit:
            self.stats_log.append({"operator": "matview_hit",
                                   "rows_out": len(records),
                                   "key": key[:16]})
            sp = _trace.current_span()
            if sp is not None and sp.kind == "plan_stage":
                sp.set(matview=True, rows_out=len(records))
        return records

    # -- leaves ------------------------------------------------------------
    def _run_scan(self, node: N.Scan) -> list[dict]:
        return list(node.records)

    def _run_streamscan(self, node: N.StreamScan) -> list[dict]:
        # pinned version -> reproducible snapshot; floating -> current rows
        return node.records

    # -- partition boundaries ----------------------------------------------
    # Partition/Exchange are semantically transparent by IR contract, so the
    # base executor runs them single-partition (identical results); the
    # PartitionedExecutor subclass overrides _run_exchange with real
    # fragment-parallel execution.
    def _run_partition(self, node: N.Partition) -> list[dict]:
        return self.run(node.child)

    def _run_exchange(self, node: N.Exchange) -> list[dict]:
        return self.run(node.child)

    # -- filter ------------------------------------------------------------
    def _run_filter(self, node: N.Filter) -> list[dict]:
        recs = self.run(node.child)
        if not node.is_cascade:
            mask, stats = _filter.sem_filter_gold(recs, node.langex, self.oracle)
        else:
            if self.proxy is None:
                raise ValueError("optimized sem_filter needs a proxy model in the Session")
            mask, stats = _filter.sem_filter_cascade(
                recs, node.langex, self.oracle, self.proxy, **self._targets(node))
        out = [t for t, m in zip(recs, mask) if m]
        self._log(stats, node, n_in=len(recs), n_out=len(out))
        return out

    # -- join --------------------------------------------------------------
    def _join_dispatch(self, node: N.Join, left, right):
        """Strategy dispatch shared by this executor and the adaptive
        subclass: ``strategy=None`` reproduces the historical dispatch
        bit-identically (cascade iff targets are set, else prefilter/gold);
        ``"cascade"`` forces the pairwise cascade; ``"block"`` runs the
        three-stage fast path; ``"auto"`` resolves through the optimizer's
        cost model at observed cardinalities."""
        strategy = node.strategy
        if strategy == "auto":
            from repro_torch.core.plan.optimize import resolve_join_strategy
            strategy = resolve_join_strategy(len(left), len(right))
        if strategy == "block":
            if self.embedder is None:
                raise ValueError("block sem_join needs an embedder in the Session")
            return _join.sem_join_block(
                left, right, node.langex, self.oracle, self.embedder,
                equivalence=node.langex.equivalence or None,
                index_builder=lambda texts, nq: self._build_index(
                    texts, n_queries=nq),
                **self._targets(node))
        if strategy == "cascade" or (strategy is None and node.is_cascade):
            if self.embedder is None:
                raise ValueError("optimized sem_join needs an embedder in the Session")
            return _join.sem_join_cascade(
                left, right, node.langex, self.oracle, self.embedder,
                project_fn=node.project_fn, force_plan=node.force_plan,
                **self._targets(node))
        if node.prefilter_k:
            return self._join_prefiltered(node, left, right)
        return _join.sem_join_gold(left, right, node.langex, self.oracle)

    def _run_join(self, node: N.Join) -> list[dict]:
        left = self.run(node.left)
        right = self.run(node.right)
        mask, stats = self._join_dispatch(node, left, right)
        out = []
        n1, n2 = mask.shape
        for i in range(n1):
            for j in range(n2):
                if mask[i, j]:
                    out.append({**left[i],
                                **{f"right_{k}": v for k, v in right[j].items()}})
        # candidate space for a join is the pair grid, so selectivity is
        # matches / (n1*n2) — the quantity the optimizer's join estimate uses
        self._log(stats, node, n_in=n1 * n2, n_out=len(out))
        return out

    def _join_prefiltered(self, node: N.Join, left, right):
        """Gold join narrowed to each left row's top-k most-similar right rows
        (the optimizer-injected sem_sim_join prefilter; trades a recall tail
        for an n1*k instead of n1*n2 oracle bill)."""
        lx = node.langex
        with accounting.track("sem_join_prefiltered") as st:
            n1, n2 = len(left), len(right)
            k = min(node.prefilter_k, n2)
            lfields = [f for f in lx.fields if f.side != "right"]
            rfields = [f for f in lx.fields if f.side == "right"]
            # candidate retrieval rides the RetrievalBackend layer (shared
            # with sem_sim_join: exact or IVF by the cost model / registry)
            right_index = self._build_index(
                _join._render_side(right, rfields), n_queries=n1)
            emb_l = self.embedder.embed(_join._render_side(left, lfields))
            _, cand = right_index.search(emb_l, k)
            pairs = [(i, int(j)) for i in range(n1) for j in cand[i]]
            passed, _ = self.oracle.predicate(_join._pair_prompts(lx, left, right, pairs))
            mask = np.zeros((n1, n2), bool)
            for (i, j), p in zip(pairs, passed):
                mask[i, j] = p
            st.details.update(prefilter_k=k, candidate_pairs=len(pairs),
                              pruned_pairs=n1 * n2 - len(pairs),
                              index=right_index.kind,
                              **{f"index_{kk}": v for kk, v in
                                 right_index.last_stats.items()
                                 if kk in ("scored_vectors", "probed_clusters")})
            return mask, st.as_dict()

    # -- topk --------------------------------------------------------------
    def _run_topk(self, node: N.TopK) -> list[dict]:
        recs = self.run(node.child)
        if node.group_by is not None:
            groups: dict = {}
            for t in recs:
                groups.setdefault(t[node.group_by], []).append(t)
            out = []
            for _, sub in sorted(groups.items(), key=lambda kv: str(kv[0])):
                child = dataclasses.replace(node, child=N.Scan(sub), group_by=None)
                out.extend(self.run(child))
            return out

        s = self.session
        pivot_scores = None
        if node.pivot_query is not None and self.embedder is not None:
            # pivot selection rides the retrieval layer: the corpus index is
            # registry-shared, so concurrent sessions embed the texts once
            index = self._build_index([node.langex.render(t) for t in recs],
                                      kind="exact")
            qv = self.embedder.embed([node.pivot_query])
            pivot_scores = index.pairwise(qv)[0]
        fn = {"quickselect": _topk.sem_topk_quickselect,
              "quadratic": _topk.sem_topk_quadratic,
              "heap": _topk.sem_topk_heap}[node.algorithm]
        if node.algorithm == "quickselect":
            idx, stats = fn(recs, node.langex, node.k, self.oracle,
                            pivot_scores=pivot_scores, seed=s.seed)
        else:
            idx, stats = fn(recs, node.langex, node.k, self.oracle)
        self._log(stats, node, n_in=len(recs), n_out=len(idx))
        return [recs[i] for i in idx]

    # -- agg ---------------------------------------------------------------
    def _run_agg(self, node: N.Agg) -> list[dict]:
        recs = self.run(node.child)
        if node.group_by is not None:
            groups: dict = {}
            for t in recs:
                groups.setdefault(t[node.group_by], []).append(t)
            out = []
            for g, sub in groups.items():
                answer, stats = _agg.sem_agg_hierarchical(
                    sub, node.langex, self.oracle,
                    fanout=node.fanout, partitioner=node.partitioner)
                self._log(stats, node, n_in=len(sub), n_out=1)
                out.append({node.group_by: g, node.out_column: answer})
            return out
        answer, stats = _agg.sem_agg_hierarchical(
            recs, node.langex, self.oracle,
            fanout=node.fanout, partitioner=node.partitioner)
        self._log(stats, node, n_in=len(recs), n_out=1)
        return [{node.out_column: answer}]

    # -- group_by ----------------------------------------------------------
    def _run_groupby(self, node: N.GroupBy) -> list[dict]:
        recs = self.run(node.child)
        s = self.session
        if self.embedder is None:
            raise ValueError("sem_group_by needs an embedder in the Session")
        if node.accuracy_target is None:
            res = _groupby.sem_group_by_gold(recs, node.langex, node.C,
                                             self.oracle, self.embedder, seed=s.seed)
        else:
            res = _groupby.sem_group_by_cascade(
                recs, node.langex, node.C, self.oracle, self.embedder,
                accuracy_target=node.accuracy_target,
                delta=node.delta if node.delta is not None else s.default_delta,
                sample_size=s.sample_size, seed=s.seed)
        self._log(res.stats, node, n_in=len(recs), n_out=len(recs))
        return [{**t, "group": int(g), "group_label": res.labels[int(g)]}
                for t, g in zip(recs, res.assignment)]

    # -- map family --------------------------------------------------------
    def _run_map(self, node: N.Map) -> list[dict]:
        recs = self.run(node.child)
        texts, stats = _mapex.sem_map(recs, node.langex, self.oracle)
        self._log(stats, node, n_in=len(recs), n_out=len(recs))
        return [{**t, node.out_column: x} for t, x in zip(recs, texts)]

    def _run_fusedmap(self, node: N.FusedMap) -> list[dict]:
        recs = self.run(node.child)
        columns, stats = _mapex.sem_map_fused(recs, node.langexes, self.oracle)
        self._log(stats, node, n_in=len(recs), n_out=len(recs))
        return [{**t, **{c: col[i] for c, col in zip(node.out_columns, columns)}}
                for i, t in enumerate(recs)]

    def _run_extract(self, node: N.Extract) -> list[dict]:
        recs = self.run(node.child)
        texts, stats = _mapex.sem_extract(recs, node.langex, self.oracle,
                                          source_field=node.source_field)
        self._log(stats, node, n_in=len(recs), n_out=len(recs))
        return [{**t, node.out_column: x} for t, x in zip(recs, texts)]

    # -- similarity family -------------------------------------------------
    def _run_search(self, node: N.Search) -> list[dict]:
        recs = self.run(node.child)
        index = node.index or self._corpus_index(
            node.child, [str(t[node.column]) for t in recs], node.column,
            kind=node.index_kind, nprobe=node.nprobe, shards=node.shards,
            quantize=node.quantize, index_auto=node.index_auto)
        # a shared stream index can be ahead of this run's pinned snapshot
        # (a commit landed mid-query): bound hits to the snapshot's rows
        cutoff = len(recs) \
            if isinstance(N.plain(node.child), N.StreamScan) else None
        hits, stats = _search.sem_search(
            index, node.query, self.embedder, k=node.k, n_rerank=node.n_rerank,
            rerank_model=self.oracle if node.n_rerank else None,
            records=recs, rerank_langex=node.rerank_langex, max_pos=cutoff)
        out = [recs[i] for i in hits if i < len(recs)]
        self._log(stats, node, n_in=len(recs), n_out=len(out))
        return out

    def _run_simjoin(self, node: N.SimJoin) -> list[dict]:
        left = self.run(node.left)
        right = self.run(node.right)
        index = self._corpus_index(node.right,
                                   [str(t[node.right_col]) for t in right],
                                   node.right_col, kind=node.index_kind,
                                   nprobe=node.nprobe, n_queries=len(left),
                                   shards=node.shards, quantize=node.quantize,
                                   index_auto=node.index_auto)
        cutoff = len(right) \
            if isinstance(N.plain(node.right), N.StreamScan) else None
        scores, idx, stats = _search.sem_sim_join(
            [str(t[node.left_col]) for t in left], index, self.embedder,
            k=node.k, max_pos=cutoff)
        out = self._simjoin_rows(left, right, scores, idx)
        self._log(stats, node, n_in=len(left), n_out=len(out))
        return out

    def _simjoin_rows(self, left, right, scores, idx) -> list[dict]:
        out = []
        for i, t in enumerate(left):
            for rank in range(idx.shape[1]):
                j = int(idx[i, rank])
                if j >= len(right) or scores[i, rank] <= MASKED_SCORE / 2:
                    continue  # beyond the pinned snapshot / unfilled slot
                out.append({**t, **{f"right_{kk}": v for kk, v in right[j].items()},
                            "sim_score": float(scores[i, rank])})
        return out


class PartitionedExecutor(PlanExecutor):
    """PlanExecutor that actually runs Exchange-bounded plan fragments.

    ``_run_exchange`` dispatches the merged operator to its partitioned
    implementation (``repro_torch.core.plan.parallel`` / ``sem_topk_partitioned``)
    over the row partitions declared by the Partition node below it.  Every
    merge preserves the single-partition output — gold ops are row- or
    pair-tiled with unchanged prompts, cascades calibrate on one global
    importance sample, agg fragments align to reduction-tree subtrees, and
    top-k merges partition winners losslessly through a shared comparator —
    so a partitioned plan returns exactly what the base executor would.

    Fragments run serially without a pool, or concurrently on
    ``fragment_pool`` (the serving gateway shares one across sessions;
    ``fragment_workers`` > 1 instead creates a private pool — ``close()``
    releases it).  ``fragments_run`` / ``partitioned_ops`` feed the
    gateway's per-session metrics.
    """

    def __init__(self, session, *, fragment_pool=None,
                 fragment_workers: int = 0, **kw):
        super().__init__(session, **kw)
        self._own_pool = None
        if fragment_pool is None and fragment_workers > 1:
            fragment_pool = self._own_pool = ThreadPoolExecutor(
                max_workers=fragment_workers, thread_name_prefix="plan-frag")
        self._pool = fragment_pool
        self.fragments_run = 0
        self.partitioned_ops = 0

    def close(self, *, wait: bool = True) -> None:
        if self._own_pool is not None:
            self._own_pool.shutdown(wait=wait)
            self._own_pool = None
            self._pool = None

    def __del__(self):  # GC backstop for private pools; close() is the API
        try:
            self.close(wait=False)
        except Exception:  # pragma: no cover - interpreter shutdown
            pass

    def _count(self, n_fragments: int) -> None:
        self.fragments_run += n_fragments
        self.partitioned_ops += 1

    # -- dispatch ----------------------------------------------------------
    def _run_exchange(self, node: N.Exchange) -> list[dict]:
        if node.kind == "broadcast":
            # replication marker: rows are unchanged, distribution is the
            # consuming operator's business
            return self.run(node.child)
        child = node.child
        handler = {
            N.Filter: self._part_filter, N.Map: self._part_map,
            N.FusedMap: self._part_fusedmap, N.Extract: self._part_extract,
            N.TopK: self._part_topk, N.Agg: self._part_agg,
            N.Join: self._part_join, N.SimJoin: self._part_simjoin,
        }.get(type(child))
        if handler is None or not isinstance(self._part_source(child),
                                             N.Partition):
            return self.run(child)  # nothing partitioned below: fall through
        return handler(child)

    @staticmethod
    def _part_source(node) -> N.LogicalNode:
        """The child slot the optimizer partitions for this operator."""
        return node.left if isinstance(node, (N.Join, N.SimJoin)) else node.child

    def _split(self, records, part: N.Partition, *, fanout: int = 8):
        return parallel.split_partitions(records, part, fanout=fanout)

    # -- row-parallel family -----------------------------------------------
    def _part_filter(self, node: N.Filter) -> list[dict]:
        part = node.child
        recs = self.run(part.child)
        parts = self._split(recs, part)
        if not node.is_cascade:
            mask, stats = parallel.sem_filter_gold_partitioned(
                recs, node.langex, self.oracle, parts, self._pool)
        else:
            if self.proxy is None:
                raise ValueError(
                    "optimized sem_filter needs a proxy model in the Session")
            mask, stats = parallel.sem_filter_cascade_partitioned(
                recs, node.langex, self.oracle, self.proxy, parts, self._pool,
                **self._targets(node))
        self._count(len(parts))
        out = [t for t, m in zip(recs, mask) if m]
        self._log(stats, node, n_in=len(recs), n_out=len(out))
        return out

    def _part_map(self, node: N.Map) -> list[dict]:
        part = node.child
        recs = self.run(part.child)
        parts = self._split(recs, part)

        def frag(idx):
            texts, _ = _mapex.sem_map([recs[i] for i in idx], node.langex,
                                      self.oracle)
            return texts

        texts, stats = parallel.rows_partitioned("sem_map", parts, self._pool,
                                                 frag)
        self._count(len(parts))
        self._log(stats, node, n_in=len(recs), n_out=len(recs))
        return [{**t, node.out_column: x} for t, x in zip(recs, texts)]

    def _part_fusedmap(self, node: N.FusedMap) -> list[dict]:
        part = node.child
        recs = self.run(part.child)
        parts = self._split(recs, part)

        def frag(idx):
            columns, _ = _mapex.sem_map_fused([recs[i] for i in idx],
                                              node.langexes, self.oracle)
            return list(zip(*columns))  # per-row tuples across out columns

        rows, stats = parallel.rows_partitioned("sem_map_fused", parts,
                                                self._pool, frag)
        self._count(len(parts))
        self._log(stats, node, n_in=len(recs), n_out=len(recs))
        return [{**t, **dict(zip(node.out_columns, row))}
                for t, row in zip(recs, rows)]

    def _part_extract(self, node: N.Extract) -> list[dict]:
        part = node.child
        recs = self.run(part.child)
        parts = self._split(recs, part)

        def frag(idx):
            texts, _ = _mapex.sem_extract([recs[i] for i in idx], node.langex,
                                          self.oracle,
                                          source_field=node.source_field)
            return texts

        texts, stats = parallel.rows_partitioned("sem_extract", parts,
                                                 self._pool, frag)
        self._count(len(parts))
        self._log(stats, node, n_in=len(recs), n_out=len(recs))
        return [{**t, node.out_column: x} for t, x in zip(recs, texts)]

    # -- top-k ---------------------------------------------------------------
    def _part_topk(self, node: N.TopK) -> list[dict]:
        part = node.child
        recs = self.run(part.child)
        parts = self._split(recs, part)
        s = self.session
        pivot_scores = None
        if node.pivot_query is not None and self.embedder is not None:
            index = self._build_index([node.langex.render(t) for t in recs],
                                      kind="exact")
            qv = self.embedder.embed([node.pivot_query])
            pivot_scores = index.pairwise(qv)[0]
        idx, stats = _topk.sem_topk_partitioned(
            recs, node.langex, node.k, self.oracle,
            [list(map(int, p)) for p in parts], pivot_scores=pivot_scores,
            seed=s.seed, fragment_pool=self._pool)
        self._count(len(parts))
        self._log(stats, node, n_in=len(recs), n_out=len(idx))
        return [recs[i] for i in idx]

    # -- agg -----------------------------------------------------------------
    def _part_agg(self, node: N.Agg) -> list[dict]:
        part = node.child
        recs = self.run(part.child)
        if node.group_by is not None:
            parts = self._split(recs, part)
            rows, stats_list = parallel.sem_agg_groupby_partitioned(
                recs, node.langex, self.oracle, node.group_by, parts,
                self._pool, fanout=node.fanout, out_column=node.out_column)
            self._count(len(parts))
            for gi, stats in enumerate(stats_list):
                # observe the node once (first group) — per-group stats all
                # describe the same logical Agg over the same input rows
                if gi == 0:
                    self._log(stats, node, n_in=len(recs), n_out=len(rows))
                else:
                    self._log(stats)
            return rows
        parts = self._split(recs, part, fanout=node.fanout)
        answer, stats = parallel.sem_agg_partitioned(
            recs, node.langex, self.oracle, parts, self._pool,
            fanout=node.fanout)
        self._count(len(parts))
        self._log(stats, node, n_in=len(recs), n_out=1)
        return [{node.out_column: answer}]

    # -- join ----------------------------------------------------------------
    def _part_join(self, node: N.Join) -> list[dict]:
        lpart = node.left
        left = self.run(lpart.child)
        lparts = self._split(left, lpart)
        if isinstance(node.right, N.Partition):      # repartition grid
            right = self.run(node.right.child)
            rparts = self._split(right, node.right)
            exchange = "repartition"
        else:                                        # broadcast right
            right = self.run(node.right)
            rparts = [np.arange(len(right))]
            exchange = "broadcast"
        if node.prefilter_k:
            mask, stats = self._join_prefiltered_partitioned(
                node, left, right, lparts)
            n_frag = len(lparts)
        else:
            mask, stats = parallel.sem_join_gold_partitioned(
                left, right, node.langex, self.oracle, lparts, rparts,
                self._pool, exchange=exchange)
            n_frag = len(lparts) * len(rparts)
        self._count(n_frag)
        out = []
        n1, n2 = mask.shape
        for i in range(n1):
            for j in range(n2):
                if mask[i, j]:
                    out.append({**left[i],
                                **{f"right_{k}": v for k, v in right[j].items()}})
        self._log(stats, node, n_in=n1 * n2, n_out=len(out))
        return out

    def _join_prefiltered_partitioned(self, node: N.Join, left, right, lparts):
        """The optimizer-injected sim-prefilter join, fragment-parallel over
        left partitions: the right index is built once (registry-shared) and
        broadcast; each fragment embeds its probe rows, retrieves top-k
        candidates, and oracles its candidate pairs."""
        lx = node.langex
        with accounting.track("sem_join_prefiltered") as st:
            n1, n2 = len(left), len(right)
            k = min(node.prefilter_k, n2)
            lfields = [f for f in lx.fields if f.side != "right"]
            rfields = [f for f in lx.fields if f.side == "right"]
            right_index = self._build_index(
                _join._render_side(right, rfields), n_queries=n1)
            rendered_left = _join._render_side(left, lfields)

            def frag(pi, lidx):
                def task():
                    with accounting.track(f"fragment[{pi}]"):
                        emb = self.embedder.embed(
                            [rendered_left[int(i)] for i in lidx])
                        _, cand = right_index.search(emb, k)
                        pairs = [(int(i), int(j))
                                 for i, row in zip(lidx, cand) for j in row]
                        passed, _ = self.oracle.predicate(
                            _join._pair_prompts(lx, left, right, pairs))
                        return pairs, passed, dict(right_index.last_stats)
                return task

            results = parallel.run_fragments(
                self._pool, [frag(pi, lidx) for pi, lidx in enumerate(lparts)])
            mask = np.zeros((n1, n2), bool)
            n_pairs = 0
            scored = probed = 0
            for pairs, passed, idx_stats in results:
                n_pairs += len(pairs)
                scored += idx_stats.get("scored_vectors", 0)
                probed += idx_stats.get("probed_clusters", 0)
                for (i, j), p in zip(pairs, passed):
                    mask[i, j] = p
            st.details.update(prefilter_k=k, candidate_pairs=n_pairs,
                              pruned_pairs=n1 * n2 - n_pairs,
                              index=right_index.kind,
                              index_scored_vectors=scored,
                              index_probed_clusters=probed,
                              n_partitions=len(lparts),
                              exchange="broadcast")
            return mask, st.as_dict()

    # -- sim-join ------------------------------------------------------------
    def _part_simjoin(self, node: N.SimJoin) -> list[dict]:
        lpart = node.left
        left = self.run(lpart.child)
        lparts = self._split(left, lpart)
        right = self.run(node.right)  # broadcast marker or plain child
        index = self._corpus_index(node.right,
                                   [str(t[node.right_col]) for t in right],
                                   node.right_col, kind=node.index_kind,
                                   nprobe=node.nprobe, n_queries=len(left),
                                   shards=node.shards, quantize=node.quantize,
                                   index_auto=node.index_auto)
        cutoff = len(right) \
            if isinstance(N.plain(node.right), N.StreamScan) else None
        left_texts = [str(t[node.left_col]) for t in left]
        with accounting.track("sem_sim_join") as st:
            def frag(pi, lidx):
                def task():
                    with accounting.track(f"fragment[{pi}]"):
                        scores, jdx, _ = _search.sem_sim_join(
                            [left_texts[int(i)] for i in lidx], index,
                            self.embedder, k=node.k, max_pos=cutoff)
                        return scores, jdx, dict(index.last_stats)
                return task

            results = parallel.run_fragments(
                self._pool, [frag(pi, lidx) for pi, lidx in enumerate(lparts)])
            width = max((r[1].shape[1] for r in results), default=node.k)
            scores = np.full((len(left), width), MASKED_SCORE, np.float32)
            idx = np.zeros((len(left), width), np.int64)
            scored = probed = 0
            for lidx, (s, j, idx_stats) in zip(lparts, results):
                scores[lidx, :s.shape[1]] = s
                idx[lidx, :j.shape[1]] = j
                scored += idx_stats.get("scored_vectors", 0)
                probed += idx_stats.get("probed_clusters", 0)
            st.details.update(index=index.kind, scored_vectors=scored,
                              probed_clusters=probed,
                              n_partitions=len(lparts))
            stats = st.as_dict()
        self._count(len(lparts))
        out = self._simjoin_rows(left, right, scores, idx)
        self._log(stats, node, n_in=len(left), n_out=len(out))
        return out
