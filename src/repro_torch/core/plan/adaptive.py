"""Mid-query re-optimization: the adaptive plan executor.

The optimizer prices a plan once, from a static importance sample plus
whatever the :class:`~repro_torch.obs.stats_store.StatsStore` remembers.  This
module closes the loop *inside* a running query: at Exchange and stage-hook
boundaries the :class:`AdaptivePlanExecutor` compares observed against
predicted cardinality/selectivity for completed nodes and re-costs the
remaining subplan —

* **filter chains** run greedily: after every filter the surviving gold
  filters are re-ranked by live blended cost x selectivity (the plan-time
  estimate shrunk toward the store's EWMA), so a predicate whose observed
  selectivity drifted from the costing sample is promoted or demoted
  mid-chain;
* **retrieval** re-chooses exact vs IVF vs int8 tiles when the observed
  corpus size drifts past the threshold from the cardinality estimate rule
  5 priced — only for ``index_auto`` nodes, never for user pins;
* **partition fragments** are re-sized on observed row counts with exactly
  the planner's sizing rule (``parallel.partition_count``), so a filter that
  killed most rows doesn't fan 12 fragments over 40 survivors.

Equivalence contract (the strict mode every re-plan obeys): gold filters
commute — per-row prompts and a conjunction — so reordering them is
record-identical.  Cascade filters calibrate tau on their *input set*, so
they are immovable barriers: the choosable segment is the leading run of
gold filters, and a cascade at the head always executes next.  Retrieval
switches stay inside the recall contract (the same class of change rule 5
makes at plan time), and contiguous fragment resizes are bit-identical by
the PR-5 partitioned-operator construction (one global importance sample,
unchanged prompts).  ``replans`` records every decision for
``explain_analyze``.

``REPRO_ADAPTIVE=1`` flips the default on (CI runs tier-1 once this way to
catch plan-divergence regressions).
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.core.operators import filter as _filter
from repro_torch.core.plan import nodes as N
from repro_torch.core.plan import parallel
from repro_torch.core.plan.execute import PartitionedExecutor
from repro_torch.core.plan.optimize import (DEFAULT_FILTER_SEL, CASCADE_FILTER_COST,
                                            GOLD_FILTER_COST, estimate_cardinality,
                                            shrinkage_blend)
from repro_torch.index.backend import (IVF_MIN_CORPUS, QUANT_MIN_CORPUS,
                                       choose_retrieval_config)
from repro_torch.obs import trace as _trace


def adaptive_default() -> bool:
    """Process-wide default for adaptivity (the ``REPRO_ADAPTIVE`` env
    switch CI uses to run the whole suite adaptively)."""
    return os.environ.get("REPRO_ADAPTIVE", "").strip().lower() \
        not in ("", "0", "false")


def drift_ratio(pred: float, obs: float) -> float:
    """Symmetric drift between a prediction and an observation (>= 1).
    Unlike the row-count variant in ``obs.analyze``, the floor is tiny —
    selectivities live in [0, 1] and a 0.02 vs 0.2 miss must register."""
    lo, hi = sorted((max(float(pred), 0.0), max(float(obs), 0.0)))
    return hi / max(lo, 1e-9)


@dataclasses.dataclass
class AdaptivePolicy:
    """Knobs for mid-query re-optimization.  The defaults re-plan only on
    clear drift and never touch guarantee-bearing structure."""

    drift_threshold: float = 1.75  # re-cost when obs/pred crosses this
    min_rows: int = 8              # below this, re-planning can't pay off
    reorder_filters: bool = True
    switch_retrieval: bool = True
    resize_fragments: bool = True
    prior_strength: float = 4.0    # shrinkage mass for live store blends


@dataclasses.dataclass
class ReplanEvent:
    """One mid-query decision, for metrics and ``explain_analyze``."""

    kind: str    # "reorder_filters" | "switch_retrieval" | "resize_fragments"
                 # | "switch_join_strategy" | "drift"
    node: str    # label of the node the decision was about
    reason: str


class AdaptivePlanExecutor(PartitionedExecutor):
    """PartitionedExecutor that re-costs the remaining subplan as
    observations come in (see module docstring for the equivalence
    contract).  ``optimizer`` is bound after construction by the frame /
    gateway so re-plans reuse the planner's own knobs (partition counts,
    quantization policy) instead of shadowing them."""

    def __init__(self, session, *, policy: AdaptivePolicy | None = None, **kw):
        super().__init__(session, **kw)
        self.policy = policy if policy is not None else AdaptivePolicy()
        self.optimizer = None
        self.replans: list[ReplanEvent] = []

    def _knob(self, name: str, default=None):
        v = getattr(self.optimizer, name, None) \
            if self.optimizer is not None else None
        return v if v is not None else default

    def _replan(self, kind: str, node, reason: str) -> None:
        label = node.label() if hasattr(node, "label") else str(node)
        self.replans.append(ReplanEvent(kind, label, reason))
        sp = _trace.current_span()
        if sp is not None and sp.kind == "plan_stage":
            prev = sp.attrs.get("replanned")
            note = f"{kind}: {reason}"
            sp.set(replanned=f"{prev}; {note}" if prev else note)

    # -- live cost estimates ----------------------------------------------
    def _filter_sel(self, f: N.Filter) -> float:
        prior = f.selectivity if f.selectivity is not None \
            else DEFAULT_FILTER_SEL
        if self.stats_store is not None:
            obs = self.stats_store.stats_for_node(f)
            if obs is not None and obs.selectivity is not None:
                return shrinkage_blend(prior, obs.selectivity, obs.runs,
                                       self.policy.prior_strength)
        return prior

    def _filter_cost(self, f: N.Filter) -> float:
        unit = CASCADE_FILTER_COST if f.is_cascade else GOLD_FILTER_COST
        if self.stats_store is not None:
            obs = self.stats_store.stats_for_node(f)
            if obs is not None and obs.rows_in > 0:
                return shrinkage_blend(unit, obs.oracle_calls_per_row,
                                       obs.runs, self.policy.prior_strength)
        return unit

    # -- filter chains: greedy re-ranked execution ------------------------
    def _collect_chain(self, node):
        """Walk the consecutive filters below ``node`` (each possibly in its
        own Exchange/Partition sandwich from rule 6).  Returns
        (top-down [(filter, partition-or-None)], base)."""
        chain: list[tuple[N.Filter, N.Partition | None]] = []
        cur = node
        while True:
            if (isinstance(cur, N.Exchange) and cur.kind == "gather"
                    and isinstance(cur.child, N.Filter)
                    and isinstance(cur.child.child, N.Partition)):
                f = cur.child
                chain.append((f, f.child))
                cur = f.child.child
            elif isinstance(cur, N.Filter):
                chain.append((cur, None))
                cur = cur.child
            else:
                return chain, cur

    def _run_exchange(self, node: N.Exchange) -> list[dict]:
        if self.policy.reorder_filters:
            chain, base = self._collect_chain(node)
            if len(chain) >= 2:
                return self._run_filter_chain(chain, base)
        return super()._run_exchange(node)

    def _run_filter(self, node: N.Filter) -> list[dict]:
        if self.policy.reorder_filters:
            chain, base = self._collect_chain(node)
            if len(chain) >= 2:
                return self._run_filter_chain(chain, base)
        return super()._run_filter(node)

    def _pick_next(self, pending) -> int:
        """Index of the filter to execute next.  Strict mode: a cascade
        calibrates tau on its input set, so a cascade at the head must run
        (and none may be jumped over); gold filters permute within the
        leading gold segment by ascending blended cost / (1 - sel).  The
        tie-break is the planned order, so with no new evidence the greedy
        pass replays the static plan exactly."""
        if pending[0][0].is_cascade:
            return 0
        best, best_rank = 0, None
        for j, (f, _) in enumerate(pending):
            if f.is_cascade:
                break
            rank = self._filter_cost(f) / max(1.0 - self._filter_sel(f), 1e-6)
            if best_rank is None or rank < best_rank - 1e-12:
                best, best_rank = j, rank
        return best

    def _run_filter_chain(self, chain, base) -> list[dict]:
        rows = self.run(base)
        pending = list(reversed(chain))  # planned (bottom-up) order
        while pending:
            i = self._pick_next(pending)
            f, part = pending.pop(i)
            reason = None
            if i != 0:
                reason = (f"promoted over {i} planned filter(s): blended "
                          f"sel~{self._filter_sel(f):.2f} ranks cheapest "
                          f"of the gold segment")
            n_in = len(rows)
            rows = self._apply_filter(f, part, rows, reason=reason)
            if pending and n_in:
                pred = f.selectivity if f.selectivity is not None \
                    else DEFAULT_FILTER_SEL
                obs = len(rows) / n_in
                r = drift_ratio(pred, obs)
                if r > self.policy.drift_threshold:
                    self._replan(
                        "drift", f,
                        f"observed sel {obs:.2f} vs predicted {pred:.2f} "
                        f"(x{r:.1f}); re-costing {len(pending)} remaining "
                        f"filter(s)")
        return rows

    def _apply_filter(self, f: N.Filter, part, rows, *, reason=None):
        if _trace.current_tracer() is None:
            if reason:
                self._replan("reorder_filters", f, reason)
            return self._filter_body(f, part, rows)
        # the chain executes under the top node's span: give each filter its
        # own plan_stage span so explain_analyze still joins per-node
        with _trace.span(type(f).__name__, kind="plan_stage",
                         label=f.label(), node_id=id(f)) as sp:
            if reason:
                self._replan("reorder_filters", f, reason)
            out = self._filter_body(f, part, rows)
            sp.set(rows_out=len(out))
            return out

    def _filter_body(self, f: N.Filter, part, rows) -> list[dict]:
        parts = self._split(rows, part) if part is not None else None
        if f.is_cascade and self.proxy is None:
            raise ValueError(
                "optimized sem_filter needs a proxy model in the Session")
        if parts is not None and len(parts) >= 2:
            if not f.is_cascade:
                mask, stats = parallel.sem_filter_gold_partitioned(
                    rows, f.langex, self.oracle, parts, self._pool)
            else:
                mask, stats = parallel.sem_filter_cascade_partitioned(
                    rows, f.langex, self.oracle, self.proxy, parts,
                    self._pool, **self._targets(f))
            self._count(len(parts))
        elif not f.is_cascade:
            mask, stats = _filter.sem_filter_gold(rows, f.langex, self.oracle)
        else:
            mask, stats = _filter.sem_filter_cascade(
                rows, f.langex, self.oracle, self.proxy, **self._targets(f))
        out = [t for t, m in zip(rows, mask) if m]
        self._log(stats, f, n_in=len(rows), n_out=len(out))
        return out

    # -- fragment resizing on observed cardinality -------------------------
    def _split(self, records, part: N.Partition, *, fanout: int = 8):
        if self.policy.resize_fragments and part.strategy == "contiguous":
            configured = self._knob("n_partitions") or part.n_partitions
            P = parallel.partition_count(
                len(records), configured, self._knob("partition_min_rows", 32))
            if P != part.n_partitions:
                self._replan(
                    "resize_fragments", part,
                    f"{part.n_partitions} -> {P} fragments for "
                    f"{len(records)} observed rows")
                part = dataclasses.replace(part, n_partitions=P)
        return super()._split(records, part, fanout=fanout)

    # -- join strategy re-choice on observed cardinalities -----------------
    def _join_dispatch(self, node: N.Join, left, right):
        """Re-resolve an optimizer-chosen join strategy when the observed
        pair grid drifts past the threshold from what rule 4b priced.  Only
        ``strategy_auto`` nodes re-choose — a user pin stays fixed — and the
        switch is the same class of change the optimizer makes at plan time
        (both sides honor the node's (recall, precision, delta) targets)."""
        if (node.strategy_auto and node.strategy in ("block", "cascade")
                and len(left) >= self.policy.min_rows):
            from repro_torch.core.plan.optimize import resolve_join_strategy
            n1_est = estimate_cardinality(N.plain(node.left))
            n2_est = estimate_cardinality(N.plain(node.right))
            pairs_est = max(n1_est * n2_est, 1.0)
            pairs_obs = max(len(left) * len(right), 1)
            if drift_ratio(pairs_est, pairs_obs) > self.policy.drift_threshold:
                chosen = resolve_join_strategy(len(left), len(right))
                if chosen != node.strategy:
                    self._replan(
                        "switch_join_strategy", node,
                        f"pair grid est ~{pairs_est:.0f} vs {pairs_obs} "
                        f"observed: {node.strategy} -> {chosen}")
                    node = dataclasses.replace(node, strategy=chosen)
        return super()._join_dispatch(node, left, right)

    # -- retrieval switching on observed corpus size -----------------------
    def _corpus_index(self, child, texts, column, *, kind="auto", nprobe=None,
                      n_queries=1, shards=None, quantize=None,
                      index_auto=False):
        if (self.policy.switch_retrieval and index_auto and kind != "auto"
                and len(texts) >= self.policy.min_rows):
            n_est = estimate_cardinality(N.plain(child))
            if drift_ratio(n_est, len(texts)) > self.policy.drift_threshold:
                cfg = choose_retrieval_config(
                    len(texts), max(int(n_queries), 1),
                    recall_target=self.recall_target,
                    min_corpus=self.index_min_corpus or IVF_MIN_CORPUS,
                    shared=self.index_registry is not None,
                    quantize=self._knob("quantize", "auto"),
                    min_quant_corpus=self._knob("quant_min_corpus",
                                                QUANT_MIN_CORPUS))
                if (cfg["kind"], cfg["quantize"]) != (kind, quantize):
                    self._replan(
                        "switch_retrieval", N.plain(child),
                        f"corpus est ~{n_est:.0f} rows vs {len(texts)} "
                        f"observed: {kind}/{quantize or 'none'} -> "
                        f"{cfg['kind']}/{cfg['quantize'] or 'none'}")
                    kind, quantize = cfg["kind"], cfg["quantize"]
                    # same stream-corpus rule as the planner: never pin a
                    # size-derived nprobe into a versioned registry key
                    nprobe = None \
                        if isinstance(N.plain(child), N.StreamScan) \
                        else cfg["nprobe"]
        return super()._corpus_index(child, texts, column, kind=kind,
                                     nprobe=nprobe, n_queries=n_queries,
                                     shards=shards, quantize=quantize,
                                     index_auto=index_auto)
