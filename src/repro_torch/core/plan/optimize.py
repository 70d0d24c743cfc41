"""Rule-based plan optimizer over the logical IR.

Five rewrites, applied in a fixed order (each is semantics-preserving wrt
the gold algorithms except 4-5, which trade a bounded recall tail for a
smaller bill and only fire when the cost model says so):

  1. ``fuse_maps``            — consecutive independent sem_maps collapse
                                into one FusedMap prompt pass (N calls, not
                                K*N).
  2. ``pushdown_filter``      — a filter over a join whose langex touches
                                only one side's columns moves below the join,
                                shrinking the pair space before the O(n1*n2)
                                operator runs.
  3. ``reorder_filters``      — a chain of filters over a Scan is re-ordered
                                by estimated cost x selectivity: each
                                predicate's selectivity comes from ONE shared
                                importance sample (optimizer/stats.py) probed
                                through the executor's BatchedModelCache, so
                                probe labels are re-used by the execution
                                itself.  Classic ordering: ascending
                                cost / (1 - selectivity).
  4. ``inject_sim_prefilter`` — a gold join whose estimated pair count
                                exceeds ``prefilter_threshold`` gets a
                                sem_sim_join candidate prefilter (top
                                ``prefilter_frac`` of right rows per left
                                row) when the session has an embedder.
  4b. ``choose_join_strategy`` — a ``strategy="auto"`` join is priced both
                                ways — IVF blocking + B-pair block prompts
                                + transitivity inference vs the pairwise
                                cascade — and the winner is installed on the
                                node (``strategy_auto`` marks it
                                re-choosable by the adaptive executor).
  5. ``choose_retrieval``     — every Search/SimJoin node with
                                ``index_kind="auto"`` gets an exact or IVF
                                retrieval backend by byte-aware cost (build
                                cost amortized over expected probes vs exact
                                scan, scan cost priced in HBM bytes per
                                stored dtype;
                                ``repro_torch.index.backend.choose_retrieval_config``)
                                at the optimizer's ``recall_target``; the
                                choice — kind, IVF ``nprobe``, and tile
                                precision (int8 tiles + exact rerank when the
                                byte/recall trade wins and the corpus clears
                                ``quant_min_corpus``) — is installed on the
                                node and shows up in ``explain_plan``.
  6. ``plan_partitions``      — with ``n_partitions`` set, operators over
                                enough rows are cut into Exchange-bounded
                                fragments (``nodes.Partition`` below,
                                ``nodes.Exchange`` above) with a per-operator
                                strategy: Filter/Map/FusedMap/Extract are
                                row-parallel (contiguous partitions, gather
                                concat), TopK runs per-partition select +
                                lossless merge, Agg reduces subtree-aligned
                                partitions (hash partitions on the group key
                                for group-bys), and a gold Join either
                                broadcasts a small right side to left
                                fragments or repartitions both sides into a
                                fragment grid (cost: right-side cardinality
                                vs ``broadcast_max_rows``).  Cascades keep
                                their one *global* importance sample, so
                                thresholds — and therefore guarantees — are
                                unchanged (see ``plan.parallel``).  The same
                                rule installs the device-shard layout on
                                Search/SimJoin corpora (``shards``; exact and
                                IVF scans run sharded when the process has
                                devices and the corpus clears
                                ``shard_min_corpus``).

Feedback: constructed with a ``stats_store`` (``repro_torch.obs.stats_store``),
the optimizer runs a zeroth pass — ``feedback_costing`` — that installs
observed selectivities on Filter/Join nodes whose semantic fingerprint the
store has seen before, shrinkage-blended with the model prior by evidence
mass, and rules 3/5/6 price from the blended numbers.  A recurring
predicate is thus costed from what it actually did last time, not from the
static default.

``explain_plan`` renders a plan tree with per-node cardinality and
oracle-call estimates (plus, on Exchange boundaries, the partition count and
per-fragment cost share, and — given a ``stats_store`` — the observed
selectivity next to the model's guess); ``LazySemFrame.explain()`` shows
before/after plus the applied rewrite list.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np

from repro_torch.core.operators.filter import predicate_prompt
from repro_torch.core.optimizer import stats
from repro_torch.core.plan import nodes as N
from repro_torch.index.backend import (IVF_MIN_CORPUS, QUANT_MIN_CORPUS,
                                       SHARD_MIN_CORPUS, choose_retrieval_config,
                                       choose_shards)

# per-tuple oracle-equivalent unit costs (cascades mostly pay the proxy)
GOLD_FILTER_COST = 1.0
CASCADE_FILTER_COST = 0.45
GENERATE_COST = 1.0
DEFAULT_FILTER_SEL = 0.5
DEFAULT_JOIN_SEL = 0.05

_RIGHT_FIELD_RE = re.compile(r"\{right_([^{}:]+)\}")


def _device_count() -> int:
    """Device probe via the kernels dispatch helper (one definition of
    device resolution): the CUDA card count, or 1 when the port runs on the
    CPU.  Imported lazily, so plan logic imports no torch kernel module."""
    from repro_torch.kernels.ops import _n_devices
    return _n_devices()


@dataclasses.dataclass(frozen=True)
class AppliedRewrite:
    rule: str
    detail: str

    def __str__(self) -> str:
        return f"{self.rule}: {self.detail}"


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


def estimate_cardinality(node: N.LogicalNode) -> float:
    if isinstance(node, (N.Scan, N.StreamScan)):
        return float(len(node.records))
    if isinstance(node, N.Filter):
        sel = node.selectivity if node.selectivity is not None else DEFAULT_FILTER_SEL
        return sel * estimate_cardinality(node.child)
    if isinstance(node, N.Join):
        sel = node.selectivity if node.selectivity is not None else DEFAULT_JOIN_SEL
        return (sel * estimate_cardinality(node.left)
                * estimate_cardinality(node.right))
    if isinstance(node, N.SimJoin):
        return node.k * estimate_cardinality(node.left)
    if isinstance(node, N.TopK):
        n = estimate_cardinality(node.child)
        if node.group_by is not None:
            return n  # k rows per group, group count unknown: upper bound
        return float(min(node.k, n))
    if isinstance(node, N.Search):
        return float(min(node.k, estimate_cardinality(node.child)))
    if isinstance(node, N.Agg):
        return 1.0
    # Map / FusedMap / Extract / GroupBy keep cardinality
    return estimate_cardinality(node.children()[0]) if node.children() else 0.0


def block_join_cost(n1: float, n2: float) -> float:
    """Oracle-equivalent cost of the block-join path: the mid region of an
    O(n1*k) candidate set amortized over B-pair block prompts, plus the
    pairwise coverage probes / agreement checks and the calibration bill."""
    from repro_torch.core.optimizer.blocks import DEFAULT_BLOCK_SIZE, blocking_k
    k = min(blocking_k(int(n2)), max(int(n2), 1))
    n_cand = n1 * k
    return 0.1 * n_cand / DEFAULT_BLOCK_SIZE + 0.02 * n1 + 48.0


def cascade_join_cost(n1: float, n2: float) -> float:
    return 0.1 * n1 * n2 + n1  # sample + mid region + projection


def resolve_join_strategy(n1: float, n2: float) -> str:
    """The cost model's pick for ``strategy="auto"`` joins: blocking +
    block prompts when they beat the pairwise cascade on the pair grid."""
    return "block" if block_join_cost(n1, n2) < cascade_join_cost(n1, n2) \
        else "cascade"


def estimate_cost(node: N.LogicalNode) -> float:
    """Estimated oracle-equivalent LM calls for this node alone."""
    if isinstance(node, N.Scan) or isinstance(node, N.SimJoin):
        return 0.0
    if isinstance(node, N.Filter):
        unit = CASCADE_FILTER_COST if node.is_cascade else GOLD_FILTER_COST
        return unit * estimate_cardinality(node.child)
    if isinstance(node, N.Join):
        n1 = estimate_cardinality(node.left)
        n2 = estimate_cardinality(node.right)
        strat = node.strategy
        if strat == "auto":
            strat = resolve_join_strategy(n1, n2)
        if strat == "block":
            return block_join_cost(n1, n2)
        if strat == "cascade" or (strat is None and node.is_cascade):
            return cascade_join_cost(n1, n2)
        if node.prefilter_k:
            return n1 * min(node.prefilter_k, n2)
        return n1 * n2
    if isinstance(node, (N.Map, N.Extract, N.FusedMap)):
        return GENERATE_COST * estimate_cardinality(node.child)
    if isinstance(node, N.TopK):
        return 2.0 * estimate_cardinality(node.child)
    if isinstance(node, N.GroupBy):
        n = estimate_cardinality(node.child)
        return 2.0 * n if node.accuracy_target is None else 1.2 * n
    if isinstance(node, N.Agg):
        n = estimate_cardinality(node.child)
        return n / max(node.fanout - 1, 1) + 1
    if isinstance(node, N.Search):
        return float(node.n_rerank or 0)
    return 0.0


def total_cost(node: N.LogicalNode) -> float:
    return estimate_cost(node) + sum(total_cost(c) for c in node.children())


def predicted_selectivity(node: N.LogicalNode) -> float | None:
    """Predicted output/input-fraction for selective nodes; None where the
    notion doesn't apply (scans, maps).  The join candidate space is the
    pair grid, matching the executor's observed convention."""
    if isinstance(node, N.Filter):
        return (node.selectivity if node.selectivity is not None
                else DEFAULT_FILTER_SEL)
    if isinstance(node, N.Join):
        return (node.selectivity if node.selectivity is not None
                else DEFAULT_JOIN_SEL)
    if isinstance(node, (N.TopK, N.Search)):
        n = estimate_cardinality(node.children()[0])
        return min(float(node.k) / n, 1.0) if n else None
    if isinstance(node, N.Exchange):
        return predicted_selectivity(node.child)
    if isinstance(node, N.Partition):
        return None
    return None


def predicted_node_metrics(node: N.LogicalNode) -> dict:
    """The cost model's per-node predictions in one place — the single
    source of truth behind both ``explain_plan`` (planning time) and
    ``explain_analyze``'s predicted column (after a traced run)."""
    target = node.child if isinstance(node, (N.Exchange, N.Partition)) else node
    return {
        "rows": estimate_cardinality(node),
        "selectivity": predicted_selectivity(node),
        "oracle_calls": estimate_cost(target),
    }


def shrinkage_blend(prior: float, observed: float, weight: float,
                    prior_strength: float) -> float:
    """Observed statistic blended with its model prior, shrunk by evidence
    mass: ``weight`` is the (possibly decayed) run count behind the
    observation, ``prior_strength`` the pseudo-run weight of the prior.  A
    once-seen predicate moves the estimate a little; a recurring one
    dominates it."""
    w = max(float(weight), 0.0)
    return (prior_strength * prior + w * observed) / (prior_strength + w)


def explain_plan(node: N.LogicalNode, *, indent: str = "",
                 stats_store=None) -> str:
    pred = predicted_node_metrics(node)
    extra = ""
    if pred["selectivity"] is not None:
        extra += f", sel~{pred['selectivity']:.2f}"
    if stats_store is not None:
        # observed reality next to the model's guess, when the store has
        # seen this predicate before (keyed by semantic fingerprint)
        obs = stats_store.stats_for_node(node)
        if obs is not None and obs.selectivity is not None:
            extra += f", sel_obs={obs.selectivity:.2f} (w={obs.runs:.1f})"
    if isinstance(node, N.Exchange) and node.n_partitions > 1:
        # cost share of one fragment at this boundary (the merged operator's
        # own bill split across partitions)
        extra += f", frag_oracle~{pred['oracle_calls'] / node.n_partitions:.0f}"
    out = [f"{indent}{node.label()}  "
           f"(rows~{pred['rows']:.0f}, "
           f"oracle~{estimate_cost(node):.0f}{extra})"]
    for c in node.children():
        out.append(explain_plan(c, indent=indent + "  ",
                                stats_store=stats_store))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


class PlanOptimizer:
    def __init__(self, session, *, oracle=None, proxy=None, sample_size: int = 32,
                 seed: int = 0, prefilter_threshold: int = 20_000,
                 prefilter_frac: float = 0.25, recall_target: float = 0.95,
                 index_min_corpus: int = IVF_MIN_CORPUS,
                 index_shared: bool = False,
                 n_partitions: int | None = None,
                 partition_min_rows: int = 32,
                 broadcast_max_rows: int = 2048,
                 shards: int | str | None = "auto",
                 shard_min_corpus: int = SHARD_MIN_CORPUS,
                 quantize: str = "auto",
                 quant_min_corpus: int = QUANT_MIN_CORPUS,
                 stats_store=None,
                 prior_strength: float = 4.0):
        self.session = session
        # probe through the executor's cache so sample labels are reused
        self.oracle = oracle if oracle is not None else session.oracle
        self.proxy = proxy if proxy is not None else session.proxy
        self.sample_size = sample_size
        self.seed = seed
        self.prefilter_threshold = prefilter_threshold
        self.prefilter_frac = prefilter_frac
        self.recall_target = recall_target          # ANN retrieval knob
        self.index_min_corpus = index_min_corpus
        # True when an IndexRegistry shares builds across sessions (the
        # serving gateway sets it): the cost model then amortizes the IVF
        # build over serving traffic instead of charging it to one plan
        self.index_shared = index_shared
        # fragment parallelism: None/1 leaves plans single-partition (the
        # pre-partition behavior); the serving gateway and collect() opt in
        self.n_partitions = n_partitions
        self.partition_min_rows = partition_min_rows
        self.broadcast_max_rows = broadcast_max_rows
        # device-shard layout for similarity corpora: "auto" = every device
        # once the corpus clears shard_min_corpus (a single-device process
        # never annotates, so plain CPU runs are untouched); an int pins it
        self.shards = shards
        self.shard_min_corpus = shard_min_corpus
        # IVF tile precision: "auto" lets the byte-aware cost model pick int8
        # tiles (+ exact rerank) once the corpus clears quant_min_corpus;
        # "int8"/"none" pin it
        self.quantize = quantize
        self.quant_min_corpus = quant_min_corpus
        # runtime feedback: observed (operator, fingerprint) statistics from
        # prior executions, blended with the model prior at prior_strength
        # pseudo-runs (see shrinkage_blend)
        self.stats_store = stats_store
        self.prior_strength = prior_strength
        self.applied: list[AppliedRewrite] = []
        self._sel_memo: dict[tuple, float] = {}

    # -- generic bottom-up transform --------------------------------------
    def _transform(self, node: N.LogicalNode, fn) -> N.LogicalNode:
        mapping = {id(c): self._transform(c, fn) for c in node.children()}
        node = node.replace_children(mapping)
        out = fn(node)
        return node if out is None else out

    def optimize(self, plan: N.LogicalNode) -> N.LogicalNode:
        self.applied = []  # per-run; the selectivity memo persists across runs
        plan = self._feedback_costing(plan)
        plan = self._transform(plan, self._fuse_maps)
        for _ in range(8):  # pushdown to fixpoint (filters sink through join stacks)
            before = len(self.applied)
            plan = self._transform(plan, self._pushdown_filter)
            if len(self.applied) == before:
                break
        plan = self._reorder_filters(plan)
        plan = self._transform(plan, self._inject_sim_prefilter)
        plan = self._transform(plan, self._choose_join_strategy)
        plan = self._transform(plan, self._choose_retrieval)
        plan = self._transform(plan, self._plan_partitions)
        return plan

    # -- rule 0: feedback-informed initial costing -------------------------
    def _blend_with_store(self, node, prior: float) -> tuple[float, float] | None:
        """(blended selectivity, evidence weight) from the stats store for a
        node's fingerprint, or None when the store has never seen it."""
        if self.stats_store is None:
            return None
        obs = self.stats_store.stats_for_node(node)
        if obs is None or obs.selectivity is None:
            return None
        return (shrinkage_blend(prior, obs.selectivity, obs.runs,
                                self.prior_strength), obs.runs)

    def _feedback_costing(self, plan):
        """Zeroth pass: install observed selectivities (shrinkage-blended
        with the default prior) on Filter/Join nodes the stats store has
        seen before, so every later rule prices from history."""
        if self.stats_store is None:
            return plan
        installed: list[str] = []

        def fn(node):
            if isinstance(node, N.Filter) and node.selectivity is None:
                prior = DEFAULT_FILTER_SEL
            elif isinstance(node, N.Join) and node.selectivity is None:
                prior = DEFAULT_JOIN_SEL
            else:
                return None
            blended = self._blend_with_store(node, prior)
            if blended is None:
                return None
            sel, weight = blended
            installed.append(f"{node.langex.template!r} sel~{sel:.2f} "
                             f"(w={weight:.1f})")
            return dataclasses.replace(node, selectivity=sel)

        plan = self._transform(plan, fn)
        if installed:
            self.applied.append(AppliedRewrite(
                "feedback_costing",
                f"{len(installed)} node(s) costed from observed history: "
                + "; ".join(installed)))
        return plan

    # -- rule 1: map fusion ------------------------------------------------
    def _fuse_maps(self, node):
        if not isinstance(node, N.Map):
            return None
        child = node.child
        if isinstance(child, N.Map):
            langexes, cols = (child.langex,), (child.out_column,)
            base = child.child
        elif isinstance(child, N.FusedMap):
            langexes, cols = child.langexes, child.out_columns
            base = child.child
        else:
            return None
        deps = {f.name for f in node.langex.fields}
        if deps & set(cols) or node.out_column in cols:
            return None  # second map reads/overwrites the first's output
        fused = N.FusedMap(base, langexes + (node.langex,), cols + (node.out_column,))
        self.applied.append(AppliedRewrite(
            "fuse_maps", f"{len(fused.langexes)} sem_maps -> one prompt pass "
                         f"(columns {', '.join(fused.out_columns)})"))
        return fused

    # -- rule 2: filter pushdown below join --------------------------------
    def _pushdown_filter(self, node):
        if not (isinstance(node, N.Filter) and isinstance(node.child, N.Join)):
            return None
        join = node.child
        fields = {f.name for f in node.langex.fields}
        if not fields:
            return None
        left_cols = join.left.columns()
        right_cols = join.right.columns()
        if fields <= left_cols:
            pushed = dataclasses.replace(node, child=join.left)
            self.applied.append(AppliedRewrite(
                "pushdown_filter",
                f"filter {node.langex.template!r} pushed below join (left side)"))
            return dataclasses.replace(join, left=pushed)
        stripped = {m.group(1) for m in _RIGHT_FIELD_RE.finditer(node.langex.template)}
        if stripped and fields == {f"right_{s}" for s in stripped} \
                and stripped <= right_cols:
            template = _RIGHT_FIELD_RE.sub(r"{\1}", node.langex.template)
            pushed = dataclasses.replace(node, child=join.right, langex=template)
            self.applied.append(AppliedRewrite(
                "pushdown_filter",
                f"filter {node.langex.template!r} pushed below join (right side)"))
            return dataclasses.replace(join, right=pushed)
        return None

    # -- rule 3: filter chain reordering -----------------------------------
    def _filter_unit_cost(self, f: N.Filter) -> float:
        unit = CASCADE_FILTER_COST if f.is_cascade else GOLD_FILTER_COST
        if self.stats_store is not None:
            # observed oracle calls per input row refine the static unit
            # cost (a well-cached or proxy-heavy predicate bills far less)
            obs = self.stats_store.stats_for_node(f)
            if obs is not None and obs.rows_in > 0:
                unit = shrinkage_blend(unit, obs.oracle_calls_per_row,
                                       obs.runs, self.prior_strength)
        return unit

    def _probe_selectivity(self, f: N.Filter, base: N.LogicalNode,
                           base_records: list, idx: np.ndarray,
                           probs: np.ndarray) -> float:
        memo_key = (f.langex.template, id(base))
        if memo_key not in self._sel_memo:
            sampled = [base_records[i] for i in idx]
            prompts = [predicate_prompt(f.langex, t) for t in sampled]
            labels, _ = self.oracle.predicate(prompts)
            self._sel_memo[memo_key] = stats.estimate_selectivity(idx, probs, labels)
        return self._sel_memo[memo_key]

    def _reorder_filters(self, node):
        if not isinstance(node, N.Filter):
            mapping = {id(c): self._reorder_filters(c) for c in node.children()}
            return node.replace_children(mapping)

        # collect the maximal chain below this (top-most) filter; the loop
        # consumes inner filters, so recursion only re-enters below the chain
        chain: list[N.Filter] = []
        cur: N.LogicalNode = node
        while isinstance(cur, N.Filter):
            chain.append(cur)
            cur = cur.child
        base = self._reorder_filters(cur)
        chain_bottom_up = list(reversed(chain))  # application order

        # a StreamScan base reorders too: its pinned snapshot is the sample
        # population (probe labels land in the shared cache, so execution —
        # and the next version's re-run — reuse them)
        base_records = base.records \
            if isinstance(base, (N.Scan, N.StreamScan)) else []
        if len(chain) < 2 or len(base_records) < 2:
            rebuilt = base
            for f in chain_bottom_up:
                rebuilt = dataclasses.replace(f, child=rebuilt)
            return rebuilt

        base_cols = base.columns()
        if any({fl.name for fl in f.langex.fields} - base_cols for f in chain):
            rebuilt = base
            for f in chain_bottom_up:
                rebuilt = dataclasses.replace(f, child=rebuilt)
            return rebuilt

        # with a proxy in the session, draw the shared sample from the SUPG
        # defensive proposal over the chain's first predicate (cheap scores);
        # without one, uniform — Hajek weighting absorbs either proposal
        scores = None
        if self.proxy is not None:
            prompts = [predicate_prompt(chain_bottom_up[0].langex, t)
                       for t in base_records]
            _, scores = self.proxy.predicate(prompts)
        idx, probs = stats.shared_sample_indices(
            len(base_records), self.sample_size, self.seed, scores=scores)
        sels = [self._probe_selectivity(f, base, base_records, idx, probs)
                for f in chain_bottom_up]
        # fold in observed history: the importance-sample probe is the prior,
        # the store's EWMA selectivity the evidence
        sels = [b[0] if (b := self._blend_with_store(f, s)) is not None else s
                for f, s in zip(chain_bottom_up, sels)]
        # optimal chain order: ascending cost / (1 - selectivity)
        rank = [self._filter_unit_cost(f) / max(1.0 - s, 1e-6)
                for f, s in zip(chain_bottom_up, sels)]
        order = sorted(range(len(chain)), key=lambda i: rank[i])
        rebuilt = base
        for i in order:
            rebuilt = dataclasses.replace(chain_bottom_up[i], child=rebuilt,
                                          selectivity=sels[i])
        if order != list(range(len(chain))):
            self.applied.append(AppliedRewrite(
                "reorder_filters",
                f"{len(chain)}-filter chain reordered by cost x selectivity "
                f"(sel={', '.join(f'{s:.2f}' for s in sels)})"))
        return rebuilt

    # -- rule 4b: block-join vs pairwise-cascade strategy ------------------
    def _choose_join_strategy(self, node):
        """Price IVF blocking + block prompts against the pairwise cascade
        for ``strategy="auto"`` joins and install the winner (visible in
        ``explain_plan`` via the node label and the rewrite list)."""
        if not isinstance(node, N.Join) or node.strategy != "auto":
            return None
        n1 = estimate_cardinality(node.left)
        n2 = estimate_cardinality(node.right)
        chosen = resolve_join_strategy(n1, n2)
        self.applied.append(AppliedRewrite(
            "choose_join_strategy",
            f"join over ~{n1 * n2:.0f} pairs -> {chosen} (block "
            f"~{block_join_cost(n1, n2):.0f} oracle units vs pairwise "
            f"cascade ~{cascade_join_cost(n1, n2):.0f})"))
        return dataclasses.replace(node, strategy=chosen, strategy_auto=True)

    # -- rule 5: cost-based exact vs IVF retrieval -------------------------
    def _choose_retrieval(self, node):
        if isinstance(node, N.Search):
            if node.index is not None or node.index_kind != "auto":
                return None  # user pinned an index or a kind
            n_corpus = estimate_cardinality(node.child)
            n_queries = 1.0
        elif isinstance(node, N.SimJoin):
            if node.index_kind != "auto":
                return None
            n_corpus = estimate_cardinality(node.right)
            n_queries = estimate_cardinality(node.left)
        else:
            return None
        corpus_child = node.child if isinstance(node, N.Search) else node.right
        k = node.k if isinstance(node, (N.Search, N.SimJoin)) else 10
        cfg = choose_retrieval_config(
            int(n_corpus), max(int(n_queries), 1),
            recall_target=self.recall_target, min_corpus=self.index_min_corpus,
            shared=self.index_shared,
            quantize=node.quantize or self.quantize,  # node pin wins
            min_quant_corpus=self.quant_min_corpus, k=max(int(k), 1))
        kind, nprobe, quantize = cfg["kind"], cfg["nprobe"], cfg["quantize"]
        if isinstance(corpus_child, N.StreamScan):
            # don't pin the size-derived nprobe on a stream corpus: it would
            # land in the versioned registry key and churn it as the table
            # grows (sqrt(n) shifts), forcing full rebuilds; the executor
            # keys by recall_target and the index derives nprobe itself
            nprobe = None
        if kind == "ivf":
            c = cfg["costs"]
            tag = "IVF-int8 (+exact rerank)" if quantize == "int8" else "IVF"
            detail = (f"{type(node).__name__.lower()} over ~{n_corpus:.0f} "
                      f"rows -> {tag} (nprobe={nprobe}/{c['n_clusters']} "
                      f"clusters, recall_target={self.recall_target}; est. "
                      f"scan units {c['ivf']:.0f} vs exact {c['exact']:.0f}")
            if quantize == "int8":
                detail += (f"; int8 {c['ivf_q']:.0f} units, "
                           f"~{c['ivf_bytes_per_query'] / max(c['ivf_q_bytes_per_query'], 1):.1f}x "
                           f"fewer scan bytes/query)")
            else:
                detail += ")"
            self.applied.append(AppliedRewrite("choose_retrieval", detail))
        # index_auto marks the choice as estimate-derived: the adaptive
        # executor may re-choose at run time when the real corpus size
        # drifts from n_corpus (user pins returned above, so stay fixed)
        return dataclasses.replace(node, index_kind=kind, nprobe=nprobe,
                                   quantize=quantize, index_auto=True)

    # -- rule 6: partition planning ----------------------------------------
    def _partition_count(self, n_rows: float) -> int:
        """Fragments for an operator over ``n_rows`` input rows: the
        configured count, capped so no fragment is empty.  Shared with the
        adaptive executor (``parallel.partition_count``) so a mid-query
        resize recomputes exactly the planner's sizing rule on observed
        rows."""
        from repro_torch.core.plan.parallel import partition_count
        return partition_count(n_rows, self.n_partitions,
                               self.partition_min_rows)

    def _shard_count(self, n_corpus: float) -> int:
        if self.shards in (None, 0, 1) or n_corpus < 1:
            return 1
        requested = None if self.shards == "auto" else int(self.shards)
        return choose_shards(int(n_corpus), _device_count(),
                             requested=requested,
                             min_corpus=self.shard_min_corpus)

    def _wrap_row_parallel(self, node, what: str):
        P = self._partition_count(estimate_cardinality(node.child))
        if P < 2:
            return None
        wrapped = dataclasses.replace(node, child=N.Partition(node.child, P))
        self.applied.append(AppliedRewrite(
            "plan_partitions", f"{what} row-parallel over {P} partitions "
                               f"(gather concat)"))
        return N.Exchange(wrapped, "gather", P)

    def _plan_partitions(self, node):
        """Cut operators into Exchange-bounded fragments and install the
        device-shard layout on similarity corpora.  Every wrap is
        guarantee-preserving: the partitioned execution (``plan.parallel``)
        reproduces the single-partition output, and cascades keep one
        global importance sample."""
        if isinstance(node, N.Search):
            s = 1 if node.index is not None else \
                self._shard_count(estimate_cardinality(node.child))
            if s < 2:
                return None
            self.applied.append(AppliedRewrite(
                "plan_partitions",
                f"search corpus sharded across {s} devices"))
            return dataclasses.replace(node, shards=s)

        if isinstance(node, N.SimJoin):
            out = node
            s = self._shard_count(estimate_cardinality(node.right))
            if s >= 2:
                self.applied.append(AppliedRewrite(
                    "plan_partitions",
                    f"sim-join right corpus sharded across {s} devices"))
                out = dataclasses.replace(out, shards=s)
            P = self._partition_count(estimate_cardinality(node.left))
            if P >= 2:
                out = dataclasses.replace(
                    out, left=N.Partition(out.left, P),
                    right=N.Exchange(out.right, "broadcast", P))
                self.applied.append(AppliedRewrite(
                    "plan_partitions",
                    f"sim-join probe side over {P} partitions "
                    f"(right index broadcast)"))
                out = N.Exchange(out, "gather", P)
            return out if out is not node else None

        if isinstance(node, (N.Map, N.FusedMap, N.Extract)):
            return self._wrap_row_parallel(node, type(node).__name__.lower())

        if isinstance(node, N.Filter):
            mode = "cascade (global sample)" if node.is_cascade else "gold"
            return self._wrap_row_parallel(node, f"{mode} filter")

        if isinstance(node, N.TopK):
            # only the quickselect algorithm has a partitioned form (the
            # Table-7 baselines exist for measurement, not scale)
            if node.group_by is not None or node.algorithm != "quickselect":
                return None
            P = self._partition_count(estimate_cardinality(node.child))
            if P < 2:
                return None
            wrapped = dataclasses.replace(node,
                                          child=N.Partition(node.child, P))
            self.applied.append(AppliedRewrite(
                "plan_partitions",
                f"top-k over {P} partitions (per-partition quickselect + "
                f"lossless merge)"))
            return N.Exchange(wrapped, "gather", P)

        if isinstance(node, N.Agg):
            if node.partitioner is not None:  # user controls grouping/order
                return None
            P = self._partition_count(estimate_cardinality(node.child))
            if P < 2:
                return None
            if node.group_by is not None:
                part = N.Partition(node.child, P, strategy="hash",
                                   key=node.group_by)
                detail = (f"group-by agg hash-partitioned on "
                          f"{node.group_by!r} over {P} fragments")
            else:
                # fragment boundaries align to the reduction tree's root
                # subtrees -> record-identical merge; the aligned count is
                # fixed by (n, fanout), NOT by the configured n_partitions,
                # so estimate it the same way the executor derives it
                from repro_torch.core.plan.parallel import subtree_partitions
                n_est = estimate_cardinality(node.child)
                P = len(subtree_partitions(int(n_est), node.fanout, P))
                if P < 2:
                    return None
                part = N.Partition(node.child, P, strategy="subtree")
                detail = (f"hierarchical agg over {P} subtree partitions "
                          f"+ one root reduce")
            self.applied.append(AppliedRewrite("plan_partitions", detail))
            return N.Exchange(dataclasses.replace(node, child=part),
                              "gather", P)

        if isinstance(node, N.Join):
            if node.is_cascade or node.strategy:
                # cascade joins calibrate on a global pair sample, and the
                # block path owns its own O(n1*k) candidate layout: both
                # stay single-fragment
                return None
            P = self._partition_count(estimate_cardinality(node.left))
            if P < 2:
                return None
            n2 = estimate_cardinality(node.right)
            if n2 <= self.broadcast_max_rows:
                join = dataclasses.replace(
                    node, left=N.Partition(node.left, P),
                    right=N.Exchange(node.right, "broadcast", P))
                self.applied.append(AppliedRewrite(
                    "plan_partitions",
                    f"join left over {P} partitions, right (~{n2:.0f} rows) "
                    f"broadcast"))
                return N.Exchange(join, "gather", P)
            # near-square grid capped at P fragments; the oversized right
            # side always splits (gr >= 2), the left only when P allows
            # (P=2 -> a 1x2 grid, not an inflated 2x2)
            gl = max(1, int(math.floor(math.sqrt(P))))
            gr = max(2, P // gl)
            join = dataclasses.replace(
                node, left=N.Partition(node.left, gl),
                right=N.Partition(node.right, gr))
            self.applied.append(AppliedRewrite(
                "plan_partitions",
                f"join repartitioned into a {gl}x{gr} fragment grid "
                f"(right ~{n2:.0f} rows too large to broadcast)"))
            return N.Exchange(join, "gather", gl * gr)

        return None

    # -- rule 4: sim-join prefilter ----------------------------------------
    def _inject_sim_prefilter(self, node):
        if not isinstance(node, N.Join) or node.is_cascade \
                or node.prefilter_k or node.strategy:
            return None
        if self.session.embedder is None or not node.langex.is_binary:
            return None
        n1 = estimate_cardinality(node.left)
        n2 = estimate_cardinality(node.right)
        if n1 * n2 < self.prefilter_threshold or n2 < 4:
            return None
        k = max(1, math.ceil(self.prefilter_frac * n2))
        self.applied.append(AppliedRewrite(
            "inject_sim_prefilter",
            f"gold join over ~{n1 * n2:.0f} pairs narrowed to top-{k} "
            f"similar right rows per left row"))
        return dataclasses.replace(node, prefilter_k=k)
