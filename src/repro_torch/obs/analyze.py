"""EXPLAIN ANALYZE for lazy semantic-operator plans.

``explain_analyze(frame)`` runs the plan under a tracer and renders the
optimized plan tree with the cost model's *predictions* next to what the
run actually *observed* — per-node cardinality, selectivity, oracle calls,
wall time, and scanned bytes — flagging nodes where the model drifted
beyond a tolerance.  Predictions come from
``core.plan.optimize.predicted_node_metrics`` (the same numbers
``explain_plan`` prints); observations come from the span tree
(``kind="plan_stage"`` spans keyed by plan-node identity) and land in the
given ``StatsStore`` so later sessions can price the same predicates from
observed reality.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import accounting
from repro_torch.core.plan import nodes as N
from repro_torch.core.plan.execute import PlanExecutor
from repro_torch.core.plan.optimize import predicted_node_metrics
from repro_torch.obs import audit as _audit
from repro_torch.obs import trace as _trace
from repro_torch.obs.stats_store import StatsStore, node_fingerprint
from repro_torch.obs.trace import Span, Tracer

_OBS_COUNTERS = ("oracle_calls", "proxy_calls", "embed_calls", "cache_hits",
                 "scanned_bytes", "candidate_pairs",
                 "pairs_pruned_by_inference", "block_prompts",
                 "block_fallbacks")


@dataclasses.dataclass
class NodeReport:
    node: N.LogicalNode
    depth: int
    predicted: dict
    observed: dict | None          # None when the node never ran directly
    drift: list[str] = dataclasses.field(default_factory=list)
    replanned: str | None = None   # adaptive executor's mid-query decision
    audit: dict | None = None      # GuaranteeAuditor CI estimate for this
                                   # node's predicate fingerprint

    def render(self) -> str:
        pad = "  " * self.depth
        pred = self.predicted
        line = f"{pad}{self.node.label()}"
        if self.observed is None:
            return (f"{line}  (pred rows~{pred['rows']:.0f}, "
                    f"oracle~{pred['oracle_calls']:.0f}; not executed "
                    f"directly)")
        obs = self.observed
        cols = [f"rows {pred['rows']:.0f}~/{obs['rows_out']} obs"]
        if pred["selectivity"] is not None and obs.get("selectivity") is not None:
            cols.append(f"sel {pred['selectivity']:.3f}~/"
                        f"{obs['selectivity']:.3f} obs")
        cols.append(f"oracle {pred['oracle_calls']:.0f}~/"
                    f"{obs['oracle_calls']} obs")
        cols.append(f"wall {obs['wall_s'] * 1e3:.1f}ms")
        if obs.get("scanned_bytes"):
            cols.append(f"bytes {obs['scanned_bytes']}")
        if obs.get("tau_plus") is not None:
            cols.append(f"tau {obs['tau_plus']:.2f}/{obs['tau_minus']:.2f}")
        if obs.get("candidate_pairs"):
            cols.append(f"cand {obs['candidate_pairs']}")
        if obs.get("block_prompts"):
            blk = f"blocks {obs['block_prompts']}"
            if obs.get("block_fallbacks"):
                blk += f"(-{obs['block_fallbacks']} fb)"
            cols.append(blk)
        if obs.get("pairs_pruned_by_inference"):
            cols.append(f"pruned {obs['pairs_pruned_by_inference']}")
        if self.audit is not None:
            # the audited guarantee next to the calibrated thresholds: CI
            # bounds on live precision/recall from gold re-judgments
            for kind, tag in (("precision", "P"), ("recall", "R")):
                ci = self.audit.get(kind)
                if ci is not None:
                    cols.append(f"audit {tag}~{ci['point']:.2f}"
                                f"[{ci['lo']:.2f},{ci['hi']:.2f}] "
                                f"n={ci['n']}")
            if self.audit.get("violations"):
                cols.append(f"violations={self.audit['violations']}")
        line += "  (" + ", ".join(cols) + ")"
        if self.drift:
            line += "  !! drift: " + ", ".join(self.drift)
        if self.replanned:
            line += f"  >> replanned: {self.replanned}"
        return line


@dataclasses.dataclass
class ExplainAnalyzeReport:
    records: list
    plan: N.LogicalNode
    nodes: list[NodeReport]
    tracer: Tracer
    stats_store: StatsStore
    tolerance: float

    @property
    def drifted(self) -> list[NodeReport]:
        return [r for r in self.nodes if r.drift]

    def render(self) -> str:
        head = (f"EXPLAIN ANALYZE  (predicted~/observed, "
                f"drift tolerance {self.tolerance:.0%})")
        return "\n".join([head] + [r.render() for r in self.nodes])

    def __str__(self) -> str:
        return self.render()


def _drift_ratio(pred: float, obs: float) -> float:
    lo, hi = sorted((max(pred, 0.0), float(obs)))
    return hi / max(lo, 1.0)


def _observed_for(sp: Span, children: dict) -> dict:
    """Exclusive observed metrics for one plan-stage span: call counters
    from the *top-level* operator/fragment spans directly below it (their
    attrs already include nested roll-ups via ``accounting.track``), wall
    minus the time spent in child plan stages."""
    agg = dict.fromkeys(_OBS_COUNTERS, 0)
    taus: dict = {}
    child_stage_wall = 0.0
    stack = list(children.get(sp.span_id, ()))
    while stack:
        c = stack.pop()
        if c.kind == "plan_stage":
            child_stage_wall += c.dur_s
            continue
        if c.kind in ("operator", "fragment"):
            for k in _OBS_COUNTERS:
                v = c.attrs.get(k, 0)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    agg[k] += int(v)
            # calibrated cascade thresholds land on the operator span via
            # accounting.track's detail flattening
            for k in ("tau_plus", "tau_minus"):
                if k not in taus and isinstance(c.attrs.get(k), float):
                    taus[k] = c.attrs[k]
            continue  # roll-ups make descending double-count
        stack.extend(children.get(c.span_id, ()))
    rows_in = sp.attrs.get("rows_in")
    rows_out = sp.attrs.get("rows_out", 0)
    return {
        **agg,
        **taus,
        "rows_in": rows_in,
        "rows_out": rows_out,
        "selectivity": (rows_out / rows_in if rows_in else None),
        "wall_s": max(sp.dur_s - child_stage_wall, 0.0),
        "wall_total_s": sp.dur_s,
    }


def _walk(node: N.LogicalNode, depth: int, by_node: dict, children: dict,
          tolerance: float, out: list, auditor=None) -> None:
    pred = predicted_node_metrics(node)
    sp = by_node.get(id(node))
    observed = _observed_for(sp, children) if sp is not None else None
    drift = []
    if observed is not None:
        if _drift_ratio(pred["rows"], observed["rows_out"]) > 1 + tolerance:
            drift.append(
                f"rows {_drift_ratio(pred['rows'], observed['rows_out']):.1f}x")
        # oracle drift only matters where the model priced actual calls
        if pred["oracle_calls"] >= 1 or observed["oracle_calls"] >= 1:
            r = _drift_ratio(pred["oracle_calls"], observed["oracle_calls"])
            if r > 1 + tolerance:
                drift.append(f"oracle {r:.1f}x")
    replanned = sp.attrs.get("replanned") if sp is not None else None
    audit = auditor.report_for(node_fingerprint(node)) \
        if auditor is not None else None
    out.append(NodeReport(node, depth, pred, observed, drift, replanned,
                          audit))
    for c in node.children():
        _walk(c, depth + 1, by_node, children, tolerance, out, auditor)


def explain_analyze(frame, *, optimize: bool = True, tolerance: float = 0.5,
                    tracer: Tracer | None = None,
                    stats_store: StatsStore | None = None,
                    auditor=None,
                    **opt_kw) -> ExplainAnalyzeReport:
    """Run a ``LazySemFrame`` plan traced, and return a report comparing the
    cost model's per-node predictions with the observed execution.

    The frame's cached (optimizer, executor) pair is reused, so an
    ``explain()`` or earlier ``collect()`` shares probe labels and the
    batched cache with this run — same contract as ``collect``.

    With ``auditor=`` (a ``GuaranteeAuditor``) the run executes under that
    auditor's sampling hooks, the queue is drained before reporting, and
    each node shows the audited precision/recall CI for its predicate
    fingerprint next to the calibrated thresholds.
    """
    tracer = tracer if tracer is not None else Tracer()
    stats_store = stats_store if stats_store is not None else StatsStore()
    if optimize:
        optimizer, executor = frame._optimizer_and_executor(**opt_kw)
    else:
        optimizer = None
        executor = PlanExecutor(frame.session, stats_log=frame.stats_log)
    prev_store, executor.stats_store = executor.stats_store, stats_store
    try:
        with _trace.activate(tracer), _audit.activate_ctx(auditor):
            if optimizer is not None:
                with _trace.span("explain_analyze", kind="session"):
                    with accounting.track("plan_optimize") as st:
                        plan = optimizer.optimize(frame.plan)
                    st.details.update(
                        rewrites=[str(r) for r in optimizer.applied])
                    frame.stats_log.append(st.as_dict())
                    frame.last_rewrites = optimizer.applied
                    records = executor.run(plan)
            else:
                with _trace.span("explain_analyze", kind="session"):
                    plan = frame.plan
                    records = executor.run(plan)
    finally:
        executor.stats_store = prev_store
    if auditor is not None:
        auditor.drain()   # settle queued gold re-judgments before reporting
    by_node = {}
    for sp in tracer.spans(kind="plan_stage"):
        by_node.setdefault(sp.attrs.get("node_id"), sp)
    nodes: list[NodeReport] = []
    _walk(plan, 0, by_node, tracer.children_index(), tolerance, nodes,
          auditor)
    return ExplainAnalyzeReport(records=records, plan=plan, nodes=nodes,
                                tracer=tracer, stats_store=stats_store,
                                tolerance=tolerance)
