"""Observability for the semantic-operator stack: span tracing, EXPLAIN
ANALYZE, the cross-session observed-statistics store, the online
guarantee auditor and the Prometheus metrics registry."""
from repro_torch.obs.stats_store import (ObservedStats, StatsStore,  # noqa: F401
                                         node_fingerprint, predicate_fingerprint)
from repro_torch.obs.trace import (NOOP_SPAN, Span, Tracer, activate,  # noqa: F401
                                   activate_ctx, capture, current_span,
                                   current_tracer, span, span_in)

__all__ = [
    "Tracer", "Span", "NOOP_SPAN", "span", "span_in", "activate",
    "activate_ctx", "capture", "current_span", "current_tracer",
    "StatsStore", "ObservedStats", "predicate_fingerprint",
    "node_fingerprint", "explain_analyze", "ExplainAnalyzeReport",
    "GuaranteeAuditor", "AuditPolicy", "AuditBudgeter", "ViolationEvent",
    "wilson_interval", "clopper_pearson", "binomial_interval",
    "MetricsRegistry", "parse_exposition",
]

_AUDIT_NAMES = frozenset({
    "GuaranteeAuditor", "AuditPolicy", "AuditBudgeter", "ViolationEvent",
    "wilson_interval", "clopper_pearson", "binomial_interval",
})
_METRICS_NAMES = frozenset({"MetricsRegistry", "parse_exposition"})


def __getattr__(name):
    # explain_analyze pulls in the plan executor; import lazily so
    # core modules can import repro_torch.obs without a cycle
    if name in ("explain_analyze", "ExplainAnalyzeReport"):
        from repro_torch.obs import analyze
        return getattr(analyze, name)
    # audit pulls in accounting/backends lazily, metrics is standalone;
    # both stay lazy here so `import repro_torch.obs` keeps no heavy edges
    if name in _AUDIT_NAMES:
        from repro_torch.obs import audit
        return getattr(audit, name)
    if name in _METRICS_NAMES:
        from repro_torch.obs import metrics
        return getattr(metrics, name)
    raise AttributeError(name)
