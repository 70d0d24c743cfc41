"""Observability for the semantic-operator stack: span tracing, the
cross-session observed-statistics store and the online guarantee auditor.
``explain_analyze`` and the Prometheus ``MetricsRegistry`` of ``repro.obs``
arrive with the plan layer."""
from repro_torch.obs.stats_store import (ObservedStats, StatsStore,  # noqa: F401
                                         node_fingerprint, predicate_fingerprint)
from repro_torch.obs.trace import (NOOP_SPAN, Span, Tracer, activate,  # noqa: F401
                                   activate_ctx, capture, current_span,
                                   current_tracer, span, span_in)

__all__ = [
    "Tracer", "Span", "NOOP_SPAN", "span", "span_in", "activate",
    "activate_ctx", "capture", "current_span", "current_tracer",
    "StatsStore", "ObservedStats", "predicate_fingerprint",
    "node_fingerprint",
    "GuaranteeAuditor", "AuditPolicy", "AuditBudgeter", "ViolationEvent",
    "wilson_interval", "clopper_pearson", "binomial_interval",
]

_AUDIT_NAMES = frozenset({
    "GuaranteeAuditor", "AuditPolicy", "AuditBudgeter", "ViolationEvent",
    "wilson_interval", "clopper_pearson", "binomial_interval",
})


def __getattr__(name):
    # audit pulls in accounting/backends lazily; it stays lazy here so
    # `import repro_torch.obs` keeps no heavy edges
    if name in _AUDIT_NAMES:
        from repro_torch.obs import audit
        return getattr(audit, name)
    raise AttributeError(name)
