"""Per-operator cost accounting: oracle/proxy LM calls, embedding calls.

Every backend call is routed through the active ``OpStats`` so benchmarks can
report the paper's '# LM calls' columns exactly.

Two nesting levels:

  * ``track(operator)`` — one OpStats per operator invocation; nested
    operators roll up into their parent (unchanged single-query behavior).
  * ``session_scope(name)`` — a long-lived roll-up that accumulates every
    ``record()`` on this thread across *all* operator blocks, used by the
    serving gateway to report per-session totals while many sessions run
    concurrently (accounting state is thread-local, and each serve session
    executes on one worker thread).

Partition fragments are the one place a single operator's model calls span
threads: the partitioned executor captures the coordinating thread's
(operator, session) stats with ``capture()`` and re-installs them on each
fragment worker with ``activate()``, so per-partition calls roll up into the
same operator block and the same serve session.  Because several fragments
may then add into one shared OpStats concurrently, all cross-thread adds
(``record()`` and the ``track()`` roll-up) serialize on one module lock —
they are rare (per *batch*, not per prompt), so contention is noise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from repro_torch.obs import trace as _trace

_ctx = threading.local()
_add_lock = threading.Lock()  # guards adds into potentially shared OpStats


@dataclasses.dataclass
class OpStats:
    operator: str = ""
    oracle_calls: int = 0
    proxy_calls: int = 0
    embed_calls: int = 0
    compare_calls: int = 0
    generate_calls: int = 0
    audit_calls: int = 0   # gold re-judgments by the GuaranteeAuditor — a
                           # dedicated kind so query bills are bit-identical
                           # with auditing on or off
    cache_hits: int = 0    # prompts served by BatchedModelCache, not a model
    wall_s: float = 0.0
    details: dict = dataclasses.field(default_factory=dict)

    _KINDS = ("oracle", "proxy", "embed", "compare", "generate", "audit",
              "cache_hit")

    def add(self, kind: str, n: int) -> None:
        attr = "cache_hits" if kind == "cache_hit" else f"{kind}_calls"
        setattr(self, attr, getattr(self, attr) + n)

    @property
    def lm_calls(self) -> int:
        # every LM call is attributed to its wrapping role (oracle/proxy);
        # compare/generate are kept as per-kind breakdown columns of the same
        # traffic, so summing them here would double-count
        return self.oracle_calls + self.proxy_calls

    def as_dict(self) -> dict:
        return {
            "operator": self.operator, "oracle_calls": self.oracle_calls,
            "proxy_calls": self.proxy_calls, "embed_calls": self.embed_calls,
            "compare_calls": self.compare_calls, "generate_calls": self.generate_calls,
            "audit_calls": self.audit_calls, "cache_hits": self.cache_hits,
            "lm_calls": self.lm_calls, "wall_s": round(self.wall_s, 4), **self.details,
        }


def current() -> OpStats | None:
    return getattr(_ctx, "stats", None)


def current_session() -> OpStats | None:
    return getattr(_ctx, "session_stats", None)


def record(kind: str, n: int) -> None:
    st = current()
    sess = current_session()
    if st is None and sess is None:
        return
    with _add_lock:
        if st is not None:
            st.add(kind, n)
        if sess is not None:
            sess.add(kind, n)


def capture() -> tuple:
    """Snapshot this thread's accounting context (operator + session stats
    + trace context + active auditor) for re-installation on a fragment
    worker thread."""
    from repro_torch.obs import audit as _audit
    return (current(), current_session(), _trace.capture(), _audit.capture())


@contextlib.contextmanager
def activate(ctx: tuple):
    """Install a captured context on the current thread (fragment workers);
    restores the thread's own context on exit, so pooled threads never leak
    one session's stats into the next."""
    from repro_torch.obs import audit as _audit
    prev = (current(), current_session())
    _ctx.stats, _ctx.session_stats = ctx[0], ctx[1]
    trace_ctx = ctx[2] if len(ctx) > 2 else (None, None)
    auditor = ctx[3] if len(ctx) > 3 else None
    try:
        with _trace.activate_ctx(trace_ctx), _audit.activate_ctx(auditor):
            yield
    finally:
        _ctx.stats, _ctx.session_stats = prev


@contextlib.contextmanager
def track(operator: str):
    prev = current()
    st = OpStats(operator=operator)
    _ctx.stats = st
    t0 = time.monotonic()
    span_cm = _trace.span(
        operator,
        kind="fragment" if operator.startswith("fragment[") else "operator")
    sp = span_cm.__enter__()
    try:
        yield st
    finally:
        st.wall_s = time.monotonic() - t0
        sp.set(**st.as_dict())
        span_cm.__exit__(None, None, None)
        _ctx.stats = prev
        if prev is not None:  # nested operators roll up into the parent
            with _add_lock:   # the parent may be shared across fragments
                for kind in OpStats._KINDS:
                    prev.add(kind,
                             getattr(st, "cache_hits" if kind == "cache_hit"
                                     else f"{kind}_calls"))
                # numeric detail keys (scanned_bytes, rerank rows, ...)
                # merge additively instead of vanishing with the child
                for k, v in st.details.items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        base = prev.details.get(k, 0)
                        if isinstance(base, (int, float)) \
                                and not isinstance(base, bool):
                            prev.details[k] = base + v
                    elif k not in prev.details:
                        prev.details[k] = v


@contextlib.contextmanager
def session_scope(name: str):
    """Accumulate every ``record()`` on this thread into one session-level
    OpStats, across any number of ``track()`` operator blocks.  ``track()``
    roll-ups bypass ``record()``, so each backend call lands in the session
    stats exactly once.  Scopes nest by shadowing (innermost wins)."""
    prev = current_session()
    st = OpStats(operator=f"session/{name}")
    _ctx.session_stats = st
    t0 = time.monotonic()
    try:
        yield st
    finally:
        st.wall_s = time.monotonic() - t0
        _ctx.session_stats = prev
