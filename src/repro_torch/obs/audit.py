"""GuaranteeAuditor: online quality observability for the guarantee machinery.

Cascade thresholds (``tau_plus``/``tau_minus``) are calibrated once, from an
importance sample at (gamma_R, gamma_P, delta) — but under streaming
appends, shared-cache reuse, adaptive replans, and proxy drift nothing
re-checks that the deployed decision rule still delivers the promised
precision/recall.  This module is that check:

  * every cascade operator (``sem_filter`` / cascade joins, including the
    partitioned variants) emits its *auto-decisions* — rows accepted or
    rejected by threshold alone, without an oracle label — through
    :func:`emit_cascade`;
  * the auditor samples a budgeted fraction of them
    (:class:`AuditBudgeter`: a hard per-window sample cap) and re-judges the
    sampled rows with the gold oracle **asynchronously**, on its own worker
    thread, through the micro-batch dispatcher's background-priority
    ``audit`` role — so audit traffic shares fused batches but never blocks
    a query, never warms a query-visible cache namespace, and bills to a
    dedicated ``audit`` accounting kind (query oracle bills stay
    bit-identical with auditing on or off);
  * per (operator, predicate-fingerprint) it accumulates Wilson /
    Clopper-Pearson confidence intervals on the observed precision and
    recall of the deployed rule, and — for ANN retrieval — sampled exact
    re-scans estimating live recall@k against each index's
    ``recall_target`` (:func:`emit_search`, fed by ``IVFIndex.search``
    including the delta-buffer and int8 paths);
  * when a CI lower bound crosses below the declared target it emits a
    structured :class:`ViolationEvent`: an alert counter is raised, the
    matching ``StatsStore`` fingerprint entry is poisoned (adaptive
    replanning and feedback costing stop trusting stale selectivities), and
    an ``on_violation`` callback lets the gateway purge the predicate's
    cached oracle/proxy answers so the next query recalibrates fresh.

Estimators (w.r.t. the *current* gold oracle):

  judged rows carry oracle labels, so errors only hide in auto-decisions.
  With J = judged-accepted, A = auto-accepted, R = auto-rejected population
  counts and audited gold-true rates p_acc (among sampled auto-accepts) and
  p_rej (among sampled auto-rejects):

      precision_lo = (J + A * lo(p_acc)) / (J + A)
      recall_lo    = (J + A * lo(p_acc))
                     / (J + A * lo(p_acc) + R * hi(p_rej))

  where lo/hi are the chosen binomial interval's bounds at 1 - delta.
  Both intervals are numpy/stdlib-only: Wilson uses the normal quantile
  from ``statistics.NormalDist``; Clopper-Pearson inverts the regularized
  incomplete beta (continued fraction + bisection).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import re
import statistics
import threading
import time
from collections import deque

import numpy as np

from repro_torch.obs.stats_store import predicate_fingerprint

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Binomial confidence intervals (numpy/stdlib only — no scipy)
# ---------------------------------------------------------------------------


def wilson_interval(successes: int, n: int, *,
                    delta: float = 0.05) -> tuple[float, float]:
    """Wilson score interval: P(p in [lo, hi]) >= 1 - delta (approx)."""
    if n <= 0:
        return 0.0, 1.0
    s = min(max(int(successes), 0), int(n))
    z = statistics.NormalDist().inv_cdf(1.0 - delta / 2.0)
    p = s / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    # at the boundaries center-half is exactly 0 (resp. 1) in real
    # arithmetic; pin them so float error cannot leak past the edge
    lo = 0.0 if s == 0 else max(0.0, center - half)
    hi = 1.0 if s == n else min(1.0, center + half)
    return lo, hi


def _betacf(a: float, b: float, x: float) -> float:
    """Continued fraction for the incomplete beta (Numerical Recipes)."""
    MAXIT, EPS, FPMIN = 300, 3e-14, 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < FPMIN:
        d = FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, MAXIT + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        delt = d * c
        h *= delt
        if abs(delt - 1.0) < EPS:
            break
    return h


def _betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_bt = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log1p(-x))
    bt = math.exp(ln_bt)
    if x < (a + 1.0) / (a + b + 2.0):
        return bt * _betacf(a, b, x) / a
    return 1.0 - bt * _betacf(b, a, 1.0 - x) / b


def _beta_inv(p: float, a: float, b: float) -> float:
    """Inverse of I_x(a, b) by bisection (monotone in x; ~1e-12 accurate)."""
    lo, hi = 0.0, 1.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _betainc(a, b, mid) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def clopper_pearson(successes: int, n: int, *,
                    delta: float = 0.05) -> tuple[float, float]:
    """Exact (conservative) binomial interval: P(p in [lo, hi]) >= 1-delta."""
    if n <= 0:
        return 0.0, 1.0
    s = min(max(int(successes), 0), int(n))
    lo = 0.0 if s == 0 else _beta_inv(delta / 2.0, s, n - s + 1)
    hi = 1.0 if s == n else _beta_inv(1.0 - delta / 2.0, s + 1, n - s)
    return lo, hi


def binomial_interval(successes: int, n: int, *, delta: float = 0.05,
                      method: str = "wilson") -> tuple[float, float]:
    if method in ("cp", "clopper-pearson", "clopper_pearson", "exact"):
        return clopper_pearson(successes, n, delta=delta)
    if method == "wilson":
        return wilson_interval(successes, n, delta=delta)
    raise ValueError(f"unknown interval method {method!r}")


def template_match_token(template) -> str:
    """Longest literal segment of a langex template — present verbatim in
    every rendered prompt, so it keys cache invalidation for the predicate."""
    segs = re.split(r"\{[^{}]*\}", str(template))
    return max(segs, key=len).strip() if segs else ""


# ---------------------------------------------------------------------------
# Budgeter
# ---------------------------------------------------------------------------


class AuditBudgeter:
    """Hard per-window sample cap: ``take(n)`` grants at most what is left
    of ``budget`` in the current ``window_s`` window (clock injectable for
    the property tests).  Thread-safe; never grants more than asked."""

    def __init__(self, budget: int, window_s: float, *,
                 now_fn=time.monotonic):
        if budget < 0:
            raise ValueError(f"budget={budget} (expected >= 0)")
        if window_s <= 0:
            raise ValueError(f"window_s={window_s} (expected > 0)")
        self.budget = int(budget)
        self.window_s = float(window_s)
        self._now = now_fn
        self._lock = threading.Lock()
        self._window_start: float | None = None
        self._spent_window = 0
        self.granted_total = 0
        self.denied_total = 0

    def _roll(self, now: float) -> None:
        if self._window_start is None or \
                now - self._window_start >= self.window_s:
            self._window_start = now
            self._spent_window = 0

    def take(self, n: int) -> int:
        """Grant ``min(n, remaining-in-window)`` samples; 0 when spent."""
        if n <= 0:
            return 0
        with self._lock:
            self._roll(self._now())
            granted = min(int(n), self.budget - self._spent_window)
            granted = max(granted, 0)
            self._spent_window += granted
            self.granted_total += granted
            self.denied_total += int(n) - granted
            return granted

    def remaining(self) -> int:
        with self._lock:
            self._roll(self._now())
            return self.budget - self._spent_window


# ---------------------------------------------------------------------------
# Policy / events
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AuditPolicy:
    sample_fraction: float = 0.5       # of auto-decisions per cascade
    budget_per_window: int = 512       # gold re-judgments per window
    window_s: float = 30.0
    min_samples: int = 16              # CI checks wait for this many audits
    delta: float = 0.1                 # CI coverage 1 - delta
    method: str = "wilson"             # or "clopper-pearson"
    recalibrate: bool = True           # violation => purge + poison
    search_sample_fraction: float = 0.25   # of queries per ANN search
    search_budget_per_window: int = 256    # exact re-scored queries / window
    min_search_samples: int = 32       # returned slots before recall CI check
    seed: int = 0

    def interval(self, successes: int, n: int) -> tuple[float, float]:
        return binomial_interval(successes, n, delta=self.delta,
                                 method=self.method)


@dataclasses.dataclass
class ViolationEvent:
    """A CI lower bound fell below its declared target."""

    kind: str                  # "precision" | "recall" | "recall_at_k"
                               # | "block_agreement"
    operator: str
    fingerprint: str
    template: str | None
    match_token: str | None
    observed: float            # point estimate
    lower: float               # CI lower bound that tripped
    target: float
    n: int                     # audited samples behind the bound
    details: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["observed"] = round(self.observed, 4)
        d["lower"] = round(self.lower, 4)
        return d


# ---------------------------------------------------------------------------
# Accumulators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _CascadeAccount:
    operator: str
    fingerprint: str
    template: str
    match_token: str
    recall_target: float
    precision_target: float
    # audited samples (gold re-judgments of auto-decisions)
    acc_n: int = 0             # sampled auto-accepts
    acc_true: int = 0          # ... that the gold oracle confirms
    rej_n: int = 0             # sampled auto-rejects
    rej_true: int = 0          # ... that the gold oracle says were matches
    # population totals since the last reset
    judged_accepted: int = 0
    auto_accepted: int = 0
    auto_rejected: int = 0
    audited: int = 0
    violations: int = 0

    def reset_window(self) -> None:
        """Start a fresh estimation window (after a violation fires the old
        evidence describes the *pre-recalibration* rule)."""
        self.acc_n = self.acc_true = 0
        self.rej_n = self.rej_true = 0
        self.judged_accepted = self.auto_accepted = self.auto_rejected = 0

    def estimates(self, policy: AuditPolicy) -> dict:
        j, a, r = self.judged_accepted, self.auto_accepted, self.auto_rejected
        out: dict = {"operator": self.operator,
                     "fingerprint": self.fingerprint,
                     "template": self.template,
                     "audited_accepts": self.acc_n,
                     "audited_rejects": self.rej_n,
                     "audited": self.audited,
                     "violations": self.violations,
                     "precision_target": self.precision_target,
                     "recall_target": self.recall_target,
                     "precision": None, "recall": None}
        if self.acc_n > 0 and (j + a) > 0:
            p_hat = self.acc_true / self.acc_n
            p_lo, p_hi = policy.interval(self.acc_true, self.acc_n)
            out["precision"] = {
                "point": (j + a * p_hat) / (j + a),
                "lo": (j + a * p_lo) / (j + a),
                "hi": (j + a * p_hi) / (j + a),
                "n": self.acc_n}
            if self.rej_n > 0:
                m_hat = self.rej_true / self.rej_n
                m_lo, m_hi = policy.interval(self.rej_true, self.rej_n)
                tp = j + a * p_hat
                tp_lo = j + a * p_lo
                denom = tp + r * m_hat
                out["recall"] = {
                    "point": tp / denom if denom > 0 else 1.0,
                    "lo": tp_lo / (tp_lo + r * m_hi)
                    if (tp_lo + r * m_hi) > 0 else 1.0,
                    "hi": min((j + a * p_hi)
                              / max(j + a * p_hi + r * m_lo, 1e-12), 1.0),
                    "n": self.rej_n}
        return out


@dataclasses.dataclass
class _BlockAccount:
    """Agreement of block-prompt verdicts with the pairwise gold oracle.

    The block-join path decides most pairs through multi-pair structured
    prompts; its guarantee rests on block verdicts tracking what the same
    oracle would answer pairwise.  Sampled block verdicts are re-judged
    pairwise and the agreement rate gets a CI against the operator's
    declared agreement target."""

    operator: str
    fingerprint: str
    template: str
    match_token: str
    agreement_target: float
    n: int = 0                 # block verdicts re-judged pairwise
    agree: int = 0             # ... matching the pairwise gold verdict
    pairs_seen: int = 0        # block-judged pairs observed (population)
    audited: int = 0
    violations: int = 0

    def reset_window(self) -> None:
        self.n = self.agree = 0

    def estimates(self, policy: AuditPolicy) -> dict:
        out: dict = {"operator": self.operator,
                     "fingerprint": self.fingerprint,
                     "template": self.template,
                     "agreement_target": self.agreement_target,
                     "pairs_seen": self.pairs_seen, "audited": self.audited,
                     "violations": self.violations, "agreement": None}
        if self.n > 0:
            lo, hi = policy.interval(self.agree, self.n)
            out["agreement"] = {"point": self.agree / self.n,
                                "lo": lo, "hi": hi, "n": self.n}
        return out


@dataclasses.dataclass
class _SearchAccount:
    key: str                   # index kind (+ quantize) label
    recall_target: float
    n: int = 0                 # audited result slots (k per audited query)
    hits: int = 0              # slots whose exact score clears the exact kth
    queries_audited: int = 0
    violations: int = 0

    def estimates(self, policy: AuditPolicy) -> dict:
        out = {"key": self.key, "recall_target": self.recall_target,
               "queries_audited": self.queries_audited, "n": self.n,
               "violations": self.violations, "recall_at_k": None}
        if self.n > 0:
            lo, hi = policy.interval(self.hits, self.n)
            out["recall_at_k"] = {"point": self.hits / self.n,
                                  "lo": lo, "hi": hi, "n": self.n}
        return out


# ---------------------------------------------------------------------------
# Thread-local auditor context (mirrors accounting/trace propagation)
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_auditor() -> "GuaranteeAuditor | None":
    return getattr(_tls, "auditor", None)


def capture() -> "GuaranteeAuditor | None":
    """Snapshot for re-installation on fragment/worker threads (rides in
    ``accounting.capture()``'s context tuple)."""
    return current_auditor()


@contextlib.contextmanager
def activate_ctx(auditor: "GuaranteeAuditor | None"):
    prev = current_auditor()
    _tls.auditor = auditor
    try:
        yield
    finally:
        _tls.auditor = prev


# -- operator-side emission hooks (cheap no-ops without an active auditor) --


def emit_cascade(operator: str, template, res, prompt_fn, *,
                 recall_target: float, precision_target: float) -> int:
    """Called by cascade operators right after the decision rule ran.
    ``res`` is a ``CascadeResult`` (its ``judged`` mask marks oracle-labeled
    rows); ``prompt_fn(indices) -> prompts`` materializes prompts for the
    sampled rows only.  Returns the number of decisions enqueued for audit."""
    aud = current_auditor()
    if aud is None or getattr(res, "judged", None) is None:
        return 0
    try:
        return aud.observe_cascade(operator, template, res, prompt_fn,
                                   recall_target=recall_target,
                                   precision_target=precision_target)
    except Exception:  # auditing is observability: never break the query
        log.warning("audit emit_cascade failed", exc_info=True)
        return 0


def emit_search(index, queries, scores, ids, k, *, vectors, n_cut,
                recall_target: float) -> int:
    """Called by ANN indexes at the end of ``search()``; the auditor
    exact-rescans a sampled subset of the query rows asynchronously."""
    aud = current_auditor()
    if aud is None:
        return 0
    try:
        return aud.observe_search(index, queries, scores, ids, k,
                                  vectors=vectors, n_cut=n_cut,
                                  recall_target=recall_target)
    except Exception:
        log.warning("audit emit_search failed", exc_info=True)
        return 0


def emit_block_join(operator: str, template, pairs, verdicts, prompt_fn, *,
                    agreement_target: float) -> int:
    """Called by the block-join path with the pairs it decided through block
    prompts (``pairs``/``verdicts`` aligned); the auditor re-judges a
    budgeted sample of them *pairwise* asynchronously and tracks the
    block-vs-pairwise agreement CI against ``agreement_target``.
    ``prompt_fn(indices) -> prompts`` renders the pairwise prompts for the
    sampled positions only."""
    aud = current_auditor()
    if aud is None or not len(pairs):
        return 0
    try:
        return aud.observe_block_join(operator, template, pairs, verdicts,
                                      prompt_fn,
                                      agreement_target=agreement_target)
    except Exception:
        log.warning("audit emit_block_join failed", exc_info=True)
        return 0


# ---------------------------------------------------------------------------
# The auditor
# ---------------------------------------------------------------------------


class GuaranteeAuditor:
    """Budgeted asynchronous gold audits of live cascade/ANN decisions.

    ``oracle`` is any predicate-capable model; a raw backend is wrapped in
    a ``CountedModel(..., "audit")`` so its calls land on the dedicated
    ``audit`` accounting kind (dispatcher handles already carry a role).
    The worker thread runs under the auditor's own ``OpStats`` — audit
    traffic never leaks into any session's bill.
    """

    def __init__(self, oracle, *, policy: AuditPolicy | None = None,
                 stats_store=None, on_violation=None, path: str | None = None,
                 now_fn=time.monotonic):
        from repro_torch.core.accounting import OpStats  # lazy: avoids a cycle
        if getattr(oracle, "role", None) != "audit":
            from repro_torch.core.backends.base import CountedModel
            oracle = CountedModel(oracle, "audit")
        self._oracle = oracle
        self.policy = policy or AuditPolicy()
        self.stats_store = stats_store
        self.on_violation = on_violation
        self.path = path
        self.stats = OpStats(operator="audit")
        self.budgeter = AuditBudgeter(self.policy.budget_per_window,
                                      self.policy.window_s, now_fn=now_fn)
        self.search_budgeter = AuditBudgeter(
            self.policy.search_budget_per_window, self.policy.window_s,
            now_fn=now_fn)
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(self.policy.seed)
        self._cascades: dict[str, _CascadeAccount] = {}
        self._searches: dict[str, _SearchAccount] = {}
        self._blocks: dict[str, _BlockAccount] = {}
        self._emissions: dict[str, dict] = {}   # per-tenant continuous-query
        self.violations: deque[ViolationEvent] = deque(maxlen=256)
        self.violation_counts: dict[str, int] = {}
        self.errors = 0
        self.last_error: str | None = None
        self._pending = 0
        self._done_cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._queue_cv = threading.Condition()
        self._closed = False
        if path:
            self.load(path)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="guarantee-auditor")
        self._thread.start()

    # -- caller side (query threads; cheap) --------------------------------
    def observe_cascade(self, operator: str, template, res, prompt_fn, *,
                        recall_target: float, precision_target: float) -> int:
        template = str(getattr(template, "template", template))
        passed = np.asarray(res.passed, bool).ravel()
        judged = np.asarray(res.judged, bool).ravel()
        auto_acc = np.flatnonzero(passed & ~judged)
        auto_rej = np.flatnonzero(~passed & ~judged)
        fp = predicate_fingerprint(operator, template)
        frac = self.policy.sample_fraction
        want_acc = math.ceil(frac * len(auto_acc)) if len(auto_acc) else 0
        want_rej = math.ceil(frac * len(auto_rej)) if len(auto_rej) else 0
        with self._lock:
            acct = self._cascades.get(fp)
            if acct is None:
                acct = self._cascades[fp] = _CascadeAccount(
                    operator=operator, fingerprint=fp, template=template,
                    match_token=template_match_token(template),
                    recall_target=recall_target,
                    precision_target=precision_target)
            acct.recall_target = recall_target
            acct.precision_target = precision_target
            acct.judged_accepted += int((passed & judged).sum())
            acct.auto_accepted += len(auto_acc)
            acct.auto_rejected += len(auto_rej)
            granted = self.budgeter.take(want_acc + want_rej)
            if granted <= 0:
                return 0
            g_acc = min(want_acc, granted)
            g_rej = min(want_rej, granted - g_acc)
            sel_acc = self._rng.choice(auto_acc, size=g_acc, replace=False) \
                if g_acc else np.zeros(0, int)
            sel_rej = self._rng.choice(auto_rej, size=g_rej, replace=False) \
                if g_rej else np.zeros(0, int)
        prompts_acc = list(prompt_fn(sel_acc)) if len(sel_acc) else []
        prompts_rej = list(prompt_fn(sel_rej)) if len(sel_rej) else []
        if not prompts_acc and not prompts_rej:
            return 0
        self._enqueue(("cascade", fp, prompts_acc, prompts_rej))
        return len(prompts_acc) + len(prompts_rej)

    def observe_search(self, index, queries, scores, ids, k, *, vectors,
                       n_cut: int, recall_target: float) -> int:
        q = np.atleast_2d(np.asarray(queries, np.float32))
        nq = len(q)
        if nq == 0 or n_cut <= 0 or k <= 0:
            return 0
        want = math.ceil(self.policy.search_sample_fraction * nq)
        granted = self.search_budgeter.take(want)
        if granted <= 0:
            return 0
        with self._lock:
            rows = self._rng.choice(nq, size=min(granted, nq), replace=False)
        key = getattr(index, "kind", str(index))
        quant = getattr(index, "quantize", None)
        if quant and quant != "none":
            key = f"{key}/{quant}"
        # copies decouple the job from the caller's buffers; `vectors` is
        # the search-time snapshot (replaced, never resized, on mutation)
        job = ("search", key, float(recall_target), vectors,
               q[rows].copy(), np.asarray(scores)[rows].copy(),
               np.asarray(ids)[rows].copy(), int(k), int(n_cut))
        self._enqueue(job)
        return len(rows)

    def observe_block_join(self, operator: str, template, pairs, verdicts,
                           prompt_fn, *, agreement_target: float) -> int:
        template = str(getattr(template, "template", template))
        verdicts = np.asarray(verdicts, bool).ravel()
        n_pairs = len(verdicts)
        if n_pairs == 0:
            return 0
        fp = predicate_fingerprint(operator, template)
        want = math.ceil(self.policy.sample_fraction * n_pairs)
        with self._lock:
            acct = self._blocks.get(fp)
            if acct is None:
                acct = self._blocks[fp] = _BlockAccount(
                    operator=operator, fingerprint=fp, template=template,
                    match_token=template_match_token(template),
                    agreement_target=agreement_target)
            acct.agreement_target = agreement_target
            acct.pairs_seen += n_pairs
            granted = self.budgeter.take(want)
            if granted <= 0:
                return 0
            sel = self._rng.choice(n_pairs, size=min(granted, n_pairs),
                                   replace=False)
        prompts = list(prompt_fn(sel))
        if not prompts:
            return 0
        self._enqueue(("block_join", fp, prompts, verdicts[sel].tolist()))
        return len(prompts)

    def observe_emission(self, *, tenant: str, rows: int, added: int,
                         error: bool = False) -> None:
        """Continuous-query emission accounting (per-tenant audit series);
        the emission's cascade decisions are sampled by the normal
        ``emit_cascade`` path since subscriptions execute through the
        gateway workers."""
        with self._lock:
            e = self._emissions.setdefault(
                tenant, {"emissions": 0, "rows": 0, "added": 0, "errors": 0})
            e["emissions"] += 1
            e["rows"] += max(int(rows), 0)
            e["added"] += max(int(added), 0)
            if error:
                e["errors"] += 1

    # -- worker side -------------------------------------------------------
    def _enqueue(self, job: tuple) -> None:
        with self._queue_cv:
            if self._closed:
                return
            self._queue.append(job)
            self._queue_cv.notify()
        with self._lock:
            self._pending += 1

    def _loop(self) -> None:
        from repro_torch.core import accounting
        # the worker owns its accounting context: audit model calls land on
        # self.stats (kind "audit"), never on a session
        with accounting.activate((self.stats, None, (None, None), None)):
            while True:
                with self._queue_cv:
                    while not self._queue and not self._closed:
                        self._queue_cv.wait()
                    if not self._queue:
                        return           # closed and drained
                    job = self._queue.popleft()
                try:
                    self._run_job(job)
                except Exception as exc:
                    with self._lock:
                        self.errors += 1
                        self.last_error = repr(exc)
                finally:
                    with self._done_cv:
                        self._pending -= 1
                        self._done_cv.notify_all()

    def _run_job(self, job: tuple) -> None:
        if job[0] == "cascade":
            _, fp, prompts_acc, prompts_rej = job
            labels, _ = self._oracle.predicate(prompts_acc + prompts_rej)
            labels = np.asarray(labels, bool)
            acc_true = int(labels[: len(prompts_acc)].sum())
            rej_true = int(labels[len(prompts_acc):].sum())
            events = []
            with self._lock:
                acct = self._cascades.get(fp)
                if acct is None:
                    return
                acct.acc_n += len(prompts_acc)
                acct.acc_true += acc_true
                acct.rej_n += len(prompts_rej)
                acct.rej_true += rej_true
                acct.audited += len(prompts_acc) + len(prompts_rej)
                events = self._check_cascade(acct)
            for ev in events:
                self._fire(ev)
        elif job[0] == "block_join":
            _, fp, prompts, block_v = job
            labels, _ = self._oracle.predicate(prompts)
            labels = np.asarray(labels, bool)
            agree = int((labels == np.asarray(block_v, bool)).sum())
            event = None
            with self._lock:
                acct = self._blocks.get(fp)
                if acct is None:
                    return
                acct.n += len(prompts)
                acct.agree += agree
                acct.audited += len(prompts)
                event = self._check_block(acct)
            if event is not None:
                self._fire(event)
        elif job[0] == "search":
            (_, key, recall_target, vectors, q, scores, ids, k, n_cut) = job
            n, hits = self._exact_rescan(vectors, q, scores, ids, k, n_cut)
            event = None
            with self._lock:
                acct = self._searches.get(key)
                if acct is None:
                    acct = self._searches[key] = _SearchAccount(
                        key=key, recall_target=recall_target)
                acct.recall_target = recall_target
                acct.n += n
                acct.hits += hits
                acct.queries_audited += len(q)
                event = self._check_search(acct)
            if event is not None:
                self._fire(event)

    def _exact_rescan(self, vectors, q, scores, ids, k: int,
                      n_cut: int) -> tuple[int, int]:
        """Exact recall@k of the returned ids vs a brute-force re-scan of
        the snapshot corpus.  A returned id counts as a hit when its exact
        score clears the exact kth-best score (score-threshold overlap:
        robust to ties); unfilled/invalid slots count as misses."""
        from repro_torch.index.backend import MASKED_SCORE, exact_topk
        k_eff = min(int(k), int(n_cut))
        if k_eff <= 0:
            return 0, 0
        exact_s, _ = exact_topk(vectors[:n_cut], q, k_eff)
        kth = exact_s[:, k_eff - 1]
        corpus = np.asarray(vectors[:n_cut], np.float32)
        unit = corpus / np.maximum(
            np.linalg.norm(corpus, axis=1, keepdims=True), 1e-9)
        qn = np.asarray(q, np.float32)
        qn = qn / np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-9)
        n = hits = 0
        for r in range(len(q)):
            valid = (np.asarray(scores[r]) > MASKED_SCORE / 2)
            row_ids = np.asarray(ids[r])[valid].astype(np.int64)
            row_ids = row_ids[(row_ids >= 0) & (row_ids < n_cut)][:k_eff]
            got = unit[row_ids] @ qn[r] if len(row_ids) else np.zeros(0)
            hits += int((got >= kth[r] - 1e-6).sum())
            n += k_eff
        return n, hits

    # -- violation machinery ----------------------------------------------
    def _check_cascade(self, acct: _CascadeAccount) -> list[ViolationEvent]:
        """Lock held.  Returns the violations to fire (accumulators reset)."""
        if acct.acc_n < self.policy.min_samples:
            return []
        est = acct.estimates(self.policy)
        events = []
        prec = est["precision"]
        if prec is not None and prec["lo"] < acct.precision_target:
            events.append(ViolationEvent(
                kind="precision", operator=acct.operator,
                fingerprint=acct.fingerprint, template=acct.template,
                match_token=acct.match_token, observed=prec["point"],
                lower=prec["lo"], target=acct.precision_target, n=prec["n"],
                details={"audited_accepts": acct.acc_n,
                         "gold_true": acct.acc_true,
                         "auto_accepted": acct.auto_accepted,
                         "judged_accepted": acct.judged_accepted}))
        rec = est["recall"]
        if rec is not None and acct.rej_n >= self.policy.min_samples \
                and rec["lo"] < acct.recall_target:
            events.append(ViolationEvent(
                kind="recall", operator=acct.operator,
                fingerprint=acct.fingerprint, template=acct.template,
                match_token=acct.match_token, observed=rec["point"],
                lower=rec["lo"], target=acct.recall_target, n=rec["n"],
                details={"audited_rejects": acct.rej_n,
                         "gold_true_rejects": acct.rej_true,
                         "auto_rejected": acct.auto_rejected}))
        if events:
            acct.violations += len(events)
            # fresh estimation window: post-recalibration evidence must not
            # be averaged with the drifted rule's (and the reset debounces —
            # the next check waits for min_samples new audits)
            acct.reset_window()
        return events

    def _check_block(self, acct: _BlockAccount) -> ViolationEvent | None:
        """Lock held.  Fires when the CI lower bound of block-vs-pairwise
        agreement drops below the operator's agreement target."""
        if acct.n < self.policy.min_samples:
            return None
        lo, _ = self.policy.interval(acct.agree, acct.n)
        if lo >= acct.agreement_target:
            return None
        ev = ViolationEvent(
            kind="block_agreement", operator=acct.operator,
            fingerprint=acct.fingerprint, template=acct.template,
            match_token=acct.match_token, observed=acct.agree / acct.n,
            lower=lo, target=acct.agreement_target, n=acct.n,
            details={"pairs_seen": acct.pairs_seen, "audited": acct.audited})
        acct.violations += 1
        acct.reset_window()
        return ev

    def _check_search(self, acct: _SearchAccount) -> ViolationEvent | None:
        if acct.n < self.policy.min_search_samples:
            return None
        lo, _ = self.policy.interval(acct.hits, acct.n)
        if lo >= acct.recall_target:
            return None
        ev = ViolationEvent(
            kind="recall_at_k", operator="Search", fingerprint=acct.key,
            template=None, match_token=None, observed=acct.hits / acct.n,
            lower=lo, target=acct.recall_target, n=acct.n,
            details={"queries_audited": acct.queries_audited})
        acct.violations += 1
        acct.n = acct.hits = 0
        return ev

    def _fire(self, event: ViolationEvent) -> None:
        with self._lock:
            self.violations.append(event)
            self.violation_counts[event.kind] = \
                self.violation_counts.get(event.kind, 0) + 1
        log.warning("guarantee violation: %s %s lower=%.3f target=%.3f "
                    "(n=%d, %s)", event.kind, event.operator, event.lower,
                    event.target, event.n, event.fingerprint)
        if self.stats_store is not None and event.template is not None:
            # stale selectivities must stop feeding adaptive replans and
            # feedback costing for this predicate
            try:
                self.stats_store.poison(event.fingerprint)
            except Exception:
                log.warning("stats-store poison failed", exc_info=True)
        if self.on_violation is not None:
            try:
                self.on_violation(event)
            except Exception:
                log.warning("on_violation callback failed", exc_info=True)

    # -- reports / metrics -------------------------------------------------
    def report(self, fingerprint: str | None = None) -> dict:
        with self._lock:
            cascades = [a.estimates(self.policy)
                        for a in self._cascades.values()
                        if fingerprint is None or a.fingerprint == fingerprint]
            searches = [a.estimates(self.policy)
                        for a in self._searches.values()]
            block_joins = [a.estimates(self.policy)
                           for a in self._blocks.values()
                           if fingerprint is None
                           or a.fingerprint == fingerprint]
            return {
                "cascades": cascades, "searches": searches,
                "block_joins": block_joins,
                "emissions": {t: dict(e) for t, e in self._emissions.items()},
                "violations": dict(self.violation_counts),
                "audit_calls": self.stats.audit_calls,
                "budget": {"granted": self.budgeter.granted_total,
                           "denied": self.budgeter.denied_total},
                "errors": self.errors, "pending": self._pending,
            }

    def report_for(self, fingerprint: str | None) -> dict | None:
        """The single cascade estimate for one predicate fingerprint (the
        ``explain_analyze`` lookup); None when never audited."""
        if fingerprint is None:
            return None
        with self._lock:
            acct = self._cascades.get(fingerprint)
            return acct.estimates(self.policy) if acct is not None else None

    def collect(self, registry) -> None:
        """Write the audit series into a ``MetricsRegistry``."""
        rep = self.report()
        calls = registry.counter("repro_audit_oracle_calls_total",
                                 "gold oracle calls made by the auditor")
        calls.set_total(rep["audit_calls"])
        granted = registry.counter("repro_audit_samples_total",
                                   "audit samples granted by the budgeter",
                                   ("outcome",))
        granted.set_total(rep["budget"]["granted"], outcome="granted")
        granted.set_total(rep["budget"]["denied"], outcome="denied")
        viol = registry.counter("repro_guarantee_violations_total",
                                "guarantee CI violations", ("kind",))
        for kind in ("precision", "recall", "recall_at_k", "block_agreement"):
            viol.set_total(rep["violations"].get(kind, 0), kind=kind)
        bound = registry.gauge("repro_audit_ci_lower_bound",
                               "CI lower bound of the audited guarantee",
                               ("kind", "operator", "fingerprint"))
        point = registry.gauge("repro_audit_observed",
                               "point estimate of the audited guarantee",
                               ("kind", "operator", "fingerprint"))
        nsamp = registry.gauge("repro_audit_samples",
                               "audited samples behind the current CI",
                               ("kind", "operator", "fingerprint"))
        for est in rep["cascades"]:
            for kind in ("precision", "recall"):
                ci = est[kind]
                if ci is None:
                    continue
                labels = {"kind": kind, "operator": est["operator"],
                          "fingerprint": est["fingerprint"]}
                bound.set(ci["lo"], **labels)
                point.set(ci["point"], **labels)
                nsamp.set(ci["n"], **labels)
        for est in rep["searches"]:
            ci = est["recall_at_k"]
            if ci is None:
                continue
            labels = {"kind": "recall_at_k", "operator": "Search",
                      "fingerprint": est["key"]}
            bound.set(ci["lo"], **labels)
            point.set(ci["point"], **labels)
            nsamp.set(ci["n"], **labels)
        for est in rep["block_joins"]:
            ci = est["agreement"]
            if ci is None:
                continue
            labels = {"kind": "block_agreement", "operator": est["operator"],
                      "fingerprint": est["fingerprint"]}
            bound.set(ci["lo"], **labels)
            point.set(ci["point"], **labels)
            nsamp.set(ci["n"], **labels)
        if rep["emissions"]:
            em = registry.counter("repro_audit_emissions_total",
                                  "continuous-query emissions observed",
                                  ("tenant",))
            for tenant, e in rep["emissions"].items():
                em.set_total(e["emissions"], tenant=tenant)

    # -- persistence -------------------------------------------------------
    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("GuaranteeAuditor.save() needs a path")
        with self._lock:
            doc = {"version": 1,
                   "cascades": [dataclasses.asdict(a)
                                for a in self._cascades.values()],
                   "searches": [dataclasses.asdict(a)
                                for a in self._searches.values()],
                   "block_joins": [dataclasses.asdict(a)
                                   for a in self._blocks.values()],
                   "violation_counts": dict(self.violation_counts)}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path

    def load(self, path: str, *, strict: bool = False) -> int:
        """Merge persisted audit state; a missing/truncated/corrupt file is
        log-and-continue (fresh state) unless ``strict=True`` — auditing
        must never block gateway startup."""
        if not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                doc = json.load(f)
            n = 0
            with self._lock:
                for e in doc.get("cascades", ()):
                    acct = _CascadeAccount(**{
                        k: e[k] for k in (
                            "operator", "fingerprint", "template",
                            "match_token", "recall_target",
                            "precision_target", "acc_n", "acc_true", "rej_n",
                            "rej_true", "judged_accepted", "auto_accepted",
                            "auto_rejected", "audited", "violations")})
                    self._cascades[acct.fingerprint] = acct
                    n += 1
                for e in doc.get("block_joins", ()):
                    acct = _BlockAccount(**{
                        k: e[k] for k in (
                            "operator", "fingerprint", "template",
                            "match_token", "agreement_target", "n", "agree",
                            "pairs_seen", "audited", "violations")})
                    self._blocks[acct.fingerprint] = acct
                    n += 1
                for e in doc.get("searches", ()):
                    acct = _SearchAccount(**{
                        k: e[k] for k in ("key", "recall_target", "n", "hits",
                                          "queries_audited", "violations")})
                    self._searches[acct.key] = acct
                    n += 1
                for k, v in (doc.get("violation_counts") or {}).items():
                    self.violation_counts[k] = \
                        self.violation_counts.get(k, 0) + int(v)
            return n
        except (OSError, json.JSONDecodeError, UnicodeDecodeError,
                ValueError, KeyError, TypeError, AttributeError) as exc:
            if strict:
                raise
            log.warning("audit state load failed (%s: %s) — starting fresh",
                        path, exc)
            return 0

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float | None = 30.0) -> bool:
        """Block until every enqueued audit job has been judged."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done_cv:
            while self._pending > 0:
                left = None if deadline is None else \
                    max(deadline - time.monotonic(), 0.0)
                if left == 0.0:
                    return False
                self._done_cv.wait(timeout=left)
        return True

    def close(self, *, drain: bool = True,
              timeout: float | None = 30.0) -> None:
        if drain:
            self.drain(timeout)
        with self._queue_cv:
            self._closed = True
            self._queue_cv.notify_all()
        self._thread.join(timeout=10.0)
        if self.path:
            try:
                self.save(self.path)
            except OSError:
                log.warning("audit state save failed", exc_info=True)

    def __enter__(self) -> "GuaranteeAuditor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
