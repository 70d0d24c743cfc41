"""Algorithm 1 (SEM-FILTER) of the paper: proxy-oracle cascades with
statistical accuracy guarantees, plus the shared machinery reused by
sem_join (per-plan thresholds + cost-based plan choice) and sem_group_by.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.optimizer import stats
from repro_torch.index.quantile import quantile_calibrate


@dataclasses.dataclass
class CascadeResult:
    passed: np.ndarray          # bool [N] — the optimized operator's output set
    tau_plus: float
    tau_minus: float
    oracle_calls: int           # unique oracle invocations (sample + mid region)
    sample_size: int
    auto_accepted: int
    auto_rejected: int
    oracle_region: int
    judged: np.ndarray | None = None  # bool [N] — rows decided by an oracle
                                      # label (mid region); auto-decisions
                                      # are ~judged (the audit population)


def run_cascade(proxy_scores: np.ndarray,
                oracle_fn: Callable[[np.ndarray], np.ndarray], *,
                recall_target: float, precision_target: float, delta: float,
                sample_size: int = 100, seed: int = 0,
                calibrate: bool = True) -> CascadeResult:
    """Algorithm 1. ``oracle_fn(indices) -> bool labels`` is the gold model
    M(t, l); ``proxy_scores`` are A(t) (calibrated to quantiles here unless
    already calibrated).

    The returned set satisfies recall >= recall_target AND precision >=
    precision_target w.r.t. the gold-algorithm output, each w.p. >= 1-delta/2
    (union bound: both w.p. >= 1-delta).
    """
    n = len(proxy_scores)
    a = quantile_calibrate(proxy_scores) if calibrate else np.asarray(proxy_scores, float)
    rng = np.random.default_rng(seed)
    s = min(sample_size, n)

    # -- sample + oracle labels -----------------------------------------
    probs = stats.defensive_importance_probs(a)
    idx = stats.importance_sample(rng, probs, s)
    uniq = np.unique(idx)
    labels_uniq = np.asarray(oracle_fn(uniq), bool)
    label_of = dict(zip(uniq.tolist(), labels_uniq.tolist()))
    sample = stats.Sample(idx=idx, probs=probs,
                          labels=np.asarray([label_of[i] for i in idx], bool),
                          scores=a[idx])

    # -- learn decision rule ---------------------------------------------
    tau_plus = stats.pt_threshold(sample, precision_target, delta / 2)
    tau_minus = stats.rt_threshold(sample, recall_target, delta / 2)
    tau_plus = max(tau_plus, tau_minus)

    # -- evaluate every tuple ---------------------------------------------
    passed = np.zeros(n, bool)
    auto = a >= tau_plus
    passed[auto] = True
    mid = (~auto) & (a >= tau_minus)
    # sampled tuples already have oracle labels — reuse, don't re-call
    known = np.zeros(n, bool)
    known[uniq] = True
    for i in uniq:
        if mid[i]:
            passed[i] = label_of[i]
    need = np.flatnonzero(mid & ~known)
    if len(need):
        passed[need] = np.asarray(oracle_fn(need), bool)

    return CascadeResult(
        passed=passed, tau_plus=float(tau_plus), tau_minus=float(tau_minus),
        oracle_calls=len(uniq) + len(need), sample_size=s,
        auto_accepted=int(auto.sum()), auto_rejected=int((a < tau_minus).sum()),
        oracle_region=int(mid.sum()), judged=mid.copy(),
    )


@dataclasses.dataclass
class PlanEstimate:
    name: str
    tau_plus: float
    tau_minus: float
    est_oracle_calls: int      # mid-region size (to evaluate) + sample already spent
    extra_lm_calls: int        # e.g. projection map calls for project-sim-filter
    scores: np.ndarray
    sample: stats.Sample
    label_of: dict

    @property
    def total_cost(self) -> int:
        return self.est_oracle_calls + self.extra_lm_calls


def estimate_plan(name: str, scores: np.ndarray, sample: stats.Sample,
                  label_of: dict, *, recall_target: float, precision_target: float,
                  delta: float, extra_lm_calls: int = 0) -> PlanEstimate:
    """Learn thresholds for one candidate plan and cost it (§3.2: the join
    optimizer learns (tau+, tau-) for each proxy and takes the cheaper plan)."""
    tau_plus = stats.pt_threshold(sample, precision_target, delta / 2)
    tau_minus = stats.rt_threshold(sample, recall_target, delta / 2)
    tau_plus = max(tau_plus, tau_minus)
    mid = (scores < tau_plus) & (scores >= tau_minus)
    return PlanEstimate(name=name, tau_plus=float(tau_plus), tau_minus=float(tau_minus),
                        est_oracle_calls=int(mid.sum()), extra_lm_calls=extra_lm_calls,
                        scores=scores, sample=sample, label_of=label_of)


@dataclasses.dataclass
class BlockCalibration:
    """Outcome of block-judging a calibration sample with a pairwise-gold
    agreement check (the guarantee machinery's bridge to block verdicts:
    thresholds are only calibrated on block labels that demonstrably track
    the pairwise oracle on this predicate)."""

    labels: np.ndarray         # bool [S] — final labels (block or pairwise)
    agreement: float           # block-vs-pairwise agreement on checked pairs
    checked: int               # pairs re-judged pairwise for the check
    blocks_rejudged: int       # calibration blocks whose agreement fell
                               # below the floor (all labels replaced)
    block_prompts: int
    block_fallbacks: int


def block_labeled_sample(pairs, block_judge, pairwise_fn, *, rng,
                         check_fraction: float = 0.25,
                         agreement_floor: float = 0.9) -> BlockCalibration:
    """Label a calibration sample of candidate ``pairs`` with block prompts,
    verifying each calibration block against pairwise gold.

    Every block contributes ``ceil(check_fraction * |block|)`` uniformly
    sampled pairs that are re-judged pairwise; a block whose checked labels
    agree below ``agreement_floor`` has *all* its labels replaced by
    pairwise judgments (the block oracle is not trusted for thresholds on
    that region).  ``pairwise_fn(pairs) -> bool array`` is the gold pairwise
    judge (it may serve cached labels)."""
    pairs = [(int(i), int(j)) for i, j in pairs]
    labels = np.asarray(block_judge.judge_pairs(pairs), bool).copy()
    bs = block_judge.block_size
    agree = checked = rejudged = 0
    for s in range(0, len(pairs), bs):
        blk = pairs[s:s + bs]
        n_check = min(len(blk), max(1, int(np.ceil(check_fraction * len(blk)))))
        pick = rng.choice(len(blk), size=n_check, replace=False)
        gold = np.asarray(pairwise_fn([blk[int(p)] for p in pick]), bool)
        ok = int((labels[s + pick] == gold).sum())
        agree += ok
        checked += n_check
        if ok / n_check < agreement_floor:
            # the block oracle disagrees with pairwise gold here: replace
            # the whole calibration block with pairwise labels
            labels[s:s + len(blk)] = np.asarray(pairwise_fn(blk), bool)
            rejudged += 1
    return BlockCalibration(
        labels=labels, agreement=(agree / checked if checked else 1.0),
        checked=checked, blocks_rejudged=rejudged,
        block_prompts=block_judge.stats.block_prompts,
        block_fallbacks=block_judge.stats.block_fallbacks)


def execute_plan(plan: PlanEstimate, oracle_fn: Callable[[np.ndarray], np.ndarray]) -> CascadeResult:
    """Run the cascade decision rule of an already-estimated plan."""
    a = plan.scores
    n = len(a)
    passed = np.zeros(n, bool)
    auto = a >= plan.tau_plus
    passed[auto] = True
    mid = (~auto) & (a >= plan.tau_minus)
    known = np.asarray(sorted(plan.label_of), int)
    for i in known:
        if mid[i]:
            passed[i] = plan.label_of[int(i)]
    known_mask = np.zeros(n, bool)
    if len(known):
        known_mask[known] = True
    need = np.flatnonzero(mid & ~known_mask)
    if len(need):
        passed[need] = np.asarray(oracle_fn(need), bool)
    return CascadeResult(passed=passed, tau_plus=plan.tau_plus, tau_minus=plan.tau_minus,
                         oracle_calls=len(known) + len(need), sample_size=len(plan.sample.idx),
                         auto_accepted=int(auto.sum()),
                         auto_rejected=int((a < plan.tau_minus).sum()),
                         oracle_region=int(mid.sum()), judged=mid)
