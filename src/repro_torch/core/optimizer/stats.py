"""Statistical machinery for correct optimizations (§2.2, §3.1).

Follows SUPG (Kang et al., VLDB 2020 [37,38]) adapted to the paper's setting:
cascade thresholds on calibrated proxy scores with *both* a recall target
(RT, tau_minus) and a precision target (PT, tau_plus), each at failure budget
delta/2 (multiple-failure-mode correction of Algorithm 1), plus a Bonferroni
correction over the candidate-threshold grid (multiple hypothesis testing).

Estimators are self-normalized (Hajek) importance-weighted ratio estimators
with delta-method CLT standard errors:

    R(tau) = E[w o 1(A >= tau)] / E[w o]          (recall)
    P(tau) = E[w o 1(A >= tau)] / E[w 1(A >= tau)] (precision)

with w_j = 1 / (N p_j) for a with-replacement sample drawn from p.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import stats as sps

DEFAULT_GRID = 64
# Correction for data-dependent threshold selection: recall(tau)/precision(tau)
# are monotone families over a fine grid, so adjacent tests are ~perfectly
# correlated; a full Bonferroni over 64 grid points is far too conservative.
# We charge a fixed effective-test count (validated empirically over repeated
# trials in tests/test_guarantees.py and benchmarks/fig9, mirroring the
# paper's own empirical Fig 9d validation).
EFFECTIVE_TESTS = 8
# Finite-sample (Wilson count) guard on ratio LCBs.  True = our default,
# strictly more conservative than the paper's CLT-only bounds (which can
# certify recall=1 from 2 heavy-weight positive observations when the
# empirical ratio variance collapses).  benchmarks/table3 flips it to
# reproduce the paper's operating point at extreme skew.
FINITE_SAMPLE_GUARD = True


def defensive_importance_probs(scores: np.ndarray, *, mix: float = 0.1,
                               power: float = 0.5) -> np.ndarray:
    """Draw probabilities p_i ∝ (1-mix)·A_i^power/Σ + mix·uniform.

    power=0.5 is SUPG's sqrt weighting (filters).  Joins use a sharper
    power: with quantile-calibrated scores the positive base rate over the
    N1*N2 pair space can be <<1%, and sqrt weighting would put only ~2
    positives in a 300-draw sample — the estimators stay *safe* (degenerate
    thresholds fall back to oracle-everything) but the plans get expensive;
    top-heavy sampling keeps them informative.  The Hajek weights absorb any
    proposal, so unbiasedness is unaffected."""
    s = np.power(np.clip(scores, 1e-9, None), power)
    p = (1.0 - mix) * s / s.sum() + mix / len(scores)
    return p / p.sum()


def importance_sample(rng: np.random.Generator, probs: np.ndarray, n: int) -> np.ndarray:
    """With-replacement sample of indices."""
    return rng.choice(len(probs), size=n, replace=True, p=probs)


@dataclasses.dataclass
class Sample:
    idx: np.ndarray        # sampled indices (with replacement) [s]
    probs: np.ndarray      # full-population draw probabilities [N]
    labels: np.ndarray     # oracle labels on sampled indices [s] (bool)
    scores: np.ndarray     # proxy scores on sampled indices [s]

    @property
    def weights(self) -> np.ndarray:
        n = len(self.probs)
        return 1.0 / (n * self.probs[self.idx])


def _wilson_lcb(p_hat: float, n_eff: float, alpha: float) -> float:
    """Wilson score lower bound — finite-sample guard for tiny effective n."""
    if n_eff <= 0:
        return 0.0
    z = sps.norm.ppf(1.0 - alpha)
    z2 = z * z
    centre = p_hat + z2 / (2 * n_eff)
    margin = z * math.sqrt(max(p_hat * (1 - p_hat) / n_eff + z2 / (4 * n_eff * n_eff), 0.0))
    return float((centre - margin) / (1 + z2 / n_eff))


def _ratio_lcb(num: np.ndarray, den: np.ndarray, alpha: float) -> float:
    """Lower confidence bound for E[num]/E[den] at level alpha.

    Delta-method CLT bound combined (min) with a Wilson bound at the Kish
    effective sample size of the denominator: when only a handful of heavy-
    weight positives are observed and ALL sit above the candidate threshold,
    the empirical ratio variance collapses to zero and the pure delta method
    would certify recall=1 from 2 observations — the Wilson term keeps the
    bound honest in that rare-positive regime (extreme-skew joins)."""
    s = len(num)
    mu_n, mu_d = num.mean(), den.mean()
    if mu_d <= 0:
        return 0.0
    r = mu_n / mu_d
    var_n = num.var(ddof=1) if s > 1 else 0.0
    var_d = den.var(ddof=1) if s > 1 else 0.0
    cov = np.cov(num, den, ddof=1)[0, 1] if s > 1 else 0.0
    var_r = max((var_n - 2 * r * cov + r * r * var_d) / (mu_d * mu_d), 0.0) / s
    z = sps.norm.ppf(1.0 - alpha)
    delta_lcb = r - z * math.sqrt(var_r)
    if not FINITE_SAMPLE_GUARD:
        return float(delta_lcb)
    n_obs = float(np.count_nonzero(den))  # observed relevant draws
    return float(min(delta_lcb, _wilson_lcb(min(r, 1.0), n_obs, alpha)))


def _candidate_grid(scores: np.ndarray, grid: int) -> np.ndarray:
    qs = np.unique(np.quantile(scores, np.linspace(0.0, 1.0, grid)))
    return qs


def rt_threshold(sample: Sample, gamma_r: float, delta: float,
                 *, grid: int = DEFAULT_GRID) -> float:
    """tau_minus: largest tau with LCB(recall(tau)) >= gamma_r w.p. 1-delta.

    Tuples with A < tau_minus are dropped by the cascade; everything else is
    either auto-accepted or oracle-labeled, so recall loss comes only from
    the dropped region. Fallback: -inf (drop nothing)."""
    w, o, a = sample.weights, sample.labels.astype(float), sample.scores
    cands = _candidate_grid(a, grid)
    alpha = delta / EFFECTIVE_TESTS
    best = -np.inf
    den = w * o
    if den.sum() <= 0:
        return -np.inf  # no positives observed: keep everything
    for tau in cands:
        num = w * o * (a >= tau)
        if _ratio_lcb(num, den, alpha) >= gamma_r:
            best = max(best, float(tau))
    return best


def pt_threshold(sample: Sample, gamma_p: float, delta: float,
                 *, grid: int = DEFAULT_GRID) -> float:
    """tau_plus: smallest tau with LCB(precision(tau)) >= gamma_p w.p. 1-delta.

    Tuples with A >= tau_plus are accepted without oracle confirmation; the
    oracle-confirmed region has precision 1 wrt the gold algorithm, so the
    output precision is bounded below by precision(tau_plus).
    Fallback: +inf (auto-accept nothing)."""
    w, o, a = sample.weights, sample.labels.astype(float), sample.scores
    cands = _candidate_grid(a, grid)
    alpha = delta / EFFECTIVE_TESTS
    best = np.inf
    for tau in cands:
        sel = (a >= tau).astype(float)
        if sel.sum() == 0:
            continue
        num = w * o * sel
        den = w * sel
        if _ratio_lcb(num, den, alpha) >= gamma_p:
            best = min(best, float(tau))
    return best


def shared_sample_indices(n: int, sample_size: int, seed: int,
                          scores: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """One importance sample shared by every selectivity estimate in a plan.

    With proxy ``scores`` the draw is the defensive SUPG proposal; without, it
    is uniform.  Returns (idx [s] with replacement, probs [n]) so estimates
    stay Hajek-unbiased under either proposal.  Sharing one sample across all
    filters in a chain (rather than one per filter) is what lets the plan
    optimizer rank k predicates with a single oracle-labeled subset.
    """
    rng = np.random.default_rng(seed)
    if scores is not None:
        probs = defensive_importance_probs(np.asarray(scores, float))
    else:
        probs = np.full(n, 1.0 / n)
    s = min(sample_size, n)
    return importance_sample(rng, probs, s), probs


def estimate_selectivity(idx: np.ndarray, probs: np.ndarray,
                         labels: np.ndarray) -> float:
    """Hajek (self-normalized) selectivity estimate E[o] from a weighted
    sample: sum(w*o)/sum(w), clipped to (0, 1) open so downstream cost
    ranking never divides by zero."""
    w = 1.0 / (len(probs) * probs[idx])
    o = np.asarray(labels, float)
    est = float(np.sum(w * o) / max(np.sum(w), 1e-12))
    return float(np.clip(est, 1e-3, 1.0 - 1e-3))


def accuracy_threshold(scores: np.ndarray, correct: np.ndarray, gamma: float,
                       delta: float, *, grid: int = DEFAULT_GRID) -> float:
    """PT-style threshold on *classification accuracy* (sem_group_by §3.3):
    smallest tau such that accuracy among {A >= tau} >= gamma w.p. 1-delta,
    from a uniform sample. Fallback +inf (everything to the oracle)."""
    cands = _candidate_grid(scores, grid)
    alpha = delta / EFFECTIVE_TESTS
    best = np.inf
    c = correct.astype(float)
    for tau in cands:
        sel = scores >= tau
        n = int(sel.sum())
        if n == 0:
            continue
        acc = c[sel].mean()
        se = math.sqrt(max(acc * (1 - acc), 1e-12) / n)
        if acc - sps.norm.ppf(1 - alpha) * se >= gamma:
            best = min(best, float(tau))
    return best
