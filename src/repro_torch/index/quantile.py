"""Quantile calibration of proxy scores (§3.1/§3.2: 're-scaling by the
quantiles over all generated log-probabilities / similarity scores')."""
from __future__ import annotations

import numpy as np


def quantile_calibrate(scores) -> np.ndarray:
    """Map raw scores to their empirical quantile rank in (0, 1].

    Rank-based calibration makes thresholds comparable across proxies with
    arbitrary score scales (log-probs vs cosine similarities)."""
    s = np.asarray(scores, float).ravel()
    order = np.argsort(np.argsort(s, kind="stable"), kind="stable")
    return ((order + 1.0) / len(s)).reshape(np.shape(scores))
