"""FDR procedures for DMP calling.

Counterpart of hygeia_tpu/pipeline/multiple_testing.py, copied: a step-up
rule on posterior-null statistics, and a weighted variant that ranks sites
by a normalised excessive-error-rate score. The statistics are posterior
probabilities of the null (equal regimes), so selecting the s smallest
with mean <= threshold controls the Bayesian FDR.
"""

from __future__ import annotations

import numpy as np


def fdr_procedure(test_statistics, fdr_threshold):
    """Step-up selection: largest s with mean of the s smallest posterior-null
    stats <= threshold. Returns (s, Q_s, cutoff) where `cutoff` is the value
    of the (s+1)-th order statistic — sites strictly below it are selected.
    Matches the reference's multiple_testing.py:3-12 including its edge-case
    returns."""
    stats = np.asarray(test_statistics)
    order = np.sort(stats)
    running_mean = np.cumsum(order) / np.arange(1, len(order) + 1)
    s = int(np.sum(running_mean <= fdr_threshold))
    if fdr_threshold < order[0]:
        return 0, 0.0, 0.0
    if s == len(order):
        return s, running_mean[s - 1], 1.01
    return s, running_mean[s - 1], order[s]


def weighted_fdr_procedure(
    test_statistics, fdr_threshold, weights_false_positives, weights_false_negatives
):
    """Weighted variant (the reference's multiple_testing.py:14-22): rank
    sites by w_fp (t - a) / (w_fn (1 - t) + w_fp |t - a|), accept the prefix
    whose cumulative weighted excessive error rate stays <= 0. Returns the
    selected indices (in ranking order) and the final cumulative sum."""
    t = np.asarray(test_statistics)
    w_fp = np.asarray(weights_false_positives)
    w_fn = np.asarray(weights_false_negatives)
    ranking = w_fp * (t - fdr_threshold) / (
        w_fn * (1.0 - t) + w_fp * np.abs(t - fdr_threshold)
    )
    order = np.argsort(ranking)
    excess = (w_fp * (t - fdr_threshold))[order]
    cumulative = np.cumsum(excess)
    s = int(np.sum(cumulative <= 0))
    return order[:s], cumulative[s - 1] if s > 0 else 0.0
