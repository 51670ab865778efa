"""Faults planted in the program for the tests: each breaks one step of
the timed path where it is produced, and the check has to read it."""

from __future__ import annotations

import torch


def k1_keeps_first_m(monkeypatch):
    """K1 keeps the first M live particles, in index order, as ancestors,
    and writes the right weights for them."""
    from hygeia_tpu_torch.two_group import filter as flt

    orig = flt.optimal_resampling

    def resample(lw, M, u_sys, u_mult):
        res = orig(lw, M, u_sys, u_mult)
        N = lw.shape[-1]
        key = torch.where(torch.isfinite(lw), (N - torch.arange(N, device=lw.device)).to(lw.dtype), -1.0)
        return res._replace(parent_indices=torch.topk(key, M, -1).indices.to(torch.int32))

    monkeypatch.setattr(flt, "optimal_resampling", resample)


def k1_keeps_lightest_m(monkeypatch):
    """K1 keeps the M lightest live particles as ancestors."""
    from hygeia_tpu_torch.two_group import filter as flt

    orig = flt.optimal_resampling

    def resample(lw, M, u_sys, u_mult):
        res = orig(lw, M, u_sys, u_mult)
        key = torch.where(torch.isfinite(lw), -lw, float("-inf"))
        return res._replace(parent_indices=torch.topk(key, M, -1).indices.to(torch.int32))

    monkeypatch.setattr(flt, "optimal_resampling", resample)


def backward_uniform_over_feasible(monkeypatch):
    """The backward pass draws uniformly among the particles that can
    precede the next state, ignoring their weights and the transition's
    probability."""
    from hygeia_tpu_torch.two_group import backward as bw

    def draw(logits, noise):
        return torch.argmax(noise + torch.where(torch.isfinite(logits), 0.0, float("-inf")), dim=-1)

    monkeypatch.setattr(bw, "_categorical_rows", draw)


# Each fault, and the number of the check that has to read it.
FAULTS = {"k1_keeps_first_m": (k1_keeps_first_m, "k1_heavy_dropped"),
          "k1_keeps_lightest_m": (k1_keeps_lightest_m, "k1_systematic_mismatch"),
          "backward_uniform_over_feasible": (backward_uniform_over_feasible, "backward_pit_ks")}
