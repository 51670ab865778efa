"""Faults planted in the θ stage's program for the tests: each breaks one
step of the timed path where it is produced, and the check has to read it."""

from __future__ import annotations

import torch


def k1_keeps_first_m(monkeypatch):
    """K1 keeps the first M live particles, in slot order, as ancestors,
    and writes the weights it would have written."""
    from hygeia_tpu_torch.single_group import engine

    orig = engine.optimal_resampling

    def resample(lw, M, u_sys, u_mult):
        res = orig(lw, M, u_sys, u_mult)
        N = lw.shape[-1]
        key = torch.where(torch.isfinite(lw), (N - torch.arange(N, device=lw.device)).to(lw.dtype), -1.0)
        return res._replace(parent_indices=torch.topk(key, M, -1).indices.to(torch.int32))

    monkeypatch.setattr(engine, "optimal_resampling", resample)


def update_skips_the_tables(monkeypatch):
    """A parameter update moves θ but leaves the tables of the first θ."""
    from hygeia_tpu_torch.single_group import engine

    orig = engine._Engine._set_tables

    def set_tables(self, tables):
        if self.haz is None:
            orig(self, tables)

    monkeypatch.setattr(engine._Engine, "_set_tables", set_tables)


def adam_steps_from_a_stale_gradient(monkeypatch):
    """Each ADAM step takes the gradient of the update before it (zero at
    the first), and keeps the new one for the next."""
    from hygeia_tpu_torch.single_group import engine

    orig = engine._Engine._estimate

    def estimate(self, t, *a):
        cfg, st = self.config, self.state
        if t % cfg.steps_per_update != 0:
            return orig(self, t, *a)
        orig(self, t + 1, *a)  # φ and the score, no update
        if not hasattr(self, "_stale"):
            self._stale = torch.zeros_like(st["score"])
        gradient = self._stale.clone()
        self._stale.copy_(st["score"] - st["grad_prev"])
        it1 = (st["adam_iter"].to(self.dtype) + 1.0)[:, None]
        lr = cfg.learning_rate_factor / it1**cfg.learning_rate_exponent
        m2 = 0.9 * st["adam_m"] + 0.1 * gradient
        v2 = 0.999 * st["adam_v"] + 0.001 * gradient * gradient
        delta = lr * m2 / (torch.sqrt(v2 / (1.0 - 0.999**it1)) + 1e-8) / (1.0 - 0.9**it1)
        st["adam_m"].copy_(m2)
        st["adam_v"].copy_(v2)
        st["theta"].copy_(st["theta"] + delta)
        st["adam_iter"].copy_(st["adam_iter"] + 1)
        st["grad_prev"].copy_(st["score"])
        return True

    monkeypatch.setattr(engine._Engine, "_estimate", estimate)


# Each fault, and the number of the check that has to read it.
FAULTS = {"k1_keeps_first_m": (k1_keeps_first_m, "k1_heavy_dropped"),
          "update_skips_the_tables": (update_skips_the_tables, "hazard_gap"),
          "adam_steps_from_a_stale_gradient": (adam_steps_from_a_stale_gradient, "theta_gap")}
