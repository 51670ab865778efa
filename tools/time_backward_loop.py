#!/usr/bin/env python3
"""Times the two-group backward loop of hygeia_tpu_torch on one GPU, alone
and right after a filter call, to tell the backward pass's own time from
what the work before it does to it.

    python3 tools/time_backward_loop.py                 # this tree
    python3 tools/time_backward_loop.py --tree DIR      # the package under DIR

One seeded call at the benchmark cell's shape (U = 2 units, T = 11,001
sites, M = 50 so N = 2,400, B = 25, R = 6, f32; synthetic counts of depth
~20): one filter result is kept, then each of ``--calls`` rounds times,
with the card synchronised around each:

- ``alone``: ``backward_simulation`` on the kept filter result;
- ``filter``: a new ``run_filter`` call;
- ``after_filter``: ``backward_simulation`` on that call's result, right
  after it.

Each is milliseconds a site (wall over T, captures included). Compare two
trees in turns in separate processes (old, new, new, old): host speed
differs between processes. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE, help="the directory holding hygeia_tpu_torch (default: this repository)")
    ap.add_argument("--calls", type=int, default=6, help="rounds of the three timings (default 6)")
    ap.add_argument("--sites", type=int, default=11_001, help="T, sites a call (default 11001)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.two_group.backward import backward_simulation
    from hygeia_tpu_torch.two_group.filter import run_filter
    from hygeia_tpu_torch.two_group.model import make_params

    if not torch.cuda.is_available():
        print("time_backward_loop: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    R, M, B, T, U = 6, 50, 25, args.sites, 2
    params = make_params(
        mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751],
        p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=T + 1, device=dev,
    )
    rng = np.random.default_rng(0)
    n = rng.poisson(20, size=(U, T, 2))
    table = lambda p: torch.stack([
        emission_log_prob_table(rng.binomial(n[u], p), n[u], params.alpha, params.beta) for u in range(U)
    ])
    E_c, E_k = table(0.7), table(0.3)
    gens = lambda s: [torch.Generator(device=dev).manual_seed(s + u) for u in range(U)]
    filt = lambda s: run_filter(params, E_c, E_k, M, n_units=U, generator=gens(s))
    back = lambda res, s: backward_simulation(params, res.log_weights, res.particles, B, generator=gens(s))

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, 1e3 * (time.perf_counter() - t0) / T

    res = filt(1)
    back(res, 2)  # warm: library loads, first captures
    got = {"alone": [], "filter": [], "after_filter": []}
    for i in range(args.calls):
        got["alone"].append(timed(lambda: back(res, 100 + i))[1])
        fresh, ms = timed(lambda: filt(200 + i))
        got["filter"].append(ms)
        got["after_filter"].append(timed(lambda: back(fresh, 300 + i))[1])
        del fresh
    print(json.dumps({"tree": os.path.abspath(args.tree), "card": torch.cuda.get_device_name(dev),
                      **{k: {"median_ms_per_site": statistics.median(v), "ms_per_site": v} for k, v in got.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
