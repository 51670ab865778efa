"""The benchmark of hygeia_tpu_torch: run one cell once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, then ``card`` (name and power limit) and last ``checks``:
each number the correctness comparison read, beside its limit. The same
checks are the last lines of standard error.

Exits non-zero and prints no result where there is no CUDA card, or fewer
than the cell asks for, or where a module of JAX or of the JAX package
(``hygeia_tpu``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / "_cache"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # The program's caches at fixed paths inside the checkout.
    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    sys.path[0] = str(ROOT)

    from perfbench import harness, peaks

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, _, _ = harness.cell_spec(bench, args.workload)

    import torch

    print(f"set-up: imports {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, checks = harness.run_cell(bench=bench, cell_name=args.workload, seed=args.seed,
                                      seconds=args.seconds, trace=bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print("perfbench: modules of JAX or of the JAX package were loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(result, checks, peaks.card()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
