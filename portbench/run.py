"""The benchmark of `stemgnn_tpu_torch`: one run of one cell.

    python3 portbench/run.py --workload ecg.train --seed 7 --seconds 30 --trace 0

Run from the root of a checkout of the repository, on a machine with the
cards the cell asks for (`BENCHMARK.json`). Prints, last on standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` `breakdown`, and last `checks` (each number the check
compared, with its limit), which are also the last lines on standard error.
Exits non-zero, with no result, without a card, or where the process has
imported JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    print(f"portbench: set-up: torch imported at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)

    cell = harness.cell_of(args.workload, args.seed, "cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
