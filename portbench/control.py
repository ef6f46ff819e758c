"""The readings the limits of a cell's check are set from, at the cell's own
size, in one process:

    python3 portbench/control.py --workload ecg.train --seeds 1,2,3 \
        --control-seeds 4,5,6 --faults half,altered --fault-seeds 7,8,9

- the program (`--seeds`): a run's set-up and, for forecasting, a short
  window (`--seconds`), then the check's numbers against the reference;
- the control (`--control-seeds`): the reference computed with TF32 products
  (cuBLAS and cuDNN), the nearest precision below the configurations' f32,
  put in the program's place; no program runs;
- faults (`--faults`, on `--fault-seeds`), planted in the reference put in
  the program's place: "unchanged" (a step that updates nothing), "half"
  (half of each batch left out, the mean over the rest), "altered" (a
  produced loss or forecast moved by 1%), for training also
  "gru_backward" and "attention_backward" (a kernel family's backward
  returning zeros: the leaves it feeds get no gradient).

Prints one JSON line a reading, and writes them to `--out` too.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--detail", action="store_true",
                    help="also print where each program reading comes from")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.reference.stemgnn import precision

    out = open(args.out, "a") if args.out else None

    def report(**row):
        line = json.dumps({"workload": args.workload, **row})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    def done():
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    for seed in _seeds(args.seeds):
        cell = harness.cell_of(args.workload, seed, args.device)
        t = time.perf_counter()
        st = cell.driver.setup(cell)
        if cell.traffic["kind"] != "train":
            cell.driver.window(st, args.seconds)
        kept = cell.driver.free(st)
        del st
        done()
        with precision(tf32=False):
            truth = cell.driver.reference(cell, kept)
        report(side="program", seed=seed, seconds=time.perf_counter() - t,
               **cell.driver.compare(kept.given, kept.judged, truth))
        if args.detail and hasattr(cell.driver, "details"):
            report(side="program-detail", seed=seed,
                   **cell.driver.details(kept.given, kept.judged, truth))
        del kept, truth
        done()

    runs = [("control", None, s) for s in _seeds(args.control_seeds)]
    runs += [(f, f, s) for f in args.faults.split(",") if f for s in _seeds(args.fault_seeds)]
    for side, fault, seed in runs:
        cell = harness.cell_of(args.workload, seed, args.device)
        t = time.perf_counter()
        given = cell.driver.given_inputs(cell)
        kept = SimpleNamespace(given=given, judged=[(i, None) for i in
                                                    range(len(getattr(given, "raws", [])))])
        with precision(tf32=False):
            truth = cell.driver.reference(cell, kept)
        with precision(tf32=fault is None):
            placed = cell.driver.reference(cell, kept, fault=fault)
        if isinstance(placed, dict):  # forecasts by series
            placed = sorted(placed.items())
        report(side=side, seed=seed, seconds=time.perf_counter() - t,
               **cell.driver.compare(given, placed, truth))
        if args.detail and hasattr(cell.driver, "details"):
            report(side=side + "-detail", seed=seed,
                   **cell.driver.details(given, placed, truth))
        del given, kept, truth, placed
        done()
    print(f"control: {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
