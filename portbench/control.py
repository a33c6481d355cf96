"""Readings for the limits of ``correct`` (not run by the benchmark's runs).

    python3 portbench/control.py --workload <cell> --mode control --seeds 1 2 3 --seconds 5

runs, in one process and one seed after another, a short window of the
cell with either the program (``--mode program``: the lower readings) or
its control (``--mode control``: the upper readings) and prints each
seed's compared numbers as one JSON line.  The control is the program's
own bfloat16 lane-buffer path (``kernel_dtype``) for a ``session`` entry,
and the reference in the program's place with its frontier stored in
bfloat16 for a ``serve_step`` entry: the precision below the fp32 that
the configurations state.  It needs a card, as ``run.py`` does.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               control=args.mode == "control")
        print(json.dumps(dict(workload=args.workload, mode=args.mode, seed=seed,
                              correct=out["correct"], checks=out["checks"],
                              metrics=out["metrics"],
                              seconds=time.perf_counter() - t0)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
