"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository.  It needs as many CUDA
cards as the cell asks for and refuses without them (exit 2, no result).
The program (``src/repro_torch``) is imported from the checkout, and its
kernels build into ``build/`` there on the first run.  The last line of
standard output is the result (JSON); the numbers the correctness check
compared close standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                     ("TRITON_CACHE_DIR", "build/triton")):
        os.environ[var] = str(ROOT / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness

    chips = harness.load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"portbench: repro_torch imported from {repro_torch.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad} in the measuring process", file=sys.stderr)
        return 3
    harness.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
