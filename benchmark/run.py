"""One run of one benchmark cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Prints the result as the last line of
standard output, and each number the check compared beside its limit as
the last lines of standard error.  ``--control 1`` (for setting limits,
not part of a check) puts the control, the plain reference computed one
precision lower on the same inputs, in the program's place: its readings
are compared and decide ``correct``.  Exits non-zero, printing no result,
without a CUDA device or when the run has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"

# every build and kernel cache of the run inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(BUILD / "inductor")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import Cell, refuse_forbidden_modules, run_cell

    cell = Cell(ROOT, args.workload)
    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      control=bool(args.control), log=lambda line: print(line, file=sys.stderr, flush=True))
    line = json.dumps(result)
    refuse_forbidden_modules()  # the last step before the result is printed
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
