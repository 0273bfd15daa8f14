"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout: ``src`` is put on the path here, and the
port's kernels build into ``build/`` there at first use.  The run needs
CUDA and as many cards as the cell asks for; without them it exits with
code 2 and prints no result.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: every number
compared with the reference beside its limit); the checks are also the
last lines of standard error.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"perfbench: the port (src/repro_torch) is not in {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from perfbench import bench

    cell = bench.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = bench.run_cell(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), t_start=T_START)
    leaked = bench.forbidden_modules()
    if leaked:
        print(f"perfbench: modules of the JAX stack or package loaded: "
              f"{leaked}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
