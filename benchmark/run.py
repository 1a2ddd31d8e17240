"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's ``workloads``. It runs on the
card of the machine it starts on and exits non-zero, printing no result,
without one (or with fewer than the cell asks for). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``; its
last key, ``checks``, holds each number compared with the reference beside
its limit, and the same lines end standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process on the card, and few threads in it: the frame loop is one
# host thread, and idle worker threads only take cores from it
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.harness import cell as cells

    cell = cells.load_cell(args.workload, ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr, flush=True)
        return 3
    line = cells.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T0)
    found = cells.forbidden_modules()
    if found:
        print(f"error: the process loaded {', '.join(found)}", file=sys.stderr, flush=True)
        return 4
    cells.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
