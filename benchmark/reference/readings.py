"""Readings of the numbers compared, for setting their limits on the card.

    python3 -m benchmark.reference.readings --workload <cell> --seeds 1,2,3 \\
        --what program|control [--follow 4] [--seconds 6] [--window 10,11] \\
        --out readings.jsonl

``program``: a short run of the cell on the port (its own driver and
comparison, ``--seconds`` long); ``control``: the control
(``control.py``) in the program's place at the cell's own size, judged at
``--window`` frames. ``--follow`` sets how many frames the reference follows
a window frame from the carried stream state. One JSON line a seed and
follow depth, with every checked frame's statistics. The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("program", "control"), default="control")
    ap.add_argument("--follow", default=None)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--window", default="10,11")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cell as cells
    from benchmark.reference.control import control_checks

    if not torch.cuda.is_available():
        print("error: the readings need a card", file=sys.stderr)
        return 3
    base = cells.load_cell(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    window = [int(x) for x in args.window.split(",")]
    follows = [None] if args.follow is None else [int(x) for x in args.follow.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        for k in follows:
            cell = copy.deepcopy(base)
            if k is not None:
                cell.traffic["check_follow_frames"] = k
            t = time.perf_counter()
            if args.what == "control":
                got = control_checks(cell.config, cell.traffic, seed, dev, window)
            else:
                rec = cells.driver(cell).run(cell, seed=seed, seconds=args.seconds, trace=False,
                                             device=dev, t0=time.perf_counter())
                got = dict(rec["checks"], stats=rec["frame_stats"])
            line = {"workload": args.workload, "what": args.what, "seed": seed, "follow": k,
                    "got": got, "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
