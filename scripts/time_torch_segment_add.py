#!/usr/bin/env python3
"""Time the port's segment sums on one GPU: ``ops.math.segment_add_`` (sorted
indices, a fixed order of additions) against ``index_add_`` (atomics), and
check that the first repeats itself and equals the CPU's sum in row order.

    python3 scripts/time_torch_segment_add.py [--calls 20]

Shapes: a bench frame's latent rows (2 x 64 x 64, 4 channels, 4096 vertex
segments), its pixel rows (2 x 512 x 512) into the same segments, and pixel
rows into a k = 3 correspondence map's 9 x 4096 cells (3 channels). For each:
the milliseconds of one call by CUDA events over ``--calls`` calls (the zeroed
output included); of ``--calls`` repeats, how many differ (``segment_add_``:
from its first result; ``index_add_``: two calls from each other); and
whether ``segment_add_``'s first result equals the CPU's ``index_add_`` bit for
bit. Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((2 * 64 * 64, 4, 4096), (2 * 512 * 512, 4, 4096), (2 * 512 * 512, 3, 9 * 4096))


def event_ms(fn, calls: int) -> float:
    """Milliseconds of one call of ``fn`` over ``calls`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()

    import torch

    from stable_renderer_tpu_torch.ops.math import segment_add_

    if not torch.cuda.is_available():
        sys.exit("time_torch_segment_add.py: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for n, c, segs in SHAPES:
        values = torch.randn((n, c), generator=gen, device=dev)
        seg = torch.randint(0, segs, (n,), generator=gen, device=dev)
        fixed = lambda: segment_add_(torch.zeros((segs, c), device=dev), seg, values)  # noqa: E731
        atomic = lambda: torch.zeros((segs, c), device=dev).index_add_(0, seg, values)  # noqa: E731
        first = fixed()
        cpu = torch.zeros((segs, c)).index_add_(0, seg.cpu(), values.cpu())
        rows.append({"rows": n, "channels": c, "segments": segs,
                     "segment_add_ms": event_ms(fixed, args.calls),
                     "index_add_ms": event_ms(atomic, args.calls),
                     "segment_add_differing": sum(not torch.equal(fixed(), first)
                                                  for _ in range(args.calls)),
                     "index_add_differing": sum(not torch.equal(atomic(), atomic())
                                                for _ in range(args.calls)),
                     "segment_add_equals_cpu": torch.equal(first.cpu(), cpu)})
    print(json.dumps({"card": card, "calls": args.calls, "shapes": rows}))


if __name__ == "__main__":
    main()
