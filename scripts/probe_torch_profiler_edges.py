#!/usr/bin/env python3
"""Where torch.profiler's device events lie against the step they were
recorded in, with and without chip_smoke's host margin, on one GPU.

chip_smoke reads the kernels a call launches from a profiled step of three
calls (``chip_smoke.profiled_calls``). The tracer places device events on the
host's clock and drops those that land outside the step's window, so a
kernel launched right after the window opens may be lost. For each of
chip_smoke's three timed K4 shapes (bf16 + SiLU, 32 groups) this records
``--rounds`` steps with no margin and as many with ``PROFILE_MARGIN_S``,
between CUDA-graph captures as in chip_smoke's phase 8, and reports for each
margin the records short of three kernels, the launch events on the host
side, and the least lead (first kernel's start after the step's start) and
tail (step's end after the last kernel's end) in microseconds. Run from the
repository root:

    python3 scripts/probe_torch_profiler_edges.py [--rounds 25] [--out result.json]

Prints one JSON line a shape and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def record(fn, margin: float, calls: int = 3):
    """(device kernels, host launch events, (lead us, tail us)) of one
    profiled step of ``calls`` calls, after a warm-up step, as
    chip_smoke.profiled_calls records it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            time.sleep(margin)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin)
            prof.step()
    events = prof.events()
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep")]
    steps = [e for e in events if e.device_type.name == "CPU" and e.name.startswith("ProfilerStep")]
    launches = sum(1 for e in events if e.device_type.name == "CPU" and "aunchKernel" in e.name)
    edges = None
    if steps and kernels:
        edges = (min(e.time_range.start for e in kernels) - min(e.time_range.start for e in steps),
                 max(e.time_range.end for e in steps) - max(e.time_range.end for e in kernels))
    return len(kernels), launches, edges


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from stable_renderer_tpu_torch.kernels import _build
    from stable_renderer_tpu_torch.ops.group_norm_kernel import group_norm_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"card": card, "rounds": args.rounds, "margin_s": cs.PROFILE_MARGIN_S, "shapes": {}}
    for n, s, c in cs.K4_TIMED_SHAPES:
        x = (torch.randn((n, s, c), generator=gen, device=dev) * 1.5 + 0.3).to(torch.bfloat16)
        w = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)

        def call(x=x, w=w, b=b):
            return group_norm_kernel(x, w, b, groups=32, act="silu")

        call()
        torch.cuda.synchronize()
        recs = {0.0: [], cs.PROFILE_MARGIN_S: []}
        for _ in range(args.rounds):
            for margin, rows in recs.items():
                rows.append(record(call, margin))
            cs.graph_ms(call, calls=cs.SHORT_CALLS_A_GRAPH)
            cs.graph_ms(call)
        row = {str(margin): {
            "short": sum(1 for k, _, _ in rows if k != 3), "records": len(rows),
            "launch_events": sorted({la for _, la, _ in rows}),
            "min_lead_us": min((e[0] for _, _, e in rows if e), default=None),
            "min_tail_us": min((e[1] for _, _, e in rows if e), default=None)}
            for margin, rows in recs.items()}
        result["shapes"][str((n, s, c))] = row
        print(json.dumps({"shape": [n, s, c], **row}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
