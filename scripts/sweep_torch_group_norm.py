#!/usr/bin/env python3
"""K4 (the one-launch GroupNorm) at every cluster size, on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/sweep_torch_group_norm.py [--out result.jsonl]

For every shape class of the switched frame (chip_smoke.K4_SWITCHED_FRAME_SHAPES,
bf16 + SiLU, 32 groups) and every cluster size the shape allows (1, 2, 4, 8,
16 CTAs), prints the launch (``gn_geometry`` with the cluster forced), how many
of its clusters the card holds at once (cudaOccupancyMaxActiveClusters) against
how many the launch has, and the device time of one call over 10 calls a CUDA
graph (chip_smoke.graph_ms), checked against the plain version; then the
cluster ``gn_geometry`` picks by itself and the fastest. One JSON line a row,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from stable_renderer_tpu_torch.ops import group_norm_kernel as tgn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = open(args.out, "a") if args.out else None
    for n, s, c in sorted({k[:3] for k in chip_smoke.K4_SWITCHED_FRAME_SHAPES}):
        x = (torch.randn((n, s, c), generator=gen, device=dev) * 1.5 + 0.3).to(torch.bfloat16)
        w = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        ref = tgn.group_norm_kernel_reference(x, w, b, 32, 1e-6, "silu").float()
        picked = tgn.gn_geometry(n, s, c, 32, 2).cluster
        rows = []
        for cluster in (1, 2, 4, 8, 16):
            try:
                g = tgn.gn_geometry(n, s, c, 32, 2, cluster)
            except ValueError:
                continue
            call = lambda: tgn._launch(x, w, b, 32, 1e-6, "silu", g)  # noqa: E731
            err = (call().float() - ref).abs()
            if not (err <= chip_smoke.BF16_STEP * ref.abs() + chip_smoke.K4_ATOL).all():
                sys.exit(f"({n}, {s}, {c}) cluster {cluster}: max abs err {err.max().item():.3e}")
            row = {"shape": [n, s, c], "cluster": cluster, "picked": cluster == picked,
                   "geometry": dict(g._asdict(), threads=g.threads),
                   "clusters": n * (c // g.slice_channels),
                   "max_active_clusters": tgn.max_active_clusters(n, s, c, 32, g),
                   "ms": statistics.median(chip_smoke.graph_ms(call, calls=10)
                                           for _ in range(3)),
                   "card": card}
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
        best = min(rows, key=lambda r: r["ms"])
        mine = next(r for r in rows if r["picked"])
        print(f"({n}, {s}, {c}): picked cluster {picked} {mine['ms']:.5f} ms, fastest cluster "
              f"{best['cluster']} {best['ms']:.5f} ms", flush=True)


if __name__ == "__main__":
    main()
