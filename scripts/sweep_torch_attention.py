#!/usr/bin/env python3
"""Tile sweep of the port's flash-attention kernel (K1, bf16 route) on one GPU.

The Hopper counterpart of scripts/sweep_attention.py. Run from the
repository root on a machine with a CUDA card:

    python3 scripts/sweep_torch_attention.py [--repeats N] [--out result.jsonl]

For each of the frame's two attention shapes, (16, 4096, 4096, 40) (the UNet's
level-0 self-attention, 8 heads x CFG batch 2) and (1, 4096, 4096, 512) (the
VAE mid-block attention), and the all-frames bake submit's folded levels 1
and 2, (8, 8192, 8192, 80) and (8, 2048, 2048, 160), every compiled tile variant of
csrc/flash_attention.cu that takes the head dim (query rows, K/V rows,
pipeline stages, K/V split; the table in the source) is checked against the
plain version (bf16 bar 1e-2) and timed as device time by CUDA-graph replay,
beside F.scaled_dot_product_attention on the same inputs. Prints one JSON
line per variant (and writes them to --out), then the card's name and power
limit. The variant the wrapper uses by default is marked "default": true.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((16, 4096, 4096, 40), (1, 4096, 4096, 512), (8, 8192, 8192, 80), (8, 2048, 2048, 160))
TOL = 1e-2


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=50, help="graph replays per timing")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]

    from chip_smoke import graph_ms, k1_bound
    from stable_renderer_tpu_torch.kernels import _build
    from stable_renderer_tpu_torch.ops import flash_attention as tfa

    lib = _build.load_library()
    names = []
    while lib.sr_flash_attention_bf16_variant(len(names)) is not None:
        names.append(lib.sr_flash_attention_bf16_variant(len(names)).decode())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    lines = []
    for bh, lq, lk, d in SHAPES:
        q = torch.randn((bh, lq, 1, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((bh, lk, 1, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((bh, lk, 1, d), generator=gen, device=dev).bfloat16()
        ref = tfa.flash_attention_reference(q[:, :, 0], k[:, :, 0], v[:, :, 0]).float()
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))  # (BH, 1, L, D) for SDPA
        sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), args.repeats)
        bound_ms, bound_by = k1_bound(bh, lq, lk, d)
        for i, name in enumerate(names):
            if lib.sr_flash_attention_bf16_scratch(bh, lq, lk, d, i) < 0:
                continue  # not compiled for this head dim
            out = tfa._launch_bf16(q, k, v, variant=i)
            torch.cuda.synchronize()
            err = (out.view(bh, lq, d).float() - ref).abs().max().item()
            row = {"shape": [bh, lq, lk, d], "variant": i, "name": name,
                   "default": i == lib.sr_flash_attention_bf16_default(d),
                   "max_abs_err": err, "ok": err < TOL,
                   "ms": graph_ms(lambda: tfa._launch_bf16(q, k, v, variant=i), args.repeats),
                   "sdpa_ms": sdpa_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "card": card}
            print(json.dumps(row), flush=True)
            lines.append(row)
        del q, k, v, ref
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    print(card)
    if not all(r["ok"] for r in lines):
        sys.exit("a variant disagrees with the plain version")


if __name__ == "__main__":
    main()
