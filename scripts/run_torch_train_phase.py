#!/usr/bin/env python3
"""chip_smoke phase 30 (training and the pipelines on a one-rank mesh) alone,
on one GPU.

Builds the kernels, runs ``chip_smoke.train_phase`` (it starts and destroys
its own one-rank NCCL group) and writes its summary and K1's gradient rows
to ``--out``. Run from the repository root:

    python3 scripts/run_torch_train_phase.py --out build/train_phase.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default="build/train_phase.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from stable_renderer_tpu_torch.device import keep_f32
    from stable_renderer_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    keep_f32()
    _build.build()
    _build.load_library()
    print(f"[train] build {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    k1 = {"shapes": [], "launches_a_frame": {}}
    out = cs.train_phase(torch.device("cuda", 0), card, k1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"train": out, "k1": k1, "card": card}, default=str))
    print(f"[train] total {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
