#!/usr/bin/env python3
"""chip_smoke phase 28 (the restoration and upscale zoo) alone, on one GPU.

Builds the kernels, draws one raster-only presented 512x512 frame of the
bench scene through Engine.Run (K2), runs ``chip_smoke.zoo_phase`` on it and
writes its summary and the new K3 / K4 rows to ``--out``. Run from the
repository root:

    python3 scripts/run_torch_zoo_phase.py --out build/zoo_phase.json
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
    ap.add_argument("--out", type=str, default="build/zoo_phase.json")
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
    print(f"[zoo] build {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    _, presented = cs.run_engine(None, cs.SIZE, 3, None, disableComfyUI=True)
    k3, k4 = {"shapes": []}, {"shapes": []}
    out = cs.zoo_phase(torch.device("cuda", 0), card, k3, k4, presented[-1][2])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"zoo": out, "k3": k3, "k4": k4, "card": card},
                                         default=str))
    print(f"[zoo] total {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
