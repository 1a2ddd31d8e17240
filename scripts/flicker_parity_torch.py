"""Temporal-flicker parity harness — BASELINE metric #2, on the PyTorch port.

Counterpart of scripts/flicker_parity.py. Scores the temporal stability of
frame sequences with the port's metrics (consecutive-frame L1, 1 - SSIM,
correspondence-aware vertex flicker where id maps exist, LPIPS where a
VGG/LPIPS checkpoint is given) and writes PARITY.md and PARITY.json under
--out (default: a new run directory under outputs/).

The parity target is the REFERENCE's own dumped render outputs
(resources/example-map-outputs), given with --fixtures: its observed
temporal behavior. Without them, the report holds what is there: the
metric definitions, and "ours" with --ours. Score a render with --ours <dir of
pngs> (e.g. an Engine output_dir) and --ids <dir of id .npy maps>; parity =
our flicker <= the reference's on the same metric.

Usage:
  python scripts/flicker_parity_torch.py [--fixtures DIR] [--ours DIR] [--ids DIR]
                                         [--lpips CKPT] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch


def score_sequence(frames, id_maps=None, lpips_params=None, device=None) -> dict:
    from stable_renderer_tpu_torch.ops.metrics import (
        temporal_flicker_l1,
        temporal_flicker_ssim,
        vertex_flicker,
    )

    frames = torch.as_tensor(frames).to(device)
    out = {
        "frames": int(frames.shape[0]),
        "flicker_l1": float(temporal_flicker_l1(frames)),
        "flicker_ssim": float(temporal_flicker_ssim(frames)),
    }
    if id_maps is not None:
        out["vertex_flicker"] = float(
            vertex_flicker(frames, torch.as_tensor(id_maps).to(device), num_segments=65536)
        )
    if lpips_params is not None:
        from stable_renderer_tpu_torch.ops.metrics import lpips_flicker

        out["flicker_lpips"] = float(lpips_flicker(frames, lpips_params))
    return out


def main(argv=None) -> dict:
    """Score; returns the report written to PARITY.json."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixtures", type=str, default=None,
                    help="the reference's dumped render outputs "
                         "(resources/example-map-outputs); default: none")
    ap.add_argument("--ours", type=str, default=None,
                    help="directory of our rendered frames (pngs)")
    ap.add_argument("--ids", type=str, default=None,
                    help="directory of id .npy maps for vertex flicker")
    ap.add_argument("--lpips", type=str, default=None,
                    help="LPIPS/VGG checkpoint path (optional)")
    ap.add_argument("--out", type=str, default=None,
                    help="directory of PARITY.json and PARITY.md (default: outputs/<date>)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)

    from stable_renderer_tpu_torch.data.idmap import IDMap
    from stable_renderer_tpu_torch.data.loaders import load_image_sequence
    from stable_renderer_tpu_torch.device import resolve_device
    from stable_renderer_tpu_torch.utils.paths import new_run_dir

    device = resolve_device(args.device)
    lpips_params = None
    if args.lpips and os.path.exists(args.lpips):
        from stable_renderer_tpu_torch.models.weights import load_state_dict, tree_to

        lpips_params = tree_to(load_state_dict(args.lpips), device)

    report: dict = {"metric_defs": {
        "flicker_l1": "mean |frame_t - frame_{t+1}| (lower = stabler)",
        "flicker_ssim": "1 - mean SSIM of consecutive frames",
        "vertex_flicker": "RMS color deviation per 3D vertex across frames",
    }}

    for name in ("miku-sphere", "miku-no-sphere"):
        d = os.path.join(args.fixtures, name, "color") if args.fixtures else None
        if d and os.path.isdir(d):
            frames = load_image_sequence(d)
            ids = None
            id_dir = os.path.join(args.fixtures, name, "id")
            if os.path.isdir(id_dir):
                ids = IDMap.from_directory(id_dir).tensor
            report[f"reference/{name}"] = score_sequence(frames, ids, lpips_params, device)

    if args.ours and os.path.isdir(args.ours):
        frames = load_image_sequence(args.ours)
        ids = None
        if args.ids and os.path.isdir(args.ids):
            ids = IDMap.from_directory(args.ids).tensor
        report["ours"] = score_sequence(frames, ids, lpips_params, device)
        ref = report.get("reference/miku-sphere") or report.get("reference/miku-no-sphere")
        if ref:
            report["parity"] = {
                k: {
                    "ours": report["ours"][k],
                    "reference": ref[k],
                    "parity": bool(report["ours"][k] <= ref[k] * 1.05),
                }
                for k in ("flicker_l1", "flicker_ssim")
            }

    out = Path(args.out) if args.out else new_run_dir("flicker_parity")
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "PARITY.json", "w") as f:
        json.dump(report, f, indent=2)
    md = ["# Temporal-flicker parity report (BASELINE metric #2)", "",
          "Scored with `stable_renderer_tpu_torch.ops.metrics` — see PARITY.json for raw "
          "values.", "",
          "- `reference/*`: the reference's own dumped render sequences "
          "(`resources/example-map-outputs`), scored where they are present.", "",
          "- `ours`: the frames given with `--ours` (and `--ids` for `vertex_flicker`).", ""]
    for section, vals in report.items():
        if section in ("metric_defs",):
            continue
        md.append(f"## {section}")
        if isinstance(vals, dict):
            for k, v in vals.items():
                md.append(f"- **{k}**: {v}")
        md.append("")
    with open(out / "PARITY.md", "w") as f:
        f.write("\n".join(md) + "\n")
    print(json.dumps(report, indent=2))
    print(f"written to {out}")
    return report


if __name__ == "__main__":
    main()
