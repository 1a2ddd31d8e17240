"""Replay a baked CorrespondMap without diffusion — config 3 of BASELINE.md, on the PyTorch port.

Counterpart of scripts/corrmap_render_example.py (the reference's
scripts/corrmap_render_example.py): load a dumped CorrespondMap and render it
in BAKED mode (the 'free real-time playback' path, frag glsl:176-205).
Without --map, a synthetic rainbow map stands in.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
from stable_renderer_tpu_torch.engine import (
    Camera,
    CorrMapRenderer,
    Engine,
    EqualIntervalRotation,
    GameObject,
    Mesh,
    SpriteInfo,
)
from stable_renderer_tpu_torch.utils.paths import new_run_dir


def bake_synthetic_map(size: int, k: int = 3, device=None) -> CorrespondMap:
    """A synthetic baked map (rainbow UV) when no dumped map is given, its
    tensors on the map's device (default: the card)."""
    cmap = CorrespondMap(name="synthetic", k=k, height=size, width=size, device=device)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    vals = np.stack(
        [xx / size, yy / size, np.full_like(xx, 0.5, dtype=float), np.ones_like(xx, dtype=float)],
        axis=-1,
    ).reshape(-1, 4)
    cmap.values = torch.as_tensor(np.stack([vals] * (k * k)), dtype=torch.float32,
                                  device=cmap.device)
    cmap.written = torch.ones((k * k, size * size), dtype=torch.bool, device=cmap.device)
    return cmap


def main(argv=None) -> Path:
    """Replay; returns the run's output directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", type=str, default=None, help="path to a dumped corrmap dir/zip")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)
    out_dir = new_run_dir("corrmap_render")

    cmap = (CorrespondMap.Load(args.map, device=args.device) if args.map
            else bake_synthetic_map(args.size, device=args.device))

    class Replay(Engine):
        def beforePrepare(self):
            cam = GameObject("camera")
            cam.addComponent(Camera)
            cam.transform.position = [0.0, 0.0, 3.0]
            ball = GameObject("ball")
            ball.addComponent(SpriteInfo, prompt="")
            ball.addComponent(
                CorrMapRenderer, mesh=Mesh.Sphere(1.0, 48), corrmaps=[cmap]
            )
            ball.addComponent(
                EqualIntervalRotation, angle_deg=360.0 / max(args.frames, 1)
            )

    eng = Replay.Run(  # GAME mode -> renderMode=BAKED, no diffusion needed
        winSize=(args.size, args.size),
        disableComfyUI=True,
        max_frames=args.frames,
        output_dir=str(out_dir),
        device=args.device,
    )
    print(f"replayed {args.frames} frames -> {out_dir}; fps={eng.RuntimeManager.fps.fps:.2f}")
    return out_dir


if __name__ == "__main__":
    main()
