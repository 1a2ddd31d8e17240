"""Bake a sphere's CorrespondMap — config 1 of BASELINE.md, on the PyTorch port.

Counterpart of scripts/bake_ball.py (the reference's scripts/bake_ball.py): a
sphere with a CorrMapRenderer is rotated through evenly spaced views in BAKE
mode; the diffused frames accumulate into the k^2-view CorrespondMap, dumped
at release. --no-diffusion bakes the G-buffer alone (the reference's
disableComfyUI=True path).

Usage:
    python scripts/bake_ball_torch.py [--no-diffusion] [--frames N] [--size S]
                                      [--checkpoint path.safetensors] [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
from stable_renderer_tpu_torch.engine import (
    Camera,
    CorrMapRenderer,
    DiffusionPipeline,
    Engine,
    EqualIntervalRotation,
    GameObject,
    Mesh,
    SpriteInfo,
)
from stable_renderer_tpu_torch.ops.correspondence import DefaultCorresponder
from stable_renderer_tpu_torch.utils.paths import new_run_dir
from stable_renderer_tpu_torch.workflow.config import RenderConfig


def main(argv=None) -> Path:
    """Run the bake; returns the run's output directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-diffusion", action="store_true")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)

    out_dir = new_run_dir("bake_ball")
    corrmap = CorrespondMap(name="bake_ball", k=args.k, height=args.size, width=args.size,
                            device=args.device)

    class BakeBall(Engine):
        def beforePrepare(self):
            cam = GameObject("camera")
            cam.addComponent(Camera)
            cam.transform.position = [0.0, 0.0, 3.0]
            ball = GameObject("ball")
            ball.addComponent(SpriteInfo, prompt="a colorful beach ball, high quality")
            ball.addComponent(CorrMapRenderer, mesh=Mesh.Sphere(1.0, 48), corrmaps=[corrmap])
            ball.addComponent(
                EqualIntervalRotation, angle_deg=360.0 / max(args.frames, 1), interval=1
            )

        def beforeRelease(self):
            path = corrmap.dump(out_dir, name="bake_ball", force=True)
            print(f"corrmap dumped to {path}")

    pipeline = None
    if not args.no_diffusion:
        cfg = RenderConfig(steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform")
        if args.checkpoint:
            pipeline = DiffusionPipeline.from_checkpoint(args.checkpoint, cfg,
                                                         device=args.device)
        else:
            pipeline = DiffusionPipeline.from_random(cfg, tiny=True, device=args.device)

    BakeBall.Bake(
        winSize=(args.size, args.size),
        pipeline=pipeline,
        corresponder=DefaultCorresponder(update_corrmap_mode="first"),
        baking_interval=min(8, args.frames),
        max_frames=args.frames,
        output_dir=str(out_dir / "frames"),
        device=args.device,
    )
    print(f"outputs in {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
