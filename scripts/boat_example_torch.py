"""Single-object img2img render loop — config 2 of BASELINE.md, on the PyTorch port.

Counterpart of scripts/boat_example.py (the reference's
scripts/boat_example.py): a textured mesh, the reference's boat when its
file is given with --obj and a sphere otherwise, rendered and diffused
every frame with an img2img workflow, overlap disabled.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stable_renderer_tpu_torch.engine import (
    AutoRotation,
    Camera,
    DiffusionPipeline,
    Engine,
    GameObject,
    Mesh,
    MeshRenderer,
    SpriteInfo,
)
from stable_renderer_tpu_torch.utils.paths import new_run_dir
from stable_renderer_tpu_torch.workflow.config import RenderConfig


def main(argv=None) -> Path:
    """Run the loop; returns the run's output directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--denoise", type=float, default=0.6)
    ap.add_argument("--obj", type=str, default=None,
                    help="mesh file (the reference's boat.obj); default: a sphere")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)
    out_dir = new_run_dir("boat")

    class Boat(Engine):
        def beforePrepare(self):
            cam = GameObject("camera")
            cam.addComponent(
                Camera
            ).env_prompt.prompt = "a boat on calm water, sunset, masterpiece"
            cam.transform.position = [0.0, 1.0, 4.0]
            cam.transform.lookAt([0.0, 0.0, 0.0])
            obj = GameObject("boat")
            mesh = Mesh.Load(args.obj) if args.obj else Mesh.Sphere(1.0, 32)
            obj.addComponent(SpriteInfo, prompt="a wooden boat")
            obj.addComponent(MeshRenderer, mesh=mesh)
            obj.addComponent(AutoRotation, speed_deg=4.0)

    cfg = RenderConfig(
        steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform",
        denoise=args.denoise,
    )
    if args.checkpoint:
        pipe = DiffusionPipeline.from_checkpoint(args.checkpoint, cfg, device=args.device)
    else:
        pipe = DiffusionPipeline.from_random(cfg, tiny=True, device=args.device)

    Boat.Run(
        winSize=(args.size, args.size),
        pipeline=pipe,
        max_frames=args.frames,
        output_dir=str(out_dir),
    )
    print(f"outputs in {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
