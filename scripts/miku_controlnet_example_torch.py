"""ControlNet-conditioned character render — config 4 of BASELINE.md, on the PyTorch port.

Counterpart of scripts/miku_controlnet_example.py (the reference's
scripts/miku_controlnet_example.py and its miku-control workflow): SD1.5 +
LCM LoRA, 4 steps, cfg 2, lcm/sgm_uniform, with normal + depth ControlNets
fed from the G-buffer. The configuration comes from the reference's workflow
JSON when it is given with --workflow, and the mesh from --obj; otherwise
the same settings are written out here and a sphere stands in. Without
--controlnet the ControlNets are random.
"""

import argparse
import os
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
from stable_renderer_tpu_torch.workflow import Workflow
from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig


def main(argv=None) -> Path:
    """Run the loop; returns the run's output directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--controlnet", type=str, default=None, help="controlnet safetensors")
    ap.add_argument("--obj", type=str, default=None,
                    help="mesh file (the reference's miku.obj); default: a sphere")
    ap.add_argument("--workflow", type=str, default=None,
                    help="workflow JSON (the reference's miku-control.json); "
                         "default: the settings written here")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)
    out_dir = new_run_dir("miku")

    # configuration from the workflow JSON when one is given
    if args.workflow:
        cfg = Workflow.Load(args.workflow).build_config()
        cfg = RenderConfig(
            prompt="hatsune miku, masterpiece, best quality",
            steps=cfg.steps, cfg_scale=cfg.cfg_scale, sampler=cfg.sampler,
            scheduler=cfg.scheduler, denoise=cfg.denoise, controlnets=cfg.controlnets,
        )
    else:
        cfg = RenderConfig(
            prompt="hatsune miku, masterpiece, best quality",
            steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform",
            controlnets=(
                ControlNetSpec(source="normal"), ControlNetSpec(source="depth"),
            ),
        )

    if args.checkpoint:
        pipe = DiffusionPipeline.from_checkpoint(args.checkpoint, cfg, device=args.device)
    else:
        pipe = DiffusionPipeline.from_random(cfg, tiny=True, device=args.device)
    for spec in cfg.controlnets:
        if args.controlnet and os.path.exists(args.controlnet):
            from stable_renderer_tpu_torch.models.weights import load_state_dict

            pipe.add_control_from_state_dict(load_state_dict(args.controlnet), spec)
        else:
            pipe.add_random_controlnet(spec)

    class Miku(Engine):
        def beforePrepare(self):
            cam = GameObject("camera")
            cam.addComponent(Camera)
            cam.transform.position = [0.0, 1.0, 3.0]
            cam.transform.lookAt([0.0, 0.8, 0.0])
            obj = GameObject("miku")
            mesh = Mesh.Load(args.obj) if args.obj else Mesh.Sphere(1.0, 32)
            obj.addComponent(SpriteInfo, prompt="hatsune miku")
            obj.addComponent(MeshRenderer, mesh=mesh)
            obj.addComponent(AutoRotation, speed_deg=6.0)

    Miku.Run(
        winSize=(args.size, args.size),
        pipeline=pipe,
        max_frames=args.frames,
        output_dir=str(out_dir),
        output_maps=True,
        map_output_dir=str(out_dir / "maps"),
    )
    print(f"outputs in {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
