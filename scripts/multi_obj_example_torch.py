"""Multi-object raster-only scene — config 5's raster path of BASELINE.md, on the PyTorch port.

Counterpart of scripts/multi_obj_example.py (the reference's
scripts/multi_obj_example.py, disableComfyUI=True): several objects, an
orbiting camera, pure G-buffer rendering.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stable_renderer_tpu_torch.engine import (
    AutoRotation,
    Camera,
    CircularOrbit,
    Engine,
    GameObject,
    Mesh,
    MeshRenderer,
)
from stable_renderer_tpu_torch.utils.paths import new_run_dir


def main(argv=None) -> Path:
    """Render; returns the run's output directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)
    out_dir = new_run_dir("multi_obj")

    class MultiObj(Engine):
        def beforePrepare(self):
            cam = GameObject("camera")
            cam.addComponent(Camera)
            cam.transform.position = [0.0, 1.5, 5.0]
            cam.transform.lookAt([0.0, 0.0, 0.0])
            cam.addComponent(CircularOrbit, center=(0.0, 0.0, 0.0), speed_deg=5.0)

            ground = GameObject("ground")
            plane = Mesh.Plane(8.0, 4)
            plane.colors[:] = [0.35, 0.5, 0.35]
            ground.addComponent(MeshRenderer, mesh=plane)
            ground.transform.position = [0.0, -1.0, 0.0]

            ball = GameObject("ball")
            sphere = Mesh.Sphere(0.8, 32)
            sphere.colors[:] = [0.8, 0.3, 0.3]
            ball.addComponent(MeshRenderer, mesh=sphere)
            ball.transform.position = [-1.2, 0.0, 0.0]

            box = GameObject("box")
            cube = Mesh.Cube(1.2)
            cube.colors[:] = [0.3, 0.3, 0.8]
            box.addComponent(MeshRenderer, mesh=cube)
            box.addComponent(AutoRotation, speed_deg=7.0)
            box.transform.position = [1.2, 0.0, 0.0]

    eng = MultiObj.Run(
        winSize=(args.size, args.size),
        disableComfyUI=True,
        max_frames=args.frames,
        output_dir=str(out_dir),
        device=args.device,
    )
    print(f"{args.frames} frames -> {out_dir}; fps={eng.RuntimeManager.fps.fps:.2f}")
    return out_dir


if __name__ == "__main__":
    main()
