"""Command-line front end: ``python -m stable_renderer_tpu_torch <cmd>``.

Counterpart of stable_renderer_tpu/cli.py, with the same subcommands and
flags, and ``--device`` (default: the card; ``cpu`` runs the plain versions
of the kernels, as the tests do).

Subcommands:
  render   — run a scene (a sphere, or a mesh file: OBJ, glTF/GLB, STL, PLY,
             DAE, FBX) through the full loop
  bake     — BAKE mode: accumulate a CorrespondMap, dump at exit
  replay   — render a baked CorrespondMap in BAKED mode (no diffusion)
  bench    — the headline benchmark (bench_torch.py)
  validate — the five example scripts and the two parity scripts with a
             checkpoint, the record written to <--out>/PARITY.json
  execute, serve — need the workflow executor and the server (ROADMAP 1.12)
  upscale  — needs the model zoo (ROADMAP 1.13)

``render`` prints, after its fps line, the launches of each kernel over the
run (``kernel launches ...``: K1 flash_attention, K2 rasterize_kernel, K3
conv3x3_kernel, K4 group_norm_kernel; zero on the CPU, where no kernel runs).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", type=str, default=None, help="output dir (default: outputs/<date>)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--lora", action="append", default=[], help="path[:strength]")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--cfg", type=float, default=2.0)
    p.add_argument("--sampler", type=str, default="lcm")
    p.add_argument("--scheduler", type=str, default="sgm_uniform")
    p.add_argument("--denoise", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative", type=str, default="")
    p.add_argument("--obj", type=str, default=None,
                   help="mesh file: .obj .gltf .glb .stl .ply .dae .fbx (default: sphere)")
    p.add_argument("--no-diffusion", action="store_true")
    p.add_argument("--workflow", type=str, default=None, help="reference workflow JSON")
    p.add_argument("--gif", type=str, default=None, help="also write an animated gif")
    p.add_argument("--stream", action="store_true",
                   help="StreamDiffusion frame pipelining (one batched UNet "
                        "eval per frame; steps-1 frame output lag)")
    p.add_argument("--taesd", action="store_true",
                   help="realtime TAESD autoencoder swap")
    p.add_argument("--editor", action="store_true",
                   help="EDITOR mode: the live-view/graph-editor HTTP server (not ported)")
    p.add_argument("--editor-port", type=int, default=8188)
    _add_device(p)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' for tests)")


def _build_pipeline(args):
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow import Workflow
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    if args.workflow:
        cfg = Workflow.Load(args.workflow).build_config()
    else:
        cfg = RenderConfig(
            prompt=args.prompt, negative_prompt=args.negative, steps=args.steps,
            cfg_scale=args.cfg, sampler=args.sampler, scheduler=args.scheduler,
            denoise=args.denoise, seed=args.seed,
            stream_pipeline=getattr(args, "stream", False),
            realtime_taesd=getattr(args, "taesd", False),
        )
    loras = []
    for spec in args.lora:
        path, _, s = spec.partition(":")
        loras.append((path, float(s) if s else 1.0))
    if args.checkpoint:
        return DiffusionPipeline.from_checkpoint(args.checkpoint, cfg, loras=loras,
                                                 device=args.device)
    return DiffusionPipeline.from_random(cfg, tiny=args.size < 256, device=args.device)


def _scene(args, corrmaps=None):
    from stable_renderer_tpu_torch.engine import (
        AutoRotation, Camera, CorrMapRenderer, GameObject, Mesh, MeshRenderer, SpriteInfo,
    )

    cam = GameObject("camera")
    cam.addComponent(Camera).env_prompt.prompt = args.prompt
    cam.transform.position = [0.0, 0.5, 3.0]
    cam.transform.lookAt([0.0, 0.0, 0.0])
    obj = GameObject("subject")
    mesh = Mesh.Load(args.obj) if args.obj else Mesh.Sphere(1.0, 48)
    obj.addComponent(SpriteInfo, prompt=args.prompt)
    if corrmaps:
        obj.addComponent(CorrMapRenderer, mesh=mesh, corrmaps=corrmaps)
    else:
        obj.addComponent(MeshRenderer, mesh=mesh)
    obj.addComponent(AutoRotation, speed_deg=360.0 / max(args.frames, 1))


def kernel_counters() -> dict:
    """The kernels' wrappers by name; each counts its launches in ``launches``."""
    from stable_renderer_tpu_torch.ops.conv_kernel import conv3x3_kernel
    from stable_renderer_tpu_torch.ops.flash_attention import flash_attention
    from stable_renderer_tpu_torch.ops.group_norm_kernel import group_norm_kernel
    from stable_renderer_tpu_torch.ops.raster_kernel import rasterize_kernel

    return {f.__name__: f for f in (flash_attention, rasterize_kernel, conv3x3_kernel,
                                    group_norm_kernel)}


def cmd_render(args) -> int:
    from stable_renderer_tpu_torch.engine import Engine
    from stable_renderer_tpu_torch.utils.paths import new_run_dir

    if getattr(args, "editor", False):
        raise NotImplementedError("--editor needs the editor server (server.py), which waits "
                                  "for ROADMAP 1.12b")
    out = args.out or str(new_run_dir("render"))
    pipeline = None if args.no_diffusion else _build_pipeline(args)

    class App(Engine):
        def beforePrepare(self):
            _scene(args)

    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    eng = App.Run(
        winSize=(args.size, args.size),
        pipeline=pipeline,
        disableComfyUI=args.no_diffusion,
        max_frames=args.frames,
        output_dir=out,
        keep_frames_in_memory=bool(args.gif),
        device=args.device,
    )
    if args.gif:
        from stable_renderer_tpu_torch.utils.media import write_gif

        write_gif(eng.WindowManager.frames, args.gif)
    print(f"{args.frames} frames -> {out} (fps {eng.RuntimeManager.fps.fps:.2f})")
    launches = {name: f.launches for name, f in counters.items()}
    print(f"kernel launches over {args.frames} frames: {json.dumps(launches)}")
    return 0


def cmd_bake(args) -> int:
    from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
    from stable_renderer_tpu_torch.engine import Engine
    from stable_renderer_tpu_torch.ops.correspondence import DefaultCorresponder
    from stable_renderer_tpu_torch.utils.paths import new_run_dir

    out = args.out or str(new_run_dir("bake"))
    cmap = CorrespondMap(name="bake", k=args.k, height=args.size, width=args.size,
                         device=args.device)

    class App(Engine):
        def beforePrepare(self):
            _scene(args, corrmaps=[cmap])

        def beforeRelease(self):
            print("corrmap ->", cmap.dump(out, force=True))

    App.Bake(
        winSize=(args.size, args.size),
        pipeline=None if args.no_diffusion else _build_pipeline(args),
        disableComfyUI=args.no_diffusion,
        corresponder=DefaultCorresponder(update_corrmap_mode="first"),
        baking_interval=min(8, args.frames),
        max_frames=args.frames,
        output_dir=out + "/frames",
        device=args.device,
    )
    return 0


def cmd_replay(args) -> int:
    from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
    from stable_renderer_tpu_torch.engine import Engine
    from stable_renderer_tpu_torch.utils.paths import new_run_dir

    out = args.out or str(new_run_dir("replay"))
    cmap = CorrespondMap.Load(args.map, device=args.device)

    class App(Engine):
        def beforePrepare(self):
            _scene(args, corrmaps=[cmap])

    eng = App.Run(
        winSize=(args.size, args.size), disableComfyUI=True,
        max_frames=args.frames, output_dir=out, device=args.device,
    )
    print(f"replayed -> {out} (fps {eng.RuntimeManager.fps.fps:.2f})")
    return 0


def cmd_execute(args) -> int:
    raise NotImplementedError("execute needs the workflow executor "
                              "(workflow/executor.py), which waits for ROADMAP 1.12")


def cmd_serve(args) -> int:
    raise NotImplementedError("serve needs the HTTP server and the workflow executor "
                              "(server.py, workflow/executor.py), which wait for ROADMAP 1.12")


def cmd_upscale(args) -> int:
    raise NotImplementedError("upscale needs the model zoo (models/upscale.py and its "
                              "architectures), which waits for ROADMAP 1.13")


def cmd_bench(args) -> int:
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_torch", REPO_ROOT / "bench_torch.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bench.main(["--device", args.device] if args.device else [])
    return 0


def cmd_validate(args) -> int:
    """Run the five BASELINE configs, the image-level correspondence A/B and
    the temporal-flicker scoring against a real SD1.5 checkpoint, and write
    the results to <--out>/PARITY.json. Skips with one line when no
    checkpoint is given (random weights make image-level numbers
    meaningless)."""
    import subprocess
    import time

    from stable_renderer_tpu_torch.utils.paths import new_run_dir

    if not args.ckpt or not Path(args.ckpt).exists():
        print("validate: SKIPPED — no SD checkpoint available "
              f"({args.ckpt or '--ckpt not given'}); image-level parity "
              "numbers need real weights.")
        return 0
    out = Path(args.out) if args.out else new_run_dir("validate")
    out.mkdir(parents=True, exist_ok=True)
    py = sys.executable
    ck = str(Path(args.ckpt).resolve())
    dev = ["--device", args.device] if args.device else []
    # the 5 BASELINE.json configs map 1:1 onto the reference's example
    # scripts, plus the two parity harnesses, which write under out
    steps = [
        ("bake_ball", [py, "scripts/bake_ball_torch.py", "--no-diffusion", "--frames", "4",
                       *dev]),
        ("boat_img2img", [py, "scripts/boat_example_torch.py", "--checkpoint", ck,
                          "--frames", "2", *dev]),
        ("corrmap_replay", [py, "scripts/corrmap_render_example_torch.py", "--frames", "4",
                            *dev]),
        ("miku_controlnet", [py, "scripts/miku_controlnet_example_torch.py", "--checkpoint",
                             ck, "--frames", "2", *dev]
         + (["--controlnet", args.controlnet] if args.controlnet else [])),
        ("multi_obj_stream", [py, "scripts/multi_obj_example_torch.py", "--frames", "4", *dev]),
        ("diffusion_ab", [py, "scripts/diffusion_ab_torch.py", "--ckpt", ck,
                          "--out", str(out.resolve() / "diffusion_ab"), *dev]),
        ("flicker_parity", [py, "scripts/flicker_parity_torch.py",
                            "--out", str(out.resolve() / "flicker_parity"), *dev]
         + (["--lpips", args.lpips] if args.lpips else [])),
    ]
    results = {}
    for name, argv_ in steps:
        t0 = time.time()
        r = subprocess.run(argv_, cwd=REPO_ROOT, capture_output=True, text=True,
                           timeout=args.step_timeout)
        ok = r.returncode == 0
        results[name] = {"ok": ok, "seconds": round(time.time() - t0, 1)}
        print(f"validate[{name}]: {'ok' if ok else 'FAILED'} "
              f"({results[name]['seconds']}s)")
        if not ok:
            print("\n".join((r.stdout + r.stderr).splitlines()[-8:]))
    pj = out / "PARITY.json"
    data = json.loads(pj.read_text()) if pj.exists() else {}
    data["validate"] = {"ckpt": Path(ck).name, "steps": results,
                        "ts": time.strftime("%Y-%m-%d %H:%M:%S")}
    pj.write_text(json.dumps(data, indent=2) + "\n")
    print(f"validate: wrote {pj} 'validate' entry "
          f"({sum(v['ok'] for v in results.values())}/{len(results)} ok)")
    return 0 if all(v["ok"] for v in results.values()) else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="stable_renderer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="full render loop")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bake", help="bake a CorrespondMap")
    _add_common(p)
    p.add_argument("--k", type=int, default=3)
    p.set_defaults(fn=cmd_bake)

    p = sub.add_parser("replay", help="replay a baked CorrespondMap")
    _add_common(p)
    p.add_argument("--map", type=str, required=True)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("execute", help="run a workflow JSON on dumped maps (ROADMAP 1.12)")
    _add_common(p)
    p.add_argument("--color-dir", type=str, default=None)
    p.add_argument("--id-dir", type=str, default=None)
    p.add_argument("--noise-dir", type=str, default=None)
    p.add_argument("--normal-dir", type=str, default=None)
    p.add_argument("--depth-dir", type=str, default=None)
    p.add_argument("--model-dir", action="append", default=[])
    p.add_argument("--extra-model-paths", type=str, default=None,
                   help="reference-format extra_model_paths.yaml")
    p.set_defaults(fn=cmd_execute)

    p = sub.add_parser("serve", help="HTTP viewer + prompt server (ROADMAP 1.12)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8188)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--color-dir", type=str, default=None)
    p.add_argument("--id-dir", type=str, default=None)
    p.add_argument("--noise-dir", type=str, default=None)
    p.add_argument("--normal-dir", type=str, default=None)
    p.add_argument("--depth-dir", type=str, default=None)
    p.add_argument("--model-dir", action="append", default=[])
    p.add_argument("--extra-model-paths", type=str, default=None,
                   help="reference-format extra_model_paths.yaml")
    p.add_argument("--max-prompts", type=int, default=None,
                   help="exit after N prompts (default: run forever)")
    _add_device(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("upscale", help="run a zoo model on an image (ROADMAP 1.13)")
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--image", type=str, required=True)
    p.add_argument("--out", type=str, default="upscaled.png")
    p.add_argument("--mask", type=str, default=None, help="LaMa hole mask")
    _add_device(p)
    p.set_defaults(fn=cmd_upscale)

    p = sub.add_parser("bench", help="headline benchmark (bench_torch.py)")
    _add_device(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "validate",
        help="run the 5 BASELINE configs + image A/B + flicker vs a real "
             "checkpoint, write <--out>/PARITY.json (skips without --ckpt)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="SD1.5 checkpoint (.safetensors)")
    p.add_argument("--controlnet", type=str, default=None,
                   help="optional controlnet .safetensors for config 4")
    p.add_argument("--lpips", type=str, default=None,
                   help="optional VGG16/LPIPS weights for the LPIPS metric")
    p.add_argument("--step-timeout", type=int, default=3600)
    p.add_argument("--out", type=str, default=None,
                   help="where PARITY.json and the parity runs go (default: outputs/<date>)")
    _add_device(p)
    p.set_defaults(fn=cmd_validate)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
