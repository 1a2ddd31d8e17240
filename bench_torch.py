"""Headline benchmark of the PyTorch port: 512x512 img2img engine-loop fps.

Counterpart of bench.py for ``stable_renderer_tpu_torch``: the same modes,
knobs, scene and one-line JSON, run through the port's ``Engine.Run`` on an
NVIDIA GPU. SD1.5 widths with random weights (fps depends on architecture and
shapes, not on weight values), 4-step LCM over sgm_uniform sigmas at cfg 2.0,
bench.py's BenchApp (a 48-segment sphere turning 4 degrees a frame), 2 warm
presents, then SR_BENCH_FRAMES timed ones. The engine hands a frame to the
window SR_PRESENT_DEPTH (2) frames later and the last ones all at once when
the run ends, so the run has that many frames more and times only presents
made in steady frames (bench.py times the run's last presents too).

stdout: ONE JSON line {"metric", "value", "unit", "vs_baseline"}, with
vs_baseline = fps / 2.5 (the reference's published 2-3 fps midpoint) and the
torch device type, "(cuda)", where bench.py names the JAX platform.
stderr: first the two TF32 switches (``device.keep_f32`` turns both off, so
the f32 towers, such as the control mode's hint towers, run in f32), then the
"# compile ..." line and the present-to-present median and p90 ms of the
timed frames.

Modes (bench.py's env knobs, resolved by ``resolve_mode``):
  (default)            stream pipeline + lag-1 K/V at transformer 6 + the
                       calibrated int8 convs (K3): a throughput number, the
                       output lags the raster by steps - 1 frames.
  SR_BENCH_PLAIN=1     the sequential loop, one 4-step diffusion a frame.
  SR_BENCH_CONTROL=1   sequential + 2 random ControlNets (normal and depth
                       hints from the G-buffer, strength 0.6, seeds 5 and 6):
                       BASELINE config 4, like for like with vs_baseline.
  SR_BENCH_TAESD=1     sequential with the TAESD autoencoder (with_taesd()).
  SR_BENCH_QUICK=1     tiny model, 64x64, sequential (tests, debugging).
  SR_BENCH_STREAM / SR_BENCH_STREAM_KV / SR_BENCH_INT8 = 0|1 override one
  component each; SR_BENCH_FRAMES sets the timed frames (8; quick 4).
  SR_PALLAS_CONV=1     the switched mode on the card: float 3x3 convs to K3
                       (the JAX gate) and GroupNorm to K4, as chip_smoke.py's
                       phase 10 switches them. bench.py's switch routes the
                       convs only: the JAX package keeps its GroupNorm kernel
                       off because it measured slower on the TPU.
Attention takes K1 on the card wherever K/V is 2048 tokens or longer, with no
switch; SR_NO_PALLAS is not read, since the port's plain versions are for
tests only.

  --dp / SR_BENCH_DP=1 bench.py's bake-batched data-parallel mode: the
                       sphere rasterized and packed once into world *
                       ceil(8 / world) frames (the reference's baking
                       interval, at least one a rank), then
                       ``DiffusionPipeline.render`` over a {"dp": world,
                       "tp": 1} mesh timed: one warm submit, then 2 *
                       max(1, SR_BENCH_FRAMES // batch) timed ones. The
                       line's value is frames/s; rank 0 prints it.
Usage:  python bench_torch.py              (the card; raises without one)
        SR_BENCH_QUICK=1 python bench_torch.py --device cpu
        python bench_torch.py --dp         (one rank: one card, NCCL)
        torchrun --nproc-per-node N bench_torch.py --dp   (N cards, one rank a card)
        SR_BENCH_QUICK=1 python bench_torch.py --dp --device cpu   (gloo)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import List, Mapping, Optional

WARM = 2  # warm presents before the timed ones (bench.py)


def resolve_mode(env: Mapping[str, str], argv: List[str]) -> dict:
    """bench.py:55-89's mode resolution from ``env`` and ``argv``: the
    no-knob default is the stream + lag-1 K/V + int8 realtime configuration;
    quick, dp, plain, control and TAESD fall back to the sequential loop;
    each component knob still overrides on its own."""
    quick = env.get("SR_BENCH_QUICK") == "1"
    dp = "--dp" in argv or env.get("SR_BENCH_DP") == "1"
    plain = env.get("SR_BENCH_PLAIN") == "1"
    control = env.get("SR_BENCH_CONTROL") == "1"
    taesd = env.get("SR_BENCH_TAESD") == "1"
    realtime_default = not (quick or dp or plain or control or taesd)

    def knob(name: str, default: bool) -> bool:
        v = env.get(name)
        return default if v is None else v == "1"

    stream = knob("SR_BENCH_STREAM", realtime_default)
    return {
        "quick": quick, "dp": dp, "plain": plain, "control": control, "taesd": taesd,
        "stream": stream, "stream_kv": knob("SR_BENCH_STREAM_KV", realtime_default),
        "int8": knob("SR_BENCH_INT8", realtime_default),
        "switched": env.get("SR_PALLAS_CONV") == "1",
        "frames": int(env.get("SR_BENCH_FRAMES", "4" if quick else "8")),
        "size": 64 if quick else 512,
    }


def metric_name(mode: dict, device_type: str) -> str:
    """bench.py's metric text, with the torch device type in brackets."""
    size = mode["size"]
    return (f"engine-loop img2img fps @ {size}x{size}, 4-step LCM cfg2"
            + (" 2xcontrol" if mode["control"] else "")
            + (" taesd" if mode["taesd"] else "")
            + (" stream" if mode["stream"] else "")
            + (" stream-kv" if mode["stream_kv"] and mode["stream"] else "")
            + (" int8" if mode["int8"] else "") + f" ({device_type})")


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the bench; print its line and return it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dp", action="store_true",
                        help="bench.py's bake-batched data-parallel mode over every rank")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' for tests)")
    args = parser.parse_args(argv)
    mode = resolve_mode(os.environ, argv)
    if mode["dp"]:
        return dp_main(args.device, mode)

    import torch

    from stable_renderer_tpu_torch.device import keep_f32, resolve_device, tf32_switches
    from stable_renderer_tpu_torch.engine import (
        AutoRotation,
        Camera,
        Engine,
        GameObject,
        Mesh,
        MeshRenderer,
        SpriteInfo,
    )
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig

    device = resolve_device(args.device)
    keep_f32()
    print(f"# {tf32_switches()}", file=sys.stderr, flush=True)
    if mode["switched"] and device.type != "cpu":
        from stable_renderer_tpu_torch.models import layers
        from stable_renderer_tpu_torch.ops.conv_kernel import use_pallas_conv

        use_pallas_conv(True)
        layers._group_norm_pallas_on = True
    size, n_frames = mode["size"], mode["frames"]
    cfg = RenderConfig(
        prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform",
        denoise=1.0, realtime_taesd=mode["taesd"], stream_pipeline=mode["stream"],
        int8_conv=mode["int8"],
        stream_kv_layers=(6,) if (mode["stream"] and mode["stream_kv"]) else None,
    )
    pipe = DiffusionPipeline.from_random(cfg, tiny=mode["quick"], device=device)
    if mode["control"]:
        pipe.add_random_controlnet(ControlNetSpec(source="normal", strength=0.6), seed=5)
        pipe.add_random_controlnet(ControlNetSpec(source="depth", strength=0.6), seed=6)
    if mode["taesd"]:
        pipe.with_taesd()
    # segment bound: the next power of two over the scene's 2401 vertex ids
    corresponder = OverlapCorresponder(
        vertex_segments=size * size if mode["quick"] else 4096, update_corrmap=False)

    class BenchApp(Engine):
        def beforePrepare(self):
            cam = GameObject("camera")
            cam.addComponent(Camera).env_prompt.prompt = "a ball"
            cam.transform.position = [0.0, 0.5, 3.0]
            cam.transform.lookAt([0.0, 0.0, 0.0])
            obj = GameObject("ball")
            obj.addComponent(SpriteInfo, prompt="a shiny ball")
            obj.addComponent(MeshRenderer, mesh=Mesh.Sphere(1.0, 48))
            obj.addComponent(AutoRotation, speed_deg=4.0)

    presented = []

    def cb(frame, idx):
        presented.append((time.perf_counter(), idx, frame.dtype.str, frame.shape))

    depth = max(1, int(os.environ.get("SR_PRESENT_DEPTH", "2")))  # RenderManager's
    total = n_frames + WARM + depth
    t0 = time.perf_counter()
    Engine._reset()
    BenchApp.Run(winSize=(size, size), pipeline=pipe, corresponder=corresponder,
                 frame_callback=cb, max_frames=total)
    if [p[1] for p in presented] != list(range(total)):
        raise RuntimeError(f"presented {[p[1] for p in presented]}, want {total} frames")
    timed = presented[WARM - 1:WARM + n_frames]
    compile_s = timed[0][0] - t0
    dt = timed[-1][0] - timed[0][0]
    fps = n_frames / dt
    gaps = [(b[0] - a[0]) * 1e3 for a, b in zip(timed, timed[1:])]
    p90 = statistics.quantiles(gaps, n=10, method="inclusive")[-1] if len(gaps) > 1 else gaps[0]
    line = {"metric": metric_name(mode, device.type), "value": round(fps, 3), "unit": "fps",
            "vs_baseline": round(fps / 2.5, 3)}
    print(json.dumps(line), flush=True)
    print(f"# compile {compile_s:.1f}s, {n_frames} frames in {dt:.2f}s, device={device}"
          f"{' ' + torch.cuda.get_device_name(device) if device.type == 'cuda' else ''}, "
          f"frame0={presented[0][1:]}", file=sys.stderr)
    print(f"# present-to-present ms over the {n_frames} timed frames: median "
          f"{statistics.median(gaps):.2f}, p90 {p90:.2f}", file=sys.stderr, flush=True)
    return line


def dp_batch(size: int, batch: int, device):
    """bench.py's --dp batch: the 48-segment sphere from (0, 0.5, 3) in
    BAKING mode, rasterized and packed ``batch`` times (K2 once a frame on
    the card), with a (256, 256, 4) noise texture and background noise from
    generators seeded 3 and 7."""
    import torch

    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.data.framebuffers import GBuffer
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import (
        _draw_pass,
        mesh_device_buffers,
        pack_frame_data,
    )
    from stable_renderer_tpu_torch.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms
    from stable_renderer_tpu_torch.ops.transforms import look_at, perspective, translate

    buffers = mesh_device_buffers(Mesh.Sphere(1.0, 48), device)
    view = look_at([0.0, 0.5, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    proj = perspective(45.0, 1.0, 0.1, 100.0).to(device)
    uniforms = DrawUniforms(sprite_id=1, material_id=1, render_mode=RENDER_MODE_BAKING,
                            corrmap_k=3)
    bg_noise = torch.randn((1, size, size, 4), device=device,
                           generator=torch.Generator(device=device).manual_seed(7))
    noise_tex = torch.randn((256, 256, 4), device=device,
                            generator=torch.Generator(device=device).manual_seed(3))
    mv = (view @ translate([0.0, 0.0, 0.0])).to(device)
    packs = []
    for i in range(batch):
        gbuf = GBuffer.empty(size, size, device=device)
        zbuf = torch.ones((size, size), dtype=torch.float32, device=device)
        gbuf, _ = _draw_pass(gbuf, zbuf, buffers, mv, proj, uniforms, size, size,
                             noise=noise_tex)
        packs.append(pack_frame_data(gbuf, bg_noise, i))
    return EngineData(
        frame_indices=torch.arange(batch, device=device),
        color_maps=torch.stack([p["color"] for p in packs]),
        id_maps=torch.stack([p["id"] for p in packs]),
        noise_maps=torch.stack([p["noise"] for p in packs]),
    )


def dp_main(device_arg: Optional[str], mode: dict) -> dict:
    """bench.py's --dp mode (bench.py:137-200) over every rank of the
    process group (``init_distributed``: torchrun's world, or one rank).
    Returns the line on every rank; rank 0 prints it."""
    import math

    import torch
    import torch.distributed as dist

    from stable_renderer_tpu_torch.device import keep_f32, tf32_switches
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.parallel import create_mesh, init_distributed
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    started = not dist.is_initialized()
    device = init_distributed(device_arg)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        keep_f32()
        if rank == 0:
            print(f"# {tf32_switches()}", file=sys.stderr, flush=True)
        size, n_frames = mode["size"], mode["frames"]
        batch = world * max(1, math.ceil(8 / world))
        mesh = create_mesh({"dp": world, "tp": 1})
        cfg = RenderConfig(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm",
                           scheduler="sgm_uniform", denoise=1.0)
        pipe = DiffusionPipeline.from_random(cfg, tiny=mode["quick"], device=device)
        corresponder = OverlapCorresponder(
            vertex_segments=size * size if mode["quick"] else 4096, update_corrmap=False)
        ed = dp_batch(size, batch, device)

        def submit(seed: int):
            key = torch.Generator(device=device).manual_seed(seed)
            out = pipe.render(ed, corresponder=corresponder, key=key, mesh=mesh)
            out[0, 0, 0, 0].item()  # wait for the frames
            return out

        t0 = time.perf_counter()
        submit(0)
        compile_s = time.perf_counter() - t0
        iters = max(1, n_frames // batch) * 2
        t0 = time.perf_counter()
        for i in range(iters):
            submit(i)
        dt = time.perf_counter() - t0
        fps = iters * batch / dt
        line = {"metric": f"bake-batched img2img frames/s @ {size}x{size}, 4-step LCM cfg2, "
                          f"batch={batch}, dp={world} ({device.type})",
                "value": round(fps, 3), "unit": "frames/s", "vs_baseline": round(fps / 2.5, 3)}
        if rank == 0:
            print(json.dumps(line), flush=True)
            print(f"# compile {compile_s:.1f}s, {iters}x{batch} frames in {dt:.2f}s, "
                  f"{world} rank(s), device={device}"
                  f"{' ' + torch.cuda.get_device_name(device) if device.type == 'cuda' else ''}",
                  file=sys.stderr, flush=True)
        return line
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
