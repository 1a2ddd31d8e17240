#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stable_renderer_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device   — require CUDA, print the card's name and power limit, set and
                print the TF32 switches (both off: f32 stays f32).
  2. build    — compile the CUDA kernels in csrc/ into build/kernels/.
  3. K1       — flash attention kernel vs its plain version at the frame's
                shapes (bf16), one ragged K/V length, and f32 checks.
  4. K2       — tile rasterizer vs its plain version at 512x512 on the bench
                sphere.
  5. reference — a tiny pipeline's 128x128 frame on the GPU (both kernels) vs
                the same frame's diffusion on the CPU plain path.
  6. frame    — the bench frame at full SD1.5 widths (random bf16 weights),
                1 warm + 4 timed frames of frame_step at 512x512, with the
                kernels' launch counts checked.
The last lines are the kernels' JSON summary, the nvidia-smi line and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SIZE = 512
FRAMES_TIMED = 4
K1_CALLS_PER_FRAME = 22  # 5 level-0 self-attentions x 4 steps + VAE encode + decode
K1_BF16_TOL = 1e-2  # bf16 output rounding (2^-8 relative) + the plain path's bf16 softmax weights
K1_F32_TOL = 1e-4   # f32: summation order only
REF_TOL = 2e-3      # tiny f32 frame, GPU kernels vs CPU plain path (order of f32 sums)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bench_matrices(frame: int):
    """Bench scene (bench.py:229-236): camera at (0, 0.5, 3) looking at the
    origin, fov 45, near 0.1, far 100; the ball turned 4 degrees per frame
    about +y. Returns (model-view, projection) as float32 numpy."""
    import numpy as np

    from stable_renderer_tpu_torch.ops.transforms import look_at, perspective, quat_to_matrix

    view = look_at([0.0, 0.5, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]).numpy()
    half = math.radians(4.0 * (frame + 1)) / 2.0
    model = quat_to_matrix([math.cos(half), 0.0, math.sin(half), 0.0]).numpy()
    return (view @ model).astype(np.float32), perspective(45.0, 1.0, 0.1, 100.0).numpy()


def main() -> None:
    import torch

    # --- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on a GPU")
    try:
        import stable_renderer_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the repository root")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} | nvidia-smi: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # --- 2. build ------------------------------------------------------------
    from stable_renderer_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.load_library()
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'ran' if _build.build_seconds is not None else 'skipped: cached'})", flush=True)

    from stable_renderer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from stable_renderer_tpu_torch.ops.raster import rasterize
    from stable_renderer_tpu_torch.ops.raster_kernel import rasterize_kernel

    # --- 3. K1 ---------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    k1 = {"name": "flash_attention", "route": "cuda",
          "source": "stable_renderer_tpu_torch/csrc/flash_attention.cu",
          "replaces": "stable_renderer_tpu/ops/flash_attention.py:38", "shapes": []}
    k1_err = 0.0
    cases = [((16, 4096, 4096, 40), torch.bfloat16, K1_BF16_TOL),   # UNet level 0
             ((1, 4096, 4096, 512), torch.bfloat16, K1_BF16_TOL),   # VAE mid block
             ((16, 4096, 2100, 40), torch.bfloat16, K1_BF16_TOL),   # ragged K/V tile
             ((4, 257, 2100, 40), torch.float32, K1_F32_TOL),
             ((2, 130, 333, 512), torch.float32, K1_F32_TOL)]
    for (bh, lq, lk, d), dt, tol in cases:
        q = torch.randn((bh, lq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((bh, lk, d), generator=gen, device=dev).to(dt)
        v = torch.randn((bh, lk, d), generator=gen, device=dev).to(dt)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        if not math.isfinite(err) or err > tol:
            fail(f"K1 {dt} (bh={bh}, lq={lq}, lk={lk}, d={d}): max abs err {err:.3e} > {tol:g}")
        row = {"shape": f"bh={bh} lq={lq} lk={lk} d={d} {str(dt).replace('torch.', '')}",
               "max_abs_err": err}
        if dt == torch.bfloat16:
            k1_err = max(k1_err, err)
            row["ms"] = cuda_ms(lambda: flash_attention(q, k, v), 10)
            row["plain_ms"] = cuda_ms(lambda: flash_attention_reference(q, k, v), 10)
        k1["shapes"].append(row)
        print(f"[3 K1] {row} (tol {tol:g})", flush=True)
        del q, k, v, out, ref
    main_shape = k1["shapes"][0]
    k1.update(max_abs_err=k1_err, ms=main_shape["ms"], plain_ms=main_shape["plain_ms"])

    # --- 4. K2 ---------------------------------------------------------------
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.raster import vertex_stage

    sphere = Mesh.Sphere(1.0, 48)
    bufs = mesh_device_buffers(sphere, dev)
    mv, proj = bench_matrices(0)
    clip, _, _ = vertex_stage(bufs["positions"], bufs["normals"], torch.from_numpy(mv).to(dev),
                              torch.from_numpy(proj).to(dev))
    vis = rasterize_kernel(clip, bufs["tris"], SIZE, SIZE, cull_backface=True)
    torch.cuda.synchronize()
    ref = rasterize(clip, bufs["tris"], SIZE, SIZE, cull_backface=True)
    cov, ref_cov = vis.tri_id >= 0, ref.tri_id >= 0
    both = cov & ref_cov
    cov_diff = (cov != ref_cov).float().mean().item()
    same_tri = (vis.tri_id == ref.tri_id)[both]
    bary_ok = torch.isclose(vis.bary[both], ref.bary[both], atol=1e-3).all(-1)[same_tri]
    z_err = (vis.z[both] - ref.z[both]).abs().max().item()
    # the bars of tests/test_raster_pallas.py:38-50
    if not (0 < both.sum().item() and cov_diff < 0.005 and same_tri.float().mean() > 0.98
            and bary_ok.float().mean() > 0.98 and z_err < 1e-4):
        fail(f"K2 disagrees: coverage differs on {cov_diff:.4%}, same tri "
             f"{same_tri.float().mean():.4f}, bary {bary_ok.float().mean():.4f}, z err {z_err:.2e}")
    k2 = {"name": "rasterize_kernel", "route": "cuda",
          "source": "stable_renderer_tpu_torch/csrc/raster_tile.cu",
          "replaces": "stable_renderer_tpu/ops/raster_pallas.py:99",
          "max_abs_err": z_err,
          "ms": cuda_ms(lambda: rasterize_kernel(clip, bufs["tris"], SIZE, SIZE,
                                                 cull_backface=True), 20),
          "plain_ms": cuda_ms(lambda: rasterize(clip, bufs["tris"], SIZE, SIZE,
                                                cull_backface=True), 5, warmup=1),
          "coverage_diff": cov_diff, "same_tri": same_tri.float().mean().item(),
          "bary_agree": bary_ok.float().mean().item()}
    print(f"[4 K2] {k2} ({bufs['tris'].shape[0]} triangles)", flush=True)

    # --- 5. small-input reference --------------------------------------------
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine.frame_program import frame_step
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    cfg = RenderConfig(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm",
                       scheduler="sgm_uniform")
    sprites = {1: Sprite(spriteID=1, prompt="a shiny ball")}
    env = (EnvPrompt("a ball"),)
    sigs = ((DrawUniforms(sprite_id=1, material_id=1), (512, 512), None, None),)
    pp = PostProcessParams()

    def run_frame(pipe, size, frame, corr, bg, step_noise=None):
        d = pipe.device
        mv, proj = bench_matrices(frame)
        draws = (dict(buffers=mesh_device_buffers(sphere, d), mv=mv, diffuse=None, noise=None,
                      corrmap=None),)
        _, ctx, nctx, _, _ = pipe.prepare_conditioning(sprites, env, 1)
        key = torch.Generator(device=d).manual_seed(cfg.seed + frame)
        return frame_step(pipe, corr, (), sigs, size, size, True, False, pp, (), True, draws,
                          proj, bg, None, ctx, nctx, pipe.scheduler_sigmas(), key,
                          *pipe.compute_params(), step_noise=step_noise)

    small = 128
    tiny_gpu = DiffusionPipeline.from_random(cfg, tiny=True, device=dev)
    tiny_cpu = DiffusionPipeline.from_random(cfg, tiny=True, device="cpu")
    tiny_cpu.unet_params, tiny_cpu.vae_params, tiny_cpu.clip_params = (
        _to_cpu(tiny_gpu.unet_params), _to_cpu(tiny_gpu.vae_params), _to_cpu(tiny_gpu.clip_params))
    corr_small = OverlapCorresponder(vertex_segments=small * small, update_corrmap=False)
    bg_small = torch.randn((1, small, small, 4), generator=gen, device=dev)
    lat = (1, small // 2, small // 2, 4)  # tiny VAE downsamples by 2
    noise = [torch.randn(lat, generator=gen, device=dev) for _ in range(cfg.steps)]
    launches0 = (flash_attention.launches, rasterize_kernel.launches)
    disp, gbuf, pack, images, _, _ = run_frame(tiny_gpu, small, 0, corr_small, bg_small, noise)
    torch.cuda.synchronize()
    if flash_attention.launches - launches0[0] < 1 or rasterize_kernel.launches - launches0[1] != 1:
        fail("the small reference frame did not go through both kernels")
    _, ctx_c, nctx_c, _, _ = tiny_cpu.prepare_conditioning(sprites, env, 1)
    ref_images = tiny_cpu._render(
        corr_small, (), tiny_cpu.unet_params, tiny_cpu.vae_params, (),
        pack["color"][None].cpu(), pack["noise"][None].cpu(), pack["id"][None].cpu(), (),
        ctx_c, nctx_c, tiny_cpu.scheduler_sigmas(), None, normal_maps=pack["normal"][None].cpu(),
        step_noise=[n.cpu() for n in noise])
    ref_err = (images.cpu() - ref_images).abs().max().item()
    if not (torch.isfinite(images).all() and ref_err < REF_TOL):
        fail(f"small frame: GPU vs CPU plain path max abs err {ref_err:.3e} >= {REF_TOL}")
    print(f"[5 reference] tiny pipeline {small}x{small}: GPU (K1 + K2) vs CPU plain "
          f"max abs err {ref_err:.3e} (tol {REF_TOL})", flush=True)
    del tiny_gpu, tiny_cpu

    # --- 6. the frame ------------------------------------------------------------
    pipe = DiffusionPipeline.from_random(cfg, tiny=False, device=dev)
    corr = OverlapCorresponder(vertex_segments=4096, update_corrmap=False)
    bg = torch.randn((1, SIZE, SIZE, 4), generator=torch.Generator(device=dev).manual_seed(7),
                     device=dev)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    rasterize_kernel.launches = 0
    times, displays = [], []
    for f in range(1 + FRAMES_TIMED):
        t0 = time.perf_counter()
        disp, gbuf, pack, images, _, _ = run_frame(pipe, SIZE, f, corr, bg)
        host = disp.cpu()  # the present's readback
        times.append((time.perf_counter() - t0) * 1e3)
        displays.append(host)
        if not torch.isfinite(images).all():
            fail(f"frame {f}: non-finite decoded image")
    k1["launches"], k2["launches"] = flash_attention.launches, rasterize_kernel.launches
    n_frames = 1 + FRAMES_TIMED
    if k1["launches"] != K1_CALLS_PER_FRAME * n_frames or k2["launches"] != n_frames:
        fail(f"launch counts over {n_frames} frames: K1 {k1['launches']} (want "
             f"{K1_CALLS_PER_FRAME * n_frames}), K2 {k2['launches']} (want {n_frames})")
    for f, host in enumerate(displays):
        if host.shape != (SIZE, SIZE, 4) or host.dtype != torch.uint8:
            fail(f"frame {f}: display {tuple(host.shape)} {host.dtype}")
        if int(host[..., :3].max()) == int(host[..., :3].min()):
            fail(f"frame {f}: constant display")
    ms = statistics.median(times[1:])
    print(f"[6 frame] {SIZE}x{SIZE} SD1.5 widths bf16, 4-step LCM cfg 2.0, sequential: "
          f"median {ms:.1f} ms/frame ({1e3 / ms:.2f} fps) over {FRAMES_TIMED} frames, warm frame "
          f"{times[0]:.1f} ms; K1 {k1['launches']} and K2 {k2['launches']} launches in "
          f"{n_frames} frames; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}", flush=True)

    print(json.dumps({"kernels": [k1, k2], "frame_ms": ms, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


if __name__ == "__main__":
    main()
