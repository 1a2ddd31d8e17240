#!/usr/bin/env python3
"""Where the PyTorch port's 512x512 frame spends its time, on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/profile_torch_frame.py [--frames N] [--int8 | --switched] [--stream]
        [--control] [--out result.json]

Builds the bench frame of chip_smoke.py (full SD1.5 widths, random bf16
weights, 4-step LCM, cfg 2.0, OverlapCorresponder, 512x512; with --int8 the
calibrated int8 convs of RenderConfig(int8_conv=True), whose 3x3 convs run on
the K3 kernel; with --switched the bf16 frame with the float K3 switch and the
K4 switch on, as chip_smoke.py phase 10 runs it; with --stream the stream
program of RenderConfig(stream_pipeline=True, stream_kv_layers=(6,)), as
chip_smoke.py phase 12 runs it, in bf16 or with --int8; with --control two
random ControlNets with perturbed zero convs, normal and depth hints at
strength 0.6, as chip_smoke.py phase 13 runs them), runs one warm frame (the
stream: S warm frames, so that every stage is filled), then N frames under
CUDA-event stage timers and one frame under torch.profiler. Prints and
writes:
  * per-stage time per frame (raster + G-buffer, pack, VAE encode, the
    ControlNets' hint towers and their trunks, the UNet evaluations, VAE
    decode, the rest; means) from CUDA events around the
    stages — stream time between the events, so it includes the device's
    idle gaps while the host enqueues that stage;
  * host wall time per frame (median and max), and the device busy share:
    one profiled frame's summed kernel time over the unprofiled median wall
    time;
  * the kernels with the most device time, by name; the device operations
    (kernels, copies, sets) the profiled frame launched, and among them the
    layout-copy kernels (names with "copy"); K1's kernels (names with
    "flash_") in time and launches; K3's kernels, the GEMM and the prep pass
    apart (every kernel of csrc/conv3x3.cu), in time and launches; K2's
    (csrc/raster_tile.cu: the setup and the binned tile kernel, or an older
    tree's raster_tile) and K4's (csrc/group_norm.cu: gn_cluster, or an older
    tree's gn_partial, gn_finalize and gn_apply), in time and launches;
  * with --int8, from one more frame: how many int8 conv calls met an input
    beyond their calibrated range (max|x| > 127.5 * a_scale, so that values
    clip at +-127), and the largest ratio of max|x| to the calibrated max.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--int8", action="store_true",
                    help="the calibrated int8 frame (RenderConfig(int8_conv=True))")
    ap.add_argument("--switched", action="store_true",
                    help="the bf16 frame with use_pallas_conv(True) and _group_norm_pallas_on")
    ap.add_argument("--stream", action="store_true",
                    help="the stream program, lag-1 K/V at transformer 6 (bench.py's default "
                         "mode with --int8)")
    ap.add_argument("--control", action="store_true",
                    help="two perturbed ControlNets, normal and depth, strength 0.6")
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]

    import chip_smoke
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine import frame_program, render_exec
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams
    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig

    dev = torch.device("cuda", 0)
    if args.int8 and args.switched:
        sys.exit("--int8 and --switched are two frames: choose one")
    if args.switched:
        from stable_renderer_tpu_torch.models import layers
        from stable_renderer_tpu_torch.ops.conv_kernel import use_pallas_conv

        use_pallas_conv(True)
        layers._group_norm_pallas_on = True
    cfg = RenderConfig(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm",
                       scheduler="sgm_uniform", int8_conv=args.int8,
                       stream_pipeline=args.stream, stream_kv_layers=(6,) if args.stream else ())
    t0 = time.perf_counter()
    pipe = DiffusionPipeline.from_random(cfg, tiny=False, device=dev)
    if args.control:
        for source, seed in (("normal", 5), ("depth", 6)):
            chip_smoke.perturbed_controlnet(pipe, ControlNetSpec(source=source, strength=0.6),
                                            seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    corr = OverlapCorresponder(vertex_segments=4096, update_corrmap=False)
    bg = torch.randn((1, 512, 512, 4), generator=torch.Generator(device=dev).manual_seed(7),
                     device=dev)
    sphere = Mesh.Sphere(1.0, 48)
    sigs = ((DrawUniforms(sprite_id=1, material_id=1), (512, 512), None, None),)
    sprites, env = {1: Sprite(spriteID=1, prompt="a shiny ball")}, (EnvPrompt("a ball"),)

    # CUDA-event timers around the stages (events on the current stream)
    spans = defaultdict(list)
    active = {"on": False}

    def timed(name, fn):
        def wrapper(*a, **kw):
            if not active["on"]:
                return fn(*a, **kw)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            with torch.profiler.record_function(name):
                out = fn(*a, **kw)
            e.record()
            spans[name].append((s, e))
            return out
        return wrapper

    frame_program._draw_pass = timed("raster+gbuffer", render_exec._draw_pass)
    frame_program._pack_arrays = timed("pack", render_exec._pack_arrays)
    pipe.vae.encode = timed("vae_encode", pipe.vae.encode)
    pipe.vae.decode = timed("vae_decode", pipe.vae.decode)
    pipe.unet.apply = timed("unet_eval", pipe.unet.apply)
    for cn, _, _ in pipe.controlnets:
        cn.apply_hint = timed("hint_tower", cn.apply_hint)
        cn.apply = timed("controlnet", cn.apply)
    cn_sources = tuple(spec.source for _, _, spec in pipe.controlnets)
    stream = {"state": None, "kv": None}

    def frame(i):
        mv, proj = chip_smoke.bench_matrices(i)
        draws = (dict(buffers=render_exec.mesh_device_buffers(sphere, dev), mv=mv, diffuse=None,
                      noise=None, corrmap=None),)
        _, ctx, nctx, _, _ = pipe.prepare_conditioning(sprites, env, 1)
        key = torch.Generator(device=dev).manual_seed(cfg.seed + i)
        out = frame_program.frame_step(
            pipe, corr, (), sigs, 512, 512, True, False, PostProcessParams(), cn_sources, True,
            draws, proj, bg, None, ctx, nctx, pipe.scheduler_sigmas(), key,
            *pipe.compute_params(), stream_state=stream["state"],
            stream_init=args.stream and stream["state"] is None, stream_kv=stream["kv"])
        if args.stream:
            stream["state"], stream["kv"] = out[4], out[5]
        return out[0].cpu()

    warm = cfg.steps if args.stream else 1
    for i in range(warm):
        frame(i)
    torch.cuda.synchronize()
    active["on"] = True
    walls, totals = [], []
    for i in range(args.frames):
        fs, fe = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        fs.record()
        frame(warm + i)
        fe.record()
        fe.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        totals.append(fs.elapsed_time(fe))
    active["on"] = False
    per_frame = {k: sum(s.elapsed_time(e) for s, e in v) / args.frames for k, v in spans.items()}
    per_frame["rest (CLIP cache hit, sampler math, defer/post, uint8, readback)"] = (
        statistics.mean(totals) - sum(per_frame.values()))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame(warm + args.frames)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels = []
    device_us = 0.0
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and ev.device_type.name == "CUDA":
            kernels.append((dt / 1e3, ev.count, ev.key))
            device_us += dt
    k1 = [(ms, n) for ms, n, k in kernels if "flash_" in k]
    kernels.sort(reverse=True)
    clipping = None
    if args.int8:
        from stable_renderer_tpu_torch.models import layers, quant

        seen = []
        k3, conv_q = layers.conv3x3_kernel, quant.conv2d_q

        def ratio(x, a_scale):
            seen.append((x.float().abs().amax() / (127.5 * a_scale.float())).item())

        def k3_rec(x, w, bias=None, **kw):
            if kw.get("a_scale") is not None:
                ratio(x, kw["a_scale"])
            return k3(x, w, bias, **kw)

        def conv_q_rec(p, x, stride=1, padding=0):
            if "a_scale" in p:
                ratio(x, p["a_scale"])
            return conv_q(p, x, stride=stride, padding=padding)

        layers.conv3x3_kernel, quant.conv2d_q = k3_rec, conv_q_rec
        frame(warm + 1 + args.frames)
        layers.conv3x3_kernel, quant.conv2d_q = k3, conv_q
        clipping = {"int8_conv_calls": len(seen), "calls_clipping": sum(r > 1 for r in seen),
                    "max_ratio_to_calibrated": max(seen)}
    # every kernel csrc/conv3x3.cu launches: the GEMM (conv3x3_wgmma; an
    # older tree's conv3x3_igemm) and the prep pass of int8 mode and the
    # prologue (prep_act)
    k3_gemm = [(ms, n) for ms, n, k in kernels if "conv3x3_wgmma" in k or "conv3x3_igemm" in k]
    k3_prep = [(ms, n) for ms, n, k in kernels if "prep_act" in k]
    k2_names = ("raster_setup", "raster_binned", "raster_tile")
    k4_names = ("gn_cluster", "gn_partial", "gn_finalize", "gn_apply")
    k2 = [(ms, n) for ms, n, k in kernels if any(m in k for m in k2_names)]
    k4 = [(ms, n) for ms, n, k in kernels if any(m in k for m in k4_names)]
    result = {
        "card": card,
        "mode": " ".join(["int8" if args.int8 else "bf16"] + ["switched"] * args.switched
                         + ["stream"] * args.stream + ["control"] * args.control),
        "from_random_s": setup_s,
        "frames": args.frames,
        "wall_ms_median": statistics.median(walls),
        "wall_ms_max": max(walls),
        "event_ms_mean": statistics.mean(totals),
        "stage_ms_per_frame": per_frame,
        "unet_evals_per_frame": len(spans["unet_eval"]) / args.frames,
        "controlnet_evals_per_frame": len(spans["controlnet"]) / args.frames,
        "hint_tower_runs_per_frame": len(spans["hint_tower"]) / args.frames,
        "profiled_frame_wall_ms": prof_wall,
        "profiled_device_ms": device_us / 1e3,
        # kernel time of one frame over the frame's wall time without the
        # profiler (the profiled frame's own wall time includes its overhead)
        "device_busy_share": device_us / 1e3 / statistics.median(walls),
        "k3_kernel_ms_per_frame": sum(ms for ms, _ in k3_gemm + k3_prep),
        "k3_gemm_ms_per_frame": sum(ms for ms, _ in k3_gemm),
        "k3_prep_ms_per_frame": sum(ms for ms, _ in k3_prep),
        "k3_kernels_per_frame": {"gemm": sum(n for _, n in k3_gemm),
                                 "prep": sum(n for _, n in k3_prep)},
        "k1_kernel_ms_per_frame": sum(ms for ms, _ in k1),
        "k1_kernels_per_frame": sum(n for _, n in k1),
        "k2_kernel_ms_per_frame": sum(ms for ms, _ in k2),
        "k2_kernels_per_frame": sum(n for _, n in k2),
        "k4_kernel_ms_per_frame": sum(ms for ms, _ in k4),
        "k4_kernels_per_frame": sum(n for _, n in k4),
        "k2_k4_kernels": [{"ms": round(ms, 4), "calls": n, "name": k[:80]}
                          for ms, n, k in kernels if any(m in k for m in k2_names + k4_names)],
        "device_ops_per_frame": sum(n for _, n, _ in kernels),
        "copy_kernels_per_frame": sum(n for _, n, k in kernels if "copy" in k.lower()),
        "int8_clipping": clipping,
        "top_kernels_ms": [{"ms": round(ms, 3), "calls": n, "name": k[:120]}
                           for ms, n, k in kernels[:25]],
    }
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
