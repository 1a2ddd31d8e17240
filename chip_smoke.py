#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stable_renderer_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device   — require CUDA, print the card's name and power limit, set and
                print the TF32 switches (both off: f32 stays f32).
  2. build    — compile the CUDA kernels in csrc/ into build/kernels/ with
                ptxas's report (-Xptxas -v), which must name K3's kernels
                and show no serialized wgmma (C7510-C7515) in any kernel.
  3. K1       — flash attention kernel vs its plain version at the frame's
                shapes (bf16), one ragged K/V length, f32 checks, and
                attention_pallas on the UNet's fused-QKV chunk views (read in
                place) at batch 2 (the sequential frame) and 8 (the stream
                frame), and on an unaligned view (copied by the wrapper).
  4. K2       — the setup kernel and the binned tile kernel (two launches a
                call, by torch.profiler) at 512x512, bit for bit against their
                plain versions (triangle_setup, tile_ranges,
                rasterize_tiles_reference) on the bench sphere and on a
                triangle soup (raster_soup), and the bench sphere against the
                plain rasterize at the bars of tests/test_raster_pallas.py.
  5. reference — a tiny pipeline's 128x128 frame on the GPU (both kernels) vs
                the same frame's diffusion on the CPU plain path; then three
                tiny stream frames (a perturbed ControlNet's hints and the id
                maps riding the state, lag-1 K/V) and a tiny frame with a
                perturbed ControlNet, each on the GPU against the CPU.
  6. frame    — the bench frame at full SD1.5 widths (random bf16 weights),
                1 warm + 4 timed frames of frame_step at 512x512, with the
                kernels' launch counts checked.
  7. K3       — the fused 3x3 conv kernel vs its plain version at every shape
                class of the int8 frame and of the int8 stream frame (int8,
                bit for bit), of the switched frame (bf16, with the
                GroupNorm+SiLU prologue where the frame has it); nine of
                them timed (K3_TIMED_SHAPES) and the stream frame's two
                largest classes by launches x bytes. Each timed row's
                launches a frame by shape class are read on the card in
                phases 9, 10 and 12 (k3_shape_tally).
  8. K4       — the one-launch GroupNorm kernel vs its plain version at every
                shape class of the switched frame (K4_SWITCHED_FRAME_SHAPES),
                two calls bit-identical, the cluster held by the card; three
                shapes timed (K4_TIMED_SHAPES), one kernel a call.
  9. int8     — the calibrated int8 frame: RenderConfig(int8_conv=True) ->
                from_random -> quantize_convs, 1 warm + 4 timed 512x512
                frames; K1, K2 and K3 launch counts checked, K3's also by
                shape class; the decoded image
                against phase 6's bf16 frame at the same inputs, and one UNet
                evaluation against the bf16 UNet.
 10. switches — one bf16 frame with the float K3 switch and the K4 switch on;
                launch counts checked (K3's by shape class); the image
                against phase 6's frame.
 11. engine   — the bench scene through the port's entry point, Engine.Run
                (bench.py:216-251's BenchApp, debug=True, so a failing manager
                raises), with phase 6's bf16 and phase 9's int8 pipelines:
                2 warm + 4 timed presented frames each (and PRESENT_DEPTH more,
                so every timed present happens in a steady frame), each
                presented frame (512, 512, 4) uint8 and not constant; the
                launch counts a frame, by the counters over the run and by
                torch.profiler on one frame after a warm one, equal to phases
                6 and 9's (that frame's kernel time over the present-to-
                present median is the device's busy share); the engine's
                first frame identical to frame_step's
                at the same model-view matrix, background noise and generator
                seed; the frame-time median and p90 from the present
                timestamps (bench.py:238-247) beside phase 6's and 9's
                frame_step medians.
 12. stream   — bench.py's default mode: phase 9's int8 pipeline with
                RenderConfig(stream_pipeline=True, stream_kv_layers=(6,)),
                through Engine.Run (S - 1 = 3 transient frames, 2 warm, 4
                timed) and frame_step; launches a stream frame (K1 7, K2 1
                call of 2 kernels, K3 22 + 51), by the counters (K3's also
                by shape class) and by a profiled frame; the engine's first
                frame identical to
                frame_step's stream_init frame; the int8 stream frames
                against a bf16 stream run of the same frames, cosine > 0.9.
 13. control  — bench.py's control mode: phase 6's bf16 pipeline with two
                random ControlNets (normal and depth hints, strength 0.6,
                seeds 5 and 6) through Engine.Run (K1 38 a frame) and
                frame_step: with their zero convs the frame equals phase 6's;
                with them perturbed by a seeded draw it is finite and moves
                by a mean abs above CONTROL_DIFF_FLOOR.
 14. bake     — BASELINE config 1 with diffusion: phase 6's pipeline through
                Engine.Bake of scripts/bake_ball.py's scene (Sphere(1.0, 48)
                with a CorrMapRenderer on CorrespondMap(k=3, 512x512),
                EqualIntervalRotation 22.5 degrees a frame, camera at
                (0, 0, 3)), DefaultCorresponder("first"), baking_interval 8,
                16 frames: two submits of 8 frames at cfg batch 16. K1's
                launches a submit by shape (k1_shape_tally) and in one
                profiled submit frame, K2 one call a frame; written cells
                grow with each submit; submit 1's map equal, exactly, to the
                port's plain update on the CPU fed the same decoded frames
                and id maps; one DefaultCorresponder.finished call makes no
                host sync. The bake's K1 shapes timed.
 15. replay   — BASELINE config 3: the map dumped (zip), loaded back (equal
                on the uint8 grid), and replayed by Engine.Run in GAME mode
                without diffusion (BAKED draws): 2 warm + 8 timed frames
                (present-to-present median, p90, fps); frame 0 within one
                uint8 step of the same replay on the CPU wherever both drew
                the same map cell (the pixels further apart, at raster edges
                where the plain rasterizer and K2 pick another cell, under
                REPLAY_EDGE_SHARE of the ball), and its ball showing the map.
 16. all-frames — cross_frame_attention (K1 on the batch folded into the
                query sequence) at the level-0 shape for 16 frames
                (65,536 tokens) and at the three folded shapes of a bake
                submit, each against its plain version on its first, middle
                and last frame (max abs error within K1_FOLD_REL_TOL of the
                largest |plain output|), timed; then one bake submit
                through frame_step with OverlapCorresponder(all_frames=True,
                layer_range=None): K1's launches by shape, finite frames.
Every kernel line carries its time (K1 in bf16, K2, K3 and K4: device time of
one call, from a CUDA-graph replay that leaves out the host's launch cost,
K2's and K4's over SHORT_CALLS_A_GRAPH calls a graph, with the per-call event
time beside it as ms_with_host), its plain version's
time, the least time the card could take for the same work (the larger of
bytes over 3.35 TB/s and operations over the H100's peak for their type, 700
W data sheet; for K1 also its exponentials over the MUFU pipes' rate) and,
where one PyTorch call computes the same function, that call's time.
The last lines are the kernels' JSON summary, the nvidia-smi line and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

SIZE = 512
FRAMES_TIMED = 4
ENGINE_WARM = 2     # phase 11's warm presented frames (bench.py's warm)
PRESENT_DEPTH = 2   # RenderManager's default SR_PRESENT_DEPTH
# K2's and K4's calls are shorter than the host's cost of replaying a graph,
# so their device time is taken over this many calls a graph (graph_ms)
SHORT_CALLS_A_GRAPH = 10
K1_CALLS_PER_FRAME = 22  # 5 level-0 self-attentions x 4 steps + VAE encode + decode
K1_STREAM_CALLS_PER_FRAME = 7  # the batch-8 UNet's 5 level-0 self-attentions + encode + decode
# the control frame: 22, plus 2 ControlNets x 2 level-0 self-attentions x 4 evaluations
K1_CONTROL_CALLS_PER_FRAME = 38
STREAM_DEPTH = 4  # S = steps frames in flight; the first S - 1 presents are the transient
CONTROL_PERTURB = 0.1  # perturbed zero convs: N(0, 0.1^2 / fan-in) weights, N(0, 0.1^2) biases
CONTROL_DIFF_FLOOR = 1e-3  # perturbed control frame vs phase 6, mean abs on [0, 1] pixels
K1_BF16_TOL = 1e-2  # bf16 output rounding (2^-8 relative) + the plain path's bf16 softmax weights
# all-frames attention spreads each softmax over N*L keys, so its outputs
# shrink like sqrt(e / (N L)) (~0.0064 at 65,536 keys) and an absolute bar
# would be as large as they are: the folded route's max abs error is held to
# this share of the largest |plain output| instead, a few bf16 steps (2^-8)
K1_FOLD_REL_TOL = 2e-2
K1_F32_TOL = 1e-4   # f32: summation order only
REF_TOL = 2e-3      # tiny f32 frame, GPU kernels vs CPU plain path (order of f32 sums)
# K3 and K4 launches a frame, counted on the meta device by
# tests/test_torch_conv_kernel.py: int8 4 x 22 (UNet) + 20 (encode) + 31 (decode);
# with both switches, K3 4 x 11 + 20 + 29 and K4 4 x 43 + 2 + 1
K3_INT8_CALLS_PER_FRAME = 139
K3_UNET_CALLS_PER_EVAL = 22  # int8, one UNet evaluation, any batch
K3_VAE_CALLS_PER_FRAME = 51  # int8, encode + decode
# the stream frame: one UNet evaluation (batch 2S = 8) and the VAE
K3_STREAM_CALLS_PER_FRAME = K3_UNET_CALLS_PER_EVAL + K3_VAE_CALLS_PER_FRAME
K3_SWITCHED_CALLS_PER_FRAME = 93
# K3's shape classes, (N, H, W, Cin, Cout) -> launches a frame, tallied on the
# meta device by the same tests: the int8 frame's 20 classes, and the switched
# frame's 12 (key + True: with the GroupNorm+SiLU prologue)
K3_INT8_FRAME_SHAPES = {
    (1, 128, 128, 512, 512): 10, (1, 512, 512, 128, 128): 9, (1, 256, 256, 256, 256): 8,
    (2, 64, 64, 320, 320): 28, (2, 32, 32, 640, 640): 24, (1, 64, 64, 512, 512): 18,
    (1, 256, 256, 512, 512): 1, (1, 512, 512, 256, 256): 1, (2, 64, 64, 640, 320): 8,
    (2, 64, 64, 640, 640): 4, (2, 32, 32, 1280, 1280): 4, (2, 64, 64, 960, 320): 4,
    (2, 32, 32, 1920, 640): 4, (2, 32, 32, 1280, 640): 4, (2, 32, 32, 960, 640): 4,
    (1, 256, 256, 512, 256): 1, (1, 512, 512, 256, 128): 1, (1, 256, 256, 128, 256): 1,
    (1, 128, 128, 256, 512): 1, (2, 32, 32, 320, 640): 4,
}
# the K3 rows phase 7 times (the int8 frame's largest classes by launches x
# bound, and bf16 yardsticks against cuDNN), as scripts/sweep_torch_conv.py
# --picked-only times them
# the int8 stream frame's classes: the UNet's at batch 8, once; the VAE's as above
K3_STREAM_FRAME_SHAPES = {(8 if k[0] == 2 else k[0],) + k[1:]: v // 4 if k[0] == 2 else v
                          for k, v in K3_INT8_FRAME_SHAPES.items()}
K3_TIMED_SHAPES = [
    ((2, 64, 64, 320, 320), "bf16"), ((1, 512, 512, 128, 128), "bf16+prologue"),
    ((2, 64, 64, 960, 320), "int8"), ((2, 32, 32, 640, 640), "int8"),
    ((1, 512, 512, 128, 128), "int8"), ((1, 128, 128, 512, 512), "int8"),
    ((1, 256, 256, 256, 256), "int8"), ((2, 32, 32, 640, 640), "bf16"),
    ((1, 64, 64, 512, 512), "int8"),
]
K3_SWITCHED_FRAME_SHAPES = {
    (1, 64, 64, 512, 512, True): 18, (1, 128, 128, 256, 512, True): 1,
    (1, 128, 128, 512, 512, False): 1, (1, 128, 128, 512, 512, True): 9,
    (1, 256, 256, 128, 256, True): 1, (1, 256, 256, 256, 256, True): 8,
    (1, 512, 512, 128, 128, True): 9, (1, 512, 512, 256, 128, True): 1,
    (1, 512, 512, 256, 256, False): 1, (2, 64, 64, 320, 320, True): 28,
    (2, 64, 64, 640, 320, True): 8, (2, 64, 64, 640, 640, False): 4,
    (2, 64, 64, 960, 320, True): 4,
}
K4_SWITCHED_CALLS_PER_FRAME = 175
# K4's shape classes in the switched frame, (N, S, C, act) -> launches a frame
# (32 groups each), tallied on the meta device by the same tests
K4_SWITCHED_FRAME_SHAPES = {
    (1, 4096, 512, None): 3, (2, 1024, 1280, "silu"): 4, (2, 1024, 1920, "silu"): 4,
    (2, 1024, 640, "silu"): 24, (2, 1024, 640, None): 20, (2, 256, 1280, "silu"): 24,
    (2, 256, 1280, None): 20, (2, 256, 1920, "silu"): 4, (2, 256, 2560, "silu"): 8,
    (2, 256, 640, "silu"): 4, (2, 64, 1280, "silu"): 44, (2, 64, 1280, None): 4,
    (2, 64, 2560, "silu"): 12,
}
# the K4 rows phase 8 times (bf16 + SiLU)
K4_TIMED_SHAPES = [(2, 1024, 640), (2, 256, 1920), (1, 4096, 512)]
# a profiled run that recorded no device event at all is made again, up to
# this many times in all (device_kernels)
PROFILE_ATTEMPTS = 3
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative
K3_BF16_ATOL = 1e-3    # near zero, where the bf16 step is tiny: f32 sum order
K4_ATOL = 1e-5
INT8_UNET_COS_BAR = 0.99  # int8 vs bf16, one UNet evaluation (the JAX package's bar, tests/test_quant.py:193)
INT8_FRAME_COS_FLOOR = 0.9  # int8 vs bf16 decoded frame: random weights push the frame's
# activations past their calibrated ranges (PERF.md, section 5), so the frame gets a floor only
SWITCH_MEAN_BAR = 0.02  # switched vs unswitched frame, mean abs on [0, 1] pixels
SWITCH_MAX_BAR = 0.25   # ... and max abs
# the bake (scripts/bake_ball.py, BASELINE config 1): baking_interval 8 (the
# reference's diffusionManager.py:37,47), two submits of 8 frames
BAKE_INTERVAL = 8
BAKE_FRAMES = 16
BAKE_PROMPT = "a colorful beach ball, high quality"
# K1 launches a bake submit by (BH, Lq, Lk, d): the batch-16 UNet's (8 frames x
# cfg) 5 level-0 self-attentions x 4 steps, and the batch-8 VAE's mid-block
# attention in encode and decode
K1_BAKE_SHAPES = {(128, 4096, 4096, 40): 20, (8, 4096, 4096, 512): 2}
# a bake submit with OverlapCorresponder(all_frames=True, layer_range=None):
# the hook gets the positive rows (8 frames) of every self-attention, folded
# into one sequence at each level (level 0: 8 x 4096 tokens, level 1: 8 x
# 1024, level 2: 8 x 256; the middle block's 8 x 64 stays plain, under 2048),
# 5 a level in each of 4 evaluations; the negative rows keep per-frame
# attention, which reaches K1 at level 0 only
K1_ALL_FRAMES_SHAPES = {(8, 32768, 32768, 40): 20, (8, 8192, 8192, 80): 20,
                        (8, 2048, 2048, 160): 20, (64, 4096, 4096, 40): 20,
                        (8, 4096, 4096, 512): 2}
# cross_frame_attention rows phase 16 times: (frames, tokens a frame, heads,
# d): the level-0 shape at N = 16 (8 frames x cfg 2), and the three folded
# shapes of the bake submit above (N = 8 positive rows)
CROSS_FRAME_SHAPES = [(16, 4096, 8, 40), (8, 4096, 8, 40), (8, 1024, 8, 80), (8, 256, 8, 160)]
REPLAY_WARM = 2      # phase 15's warm replay frames
REPLAY_TIMED = 8     # ... and timed ones (config 3: 8 frames of free playback)
# replay frame 0 against the CPU replay: the pixels more than one uint8 step
# apart, each in a map cell the two rasterizers chose differently, at most
# this share of the ball's pixels
REPLAY_EDGE_SHARE = 1e-3
# NVIDIA H100 SXM data sheet (700 W): dense tensor-core and FMA peaks, HBM rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12
# exponentials: 16 ex2 a clock on each SM's MUFU pipes x 132 SMs x 1.83 GHz,
# the clock at which the data sheet's 989 TFLOP/s holds (132 SMs x 4 tensor
# cores x 1024 bf16 operations a clock): ~3.9 T exponentials a second
EXP_PER_S = 16 * 132 * 1.83e9


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


def graph_ms(fn, repeats: int = 20, calls: int = 1) -> float:
    """Milliseconds of one call of ``fn`` on the device: ``calls`` calls are
    captured once in a CUDA graph and the graph replayed ``repeats`` times
    between two events, so the host's cost of launching (Python, ctypes,
    allocation) is left out. A replay costs the host a few microseconds
    itself, so for calls shorter than that, capture several a graph
    (``calls``): the calls then run back to back on the device."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture, as graphs need
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(repeats):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (repeats * calls)


def device_kernels(fn, calls: int = 3) -> list:
    """The names of the kernels one call of ``fn`` launches on the card, by
    torch.profiler: a warm-up step of ``calls`` calls, whose events are
    dropped (the tracer can miss the first launches it is given), then
    ``calls`` calls recorded; fails if they did not launch the same kernels.
    A profiled run that recorded no device event at all (the tracer now and
    then records none after CUDA-graph captures) is made again, up to
    PROFILE_ATTEMPTS times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep")]
        if names:
            break
    if len(names) % calls or names != names[:len(names) // calls] * calls:
        fail(f"{calls} calls launched {names}")
    return names[:len(names) // calls]


@contextlib.contextmanager
def k3_shape_tally():
    """K3's launches by shape class inside the ``with`` block, on the card:
    ``models.layers.conv3x3_kernel`` (the frame's one caller of the K3
    wrapper) is wrapped to note each call's (N, H, W, Cin, Cout, prologue),
    and the notes must add up to the wrapper's own launch count over the
    block. Yields the Counter of notes."""
    from stable_renderer_tpu_torch.models import layers

    k3 = layers.conv3x3_kernel
    seen = collections.Counter()

    def noted(x, w, bias=None, **kw):
        seen[tuple(x.shape) + (w.shape[-1], kw.get("pre_scale") is not None)] += 1
        return k3(x, w, bias, **kw)

    before = k3.launches
    layers.conv3x3_kernel = noted
    try:
        yield seen
    finally:
        layers.conv3x3_kernel = k3
    if sum(seen.values()) != k3.launches - before:
        fail(f"K3: {sum(seen.values())} calls noted by shape, {k3.launches - before} launches")


def per_frame_classes(seen: collections.Counter, frames: int, prologue: bool = False) -> dict:
    """``k3_shape_tally``'s notes over ``frames`` frames -> launches a frame
    by class, keyed (N, H, W, Cin, Cout) (with the prologue flag when
    ``prologue``), as chip_smoke's tallies are keyed."""
    out = collections.Counter()
    for k, n in seen.items():
        out[k if prologue else k[:5]] += n
    if any(n % frames for n in out.values()):
        fail(f"K3 launches by class over {frames} frames are not whole per frame: {dict(out)}")
    return {k: n // frames for k, n in out.items()}


@contextlib.contextmanager
def k1_shape_tally():
    """K1's launches by (BH, Lq, Lk, d) inside the ``with`` block, on the
    card: ``ops.flash_attention._launch_bf16`` (the bf16 wrappers' one call
    of the kernel) is wrapped to note each call's shape, and the notes must
    add up to the wrapper's launch count over the block. Yields the Counter."""
    from stable_renderer_tpu_torch.ops import flash_attention as fa

    launch = fa._launch_bf16
    seen = collections.Counter()

    def noted(q, k, v, variant=-1):
        seen[(q.shape[0] * q.shape[2], q.shape[1], k.shape[1], q.shape[3])] += 1
        return launch(q, k, v, variant)

    before = fa.flash_attention.launches
    fa._launch_bf16 = noted
    try:
        yield seen
    finally:
        fa._launch_bf16 = launch
    if sum(seen.values()) != fa.flash_attention.launches - before:
        fail(f"K1: {sum(seen.values())} calls noted by shape, "
             f"{fa.flash_attention.launches - before} launches")


def bound(nbytes: float, ops: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(bh: int, lq: int, lk: int, d: int):
    """(ms, "bytes" | "operations"): K1's least time in bf16, the largest of
    its bytes (q, k, v read once, the output written once), its MMA
    operations (4 bh lq lk d at the tensor cores' peak) and its exponentials
    (bh lq lk on the MUFU pipes, EXP_PER_S)."""
    t_bytes, _ = bound(2.0 * bh * d * (2 * lq + 2 * lk), 0.0, "bf16")
    t_ops = 4.0 * bh * lq * lk * d / PEAK_OPS["bf16"] * 1e3
    t_exp = bh * lq * lk / EXP_PER_S * 1e3
    t = max(t_bytes, t_ops, t_exp)
    return (t, "bytes") if t == t_bytes else (t, "operations")


def _k1_case(row: dict, dt, tol, kernel, plain, library, k1b, compare=None,
             plain_repeats: int = 10) -> float:
    """Run one K1 case: the kernel against its plain version (fails past
    the bar), then for bf16 its device time by graph replay (ms), per call
    with the host's launch cost (ms_with_host), the plain version's (median
    of ``plain_repeats`` calls) and the library call's (SDPA) times and the
    bound. The comparison is ``compare(out)`` -> (max abs err, its bar)
    where given, else the max abs difference from ``plain()`` held to tol.
    Fills row; returns the error."""
    import torch

    out = kernel()
    torch.cuda.synchronize()
    if compare is None:
        err, bar = (out.float() - plain().float()).abs().max().item(), tol
    else:
        err, bar = compare(out)
    if not math.isfinite(err) or err > bar:
        fail(f"K1 {row['shape']}: max abs err {err:.3e} > {bar:.3e}")
    row["max_abs_err"], row["err_bar"] = err, bar
    if dt == torch.bfloat16:
        row["ms"] = graph_ms(kernel)
        row["ms_with_host"] = cuda_ms(kernel, 20)
        row["plain_ms"] = cuda_ms(plain, plain_repeats)
        row["library_ms"] = graph_ms(library)
        row["bound_ms"], row["bound_by"] = k1b
    return err


def raster_soup(height: int, width: int, seed: int = 0, tiny: int = 10_000):
    """A triangle soup in clip space for K2's exactness checks, as float32
    clip positions (V, 4) and int32 triangles (T, 3) in numpy: two
    full-screen triangles at two depths; a triangle drawn twice in one plane,
    and a third in that plane overlapping it (the lowest index must win each
    tie); ``tiny`` triangles of about a pixel inside one 16x16 tile; 300
    triangles of all sizes, depths and both windings with w in [0.5, 2]; 20
    behind the camera; 20 degenerate (collinear)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tris = []  # (3, 4) clip-space triangles

    def add(ndc_xy, z, w=1.0):
        xy = np.asarray(ndc_xy, np.float64).reshape(3, 2)
        z = np.broadcast_to(np.asarray(z, np.float64), (3,))
        w = np.broadcast_to(np.asarray(w, np.float64), (3,))
        tris.append(np.concatenate([xy * w[:, None], (z * w)[:, None], w[:, None]], 1))

    full = [[-1.1, -1.1], [3.5, -1.1], [-1.1, 3.5]]
    add(full, 0.8)
    add(full, 0.6, w=[1.0, 1.5, 0.7])
    pair = [[-0.5, -0.4], [0.45, -0.35], [0.1, 0.5]]
    add(pair, -0.98)  # nearer than the rest, so the ties show
    add(pair, -0.98)
    add([[-0.2, -0.6], [0.6, 0.1], [-0.3, 0.4]], -0.98)
    tx, ty = min(3, (width - 1) // 16), min(2, (height - 1) // 16)
    for _ in range(tiny):
        cx = rng.uniform(16 * tx, min(16 * tx + 16, width))
        cy = rng.uniform(16 * ty, min(16 * ty + 16, height))
        px = cx + rng.uniform(-1.5, 1.5, 3)
        py = cy + rng.uniform(-1.5, 1.5, 3)
        add(np.stack([px / width * 2 - 1, 1 - py / height * 2], 1), rng.uniform(-0.5, 0.5, 3))
    for _ in range(300):
        c = rng.uniform(-1.2, 1.2, 2)
        size = np.exp(rng.uniform(np.log(0.002), np.log(1.5)))
        add(c + rng.normal(size=(3, 2)) * size, rng.uniform(-0.9, 1.2, 3), rng.uniform(0.5, 2, 3))
    for _ in range(20):
        add(rng.uniform(-1, 1, (3, 2)), 0.0, w=[-1.0, 1.0, 1.0])
    for _ in range(20):
        a, b = rng.uniform(-1, 1, (2, 2))
        add(np.stack([a, b, (a + b) / 2]), rng.uniform(0, 1))
    clip = np.concatenate(tris).astype(np.float32)
    return clip, np.arange(len(clip), dtype=np.int32).reshape(-1, 3)


def same_bits(a, b) -> bool:
    """Equal shapes and equal bits (f32 compared as int32)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


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


def bench_scene():
    """The bench scene (bench.py:227-236): camera at (0, 0.5, 3) looking at
    the origin, a 48-segment sphere turned 4 degrees a frame. Returns the
    Camera component and the ball's GameObject."""
    from stable_renderer_tpu_torch.engine import (
        AutoRotation,
        Camera,
        GameObject,
        Mesh,
        MeshRenderer,
        SpriteInfo,
    )

    cam = GameObject("camera")
    camera = cam.addComponent(Camera)
    camera.env_prompt.prompt = "a ball"
    cam.transform.position = [0.0, 0.5, 3.0]
    cam.transform.lookAt([0.0, 0.0, 0.0])
    ball = GameObject("ball")
    ball.addComponent(SpriteInfo, prompt="a shiny ball")
    ball.addComponent(MeshRenderer, mesh=Mesh.Sphere(1.0, 48))
    ball.addComponent(AutoRotation, speed_deg=4.0)
    return camera, ball


def run_engine(pipe, size: int, frames: int, corr, on_frame=None, scene=bench_scene,
               bake: bool = False, **kw):
    """``scene()`` (bench.py's by default) through the port's Engine.Bake
    (``bake``) or Engine.Run with ``debug=True``, its result kept as the
    engine's ``scene``; ``on_frame(engine, "begin" | "end")`` runs at each
    frame's beforeFrameBegin and beforeFrameEnd; ``kw`` goes to the engine.
    Returns the engine and its presents as (host time, frame index, uint8
    frame)."""
    from stable_renderer_tpu_torch.engine import Engine

    class App(Engine):
        def beforePrepare(self):
            self.scene = scene()

        def beforeFrameBegin(self):
            if on_frame is not None:
                on_frame(self, "begin")

        def beforeFrameEnd(self):
            if on_frame is not None:
                on_frame(self, "end")

    presented = []
    Engine._reset()
    eng = (App.Bake if bake else App.Run)(
        winSize=(size, size), pipeline=pipe, corresponder=corr, max_frames=frames, debug=True,
        frame_callback=lambda f, i: presented.append((time.perf_counter(), i, f)), **kw)
    return eng, presented


def host_syncs(fn) -> dict:
    """Where one call of ``fn`` synchronizes the host with the card: the
    caller's file:line of each synchronizing operation, with its count, by
    torch.cuda.set_sync_debug_mode("warn")."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    where = collections.Counter(
        f"{w.filename.split('stable_renderer_tpu_torch/')[-1]}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))
    return dict(where.most_common())


def engine_frame_kernels(pipe, size: int, corr):
    """(names, device ms): the kernels one engine frame launches on the
    card and their summed device time, by torch.profiler: a two-frame
    ``run_engine`` whose first frame is the profiler's warm-up step (its
    events dropped) and whose second is recorded, the device synchronized
    at both ends of each frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        def on_frame(eng, when):
            torch.cuda.synchronize()
            if when == "end":
                prof.step()

        run_engine(pipe, size, 2, corr, on_frame)
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep")]
    return [e.name for e in kernels], sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def main() -> None:
    import torch
    import torch.nn.functional as F

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
    report = _build.ptxas_log or ""
    k3_kernels = [ln for ln in report.splitlines()
                  if "Compiling entry function" in ln and "conv3x3_wgmma" in ln]
    serialized = _build.serialized_wgmma(report)
    if not k3_kernels:
        fail("ptxas's report (-Xptxas -v) names no conv3x3_wgmma kernel")
    if serialized:
        fail(f"ptxas serialized wgmma in {len(serialized)} lines: {serialized[0]}")
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'ran' if _build.build_seconds is not None else 'skipped: cached'}); "
          f"ptxas -v: {len(k3_kernels)} conv3x3_wgmma kernels, no serialized wgmma", flush=True)

    from stable_renderer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from stable_renderer_tpu_torch.ops.raster import rasterize
    from stable_renderer_tpu_torch.ops.raster_kernel import (
        rasterize_kernel,
        rasterize_tiles_reference,
        tile_ranges,
        triangle_setup,
        triangle_setup_kernel,
    )

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
        row = {"shape": f"bh={bh} lq={lq} lk={lk} d={d} {str(dt).replace('torch.', '')}"}
        # (1, BH, L, D): the fused SDPA backends take 4-D inputs
        qb, kb, vb = q[None], k[None], v[None]
        err = _k1_case(row, dt, tol, lambda: flash_attention(q, k, v),
                       lambda: flash_attention_reference(q, k, v),
                       lambda: F.scaled_dot_product_attention(qb, kb, vb), k1_bound(bh, lq, lk, d))
        if dt == torch.bfloat16:
            k1_err = max(k1_err, err)
        k1["shapes"].append(row)
        print(f"[3 K1] {row} (tol {tol:g})", flush=True)
        del q, k, v, qb, kb, vb
    # attention_pallas on (B, L, H*D): the UNet's fused-QKV chunks, read in
    # place, at the sequential frame's batch (2) and the stream frame's (8);
    # and a view whose rows are 321 elements apart, which the wrapper copies
    # (16-byte row copies need rows 8 elements apart)
    from stable_renderer_tpu_torch.ops.flash_attention import attention_pallas, needs_copy

    l, heads, d = 4096, 8, 40
    views = []
    for b in (2, 2 * STREAM_DEPTH):
        qkv = torch.randn((b, l, 3 * heads * d), generator=gen, device=dev).to(torch.bfloat16)
        views.append((f"fused-QKV view{', stream batch' if b > 2 else ''}", qkv.chunk(3, dim=-1)))
    unaligned = torch.randn((3, 2, l, heads * d + 1), generator=gen, device=dev).to(torch.bfloat16)
    views.append(("unaligned view, copied", unaligned[..., 1:]))
    for label, (q, k, v) in views:
        b = q.shape[0]
        qh = q.unflatten(-1, (heads, d))
        copied = needs_copy(qh.shape, qh.stride(), qh.data_ptr())
        if copied != label.endswith("copied"):
            fail(f"K1 {label}: needs_copy is {copied}")
        split = [t.unflatten(-1, (heads, d)).transpose(1, 2) for t in (q, k, v)]
        row = {"shape": f"attention_pallas b={b} l={l} heads={heads} d={d} bf16 {label}"}
        _k1_case(row, torch.bfloat16, K1_BF16_TOL, lambda: attention_pallas(q, k, v, heads),
                 lambda: flash_attention_reference(*split).transpose(1, 2).reshape(b, l, heads * d),
                 lambda: F.scaled_dot_product_attention(*split), k1_bound(b * heads, l, l, d))
        k1_err = max(k1_err, row["max_abs_err"])
        k1["shapes"].append(row)
        print(f"[3 K1] {row} (tol {K1_BF16_TOL:g})", flush=True)
    del views, qkv, unaligned, q, k, v, qh, split
    main_shape = k1["shapes"][0]
    k1.update(max_abs_err=k1_err, **{k: main_shape[k] for k in
                                     ("ms", "ms_with_host", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by")})

    # --- 4. K2 ---------------------------------------------------------------
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.raster import vertex_stage

    sphere = Mesh.Sphere(1.0, 48)
    bufs = mesh_device_buffers(sphere, dev)
    mv, proj = bench_matrices(0)
    clip, _, _ = vertex_stage(bufs["positions"], bufs["normals"], torch.from_numpy(mv).to(dev),
                              torch.from_numpy(proj).to(dev))
    tris = bufs["tris"]
    k2_call = lambda: rasterize_kernel(clip, tris, SIZE, SIZE, cull_backface=True)  # noqa: E731
    vis = k2_call()
    torch.cuda.synchronize()
    # bit for bit: the setup kernel against triangle_setup and tile_ranges, the
    # call against rasterize_tiles_reference over those constants; on the
    # bench sphere and on a soup of ties, tiny and full-screen triangles
    k2_exact = {}
    soup_clip, soup_tris = raster_soup(SIZE, SIZE)
    for label, c_, t_, cull in (("sphere", clip, tris, True),
                                ("soup", torch.from_numpy(soup_clip).to(dev),
                                 torch.from_numpy(soup_tris).to(dev), False)):
        tri_ref = triangle_setup(c_, t_, SIZE, SIZE, cull)
        tri_k, ranges_k = triangle_setup_kernel(c_, t_, SIZE, SIZE, cull)
        out = vis if label == "sphere" else rasterize_kernel(c_, t_, SIZE, SIZE, cull)
        torch.cuda.synchronize()
        exact = rasterize_tiles_reference(tri_ref, SIZE, SIZE)
        checks = {"setup": same_bits(tri_k, tri_ref),
                  "ranges": torch.equal(ranges_k, tile_ranges(tri_ref, SIZE, SIZE)),
                  **{f: same_bits(a, b) for f, a, b in zip(out._fields, out, exact)}}
        if not all(checks.values()):
            fail(f"K2 {label} ({t_.shape[0]} triangles): not bit for bit against its plain "
                 f"versions: {checks}")
        k2_exact[label] = t_.shape[0]
    ref = rasterize(clip, tris, SIZE, SIZE, cull_backface=True)
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
    # K2's work: the function reads clip and tris and writes z, tri_id and
    # bary; its operations are the pixel-triangle tests inside each
    # triangle's screen bounding box (~10 f32 operations each)
    ndc = clip[:, :2] / clip[:, 3:4]
    pxy = (ndc * 0.5 + 0.5) * SIZE
    tri_xy = pxy[tris.long()]  # (T, 3, 2)
    lo = tri_xy.amin(1).floor().clamp(0, SIZE)
    hi = tri_xy.amax(1).ceil().clamp(0, SIZE)
    pairs = ((hi - lo).clamp(min=0).prod(-1)).sum().item()
    k2_bound = bound(nbytes(clip, tris, vis.z, vis.tri_id, vis.bary), 10.0 * pairs, "f32")
    names = device_kernels(k2_call)
    if len(names) != 2 or "raster_setup" not in names[0] or "raster_binned" not in names[1]:
        fail(f"K2: one call launched {names}, want raster_setup then raster_binned")
    k2 = {"name": "rasterize_kernel", "route": "cuda",
          "source": "stable_renderer_tpu_torch/csrc/raster_tile.cu",
          "replaces": "stable_renderer_tpu/ops/raster_pallas.py:99",
          "max_abs_err": z_err,  # against the plain rasterize; 0 against the tiles reference
          "ms": graph_ms(k2_call, calls=SHORT_CALLS_A_GRAPH),
          "ms_one_call_a_graph": graph_ms(k2_call), "ms_with_host": cuda_ms(k2_call, 20),
          "plain_ms": cuda_ms(lambda: rasterize(clip, tris, SIZE, SIZE, cull_backface=True), 5,
                              warmup=1),
          "tiles_reference_ms": cuda_ms(lambda: rasterize_tiles_reference(
              triangle_setup(clip, tris, SIZE, SIZE, True), SIZE, SIZE), 3, warmup=1),
          "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None,
          "kernels_a_call": len(names), "bit_exact_triangles": k2_exact,
          "coverage_diff": cov_diff, "same_tri": same_tri.float().mean().item(),
          "bary_agree": bary_ok.float().mean().item()}
    print(f"[4 K2] {k2} ({tris.shape[0]} triangles; setup, ranges, z, tri_id and bary bit for "
          f"bit against triangle_setup, tile_ranges and rasterize_tiles_reference)", flush=True)

    # --- 5. small-input reference --------------------------------------------
    from dataclasses import replace as dc_replace

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine.frame_program import frame_step
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams
    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec, RenderConfig

    cfg = RenderConfig(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm",
                       scheduler="sgm_uniform")
    sprites = {1: Sprite(spriteID=1, prompt="a shiny ball")}
    env = (EnvPrompt("a ball"),)
    sigs = ((DrawUniforms(sprite_id=1, material_id=1), (512, 512), None, None),)
    pp = PostProcessParams()

    def run_frame(pipe, size, frame, corr, bg, step_noise=None, mats=None, stream=None):
        """The bench frame ``frame`` through frame_step, with the pipeline's
        ControlNets' hint sources; ``stream`` = (state, kv) runs the stream
        branch, (None, None) as its stream_init frame."""
        d = pipe.device
        mv, proj = bench_matrices(frame) if mats is None else mats
        draws = (dict(buffers=mesh_device_buffers(sphere, d), mv=mv, diffuse=None, noise=None,
                      corrmap=None),)
        _, ctx, nctx, _, _ = pipe.prepare_conditioning(sprites, env, 1)
        key = torch.Generator(device=d).manual_seed(cfg.seed + frame)
        cn_sources = tuple(spec.source for _, _, spec in pipe.controlnets)
        state, kv = stream if stream is not None else (None, None)
        return frame_step(pipe, corr, (), sigs, size, size, True, False, pp, cn_sources, True,
                          draws, proj, bg, None, ctx, nctx, pipe.scheduler_sigmas(), key,
                          *pipe.compute_params(), step_noise=step_noise, stream_state=state,
                          stream_init=stream is not None and state is None, stream_kv=kv)

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
    # three tiny stream frames, a perturbed ControlNet's hints and the id
    # maps riding the state, lag-1 K/V at the tiny UNet's middle transformer;
    # then one sequential frame with that ControlNet: the GPU frame_step
    # against the CPU plain path on the same packs, state and draws
    st_cfg = dc_replace(cfg, stream_pipeline=True, stream_kv_layers=(2,))
    st_gpu = dc_replace(tiny_gpu, config=st_cfg, controlnets=[])
    st_cpu = dc_replace(tiny_cpu, config=st_cfg, controlnets=[])
    perturbed_controlnet(st_gpu, ControlNetSpec(source="normal", strength=0.6), seed=5)
    st_cpu.add_controlnet(_to_cpu(st_gpu.controlnets[0][1]), st_gpu.controlnets[0][2])
    gpu_st = cpu_st = (None, None)
    st_err = 0.0
    for f in range(3):
        draw = torch.randn((STREAM_DEPTH,) + lat[1:], generator=gen, device=dev)
        _, _, pack, images, *gpu_st = run_frame(st_gpu, small, f, corr_small, bg_small, draw,
                                                stream=tuple(gpu_st))
        ref_images, *cpu_st = st_cpu._render_stream(
            *st_cpu.compute_params()[:2], pack["color"][None].cpu(), pack["noise"][None].cpu(),
            pack["id"][None].cpu(), cpu_st[0], st_cpu.scheduler_sigmas(), None, ctx_c, nctx_c,
            stream_init=f == 0, kv_state=cpu_st[1], cn_params=st_cpu.compute_params()[2],
            hints=(pack["normal"][None].cpu(),), corresponder=corr_small, step_noise=draw.cpu())
        errs = [(images.cpu() - ref_images).abs().max().item(),
                (gpu_st[0]["x"].cpu() - cpu_st[0]["x"]).abs().max().item(),
                (gpu_st[1]["2"].cpu() - cpu_st[1]["2"]).abs().max().item()]
        same_rows = (torch.equal(gpu_st[0]["ids"].cpu(), cpu_st[0]["ids"])
                     and torch.equal(gpu_st[0]["hints"][0].cpu(), cpu_st[0]["hints"][0]))
        st_err = max([st_err] + errs)
        if not (torch.isfinite(images).all() and max(errs) < REF_TOL and same_rows):
            fail(f"tiny stream frame {f}: GPU vs CPU image, latent state, K/V max abs err "
                 f"{errs} (tol {REF_TOL}); hints and ids equal: {same_rows}")
    cn_gpu = dc_replace(tiny_gpu, controlnets=list(st_gpu.controlnets))
    cn_cpu = dc_replace(tiny_cpu, controlnets=list(st_cpu.controlnets))
    _, _, pack, images, _, _ = run_frame(cn_gpu, small, 0, corr_small, bg_small, noise)
    ref_images = cn_cpu._render(
        corr_small, (), *cn_cpu.compute_params(), pack["color"][None].cpu(),
        pack["noise"][None].cpu(), pack["id"][None].cpu(), (pack["normal"][None].cpu(),),
        ctx_c, nctx_c, cn_cpu.scheduler_sigmas(), None, normal_maps=pack["normal"][None].cpu(),
        step_noise=[n.cpu() for n in noise])
    cn_err = (images.cpu() - ref_images).abs().max().item()
    if not (torch.isfinite(images).all() and cn_err < REF_TOL):
        fail(f"tiny control frame: GPU vs CPU plain path max abs err {cn_err:.3e} >= {REF_TOL}")
    print(f"[5 reference] tiny stream, 3 frames (hints and ids riding, lag-1 K/V): GPU vs CPU "
          f"plain max abs err {st_err:.3e} over images, latent state and K/V, hints and ids "
          f"equal; tiny frame with a perturbed ControlNet: max abs err {cn_err:.3e} "
          f"(tol {REF_TOL})", flush=True)
    del tiny_gpu, tiny_cpu, st_gpu, st_cpu, cn_gpu, cn_cpu

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
        if f == 0:
            bf16_images = images.float().clone()
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
    k1_a_frame = {"sequential": k1["launches"] // n_frames}
    ms = statistics.median(times[1:])
    # where a steady frame synchronizes the host (torch.cuda.set_sync_debug_mode)
    frame_syncs = {"bf16": host_syncs(lambda: run_frame(pipe, SIZE, n_frames, corr, bg))}
    print(f"[6 frame] {SIZE}x{SIZE} SD1.5 widths bf16, 4-step LCM cfg 2.0, sequential: "
          f"median {ms:.1f} ms/frame ({1e3 / ms:.2f} fps) over {FRAMES_TIMED} frames, warm frame "
          f"{times[0]:.1f} ms; K1 {k1['launches']} and K2 {k2['launches']} launches in "
          f"{n_frames} frames; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host syncs of one more frame "
          f"{frame_syncs['bf16']} | {card}", flush=True)

    # --- 7. K3 ----------------------------------------------------------------
    from stable_renderer_tpu_torch.ops.conv_kernel import (
        conv3x3_kernel,
        conv3x3_kernel_reference,
        conv_tiles,
    )

    k3 = {"name": "conv3x3_kernel", "route": "cuda",
          "source": "stable_renderer_tpu_torch/csrc/conv3x3.cu",
          "replaces": "stable_renderer_tpu/ops/conv_pallas.py:86", "shapes": []}
    # every shape class the int8, int8 stream and switched frames launch,
    # checked; the K3_TIMED_SHAPES rows and the stream frame's two largest
    # classes by launches x bytes also timed
    k3_cases = [(s, "int8") for s in K3_INT8_FRAME_SHAPES]
    k3_cases += [(s, "int8") for s in K3_STREAM_FRAME_SHAPES if (s, "int8") not in k3_cases]
    k3_cases += [(k[:5], "bf16+prologue" if k[5] else "bf16") for k in K3_SWITCHED_FRAME_SHAPES]
    k3_cases += [c for c in K3_TIMED_SHAPES if c not in k3_cases]
    stream_timed = sorted((s_ for s_ in K3_STREAM_FRAME_SHAPES if s_[0] == 2 * STREAM_DEPTH),
                          key=lambda s_: -K3_STREAM_FRAME_SHAPES[s_] * (
                              2 * s_[0] * s_[1] * s_[2] * (s_[3] + s_[4]) + 9 * s_[3] * s_[4]))[:2]
    k3_timed = K3_TIMED_SHAPES + [(s_, "int8") for s_ in stream_timed]
    k3_rows = {}  # (shape, mode) -> its timed row, its launches a frame filled in phase 12
    k3_checked = 0
    for (n, h, w, cin, cout), mode in k3_cases:
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
        wf = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / (3.0 * cin ** 0.5)
        b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        kw = {}
        if mode == "int8":
            ws = wf.abs().amax((0, 1, 2)) / 127.0
            wk = torch.clamp(torch.round(wf / ws), -127, 127).to(torch.int8)
            kw.update(a_scale=(x.float().abs().amax() / 127.0).reshape(()), w_scale=ws)
        else:
            wk = wf.to(torch.bfloat16)
        if mode == "bf16+prologue":
            kw.update(pre_scale=torch.rand((n, cin), generator=gen, device=dev) + 0.5,
                      pre_shift=torch.randn((n, cin), generator=gen, device=dev) * 0.5,
                      pre_act="silu")
        out = conv3x3_kernel(x, wk, b, **kw)
        torch.cuda.synchronize()
        ref = conv3x3_kernel_reference(x, wk, b, **kw)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if mode == "int8":
            ok, bar = err == 0.0, "exact"  # same int8 values, exact int32 sums, same dequant
        else:
            ok = bool((diff <= BF16_STEP * ref.float().abs() + K3_BF16_ATOL).all())
            bar = f"|d| <= 2^-7 |ref| + {K3_BF16_ATOL:g}"
        shape = f"{n}x{h}x{w}x{cin}->{cout} {mode}"
        if not (ok and math.isfinite(err)):
            fail(f"K3 {shape}: max abs err {err:.3e} (bar: {bar})")
        k3_checked += 1
        k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), err)
        if ((n, h, w, cin, cout), mode) not in k3_timed:
            del x, wk, out, ref, diff
            continue
        t = conv_tiles(n, h, w, cin, cout, mode == "int8")
        row = {"shape": shape, "max_abs_err": err, "bar": bar,
               "tiles": f"bn {t.bn} rows {t.rows}",
               "ms": graph_ms(lambda: conv3x3_kernel(x, wk, b, **kw)),
               "plain_ms": graph_ms(lambda: conv3x3_kernel_reference(x, wk, b, **kw), 5),
               "library_ms": None,
               "ms_with_host": cuda_ms(lambda: conv3x3_kernel(x, wk, b, **kw), 20)}
        if mode != "int8":  # cuDNN's conv, channels_last bf16 (the prologue not included)
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            row["library_ms"] = graph_ms(lambda: F.conv2d(x_cl, w_cl, b, padding=1))
        row["bound_ms"], row["bound_by"] = bound(
            nbytes(x, wk, b, out, kw.get("pre_scale"), kw.get("pre_shift")),
            2.0 * n * h * w * cout * 9 * cin, "int8" if mode == "int8" else "bf16")
        k3["shapes"].append(row)
        k3_rows[((n, h, w, cin, cout), mode)] = row
        print(f"[7 K3] {row}", flush=True)
        del x, wk, out, ref, diff
    print(f"[7 K3] {k3_checked} shape classes checked against the plain version (int8 exact, "
          f"bf16 |d| <= 2^-7 |ref| + {K3_BF16_ATOL:g}): max abs err {k3['max_abs_err']:.3e}",
          flush=True)
    k3["checked_shape_classes"] = k3_checked
    main_shape = next(r for r in k3["shapes"] if r["shape"].startswith("2x64x64x960"))
    k3.update(**{k: main_shape[k] for k in ("ms", "ms_with_host", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")})

    # --- 8. K4 ----------------------------------------------------------------
    from stable_renderer_tpu_torch.ops.group_norm_kernel import (
        gn_geometry,
        group_norm_kernel,
        group_norm_kernel_reference,
        max_active_clusters,
    )

    k4 = {"name": "group_norm_kernel", "route": "cuda",
          "source": "stable_renderer_tpu_torch/csrc/group_norm.cu",
          "replaces": "stable_renderer_tpu/ops/group_norm_pallas.py:54", "shapes": []}
    # every shape class of the switched frame with its activation, checked
    # (bf16, 32 groups), and K4_TIMED_SHAPES with SiLU also timed
    k4_cases = list(K4_SWITCHED_FRAME_SHAPES) + [
        s_ + ("silu",) for s_ in K4_TIMED_SHAPES if s_ + ("silu",) not in K4_SWITCHED_FRAME_SHAPES]
    k4_checked = 0
    for n, s, c, act in k4_cases:
        shape = (n, s, c)
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(torch.bfloat16)
        w = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        call = lambda: group_norm_kernel(x, w, b, groups=32, act=act)  # noqa: E731
        out = call()
        torch.cuda.synchronize()
        ref = group_norm_kernel_reference(x, w, b, groups=32, act=act)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        geo = gn_geometry(n, s, c, 32, 2)
        clusters = max_active_clusters(n, s, c, 32, geo)
        if not (math.isfinite(err) and (diff <= BF16_STEP * ref.float().abs() + K4_ATOL).all()):
            fail(f"K4 {shape} {act}: max abs err {err:.3e} (bar |d| <= 2^-7 |ref| + {K4_ATOL:g})")
        if clusters < 1:
            fail(f"K4 {shape}: cudaOccupancyMaxActiveClusters {clusters} for {geo}")
        one_wave = clusters >= n * (c // geo.slice_channels)
        if not same_bits(out.view(torch.int16), call().view(torch.int16)):
            fail(f"K4 {shape} {act}: two calls on the same input differ")
        k4_checked += 1
        k4["max_abs_err"] = max(k4.get("max_abs_err", 0.0), err)
        if act != "silu" or shape not in K4_TIMED_SHAPES:
            continue
        names = device_kernels(call)
        if len(names) != 1 or "gn_cluster" not in names[0]:
            fail(f"K4 {shape}: one call launched {names}, want one gn_cluster")
        x_nc = x.transpose(1, 2)  # (N, C, S) view for F.group_norm
        row = {"shape": f"{shape} bf16 silu", "max_abs_err": err,
               "geometry": dict(geo._asdict(), threads=geo.threads,
                                max_active_clusters=clusters, one_wave=one_wave),
               "kernels_a_call": len(names),
               "ms": graph_ms(call, calls=SHORT_CALLS_A_GRAPH),
               "ms_one_call_a_graph": graph_ms(call),
               "plain_ms": graph_ms(lambda: group_norm_kernel_reference(x, w, b, 32, 1e-6,
                                                                         "silu"),
                                    calls=SHORT_CALLS_A_GRAPH),
               "library_ms": graph_ms(lambda: F.silu(F.group_norm(x_nc, 32, w, b, 1e-6)),
                                      calls=SHORT_CALLS_A_GRAPH),
               "ms_with_host": cuda_ms(call, 20)}
        row["bound_ms"], row["bound_by"] = bound(nbytes(x, w, b, out), 10.0 * x.numel(), "f32")
        k4["shapes"].append(row)
        print(f"[8 K4] {row}", flush=True)
    print(f"[8 K4] {k4_checked} shape classes checked against the plain version (bf16, |d| <= "
          f"2^-7 |ref| + {K4_ATOL:g}; each call bit-identical to a second one, its cluster "
          f"held by the card): max abs err {k4['max_abs_err']:.3e}", flush=True)
    k4["checked_shape_classes"] = k4_checked
    # the switched frame's K4 launches, summed over its classes: each class's
    # device time, plain version, F.group_norm (+ F.silu) and bound, times its
    # launches a frame (after the loop above, so that its profiler sessions
    # do not interleave with these graph captures: a profiled call read no
    # kernel when they did)
    k4_frame = {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                "bound_by": "bytes"}
    for (n, s, c, act), per_frame in K4_SWITCHED_FRAME_SHAPES.items():
        x = (torch.randn((n, s, c), generator=gen, device=dev) * 1.5 + 0.3).to(torch.bfloat16)
        w = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        x_nc = x.transpose(1, 2)
        out = group_norm_kernel(x, w, b, groups=32, act=act)
        b_ms, b_by = bound(nbytes(x, w, b, out), 10.0 * x.numel(), "f32")
        if b_by == "operations":  # "bytes" only while every class is bound by bytes
            k4_frame["bound_by"] = b_by
        times = {
            "ms": graph_ms(lambda: group_norm_kernel(x, w, b, groups=32, act=act),
                           calls=SHORT_CALLS_A_GRAPH),
            "plain_ms": graph_ms(lambda: group_norm_kernel_reference(x, w, b, 32, 1e-6, act),
                                 calls=SHORT_CALLS_A_GRAPH),
            "library_ms": graph_ms((lambda: F.silu(F.group_norm(x_nc, 32, w, b, 1e-6)))
                                   if act == "silu" else
                                   (lambda: F.group_norm(x_nc, 32, w, b, 1e-6)),
                                   calls=SHORT_CALLS_A_GRAPH),
            "bound_ms": b_ms}
        for key, t in times.items():
            k4_frame[key] += per_frame * t
        k4_frame["launches"] += per_frame
    if k4_frame["launches"] != K4_SWITCHED_CALLS_PER_FRAME:
        fail(f"K4_SWITCHED_FRAME_SHAPES holds {k4_frame['launches']} launches, want "
             f"{K4_SWITCHED_CALLS_PER_FRAME}")
    k4["switched_frame"] = k4_frame
    print(f"[8 K4] the switched frame's {k4_frame['launches']} launches, summed over its "
          f"classes (device time by graph replay, {SHORT_CALLS_A_GRAPH} calls a graph): kernel "
          f"{k4_frame['ms']:.4f} ms, plain {k4_frame['plain_ms']:.4f} ms, F.group_norm (+ F.silu) "
          f"{k4_frame['library_ms']:.4f} ms, bound {k4_frame['bound_ms']:.4f} ms "
          f"({k4_frame['bound_by']}) | {card}", flush=True)
    k4.update(**{k: k4["shapes"][0][k] for k in ("ms", "ms_with_host", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by")})

    # --- 9. the calibrated int8 frame -----------------------------------------
    from stable_renderer_tpu_torch.models import layers

    t0 = time.perf_counter()
    pipe_i8 = DiffusionPipeline.from_random(dc_replace(cfg, int8_conv=True), tiny=False,
                                            device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_int8 = sum(_count_int8(t) for t in (pipe_i8.unet_params, pipe_i8.vae_params))
    corr_i8 = OverlapCorresponder(vertex_segments=4096, update_corrmap=False)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = rasterize_kernel.launches = 0
    conv3x3_kernel.launches = group_norm_kernel.launches = 0
    times = []
    with k3_shape_tally() as seen:
        for f in range(1 + FRAMES_TIMED):
            t0 = time.perf_counter()
            disp, gbuf, pack, images, _, _ = run_frame(pipe_i8, SIZE, f, corr_i8, bg)
            host = disp.cpu()
            times.append((time.perf_counter() - t0) * 1e3)
            if not torch.isfinite(images).all() or host.shape != (SIZE, SIZE, 4):
                fail(f"int8 frame {f}: non-finite image or display {tuple(host.shape)}")
            if f == 0:
                i8_images = images.float().clone()
    k3_classes = {"int8": per_frame_classes(seen, n_frames)}
    if k3_classes["int8"] != K3_INT8_FRAME_SHAPES:
        fail(f"int8 frame: K3 launches a frame by class {k3_classes['int8']}, want "
             f"{K3_INT8_FRAME_SHAPES}")
    counts = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches,
              group_norm_kernel.launches)
    want = (K1_CALLS_PER_FRAME * n_frames, n_frames, K3_INT8_CALLS_PER_FRAME * n_frames, 0)
    if counts != want:
        fail(f"int8 frames: launches K1, K2, K3, K4 = {counts}, want {want}")
    k3["launches"] = counts[2]
    k3_a_frame = {"int8": counts[2] // n_frames}
    a, b_ = i8_images.flatten(), bf16_images.flatten()
    cos = (a @ b_ / (a.norm() * b_.norm())).item()
    ac, bc = a - a.mean(), b_ - b_.mean()
    corr_c = (ac @ bc / (ac.norm() * bc.norm())).item()
    if not cos > INT8_FRAME_COS_FLOOR:
        fail(f"int8 frame vs bf16 frame: cosine {cos:.6f} <= {INT8_FRAME_COS_FLOOR}")
    # the JAX package's fidelity bar is on one UNet evaluation of the same input
    g9 = torch.Generator(device=dev).manual_seed(11)
    xu = torch.randn((2, SIZE // 8, SIZE // 8, 4), generator=g9, device=dev).to(torch.bfloat16)
    tu = torch.full((2,), 999.0, device=dev)
    _, ctx9, nctx9, _, _ = pipe.prepare_conditioning(sprites, env, 1)
    cu = torch.cat([ctx9, nctx9]).to(torch.bfloat16)
    with torch.no_grad():
        ub = pipe.unet.apply(pipe.unet_params, xu, tu, cu).float().flatten()
        uq = pipe_i8.unet.apply(pipe_i8.unet_params, xu, tu, cu).float().flatten()
    ucos = (ub @ uq / (ub.norm() * uq.norm())).item()
    if not ucos > INT8_UNET_COS_BAR:
        fail(f"int8 vs bf16 UNet evaluation: cosine {ucos:.6f} <= {INT8_UNET_COS_BAR}")
    ms_i8 = statistics.median(times[1:])
    print(f"[9 int8] {SIZE}x{SIZE} SD1.5 widths, calibrated int8 convs ({n_int8} int8 conv "
          f"leaves): from_random with quantize_convs {setup_s:.2f} s (set-up); median "
          f"{ms_i8:.1f} ms/frame ({1e3 / ms_i8:.2f} fps) over {FRAMES_TIMED} frames, warm frame "
          f"{times[0]:.1f} ms; launches K1 {counts[0]}, K2 {counts[1]}, K3 {counts[2]} in "
          f"{n_frames} frames; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"decoded frame 0 vs bf16: cosine {cos:.6f} (floor {INT8_FRAME_COS_FLOOR}), centred "
          f"{corr_c:.4f}, max abs diff {(a - b_).abs().max().item():.4f}; one UNet evaluation "
          f"vs bf16: cosine {ucos:.6f} (bar > {INT8_UNET_COS_BAR}) | {card}", flush=True)

    # --- 10. the bf16 frame with the K3 and K4 switches on ---------------------
    from stable_renderer_tpu_torch.ops.conv_kernel import use_pallas_conv

    use_pallas_conv(True)
    layers._group_norm_pallas_on = True
    flash_attention.launches = rasterize_kernel.launches = 0
    conv3x3_kernel.launches = group_norm_kernel.launches = 0
    t0 = time.perf_counter()
    with k3_shape_tally() as seen:
        _, _, _, sw_images, _, _ = run_frame(pipe, SIZE, 0, OverlapCorresponder(
            vertex_segments=4096, update_corrmap=False), bg)
        torch.cuda.synchronize()
    sw_ms = (time.perf_counter() - t0) * 1e3
    k3_classes["switched"] = per_frame_classes(seen, 1, prologue=True)
    use_pallas_conv(False)
    layers._group_norm_pallas_on = False
    counts = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches,
              group_norm_kernel.launches)
    want = (K1_CALLS_PER_FRAME, 1, K3_SWITCHED_CALLS_PER_FRAME, K4_SWITCHED_CALLS_PER_FRAME)
    if counts != want:
        fail(f"switched frame: launches K1, K2, K3, K4 = {counts}, want {want}")
    if k3_classes["switched"] != K3_SWITCHED_FRAME_SHAPES:
        fail(f"switched frame: K3 launches by class {k3_classes['switched']}, want "
             f"{K3_SWITCHED_FRAME_SHAPES}")
    k4["launches"] = counts[3]
    k3["launches_switched_frame"] = counts[2]
    d = (sw_images.float() - bf16_images).abs()
    if not (torch.isfinite(sw_images).all() and d.mean().item() < SWITCH_MEAN_BAR
            and d.max().item() < SWITCH_MAX_BAR):
        fail(f"switched frame vs phase 6: mean abs {d.mean().item():.4f} (bar {SWITCH_MEAN_BAR}), "
             f"max {d.max().item():.4f} (bar {SWITCH_MAX_BAR})")
    print(f"[10 switches] bf16 frame with use_pallas_conv(True) and _group_norm_pallas_on: "
          f"{sw_ms:.1f} ms (one frame, after warm-up of the unswitched path); launches K1 "
          f"{counts[0]}, K2 {counts[1]}, K3 {counts[2]}, K4 {counts[3]}; vs phase 6 frame 0: "
          f"mean abs {d.mean().item():.5f} (bar {SWITCH_MEAN_BAR}), max abs "
          f"{d.max().item():.4f} (bar {SWITCH_MAX_BAR}) | {card}", flush=True)

    # --- 11. the engine: Engine.Run of the bench scene --------------------------
    engine_ms = {}

    def run_engine_phase(phase: int, label: str, p_, step_ms: float, transient: int, want: tuple,
                         stream: bool = False) -> dict:
        """The bench scene through Engine.Run with pipeline ``p_``:
        ``transient`` frames, ENGINE_WARM warm and FRAMES_TIMED timed
        presents (and PRESENT_DEPTH more); ``want`` = launches a frame of K1,
        K2, K3 and K4, held by the counters over the run and by the profiler
        on one frame; frame 0 against frame_step's at the engine's inputs
        (its stream_init frame when ``stream``). Returns the present-to-
        present median and p90 of the timed frames."""
        first = {}

        def keep_first(eng, when):
            if eng.RuntimeManager.FrameCount != 0:
                return
            rm = eng.RenderManager
            if when == "begin":  # the model matrix frame 0 draws with: MeshRenderer
                # submits its draw before AutoRotation turns the ball
                cam, ball = eng.scene
                first["mats"] = (cam.viewMatrix @ ball.transform.globalTransformMatrix,
                                 cam.projectionMatrix(1.0))
            else:
                first.update(images=rm.last_diffusion_frames.float().clone(),
                             bg=rm.GlobalBGNoise)

        n_eng = transient + ENGINE_WARM + FRAMES_TIMED + PRESENT_DEPTH
        torch.cuda.synchronize()
        flash_attention.launches = rasterize_kernel.launches = 0
        conv3x3_kernel.launches = group_norm_kernel.launches = 0
        t0 = time.perf_counter()
        eng, presented = run_engine(
            p_, SIZE, n_eng, OverlapCorresponder(vertex_segments=4096, update_corrmap=False),
            keep_first)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches,
                  group_norm_kernel.launches)
        if counts != tuple(c * n_eng for c in want):
            fail(f"engine {label}: launches K1, K2, K3, K4 over {n_eng} frames = {counts}, "
                 f"want {want} a frame")
        if eng.device.type != "cuda" or [i for _, i, _ in presented] != list(range(n_eng)):
            fail(f"engine {label}: device {eng.device}, presented "
                 f"{[i for _, i, _ in presented]}")
        if stream and not isinstance(eng.RenderManager._stream_state, dict):
            fail(f"engine {label}: no stream state carried ({eng.RenderManager._stream_state!r})")
        for _, i, frame in presented:
            if frame.shape != (SIZE, SIZE, 4) or frame.dtype.name != "uint8":
                fail(f"engine {label} frame {i}: presented {frame.shape} {frame.dtype}")
            if int(frame[..., :3].max()) == int(frame[..., :3].min()):
                fail(f"engine {label} frame {i}: constant frame")
        # present intervals of the timed frames; frame i is presented in frame
        # i + PRESENT_DEPTH's run, so these all fall in steady frames
        lo = transient + ENGINE_WARM
        stamps = [t for t, _, _ in presented[lo - 1:lo + FRAMES_TIMED]]
        gaps = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
        e_ms = statistics.median(gaps)
        e_p90 = statistics.quantiles(gaps, n=10, method="inclusive")[-1]
        # the first frame against frame_step at the engine's model-view and
        # projection, its background noise and its generator seed (0)
        if not torch.isfinite(first["images"]).all():
            fail(f"engine {label}: non-finite decoded frame 0")
        if not same_bits(first["bg"], bg):
            fail(f"engine {label}: GlobalBGNoise differs from phase 6's background noise")
        _, _, _, ref_images, _, _ = run_frame(
            p_, SIZE, 0, OverlapCorresponder(vertex_segments=4096, update_corrmap=False), bg,
            mats=first["mats"], stream=(None, None) if stream else None)
        torch.cuda.synchronize()
        first_err = (first["images"] - ref_images.float()).abs().max().item()
        if not torch.equal(first["images"], ref_images.float()):
            fail(f"engine {label}: frame 0 differs from frame_step's at the same inputs, "
                 f"max abs {first_err:.3e}")
        # one frame's kernels by the profiler, after a warm frame
        flash_attention.launches = rasterize_kernel.launches = conv3x3_kernel.launches = 0
        names, device_ms = engine_frame_kernels(
            p_, SIZE, OverlapCorresponder(vertex_segments=4096, update_corrmap=False))
        prof_counts = (sum("flash_wg" in k or "flash_wide" in k for k in names),
                       sum("raster_binned" in k for k in names),
                       sum("raster_setup" in k for k in names),
                       sum("conv3x3_wgmma" in k for k in names))
        prof_want = (want[0], 1, 1, want[2])
        two = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches)
        if prof_counts != prof_want or two != (2 * want[0], 2, 2 * want[2]):
            fail(f"engine {label}: one profiled frame launched K1, K2 binned, K2 setup, K3 = "
                 f"{prof_counts}, want {prof_want}; counters over its two frames K1, K2, K3 "
                 f"= {two}")
        k1.setdefault("launches_engine", {})[label] = counts[0]
        k2.setdefault("launches_engine", {})[label] = counts[1]
        if want[2]:
            k3.setdefault("launches_engine", {})[label] = counts[2]
        print(f"[{phase} engine] {label}: Engine.Run of the bench scene at "
              f"{SIZE}x{SIZE}, {n_eng} frames in {run_s:.2f} s; present-to-present median "
              f"{e_ms:.1f} ms, p90 {e_p90:.1f} ms over {FRAMES_TIMED} timed frames after "
              f"{transient} transient and {ENGINE_WARM} warm (frame_step's median: "
              f"{step_ms:.1f} ms); launches K1 {counts[0]}, K2 {counts[1]}, K3 {counts[2]}, K4 "
              f"{counts[3]} ({n_eng} frames); profiled frame K1 {prof_counts[0]}, K2 "
              f"{prof_counts[1]} + {prof_counts[2]} setup, K3 {prof_counts[3]}; its kernels "
              f"{device_ms:.1f} ms, busy share {device_ms / e_ms:.3f} of the median; frame 0 "
              f"identical to frame_step's | {card}", flush=True)
        return {"median_ms": e_ms, "p90_ms": e_p90, "frame_step_median_ms": step_ms,
                "gaps_ms": gaps, "frames": n_eng, "run_s": run_s,
                "profiled_frame_device_ms": device_ms, "busy_share": device_ms / e_ms}

    for label, p_, step_ms, int8 in (("bf16", pipe, ms, False), ("int8", pipe_i8, ms_i8, True)):
        engine_ms[label] = run_engine_phase(
            11, label, p_, step_ms, 0, (K1_CALLS_PER_FRAME, 1, K3_INT8_CALLS_PER_FRAME * int8, 0))

    # --- 12. the stream: bench.py's default mode -----------------------------------
    st_cfg = dc_replace(pipe_i8.config, stream_pipeline=True, stream_kv_layers=(6,))
    pipe_st = dc_replace(pipe_i8, config=st_cfg, controlnets=[])  # phase 9's quantized trees
    pipe_st_bf16 = dc_replace(pipe, config=dc_replace(st_cfg, int8_conv=False), controlnets=[])
    st_want = (K1_STREAM_CALLS_PER_FRAME, 1, K3_STREAM_CALLS_PER_FRAME, 0)
    # frame_step over S - 1 transient frames, one warm and FRAMES_TIMED timed,
    # in int8 and in bf16 at the same inputs
    n_st = STREAM_DEPTH - 1 + 1 + FRAMES_TIMED
    st_images, st_ms, st_counts = {}, {}, {}
    for label, p_ in (("int8", pipe_st), ("bf16", pipe_st_bf16)):
        state = (None, None)
        torch.cuda.synchronize()
        flash_attention.launches = rasterize_kernel.launches = 0
        conv3x3_kernel.launches = group_norm_kernel.launches = 0
        times, imgs = [], []
        with k3_shape_tally() as seen:
            for f in range(n_st):
                t0 = time.perf_counter()
                disp, _, pack, images, *state = run_frame(p_, SIZE, f, OverlapCorresponder(
                    vertex_segments=4096, update_corrmap=False), bg, stream=tuple(state))
                host = disp.cpu()
                times.append((time.perf_counter() - t0) * 1e3)
                if not torch.isfinite(images).all() or host.shape != (SIZE, SIZE, 4):
                    fail(f"stream {label} frame {f}: non-finite image or display "
                         f"{tuple(host.shape)}")
                imgs.append(images.float().clone())
        if label == "int8":
            k3_classes["stream int8"] = per_frame_classes(seen, n_st)
            if k3_classes["stream int8"] != K3_STREAM_FRAME_SHAPES:
                fail(f"int8 stream frame: K3 launches a frame by class "
                     f"{k3_classes['stream int8']}, want {K3_STREAM_FRAME_SHAPES}")
        counts = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches,
                  group_norm_kernel.launches)
        want = tuple(c * n_st for c in st_want[:2]) + (
            st_want[2] * n_st if label == "int8" else 0, 0)
        if counts != want:
            fail(f"stream {label} frame_step: launches K1, K2, K3, K4 over {n_st} frames = "
                 f"{counts}, want {want}")
        st_counts[label] = tuple(c // n_st for c in counts)
        if sorted(state[1]) != ["6"] or tuple(state[1]["6"].shape) != (STREAM_DEPTH, 64, 1280):
            fail(f"stream {label}: captured K/V "
                 f"{[(k_, tuple(v_.shape)) for k_, v_ in state[1].items()]}")
        st_images[label] = imgs
        st_ms[label] = statistics.median(times[-FRAMES_TIMED:])
        if label == "int8":  # one more steady frame: the stream program, then the frame
            _, ctx_st, nctx_st, _, _ = p_.prepare_conditioning(sprites, env, 1)
            st_syncs = host_syncs(lambda: p_._render_stream(
                *p_.compute_params()[:2], pack["color"][None], pack["noise"][None],
                pack["id"][None], state[0], p_.scheduler_sigmas(),
                torch.Generator(device=dev).manual_seed(99), ctx_st, nctx_st, kv_state=state[1],
                corresponder=OverlapCorresponder(vertex_segments=4096, update_corrmap=False)))
            if st_syncs:
                fail(f"the stream program synchronized the host: {st_syncs}")
            frame_syncs["stream int8"] = host_syncs(lambda: run_frame(
                p_, SIZE, n_st, OverlapCorresponder(vertex_segments=4096, update_corrmap=False),
                bg, stream=tuple(state)))
    st_cos = []
    for a, b_ in zip(st_images["int8"], st_images["bf16"]):
        a, b_ = a.flatten(), b_.flatten()
        st_cos.append((a @ b_ / (a.norm() * b_.norm())).item())
    if not min(st_cos) > INT8_FRAME_COS_FLOOR:
        fail(f"int8 stream frames vs bf16 stream frames: cosines {st_cos}, floor "
             f"{INT8_FRAME_COS_FLOOR}")
    del st_images
    print(f"[12 stream] frame_step, {n_st} stream frames ({STREAM_DEPTH - 1} transient): median "
          f"int8 {st_ms['int8']:.1f} ms, bf16 {st_ms['bf16']:.1f} ms over the last "
          f"{FRAMES_TIMED}; a steady int8 _render_stream call ran without a host sync, the "
          f"frame around it synchronized {frame_syncs['stream int8']}; launches a frame "
          f"(counted) K1 {st_counts['int8'][0]}, K2 {st_counts['int8'][1]}, K3 "
          f"{st_counts['int8'][2]} in {len(k3_classes['stream int8'])} shape classes (int8); "
          f"int8 vs bf16 decoded frames: cosine min {min(st_cos):.6f} (floor "
          f"{INT8_FRAME_COS_FLOOR}) | {card}", flush=True)
    k1_a_frame["stream"] = st_counts["int8"][0]
    k3_a_frame["stream int8"] = st_counts["int8"][2]
    engine_ms["stream int8"] = run_engine_phase(
        12, "stream int8", pipe_st, st_ms["int8"], STREAM_DEPTH - 1, st_want, stream=True)
    del pipe_st, pipe_st_bf16, pipe_i8

    # --- 13. control: bench.py's control mode (two ControlNets) ----------------------
    pipe_cn = dc_replace(pipe, controlnets=[])
    for source, seed in (("normal", 5), ("depth", 6)):
        pipe_cn.add_random_controlnet(ControlNetSpec(source=source, strength=0.6), seed=seed)
    torch.cuda.synchronize()
    flash_attention.launches = rasterize_kernel.launches = 0
    conv3x3_kernel.launches = group_norm_kernel.launches = 0
    times = []
    for f in range(1 + FRAMES_TIMED):  # phase 6's frames, with the ControlNets
        t0 = time.perf_counter()
        disp, _, _, images, _, _ = run_frame(
            pipe_cn, SIZE, f, OverlapCorresponder(vertex_segments=4096, update_corrmap=False), bg)
        disp.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
        if f == 0:
            zero_images = images.float().clone()
    cn_ms = statistics.median(times[1:])
    counts = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches,
              group_norm_kernel.launches)
    cn_want = (K1_CONTROL_CALLS_PER_FRAME, 1, 0, 0)
    if counts != tuple(c * n_frames for c in cn_want):
        fail(f"control frames: launches K1, K2, K3, K4 over {n_frames} frames = {counts}, want "
             f"{cn_want} a frame")
    k1_a_frame["control"] = counts[0] // n_frames
    d = (zero_images.float() - bf16_images).abs()
    zero_same = torch.equal(zero_images.float(), bf16_images)
    if not (zero_same or (d.mean().item() < SWITCH_MEAN_BAR and d.max().item() < SWITCH_MAX_BAR)):
        fail(f"zero-init control frame vs phase 6: mean abs {d.mean().item():.3e}, max "
             f"{d.max().item():.3e} (bars {SWITCH_MEAN_BAR}, {SWITCH_MAX_BAR})")
    engine_ms["control bf16"] = run_engine_phase(13, "control bf16", pipe_cn, cn_ms, 0, cn_want)
    for i, (_, params, _) in enumerate(pipe_cn.controlnets):
        perturb_zero_convs(params, 105 + i)
    _, _, _, pert_images, _, _ = run_frame(
        pipe_cn, SIZE, 0, OverlapCorresponder(vertex_segments=4096, update_corrmap=False), bg)
    dp = (pert_images.float() - bf16_images).abs().mean().item()
    frame_syncs["control bf16"] = host_syncs(lambda: run_frame(
        pipe_cn, SIZE, 0, OverlapCorresponder(vertex_segments=4096, update_corrmap=False), bg))
    if not (torch.isfinite(pert_images).all() and dp > CONTROL_DIFF_FLOOR):
        fail(f"perturbed control frame vs phase 6: mean abs {dp:.3e} (floor {CONTROL_DIFF_FLOOR}) "
             f"or non-finite")
    print(f"[13 control] two ControlNets (normal, depth; strength 0.6): frame_step median "
          f"{cn_ms:.1f} ms over {FRAMES_TIMED} frames (phase 6 without them: {ms:.1f} ms); "
          f"launches a frame (counted) K1 {k1_a_frame['control']}, K2 {counts[1] // n_frames}; "
          f"zero-init frame vs phase "
          f"6 frame 0 {'bit for bit' if zero_same else 'differs'}: mean abs {d.mean().item():.3e}, "
          f"max {d.max().item():.3e}; with the zero convs perturbed (seeded): mean abs "
          f"{dp:.4f} (floor {CONTROL_DIFF_FLOOR}), finite; host syncs of one frame "
          f"{frame_syncs['control bf16']} | {card}", flush=True)
    # launches a frame, all counted in this run: K1's and K3's by path, and
    # each timed K3 row's by shape class (phases 9, 10 and 12)
    k1["launches_a_frame"], k3["launches_a_frame"] = k1_a_frame, k3_a_frame
    for (shape, mode), row in k3_rows.items():
        if mode == "int8":
            row["launches_a_frame"] = {"int8": k3_classes["int8"].get(shape, 0),
                                       "stream int8": k3_classes["stream int8"].get(shape, 0)}
        else:
            row["launches_a_frame"] = {"switched": k3_classes["switched"].get(
                shape + (mode == "bf16+prologue",), 0)}
    del pipe_cn

    # --- 14-16. the bake, its replay and all-frames attention ------------------------
    bake = bake_phases(pipe, dev, card, k1, k2)

    print(json.dumps({"kernels": [k1, k2, k3, k4], "frame_ms": ms, "int8_frame_ms": ms_i8,
                      "stream_frame_step_ms": st_ms, "control_frame_ms": cn_ms,
                      "host_syncs_a_frame": frame_syncs,
                      "engine_frame_ms": engine_ms, **bake,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def bake_scene(cmap, frames_a_turn: int = 16, interval: int = 1, prompt: str = BAKE_PROMPT):
    """scripts/bake_ball.py's scene (and corrmap_render_example.py's): the
    camera at (0, 0, 3), a 48-segment sphere with a CorrMapRenderer on
    ``cmap``, turned 360 / frames_a_turn degrees every ``interval`` frames."""
    from stable_renderer_tpu_torch.engine import (
        Camera,
        CorrMapRenderer,
        EqualIntervalRotation,
        GameObject,
        Mesh,
        SpriteInfo,
    )

    cam = GameObject("camera")
    cam.addComponent(Camera)
    cam.transform.position = [0.0, 0.0, 3.0]
    ball = GameObject("ball")
    ball.addComponent(SpriteInfo, prompt=prompt)
    ball.addComponent(CorrMapRenderer, mesh=Mesh.Sphere(1.0, 48), corrmaps=[cmap])
    ball.addComponent(EqualIntervalRotation, angle_deg=360.0 / frames_a_turn, interval=interval)


def _cross_frame_case(row: dict, n: int, l: int, heads: int, d: int, gen) -> None:
    """cross_frame_attention on the UNet's fused-QKV chunk views (n, l, 3 *
    heads * d), bf16, through ``_k1_case``: held to its plain version on the
    first, middle and last frame (a frame at a time: the dense form's logits
    need not fit), the largest error within K1_FOLD_REL_TOL of the smallest
    of those frames' largest |output|; the plain version timed over all n
    frames, SDPA on the folded (1, heads, n l, d) views. Fills row."""
    import torch
    import torch.nn.functional as F

    from stable_renderer_tpu_torch.parallel.ring_attention import (
        cross_frame_attention,
        cross_frame_attention_reference,
    )

    qkv = torch.randn((n, l, 3 * heads * d), generator=gen, device=gen.device).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)

    def compare(out):
        errs, peaks = [], []
        for i in sorted({0, n // 2, n - 1}):
            ref = cross_frame_attention_reference(q[i:i + 1], k, v, heads).float()
            errs.append((out[i:i + 1].float() - ref).abs().max().item())
            peaks.append(ref.abs().max().item())
            del ref
        return max(errs), K1_FOLD_REL_TOL * min(peaks)

    fold = [t.reshape(1, n * l, heads, d).transpose(1, 2) for t in (q, k, v)]
    _k1_case(row, torch.bfloat16, None, lambda: cross_frame_attention(q, k, v, heads),
             lambda: [cross_frame_attention_reference(q[i:i + 1], k, v, heads)
                      for i in range(n)],
             lambda: F.scaled_dot_product_attention(*fold), k1_bound(heads, n * l, n * l, d),
             compare=compare, plain_repeats=2)


def bake_phases(pipe, dev, card: str, k1: dict, k2: dict) -> dict:
    """Phases 14-16: the bake (BASELINE config 1) through Engine.Bake, its
    replay (config 3) through Engine.Run, and all-frames attention. Adds the
    new K1 rows to ``k1`` and the bake's launches to ``k1`` and ``k2``;
    returns the numbers for the summary line."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile, schedule

    from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine.frame_program import frame_step
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.correspondence import (
        DefaultCorresponder,
        OverlapCorresponder,
    )
    from stable_renderer_tpu_torch.ops.flash_attention import (
        attention_pallas,
        flash_attention,
        flash_attention_reference,
    )
    from stable_renderer_tpu_torch.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams
    from stable_renderer_tpu_torch.ops.raster_kernel import rasterize_kernel
    from stable_renderer_tpu_torch.ops.transforms import look_at, perspective, quat_to_matrix

    out = {}
    gen = torch.Generator(device=dev).manual_seed(14)

    # --- 14. the bake: BASELINE config 1 with diffusion ------------------------------
    cmap = CorrespondMap(name="bake_ball", k=3, height=SIZE, width=SIZE)
    corr = DefaultCorresponder(update_corrmap_mode="first")
    rec = {"written": []}

    def recording_finished(engine_data, images):
        """The stock finished, recording submit 1's inputs and the map after
        it, and each submit's written count (on the device, no host sync)."""
        first = "ids" not in rec
        if first:
            rec.update(ids=engine_data.id_maps.clone(), images=images.clone(),
                       frames=engine_data.frame_indices.tolist(),
                       keys=list(engine_data.correspond_maps))
        DefaultCorresponder.finished(corr, engine_data, images)
        rec["written"].append(cmap.written.sum())
        if first:
            rec["after"] = (cmap.values.clone(), cmap.written.clone())

    corr.finished = recording_finished
    stamps = {}

    def on_bake_frame(eng, when):
        fc = eng.RuntimeManager.FrameCount
        if fc == 0 and when == "end":  # the ball's coverage in frame 0's view
            rec["cover0"] = eng.RenderManager.last_gbuffer.id[..., 0] != 0
        if (when, fc) in (("begin", BAKE_INTERVAL), ("begin", BAKE_FRAMES - 1),
                          ("end", BAKE_FRAMES - 1)):
            torch.cuda.synchronize()
            stamps[(when, fc)] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = rasterize_kernel.launches = 0
    t0 = time.perf_counter()
    with k1_shape_tally() as seen:
        eng, _ = run_engine(pipe, SIZE, BAKE_FRAMES, corr, on_bake_frame,
                            lambda: bake_scene(cmap), bake=True, baking_interval=BAKE_INTERVAL)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    bake_mem = torch.cuda.max_memory_allocated()
    k2_bake = rasterize_kernel.launches
    submits = BAKE_FRAMES // BAKE_INTERVAL
    k1_submit = {key: n // submits for key, n in seen.items()}
    if any(n % submits for n in seen.values()) or k1_submit != K1_BAKE_SHAPES:
        fail(f"bake: K1 launches by shape over {submits} submits {dict(seen)}, want "
             f"{K1_BAKE_SHAPES} a submit")
    if k2_bake != BAKE_FRAMES or eng.Mode.name != "BAKE":
        fail(f"bake: K2 {k2_bake} calls in {BAKE_FRAMES} frames, mode {eng.Mode.name}")
    if rec["frames"] != list(range(BAKE_INTERVAL)) or len(rec["written"]) != submits:
        fail(f"bake: submit 1 held frames {rec['frames']}, {len(rec['written'])} submits")
    written = [int(w) for w in rec["written"]]
    if not 0 < written[0] < written[1] or cmap.values.device != dev:
        fail(f"bake: written cells after each submit {written} (must grow), map on "
             f"{cmap.values.device}")
    if not torch.isfinite(cmap.values).all():
        fail("bake: non-finite map values")
    # submit 1's map against the port's plain update on the CPU, fed the same
    # decoded frames and id maps: exact in "first" mode
    cpu_map = CorrespondMap(k=3, height=SIZE, width=SIZE, device="cpu")
    DefaultCorresponder(update_corrmap_mode="first").finished(
        EngineData(frame_indices=torch.arange(BAKE_INTERVAL), id_maps=rec["ids"].cpu(),
                   correspond_maps={rec["keys"][0]: cpu_map}), rec["images"].cpu())
    same_map = (torch.equal(cpu_map.values, rec["after"][0].cpu())
                and torch.equal(cpu_map.written, rec["after"][1].cpu()))
    if not same_map:
        fail(f"bake: submit 1's map differs from the CPU plain update: values max abs "
             f"{(cpu_map.values - rec['after'][0].cpu()).abs().max().item():.3e}, written "
             f"differ in {(cpu_map.written != rec['after'][1].cpu()).sum().item()} cells")
    # one finished call on a scratch map: no host sync, and its device time
    scratch = CorrespondMap(k=3, height=SIZE, width=SIZE, device=dev)
    ed = EngineData(frame_indices=torch.arange(BAKE_INTERVAL), id_maps=rec["ids"],
                    correspond_maps={rec["keys"][0]: scratch})
    fin = DefaultCorresponder(update_corrmap_mode="first")
    syncs = host_syncs(lambda: fin.finished(ed, rec["images"]))
    if syncs:
        fail(f"bake: DefaultCorresponder.finished synchronized the host: {syncs}")
    update_ms = cuda_ms(lambda: fin.finished(ed, rec["images"]), 5)
    submit_ms = (stamps[("end", BAKE_FRAMES - 1)] - stamps[("begin", BAKE_FRAMES - 1)]) * 1e3
    steady_fps = (BAKE_FRAMES - BAKE_INTERVAL) / (
        stamps[("end", BAKE_FRAMES - 1)] - stamps[("begin", BAKE_INTERVAL)])
    # one more submit, its frame profiled after a warm (accumulating) frame
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=BAKE_INTERVAL - 2, warmup=1, active=1,
                                   repeat=1)) as prof:
        def on_prof_frame(eng_, when):
            if when == "end":
                torch.cuda.synchronize()
                prof.step()

        run_engine(pipe, SIZE, BAKE_INTERVAL, DefaultCorresponder(update_corrmap_mode="first"),
                   on_prof_frame, lambda: bake_scene(CorrespondMap(k=3, height=SIZE, width=SIZE)),
                   bake=True, baking_interval=BAKE_INTERVAL)
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep")]
    names = [e.name for e in kernels]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k1_ms = sum(e.time_range.elapsed_us() for e in kernels if "flash_" in e.name) / 1e3
    prof_counts = {"flash_wg": sum("flash_wg" in n_ for n_ in names),
                   "flash_wide": sum("flash_wide" in n_ for n_ in names),
                   "raster_setup": sum("raster_setup" in n_ for n_ in names),
                   "raster_binned": sum("raster_binned" in n_ for n_ in names)}
    prof_want = {"flash_wg": sum(n for key, n in K1_BAKE_SHAPES.items() if key[3] <= 64),
                 "flash_wide": sum(n for key, n in K1_BAKE_SHAPES.items() if key[3] > 64),
                 "raster_setup": 1, "raster_binned": 1}
    if prof_counts != prof_want:
        fail(f"bake: the profiled submit frame launched {prof_counts}, want {prof_want}")
    k1.setdefault("launches_engine", {})["bake"] = sum(seen.values())
    k2.setdefault("launches_engine", {})["bake"] = BAKE_FRAMES
    k1["launches_a_frame"]["bake submit"] = sum(k1_submit.values())
    # the bake's K1 shapes, timed: the UNet's on its fused-QKV chunk views
    # (batch 16, 8 heads), the VAE's (batch 8, one head of 512)
    for bh, l, _, d in K1_BAKE_SHAPES:
        vae = d == 512  # the VAE's one head of 512 on separate q, k, v; the UNet's 8 heads
        label = "bake VAE" if vae else "bake UNet, fused-QKV views"
        heads = 1 if vae else 8
        b = bh // heads
        if not vae:
            qkv = torch.randn((b, l, 3 * heads * d), generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q, k, v = (torch.randn((b, l, d), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3))
        split = [t.unflatten(-1, (heads, d)).transpose(1, 2) for t in (q, k, v)]
        row = {"shape": f"attention_pallas b={b} l={l} heads={heads} d={d} bf16 {label}",
               "launches_a_submit": K1_BAKE_SHAPES[(bh, l, l, d)]}
        _k1_case(row, torch.bfloat16, K1_BF16_TOL, lambda: attention_pallas(q, k, v, heads),
                 lambda: flash_attention_reference(*split).transpose(1, 2).reshape(
                     b, l, heads * d),
                 lambda: F.scaled_dot_product_attention(*split), k1_bound(bh, l, l, d))
        k1["shapes"].append(row)
        print(f"[14 K1] {row}", flush=True)
        del q, k, v, split
    out["bake"] = {"submit_ms": submit_ms, "steady_frames_per_s": steady_fps, "run_s": bake_s,
                   "profiled_submit_device_ms": device_ms, "profiled_submit_k1_ms": k1_ms,
                   "busy_share": device_ms / submit_ms,
                   "corrmap_update_ms": update_ms, "peak_memory_gib": bake_mem / 2**30,
                   "written_after_submits": written, "k1_a_submit": {
                       str(key): n for key, n in k1_submit.items()}}
    print(f"[14 bake] Engine.Bake of bake_ball's scene at {SIZE}x{SIZE}, SD1.5 widths bf16, "
          f"4-step LCM cfg 2.0, DefaultCorresponder('first'), CorrespondMap(k=3, {SIZE}x{SIZE}): "
          f"{BAKE_FRAMES} frames in {bake_s:.2f} s, {submits} submits of {BAKE_INTERVAL}; "
          f"submit frame {submit_ms:.1f} ms (the second), steady {steady_fps:.2f} frames/s over "
          f"frames {BAKE_INTERVAL}-{BAKE_FRAMES - 1}; one finished() "
          f"(the corrmap update of {BAKE_INTERVAL} frames) {update_ms:.2f} ms, no host sync; "
          f"written cells after each submit {written}; submit 1's map equal to the CPU plain "
          f"update (exact); K1 a submit by (BH, Lq, Lk, d) {k1_submit}, K2 "
          f"{k2_bake} calls; profiled submit frame {prof_counts}, its kernels {device_ms:.1f} ms "
          f"(K1 {k1_ms:.1f}), busy share {device_ms / submit_ms:.3f} of the timed submit; peak memory "
          f"{bake_mem / 2**30:.2f} GiB | {card}", flush=True)

    # --- 15. replay: BASELINE config 3 ------------------------------------------------
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke_corrmap_", dir=build))
    zpath = cmap.dump(work, zip=True)
    loaded = CorrespondMap.Load(zpath)
    # the uint8 grid as dump and Load define it, in numpy on the host
    grid = np.clip(255.0 * cmap.values.cpu().numpy(), 0, 255).astype(np.uint8)
    grid = torch.from_numpy(grid.astype(np.float32) / 255.0)
    if loaded.values.device != dev or not (torch.equal(loaded.values.cpu(), grid)
                                          and torch.equal(loaded.written, cmap.written)):
        fail(f"replay: dump/Load round trip differs from the map on the uint8 grid (on "
             f"{loaded.values.device}): values max abs "
             f"{(loaded.values.cpu() - grid).abs().max().item():.3e}")
    n_replay = REPLAY_WARM + REPLAY_TIMED + PRESENT_DEPTH
    cells = {}

    def keep_cells(label: str):
        """An on_frame hook keeping frame 0's G-buffer (map index, vertex
        id), which map cell each pixel drew, as cells[label]."""
        def hook(eng_, when):
            if when == "end" and eng_.RuntimeManager.FrameCount == 0:
                cells[label] = eng_.RenderManager.last_gbuffer.id[..., 2:].cpu()
        return hook

    torch.cuda.synchronize()
    flash_attention.launches = rasterize_kernel.launches = 0
    eng, presented = run_engine(
        None, SIZE, n_replay, None, keep_cells("card"),
        lambda: bake_scene(loaded, frames_a_turn=n_replay, prompt=""), disableComfyUI=True)
    if (eng.device.type != "cuda" or eng.Mode.name != "GAME" or flash_attention.launches
            or rasterize_kernel.launches != n_replay
            or [i for _, i, _ in presented] != list(range(n_replay))):
        fail(f"replay: device {eng.device}, mode {eng.Mode.name}, K1 {flash_attention.launches}, "
             f"K2 {rasterize_kernel.launches} calls, presented {[i for _, i, _ in presented]}")
    stamps_r = [t for t, _, _ in presented[REPLAY_WARM - 1:REPLAY_WARM + REPLAY_TIMED]]
    gaps = sorted((b - a) * 1e3 for a, b in zip(stamps_r, stamps_r[1:]))
    r_ms = statistics.median(gaps)
    r_p90 = statistics.quantiles(gaps, n=10, method="inclusive")[-1]
    frame0 = torch.from_numpy(presented[0][2])
    # the same replay on the CPU: the map loaded there, the plain rasterizer
    loaded_cpu = CorrespondMap.Load(zpath, device="cpu")
    t0 = time.perf_counter()
    _, cpu_frames = run_engine(
        None, SIZE, 1, None, keep_cells("cpu"),
        lambda: bake_scene(loaded_cpu, frames_a_turn=n_replay, prompt=""), disableComfyUI=True,
        device="cpu")
    cpu_s = time.perf_counter() - t0
    diff = (frame0.int() - torch.from_numpy(cpu_frames[0][2]).int()).abs()
    over = (diff > 1).any(-1)
    same_cell = (cells["card"] == cells["cpu"]).all(-1)
    cover = rec["cover0"].cpu()
    written_px = (frame0[..., 3] > 0) & cover
    pink = ((frame0[..., 0] == 255) & (frame0[..., 1] == 0) & (frame0[..., 2] == 255)) & cover
    replay_check = {"max_abs_diff": int(diff.max()), "pixels_over_one_step": int(over.sum()),
                    "over_one_step_in_the_same_cell": int((over & same_cell).sum()),
                    "cells_differ_share": float((~same_cell).float().mean()),
                    "ball_pixels": int(cover.sum()),
                    "ball_written_share": float(written_px.sum() / cover.sum()),
                    "ball_pink_share": float(pink.sum() / cover.sum())}
    if frame0.shape != (SIZE, SIZE, 4) or frame0.dtype != torch.uint8:
        fail(f"replay: frame 0 is {tuple(frame0.shape)} {frame0.dtype}")
    # within one uint8 step wherever both replays drew the same map cell;
    # where the plain rasterizer and K2 differ at an edge (phase 4) a pixel
    # may draw another cell, and those pixels are few
    if (replay_check["over_one_step_in_the_same_cell"]
            or replay_check["pixels_over_one_step"] > REPLAY_EDGE_SHARE * cover.sum()):
        fail(f"replay: frame 0 differs from the CPU replay by more than one uint8 step: "
             f"{replay_check}")
    # the ball shows the map: not the pink of a draw without one, and more than
    # one color (its written share is reported: the BAKED lookup reads the
    # cell at the reference's swapped uv axes, ops/gbuffer.py, which other
    # views than frame 0's wrote)
    colors = len(torch.unique(frame0[cover][:, :3], dim=0))
    replay_check["ball_colors"] = colors
    if not (replay_check["ball_pink_share"] < 0.5 and replay_check["ball_written_share"] > 0
            and colors > 100):
        fail(f"replay: frame 0's ball does not show the map: {replay_check}")
    out["replay"] = {"median_ms": r_ms, "p90_ms": r_p90, "fps": 1e3 / r_ms, "gaps_ms": gaps,
                     "cpu_frame_s": cpu_s, **replay_check}
    print(f"[15 replay] dump (zip) -> Load round trip equal on the uint8 grid; Engine.Run GAME "
          f"mode, disableComfyUI, {n_replay} BAKED frames at {SIZE}x{SIZE}: present-to-present "
          f"median {r_ms:.2f} ms ({1e3 / r_ms:.1f} fps), p90 {r_p90:.2f} ms over "
          f"{REPLAY_TIMED} frames after {REPLAY_WARM} warm; K2 {n_replay} calls, no K1; frame 0 "
          f"vs the CPU replay ({cpu_s:.1f} s): {replay_check} | {card}", flush=True)
    del loaded, loaded_cpu, cmap

    # --- 16. all-frames attention --------------------------------------------------
    for n, l, heads, d in CROSS_FRAME_SHAPES:
        row = {"shape": f"cross_frame_attention n={n} l={l} heads={heads} d={d} bf16 "
                        f"(K1 bh={heads} lq=lk={n * l})"}
        if n == BAKE_INTERVAL:
            row["launches_a_submit"] = K1_ALL_FRAMES_SHAPES[(heads, n * l, n * l, d)]
        _cross_frame_case(row, n, l, heads, d, gen)
        k1["shapes"].append(row)
        print(f"[16 all-frames] {row}", flush=True)
    # one bake submit through frame_step: 7 accumulated frames and the 8th
    view = look_at([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]).numpy()
    proj = perspective(45.0, 1.0, 0.1, 100.0).numpy()
    sphere = Mesh.Sphere(1.0, 48)
    sigs = ((DrawUniforms(sprite_id=1, material_id=1, render_mode=RENDER_MODE_BAKING,
                          use_texcoord_as_id=True), (SIZE, SIZE), None, None),)
    sprites = {1: Sprite(spriteID=1, prompt=BAKE_PROMPT)}
    _, ctx, nctx, _, _ = pipe.prepare_conditioning(sprites, (EnvPrompt(""),), BAKE_INTERVAL)
    bg = torch.randn((1, SIZE, SIZE, 4), generator=gen, device=dev)
    corr_af = OverlapCorresponder(all_frames=True, layer_range=None, update_corrmap=False)

    def bake_frame(f: int, pending=None):
        half = math.radians(360.0 / 16 * f) / 2.0
        model = quat_to_matrix([math.cos(half), 0.0, math.sin(half), 0.0]).numpy()
        draws = (dict(buffers=mesh_device_buffers(sphere, dev), mv=view @ model, diffuse=None,
                      noise=None, corrmap=None),)
        key = torch.Generator(device=dev).manual_seed(pipe.config.seed + f)
        return frame_step(pipe, corr_af, (), sigs, SIZE, SIZE, pending is not None, True,
                          PostProcessParams(), (), True, draws, proj, bg, pending, ctx, nctx,
                          pipe.scheduler_sigmas(), key, *pipe.compute_params())

    packs = [bake_frame(f)[2] for f in range(BAKE_INTERVAL - 1)]
    pending = {k_: torch.stack([p[k_] for p in packs]) for k_ in packs[0]}
    times = []
    torch.cuda.reset_peak_memory_stats()
    for rep in range(2):
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with k1_shape_tally() as seen_af:
            disp, _, _, images, _, _ = bake_frame(BAKE_INTERVAL - 1, pending)
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if dict(seen_af) != K1_ALL_FRAMES_SHAPES:
            fail(f"all-frames submit: K1 launches by (BH, Lq, Lk, d) {dict(seen_af)}, want "
                 f"{K1_ALL_FRAMES_SHAPES}")
        if tuple(images.shape) != (BAKE_INTERVAL, SIZE, SIZE, 3) or not (
                torch.isfinite(images).all() and torch.isfinite(disp.float()).all()):
            fail(f"all-frames submit: images {tuple(images.shape)}, finite "
                 f"{bool(torch.isfinite(images).all())}")
    af_mem = torch.cuda.max_memory_allocated()
    k1["launches_a_frame"]["all-frames bake submit"] = sum(seen_af.values())
    out["all_frames"] = {"submit_ms": times[-1], "first_submit_ms": times[0],
                         "peak_memory_gib": af_mem / 2**30,
                         "k1_a_submit": {str(key): n for key, n in seen_af.items()}}
    print(f"[16 all-frames] a bake submit of {BAKE_INTERVAL} frames through frame_step with "
          f"OverlapCorresponder(all_frames=True, layer_range=None): {times[-1]:.1f} ms (first "
          f"{times[0]:.1f} ms), finite {tuple(images.shape)} frames; K1 a submit by (BH, Lq, "
          f"Lk, d) {dict(seen_af)}; peak memory {af_mem / 2**30:.2f} GiB | {card}", flush=True)
    return out


def perturbed_controlnet(pipe, spec, seed: int) -> None:
    """``pipe.add_random_controlnet(spec, seed)``, then its zero convs,
    middle_block_out and last hint conv drawn from a generator seeded with
    ``seed`` + 100 on the pipeline's device: weights N(0, CONTROL_PERTURB^2
    / fan-in), biases N(0, CONTROL_PERTURB^2). A fresh ControlNet adds exact
    zeros; this one moves the frame."""
    pipe.add_random_controlnet(spec, seed=seed)
    perturb_zero_convs(pipe.controlnets[-1][1], seed + 100)


def perturb_zero_convs(params: dict, seed: int) -> None:
    import torch

    w0 = params["middle_block_out"]["0"]["weight"]
    gen = torch.Generator(device=w0.device).manual_seed(seed)
    leaves = [params["middle_block_out"]["0"], params["input_hint_block"]["14"]]
    leaves += [z["0"] for z in params["zero_convs"].values()]
    for leaf in leaves:
        w, b = leaf["weight"], leaf["bias"]
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        leaf["weight"] = (torch.randn(w.shape, generator=gen, device=w.device)
                          * (CONTROL_PERTURB / fan_in ** 0.5)).to(w.dtype)
        leaf["bias"] = (torch.randn(b.shape, generator=gen, device=b.device)
                        * CONTROL_PERTURB).to(b.dtype)


def _count_int8(tree) -> int:
    if isinstance(tree, dict):
        return int("weight_q" in tree) + sum(_count_int8(v) for v in tree.values())
    return 0


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


if __name__ == "__main__":
    main()
