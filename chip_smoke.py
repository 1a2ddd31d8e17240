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
                place) and on an unaligned view (copied by the wrapper).
  4. K2       — the setup kernel and the binned tile kernel (two launches a
                call, by torch.profiler) at 512x512, bit for bit against their
                plain versions (triangle_setup, tile_ranges,
                rasterize_tiles_reference) on the bench sphere and on a
                triangle soup (raster_soup), and the bench sphere against the
                plain rasterize at the bars of tests/test_raster_pallas.py.
  5. reference — a tiny pipeline's 128x128 frame on the GPU (both kernels) vs
                the same frame's diffusion on the CPU plain path.
  6. frame    — the bench frame at full SD1.5 widths (random bf16 weights),
                1 warm + 4 timed frames of frame_step at 512x512, with the
                kernels' launch counts checked.
  7. K3       — the fused 3x3 conv kernel vs its plain version at every shape
                class of the int8 frame (int8, bit for bit) and of the
                switched frame (bf16, with the GroupNorm+SiLU prologue where
                the frame has it); nine of them timed (K3_TIMED_SHAPES).
  8. K4       — the one-launch GroupNorm kernel vs its plain version at every
                shape class of the switched frame (K4_SWITCHED_FRAME_SHAPES),
                two calls bit-identical, the cluster held by the card; three
                shapes timed (K4_TIMED_SHAPES), one kernel a call.
  9. int8     — the calibrated int8 frame: RenderConfig(int8_conv=True) ->
                from_random -> quantize_convs, 1 warm + 4 timed 512x512
                frames; K1, K2 and K3 launch counts checked; the decoded image
                against phase 6's bf16 frame at the same inputs, and one UNet
                evaluation against the bf16 UNet.
 10. switches — one bf16 frame with the float K3 switch and the K4 switch on;
                launch counts checked; the image against phase 6's frame.
 11. engine   — the bench scene through the port's entry point, Engine.Run
                (bench.py:216-251's BenchApp, debug=True, so a failing manager
                raises), with phase 6's bf16 and phase 9's int8 pipelines:
                2 warm + 4 timed presented frames each (and PRESENT_DEPTH more,
                so every timed present happens in a steady frame), each
                presented frame (512, 512, 4) uint8 and not constant; the
                launch counts a frame, by the counters over the run and by
                torch.profiler on one frame after a warm one, equal to phases
                6 and 9's; the engine's first frame identical to frame_step's
                at the same model-view matrix, background noise and generator
                seed; the frame-time median and p90 from the present
                timestamps (bench.py:238-247) beside phase 6's and 9's
                frame_step medians.
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
K1_BF16_TOL = 1e-2  # bf16 output rounding (2^-8 relative) + the plain path's bf16 softmax weights
K1_F32_TOL = 1e-4   # f32: summation order only
REF_TOL = 2e-3      # tiny f32 frame, GPU kernels vs CPU plain path (order of f32 sums)
# K3 and K4 launches a frame, counted on the meta device by
# tests/test_torch_conv_kernel.py: int8 4 x 22 (UNet) + 20 (encode) + 31 (decode);
# with both switches, K3 4 x 11 + 20 + 29 and K4 4 x 43 + 2 + 1
K3_INT8_CALLS_PER_FRAME = 139
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
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative
K3_BF16_ATOL = 1e-3    # near zero, where the bf16 step is tiny: f32 sum order
K4_ATOL = 1e-5
INT8_UNET_COS_BAR = 0.99  # int8 vs bf16, one UNet evaluation (the JAX package's bar, tests/test_quant.py:193)
INT8_FRAME_COS_FLOOR = 0.9  # int8 vs bf16 decoded frame: random weights push the frame's
# activations past their calibrated ranges (PERF.md, section 5), so the frame gets a floor only
SWITCH_MEAN_BAR = 0.02  # switched vs unswitched frame, mean abs on [0, 1] pixels
SWITCH_MAX_BAR = 0.25   # ... and max abs
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
    ``calls`` calls recorded; fails if they did not launch the same kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep")]
    if len(names) % calls or names != names[:len(names) // calls] * calls:
        fail(f"{calls} calls launched {names}")
    return names[:len(names) // calls]


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


def _k1_case(row: dict, dt, tol: float, kernel, plain, library, k1b) -> float:
    """Run one K1 case: the kernel against its plain version (fails past
    tol), then for bf16 its device time by graph replay (ms), per call with
    the host's launch cost (ms_with_host), the plain version's and the
    library call's (SDPA) times and the bound. Fills row; returns the error."""
    import torch

    out = kernel()
    torch.cuda.synchronize()
    err = (out.float() - plain().float()).abs().max().item()
    if not math.isfinite(err) or err > tol:
        fail(f"K1 {row['shape']}: max abs err {err:.3e} > {tol:g}")
    row["max_abs_err"] = err
    if dt == torch.bfloat16:
        row["ms"] = graph_ms(kernel)
        row["ms_with_host"] = cuda_ms(kernel, 20)
        row["plain_ms"] = cuda_ms(plain, 10)
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


def run_engine(pipe, size: int, frames: int, corr, on_frame=None):
    """The bench scene (bench.py:227-236) through the port's ``Engine.Run``
    with ``debug=True``; ``on_frame(engine, "begin" | "end")`` runs at each
    frame's beforeFrameBegin and beforeFrameEnd. Returns the engine and its
    presents as (host time, frame index, uint8 frame)."""
    from stable_renderer_tpu_torch.engine import (
        AutoRotation,
        Camera,
        Engine,
        GameObject,
        Mesh,
        MeshRenderer,
        SpriteInfo,
    )

    class BenchApp(Engine):
        def beforePrepare(self):
            cam = GameObject("camera")
            self.cam = cam.addComponent(Camera)
            self.cam.env_prompt.prompt = "a ball"
            cam.transform.position = [0.0, 0.5, 3.0]
            cam.transform.lookAt([0.0, 0.0, 0.0])
            self.ball = GameObject("ball")
            self.ball.addComponent(SpriteInfo, prompt="a shiny ball")
            self.ball.addComponent(MeshRenderer, mesh=Mesh.Sphere(1.0, 48))
            self.ball.addComponent(AutoRotation, speed_deg=4.0)

        def beforeFrameBegin(self):
            if on_frame is not None:
                on_frame(self, "begin")

        def beforeFrameEnd(self):
            if on_frame is not None:
                on_frame(self, "end")

    presented = []
    Engine._reset()
    eng = BenchApp.Run(winSize=(size, size), pipeline=pipe, corresponder=corr, max_frames=frames,
                       debug=True, frame_callback=lambda f, i: presented.append(
                           (time.perf_counter(), i, f)))
    return eng, presented


def engine_frame_kernels(pipe, size: int, corr) -> list:
    """The names of the kernels one engine frame launches on the card, by
    torch.profiler: a two-frame ``run_engine`` whose first frame is the
    profiler's warm-up step (its events dropped) and whose second is
    recorded, the device synchronized at both ends of each frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        def on_frame(eng, when):
            torch.cuda.synchronize()
            if when == "end":
                prof.step()

        run_engine(pipe, size, 2, corr, on_frame)
    return [e.name for e in prof.events()
            if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep")]


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
    # place; and a view whose rows are 321 elements apart, which the wrapper
    # copies (16-byte row copies need rows 8 elements apart)
    from stable_renderer_tpu_torch.ops.flash_attention import attention_pallas, needs_copy

    b, l, heads, d = 2, 4096, 8, 40
    qkv = torch.randn((b, l, 3 * heads * d), generator=gen, device=dev).to(torch.bfloat16)
    unaligned = torch.randn((3, b, l, heads * d + 1), generator=gen, device=dev).to(torch.bfloat16)
    for label, (q, k, v) in (("fused-QKV view", qkv.chunk(3, dim=-1)),
                             ("unaligned view, copied", unaligned[..., 1:])):
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
    del qkv, unaligned, q, k, v, qh, split
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

    def run_frame(pipe, size, frame, corr, bg, step_noise=None, mats=None):
        d = pipe.device
        mv, proj = bench_matrices(frame) if mats is None else mats
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
    ms = statistics.median(times[1:])
    print(f"[6 frame] {SIZE}x{SIZE} SD1.5 widths bf16, 4-step LCM cfg 2.0, sequential: "
          f"median {ms:.1f} ms/frame ({1e3 / ms:.2f} fps) over {FRAMES_TIMED} frames, warm frame "
          f"{times[0]:.1f} ms; K1 {k1['launches']} and K2 {k2['launches']} launches in "
          f"{n_frames} frames; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}", flush=True)

    # --- 7. K3 ----------------------------------------------------------------
    from stable_renderer_tpu_torch.ops.conv_kernel import (
        conv3x3_kernel,
        conv3x3_kernel_reference,
        conv_tiles,
    )

    k3 = {"name": "conv3x3_kernel", "route": "cuda",
          "source": "stable_renderer_tpu_torch/csrc/conv3x3.cu",
          "replaces": "stable_renderer_tpu/ops/conv_pallas.py:86", "shapes": []}
    # every shape class the int8 and switched frames launch, checked; the
    # K3_TIMED_SHAPES rows also timed
    k3_cases = [(s, "int8") for s in K3_INT8_FRAME_SHAPES]
    k3_cases += [(k[:5], "bf16+prologue" if k[5] else "bf16") for k in K3_SWITCHED_FRAME_SHAPES]
    k3_cases += [c for c in K3_TIMED_SHAPES if c not in k3_cases]
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
        if ((n, h, w, cin, cout), mode) not in K3_TIMED_SHAPES:
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
    from dataclasses import replace as dc_replace

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
    for f in range(1 + FRAMES_TIMED):
        t0 = time.perf_counter()
        disp, gbuf, pack, images, _, _ = run_frame(pipe_i8, SIZE, f, corr_i8, bg)
        host = disp.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(images).all() or host.shape != (SIZE, SIZE, 4):
            fail(f"int8 frame {f}: non-finite image or display {tuple(host.shape)}")
        if f == 0:
            i8_images = images.float().clone()
    counts = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches,
              group_norm_kernel.launches)
    want = (K1_CALLS_PER_FRAME * n_frames, n_frames, K3_INT8_CALLS_PER_FRAME * n_frames, 0)
    if counts != want:
        fail(f"int8 frames: launches K1, K2, K3, K4 = {counts}, want {want}")
    k3["launches"] = counts[2]
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
    _, _, _, sw_images, _, _ = run_frame(pipe, SIZE, 0, OverlapCorresponder(
        vertex_segments=4096, update_corrmap=False), bg)
    torch.cuda.synchronize()
    sw_ms = (time.perf_counter() - t0) * 1e3
    use_pallas_conv(False)
    layers._group_norm_pallas_on = False
    counts = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches,
              group_norm_kernel.launches)
    want = (K1_CALLS_PER_FRAME, 1, K3_SWITCHED_CALLS_PER_FRAME, K4_SWITCHED_CALLS_PER_FRAME)
    if counts != want:
        fail(f"switched frame: launches K1, K2, K3, K4 = {counts}, want {want}")
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
    for label, p_, step_ms in (("bf16", pipe, ms), ("int8", pipe_i8, ms_i8)):
        int8 = label == "int8"
        first = {}

        def keep_first(eng, when):
            if eng.RuntimeManager.FrameCount != 0:
                return
            rm = eng.RenderManager
            if when == "begin":  # the model matrix frame 0 draws with: MeshRenderer
                # submits its draw before AutoRotation turns the ball
                first["mats"] = (eng.cam.viewMatrix @ eng.ball.transform.globalTransformMatrix,
                                 eng.cam.projectionMatrix(1.0))
            else:
                first.update(images=rm.last_diffusion_frames.float().clone(),
                             bg=rm.GlobalBGNoise)

        n_eng = ENGINE_WARM + FRAMES_TIMED + PRESENT_DEPTH
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
        want = (K1_CALLS_PER_FRAME * n_eng, n_eng, K3_INT8_CALLS_PER_FRAME * n_eng * int8, 0)
        if counts != want:
            fail(f"engine {label}: launches K1, K2, K3, K4 over {n_eng} frames = {counts}, "
                 f"want {want}")
        if eng.device.type != "cuda" or [i for _, i, _ in presented] != list(range(n_eng)):
            fail(f"engine {label}: device {eng.device}, presented "
                 f"{[i for _, i, _ in presented]}")
        for _, i, frame in presented:
            if frame.shape != (SIZE, SIZE, 4) or frame.dtype.name != "uint8":
                fail(f"engine {label} frame {i}: presented {frame.shape} {frame.dtype}")
            if int(frame[..., :3].max()) == int(frame[..., :3].min()):
                fail(f"engine {label} frame {i}: constant frame")
        # present intervals of the timed frames; frame i is presented in frame
        # i + PRESENT_DEPTH's run, so these all fall in steady frames
        stamps = [t for t, _, _ in presented[ENGINE_WARM - 1:ENGINE_WARM + FRAMES_TIMED]]
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
            mats=first["mats"])
        torch.cuda.synchronize()
        first_err = (first["images"] - ref_images.float()).abs().max().item()
        if not torch.equal(first["images"], ref_images.float()):
            fail(f"engine {label}: frame 0 differs from frame_step's at the same inputs, "
                 f"max abs {first_err:.3e}")
        # one frame's kernels by the profiler, after a warm frame
        flash_attention.launches = rasterize_kernel.launches = conv3x3_kernel.launches = 0
        names = engine_frame_kernels(
            p_, SIZE, OverlapCorresponder(vertex_segments=4096, update_corrmap=False))
        prof_counts = (sum("flash_wg" in k or "flash_wide" in k for k in names),
                       sum("raster_binned" in k for k in names),
                       sum("raster_setup" in k for k in names),
                       sum("conv3x3_wgmma" in k for k in names))
        prof_want = (K1_CALLS_PER_FRAME, 1, 1, K3_INT8_CALLS_PER_FRAME * int8)
        two = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches)
        if prof_counts != prof_want or two != (2 * K1_CALLS_PER_FRAME, 2,
                                               2 * K3_INT8_CALLS_PER_FRAME * int8):
            fail(f"engine {label}: one profiled frame launched K1, K2 binned, K2 setup, K3 = "
                 f"{prof_counts}, want {prof_want}; counters over its two frames K1, K2, K3 "
                 f"= {two}")
        engine_ms[label] = {"median_ms": e_ms, "p90_ms": e_p90, "frame_step_median_ms": step_ms,
                            "gaps_ms": gaps, "frames": n_eng, "run_s": run_s}
        k1.setdefault("launches_engine", {})[label] = counts[0]
        k2.setdefault("launches_engine", {})[label] = counts[1]
        if int8:
            k3["launches_engine"] = counts[2]
        print(f"[11 engine] {label}: Engine.Run of the bench scene at {SIZE}x{SIZE}, {n_eng} "
              f"frames in {run_s:.2f} s; present-to-present median {e_ms:.1f} ms, p90 "
              f"{e_p90:.1f} ms over {FRAMES_TIMED} timed frames after {ENGINE_WARM} warm "
              f"(frame_step's median, phase {9 if int8 else 6}: {step_ms:.1f} ms); launches K1 "
              f"{counts[0]}, K2 {counts[1]}, K3 {counts[2]}, K4 {counts[3]} ({n_eng} frames); "
              f"profiled frame K1 {prof_counts[0]}, K2 {prof_counts[1]} + {prof_counts[2]} "
              f"setup, K3 {prof_counts[3]}; frame 0 identical to frame_step's | {card}",
              flush=True)
    del pipe_i8

    print(json.dumps({"kernels": [k1, k2, k3, k4], "frame_ms": ms, "int8_frame_ms": ms_i8,
                      "engine_frame_ms": engine_ms, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


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
