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
                shapes (bf16), one ragged K/V length, the all-frames bake
                submit's folded levels 1 and 2 (d = 80, 160: the mid wgmma
                route), the loaded f32 VAE's attention (the f32 route), f32
                checks, and attention_pallas on the UNet's fused-QKV chunk
                views (read in place) at batch 2 (the sequential frame) and 8
                (the stream frame), and on an unaligned view (copied by the
                wrapper). Each row names its kernel (k1_route).
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
                layer_range=None): K1's launches by shape and by kernel
                (levels 1 and 2 on the mid wgmma route), finite frames.
 17. TAESD   — bench.py's TAESD modes with the TAESD autoencoder
                (with_taesd(), random f32 weights from seed 11): the
                sequential bf16 frame (SR_BENCH_TAESD=1) and the int8
                stream frame with lag-1 K/V (SR_BENCH_TAESD=1
                SR_BENCH_STREAM=1 SR_BENCH_STREAM_KV=1 SR_BENCH_INT8=1):
                TAESD encode and decode at 64x64 on the card against the
                CPU plain path (f32 within TAESD_F32_TOL; bf16 within twice
                the CPU's own bf16 error against f32); frame_step over 1
                warm + 4 timed frames (and the stream's 3 transient) with K1,
                K2 and K3 launches by the counters and K3's by class
                (k3_shape_tally: no VAE class is left), one steady stream
                call checked free of host syncs; each through Engine.Run as
                in phase 11 (frames (512, 512, 4) uint8, not constant,
                launch counts, frame 0 identical to frame_step's); then the
                engine frame timed in alternating runs with the VAE frame of
                the same mode (TAESD_ALTERNATION). The flicker metrics
                (temporal_flicker_l1, temporal_flicker_ssim, vertex_flicker
                over the ball's vertex ids) of the first TAESD run's
                presented frames, on the card and on the CPU, within
                METRIC_REL_TOL.
 18. options  — a batch of two bench views drawn in BAKING mode (valid vertex
                ids) through the sequential program (_render, as frame_step
                calls it with a pending frame) with phase 6's bf16 pipeline
                and fixed sampler draws, once for each of vertex_noise (no
                noise maps), the frame_distance, pixel_distance and
                view_normal weightings: two runs of the average frame
                equal bit for bit (the segment sums' order is fixed), and
                each option finite and moved from the average frame by more
                than they differ; each held at 64x64 with a tiny pipeline on the card
                against the same pipeline on the CPU (noise and vertex-noise
                draws passed in) within REF_TOL. output_ai_canny: the bench
                scene through Engine.Run with map dumps on, its ai_canny map
                written and equal to the CPU's canny of the same colour map
                but at pixels f32 rounding may flip (ops.canny.
                unstable_pixels); canny at 64x64 the same way.
 19. bench    — python bench_torch.py in its default mode, SR_BENCH_FRAMES=4,
                as its own process: exit 0, its last stdout line bench.py's
                four-key JSON with "(cuda)" in the metric and a positive fps,
                its first stderr note both TF32 switches off.
 20. checkpoint — phase 6's trees (UNet, VAE, CLIP) written as one BF16
                .safetensors in the LDM key layout by the port's writer
                (size, write and read times; read back bit for bit) and
                loaded by DiffusionPipeline.from_checkpoint on the card: the
                SD1.5 config detected, every key consumed, every leaf equal
                to what was written after the JAX package's casts (VAE and
                CLIP to f32). The bench scene through Engine.Run with it
                (K1 22 a frame, the f32 VAE's two on K1's f32 route,
                flash_f32, counted by kernel), its frame 0 identical to
                frame_step's for a pipeline built in memory from the same
                trees at the same types; phase 3's f32 row gets these
                launches. An
                LCM-LoRA-shaped file (rank 64, F16, LDM names, every
                attention projection, ff, proj_in and proj_out) merged by
                from_checkpoint: modules applied, merge time, sampled leaves
                equal to a plain f32 merge on the CPU. The loaded pipeline
                quantized (int8_conv): K3 139 a frame by class. Control
                files through add_control_from_state_dict: two perturbed
                ControlNets under control_model. (frame equal to
                add_controlnet's with the same params, K1 38), a rank-8
                control-LoRA and a full-width T2I-Adapter (finite, moved
                frames; the adapter's K3 launches under the switch). A
                2-vector textual-inversion file: a prompt with
                embedding:name encoded on the card against the CPU.
 21. left-outs — (a) the bench scene with a second prompted sprite (a cube)
                through Engine.Run with scene conditioning: (512, 512, 4)
                uint8 frames, K1 22 a frame with the UNet's level-0
                self-attention at BH 32 (SCENE_K1_SHAPE, timed beside SDPA
                as a K1 row), frame 0 identical to frame_step's at the
                engine's inputs, moved from the same scene with one prompt;
                (b) LEFT_OUT_SAMPLERS at full width, one frame_step each,
                K1 5 an evaluation + 2; (c) the 19 samplers on the tiny f32
                UNet, 4 steps, card against CPU with the same draws and
                Brownian increments (SAMPLER_TOL), and the Brownian bridge on
                the card (repeat, additivity, unit variance); (d) phase 20's
                trees with conv_in widened to 9 channels, written and loaded
                by from_checkpoint (in_channels 9, every leaf the file's), a
                keep_background frame whose background latent is kept bit
                for bit; (e) user shaders through Engine.Run: identity vertex
                and fragment shaders give the fixed pipeline's frames bit for
                bit, Shader.DefaultDebug() moves the G-buffer color.
 22. files    — meshes from files, the command line and the scripts, with
                phase 20's checkpoint file: the bench sphere written by
                write_mesh as OBJ (vt, vn, two usemtl groups), binary and
                ascii STL, binary PLY, GLB, DAE and ascii FBX, and
                Sphere(1.0, 256) (130,560 triangles) as OBJ and GLB, each
                read by Mesh.Load (check_loaded_mesh: corners, uvs, normals,
                materials); the OBJs by the native parser, equal to load_obj
                array for array, both load times printed. K2 on the big OBJ
                from the bench camera at 512x512, bit for bit against its
                plain versions, timed as in phase 4 (a row joining K2's
                "shapes"). `python -m stable_renderer_tpu_torch render --obj
                <big OBJ> --checkpoint <file>` as its own process: exit 0, its
                fps line, six 512x512 frames not constant, K2 one call and K1
                phase 20's 22 a frame by its launch line; the big mesh with
                two materials through Engine.Run (two K2 calls a frame). In
                process: the CLI's bake (8 frames, k 3: cells written) and
                replay of its map (frames that differ from the unbaked
                raster frame); the five scripts/*_torch.py at 512x512 (the
                checkpoint where the script takes one; miku's two random
                ControlNets, K1 38 a frame); scripts/diffusion_ab_torch.py
                with the checkpoint at 512x512, both runs' metrics finite.
Every kernel line carries its time (K1's timed rows, K2, K3 and K4: device time of
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
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
K1_F32_CALLS_LOADED = 2  # the f32 VAE's mid-block attention, encode and decode
# the first kernel of each K1 launch, by name (a K/V-split launch adds a merge)
K1_KERNELS = ("flash_wg", "flash_wide", "flash_simt_f32", "flash_f32")
VAE_ATTN_SHAPE = (1, 4096, 4096, 512)  # (BH, Lq, Lk, d) at 512x512
# the all-frames bake submit's folded levels 1 and 2 (in K1_ALL_FRAMES_SHAPES),
# timed in phase 3 on K1's mid wgmma route
K1_LEVEL_SHAPES = ((8, 8192, 8192, 80), (8, 2048, 2048, 160))
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
# a profiled run whose record lacks kernels the program launched (the tracer
# drops events now and then, and after CUDA-graph captures may record none)
# is made again, up to this many times in all; see tracer_dropped
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
# the TAESD frames (phase 17): no VAE mid-block attention and no VAE conv:
# the sequential frame's K1 is the UNet's 20, the stream frame's 5, and the
# int8 stream frame's K3 the batch-8 UNet's classes alone
K1_TAESD_CALLS_PER_FRAME = K1_CALLS_PER_FRAME - 2
K1_STREAM_TAESD_CALLS_PER_FRAME = K1_STREAM_CALLS_PER_FRAME - 2
K3_STREAM_TAESD_FRAME_SHAPES = {k: v for k, v in K3_STREAM_FRAME_SHAPES.items()
                                if k[0] == 2 * STREAM_DEPTH}
TAESD_F32_TOL = 1e-4   # TAESD at 64x64 in f32, card vs CPU: order of f32 sums
METRIC_REL_TOL = 1e-4  # the flicker metrics, card vs CPU, relative
OPTION_WEIGHTINGS = ("frame_distance", "pixel_distance", "view_normal")
# phase 17's engine runs, VAE and TAESD frames of one mode in turns
TAESD_ALTERNATION = ("vae", "taesd", "taesd", "vae", "vae", "taesd")
REPLAY_WARM = 2      # phase 15's warm replay frames
REPLAY_TIMED = 8     # ... and timed ones (config 3: 8 frames of free playback)
# replay frame 0 against the CPU replay: the pixels more than one uint8 step
# apart, each in a map cell the two rasterizers chose differently, at most
# this share of the ball's pixels
REPLAY_EDGE_SHARE = 1e-3
# phase 20: the LoRA file's rank (the public LCM-LoRA for SD1.5's) and alpha,
# the control-LoRA's rank, the textual-inversion vectors; the CLIP encoding
# with an embedding, card against CPU in f32 (order of f32 sums)
CKPT_LORA_RANK = 64
CKPT_LORA_ALPHA = 64.0
CONTROL_LORA_RANK = 8
TI_VECTORS = 2
TI_TOL = 1e-4
# the full-width T2I-Adapter's 3x3 convs that pass the float K3 gate (>= 64^2
# pixels, >= 128 channels): conv_in and stage 0's two block1s, at 64x64 from
# a 512x512 hint; its later stages are below 64^2 and its block2s are 1x1
T2I_K3_CLASSES = {(1, 64, 64, 192, 320): 1, (1, 64, 64, 320, 320): 2}
# NVIDIA H100 SXM data sheet (700 W): dense tensor-core and FMA peaks, HBM rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12
# exponentials: 16 ex2 a clock on each SM's MUFU pipes x 132 SMs x 1.83 GHz,
# the clock at which the data sheet's 989 TFLOP/s holds (132 SMs x 4 tensor
# cores x 1024 bf16 operations a clock): ~3.9 T exponentials a second
EXP_PER_S = 16 * 132 * 1.83e9
# phase 21: the scene frame's UNet batch is (S + 2) x B = 4 rows (two prompted
# sprites, the environment prompt, the uncond), so its level-0
# self-attention runs at BH 32
SCENE_K1_SHAPE = (32, 4096, 4096, 40)
# phase 21's full-width sampler frames: (sampler, scheduler, steps, cfg, UNet
# evaluations a frame); K1 launches 5 an evaluation + 2 (VAE encode, decode).
# The two-stage samplers skip their second evaluation at the last step.
LEFT_OUT_SAMPLERS = (("dpmpp_2m", "karras", 20, 7.0, 20),
                     ("euler_ancestral", "normal", 4, 2.0, 4),
                     ("dpmpp_2m_sde", "karras", 4, 2.0, 4),
                     ("heun", "exponential", 4, 2.0, 7),
                     ("uni_pc", "simple", 4, 2.0, 4))
SAMPLER_TOL = 1e-3  # phase 21: a tiny f32 run of each sampler, card vs CPU
# phase 22: the big mesh (Sphere(1.0, 256): 130,560 triangles), the plain
# rasterizers' chunk of triangles there (ties still go to the lowest index),
# and the frames of the CLI's render, bake and replay
BIG_MESH_SEGMENTS = 256
K2_REF_CHUNK = 256
CLI_FRAMES = 6
BAKE_CLI_FRAMES = 8
REPLAY_CLI_FRAMES = 4


def counts() -> tuple:
    """(K1, K2, K3, K4) launches since the counters were last set to 0."""
    import torch

    from stable_renderer_tpu_torch.cli import kernel_counters

    torch.cuda.synchronize()
    return tuple(f.launches for f in kernel_counters().values())


def zero_counts() -> None:
    """Set the four kernels' launch counters to 0."""
    import torch

    from stable_renderer_tpu_torch.cli import kernel_counters

    torch.cuda.synchronize()
    for f in kernel_counters().values():
        f.launches = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def tracer_dropped(what: str, got, want, attempt: int) -> bool:
    """Whether a profiled record ``got`` (kernel counts, in the order of
    ``want``) fell short of ``want`` only by events the tracer dropped: each
    count at most its want. Then, before the last of PROFILE_ATTEMPTS, notes
    it on stderr and returns True (profile again). A record with more
    launches than wanted, or short on the last attempt, fails."""
    got, want = tuple(got), tuple(want)
    if got == want:
        return False
    if attempt + 1 < PROFILE_ATTEMPTS and all(g <= w for g, w in zip(got, want)):
        print(f"[profile] {what}: the record holds {got} of {want} kernels; profiling again",
              file=sys.stderr, flush=True)
        return True
    fail(f"{what}: the profiled record launched {got}, want {want} "
         f"(attempt {attempt + 1} of {PROFILE_ATTEMPTS})")


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
    """K1's launches by shape inside the ``with`` block, on the card:
    ``ops.flash_attention._launch_bf16`` and ``_launch_f32`` (the wrappers'
    only calls of the kernels) are wrapped to note each call's (BH, Lq, Lk,
    d), and (BH, Lq, Lk, d, "f32") for f32, and the notes must add up to the
    wrapper's launch count over the block. Yields the Counter;
    ``k1_routes`` names the kernel each shape took."""
    from stable_renderer_tpu_torch.ops import flash_attention as fa

    launch_bf16, launch_f32 = fa._launch_bf16, fa._launch_f32
    seen = collections.Counter()

    def noted_bf16(q, k, v, variant=-1):
        seen[(q.shape[0] * q.shape[2], q.shape[1], k.shape[1], q.shape[3])] += 1
        return launch_bf16(q, k, v, variant)

    def noted_f32(q, k, v):
        seen[(q.shape[0], q.shape[1], k.shape[1], q.shape[2], "f32")] += 1
        return launch_f32(q, k, v)

    before = fa.flash_attention.launches
    fa._launch_bf16, fa._launch_f32 = noted_bf16, noted_f32
    try:
        yield seen
    finally:
        fa._launch_bf16, fa._launch_f32 = launch_bf16, launch_f32
    if sum(seen.values()) != fa.flash_attention.launches - before:
        fail(f"K1: {sum(seen.values())} calls noted by shape, "
             f"{fa.flash_attention.launches - before} launches")


def k1_route(d: int, f32: bool = False) -> str:
    """The kernel K1's wrapper launches for head dim d (the library's own
    dispatch: sr_flash_attention_route)."""
    from stable_renderer_tpu_torch.kernels import _build

    return _build.load_library().sr_flash_attention_route(d, int(f32)).decode()


def k1_routes(seen) -> dict:
    """``k1_shape_tally``'s notes -> launches by kernel."""
    out = collections.Counter()
    for key, n in seen.items():
        out[k1_route(key[3], len(key) == 5)] += n
    return dict(out)


def bound(nbytes: float, ops: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(bh: int, lq: int, lk: int, d: int, f32: bool = False):
    """(ms, "bytes" | "operations"): K1's least time, the largest of its
    bytes (q, k, v read once, the output written once), its operations (4
    bh lq lk d: the tensor cores' bf16 peak, or for ``f32`` the FMA pipes'
    f32 peak) and its exponentials (bh lq lk on the MUFU pipes,
    EXP_PER_S)."""
    kind = "f32" if f32 else "bf16"
    t_bytes, _ = bound((4.0 if f32 else 2.0) * bh * d * (2 * lq + 2 * lk), 0.0, kind)
    t_ops = 4.0 * bh * lq * lk * d / PEAK_OPS[kind] * 1e3
    t_exp = bh * lq * lk / EXP_PER_S * 1e3
    t = max(t_bytes, t_ops, t_exp)
    return (t, "bytes") if t == t_bytes else (t, "operations")


def _k1_case(row: dict, dt, tol, kernel, plain, library, k1b, compare=None,
             plain_repeats: int = 10, timed: bool = None) -> float:
    """Run one K1 case: the kernel against its plain version (fails past
    the bar), then, if ``timed`` (default: for bf16), its device time by
    graph replay (ms), per call with the host's launch cost (ms_with_host),
    the plain version's (median of ``plain_repeats`` calls) and the library
    call's (SDPA) times and the bound. The comparison is ``compare(out)`` ->
    (max abs err, its bar) where given, else the max abs difference from
    ``plain()`` held to tol. Fills row; returns the error."""
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
    if dt == torch.bfloat16 if timed is None else timed:
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

    t_start = time.perf_counter()
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
    from stable_renderer_tpu_torch.device import keep_f32, tf32_switches

    keep_f32()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {tf32_switches()}", flush=True)

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
    # (shape, type, bar, timed): the f32 rows are timed where the main path
    # runs them (the loaded VAE's attention)
    cases = [((16, 4096, 4096, 40), torch.bfloat16, K1_BF16_TOL, True),   # UNet level 0
             ((1, 4096, 4096, 512), torch.bfloat16, K1_BF16_TOL, True),   # VAE mid block
             ((16, 4096, 2100, 40), torch.bfloat16, K1_BF16_TOL, True),   # ragged K/V tile
             *((shape, torch.bfloat16, K1_BF16_TOL, True) for shape in K1_LEVEL_SHAPES),
             (VAE_ATTN_SHAPE, torch.float32, K1_F32_TOL, True),           # the loaded f32 VAE
             ((4, 257, 2100, 40), torch.float32, K1_F32_TOL, False),
             ((2, 130, 333, 512), torch.float32, K1_F32_TOL, False)]
    for (bh, lq, lk, d), dt, tol, timed in cases:
        q = torch.randn((bh, lq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((bh, lk, d), generator=gen, device=dev).to(dt)
        v = torch.randn((bh, lk, d), generator=gen, device=dev).to(dt)
        f32 = dt == torch.float32
        row = {"shape": f"bh={bh} lq={lq} lk={lk} d={d} {str(dt).replace('torch.', '')}",
               "route": k1_route(d, f32)}
        # (1, BH, L, D): the fused SDPA backends take 4-D inputs
        qb, kb, vb = q[None], k[None], v[None]
        err = _k1_case(row, dt, tol, lambda: flash_attention(q, k, v),
                       lambda: flash_attention_reference(q, k, v),
                       lambda: F.scaled_dot_product_attention(qb, kb, vb),
                       k1_bound(bh, lq, lk, d, f32), timed=timed,
                       plain_repeats=5 if f32 else 10)
        if not f32:
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

    def run_frame(pipe, size, frame, corr, bg, step_noise=None, mats=None, stream=None,
                  draw_sigs=sigs):
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
        return frame_step(pipe, corr, (), draw_sigs, size, size, True, False, pp, cn_sources,
                          True, draws, proj, bg, None, ctx, nctx, pipe.scheduler_sigmas(), key,
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
                         stream: bool = False, ref=None) -> dict:
        """The bench scene through Engine.Run with pipeline ``p_``:
        ``transient`` frames, ENGINE_WARM warm and FRAMES_TIMED timed
        presents (and PRESENT_DEPTH more); ``want`` = launches a frame of K1,
        K2, K3 and K4, held by the counters over the run and by the profiler
        on one frame; frame 0 against frame_step's at the engine's inputs
        (its stream_init frame when ``stream``) with pipeline ``ref``
        (default ``p_``). Returns the present-to-present median and p90 of
        the timed frames."""
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
            p_ if ref is None else ref, SIZE, 0,
            OverlapCorresponder(vertex_segments=4096, update_corrmap=False), bg,
            mats=first["mats"], stream=(None, None) if stream else None)
        torch.cuda.synchronize()
        first_err = (first["images"] - ref_images.float()).abs().max().item()
        if not torch.equal(first["images"], ref_images.float()):
            fail(f"engine {label}: frame 0 differs from frame_step's at the same inputs, "
                 f"max abs {first_err:.3e}")
        # one frame's kernels by the profiler, after a warm frame
        prof_want = (want[0], 1, 1, want[2])
        for attempt in range(PROFILE_ATTEMPTS):
            flash_attention.launches = rasterize_kernel.launches = conv3x3_kernel.launches = 0
            names, device_ms = engine_frame_kernels(
                p_, SIZE, OverlapCorresponder(vertex_segments=4096, update_corrmap=False))
            prof_counts = (sum(any(k1k in k for k1k in K1_KERNELS) for k in names),
                           sum("raster_binned" in k for k in names),
                           sum("raster_setup" in k for k in names),
                           sum("conv3x3_wgmma" in k for k in names))
            two = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches)
            if two != (2 * want[0], 2, 2 * want[2]):
                fail(f"engine {label}: counters over the profiled run's two frames K1, K2, K3 "
                     f"= {two}, want {want} a frame")
            if not tracer_dropped(f"engine {label}: one frame's K1, K2 binned, K2 setup, K3",
                                  prof_counts, prof_want, attempt):
                break
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
    del pipe_st, pipe_st_bf16

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

    # --- 17. TAESD: bench.py's TAESD modes --------------------------------------------
    from stable_renderer_tpu_torch.data.framebuffers import NON_AI_MAP_INDEX
    from stable_renderer_tpu_torch.models.taesd import TAESD
    from stable_renderer_tpu_torch.ops import metrics

    taesd = {}
    # TAESD on the card against the CPU plain path, 64x64, f32 and bf16
    tm = TAESD()
    t_dev = tm.init(torch.Generator(device=dev).manual_seed(11), device=dev)
    t_cpu = _to_cpu(t_dev)
    g17 = torch.Generator(device=dev).manual_seed(17)
    for label, fn, inp in (("encode", tm.encode, torch.rand((2, 64, 64, 3), generator=g17,
                                                             device=dev)),
                           ("decode", tm.decode, torch.randn((2, 8, 8, 4), generator=g17,
                                                             device=dev))):
        ref = fn(t_cpu, inp.cpu())
        err = (fn(t_dev, inp).cpu() - ref).abs().max().item()
        e_card = (fn(t_dev, inp.to(torch.bfloat16)).float().cpu() - ref).abs().max().item()
        e_cpu = (fn(t_cpu, inp.cpu().to(torch.bfloat16)).float() - ref).abs().max().item()
        bf16_bar = max(2.0 * e_cpu, BF16_STEP * ref.abs().max().item())
        if not (err <= TAESD_F32_TOL and e_card <= bf16_bar):
            fail(f"TAESD {label} 64x64: card vs CPU f32 max abs {err:.3e} (tol {TAESD_F32_TOL}); "
                 f"bf16 error against f32 {e_card:.3e} on the card, {e_cpu:.3e} on the CPU "
                 f"(bar {bf16_bar:.3e})")
        taesd[f"{label}_64"] = {"f32_max_abs_err": err, "bf16_err_card": e_card,
                                "bf16_err_cpu": e_cpu, "bf16_bar": bf16_bar}
    del t_dev, t_cpu
    pipe_t = dc_replace(pipe, config=dc_replace(cfg, realtime_taesd=True),
                        controlnets=[]).with_taesd()
    pipe_st_vae = dc_replace(pipe_i8, config=st_cfg, controlnets=[])
    pipe_st_t = dc_replace(pipe_i8, config=dc_replace(st_cfg, realtime_taesd=True),
                           controlnets=[]).with_taesd()
    t_modes = (("taesd bf16", pipe_t, 0, (K1_TAESD_CALLS_PER_FRAME, 1, 0, 0), {}),
               ("stream int8 taesd", pipe_st_t, STREAM_DEPTH - 1,
                (K1_STREAM_TAESD_CALLS_PER_FRAME, 1, K3_UNET_CALLS_PER_EVAL, 0),
                K3_STREAM_TAESD_FRAME_SHAPES))
    t_step_ms = {}
    for label, p_, transient, want, classes in t_modes:
        stream = transient > 0
        n_t = transient + 1 + FRAMES_TIMED
        state, times = (None, None), []
        torch.cuda.synchronize()
        flash_attention.launches = rasterize_kernel.launches = 0
        conv3x3_kernel.launches = group_norm_kernel.launches = 0
        with k3_shape_tally() as seen:
            for f in range(n_t):
                t0 = time.perf_counter()
                disp, _, pack, images, *st = run_frame(
                    p_, SIZE, f, OverlapCorresponder(vertex_segments=4096, update_corrmap=False),
                    bg, stream=tuple(state) if stream else None)
                host = disp.cpu()
                times.append((time.perf_counter() - t0) * 1e3)
                state = st
                if not torch.isfinite(images).all() or host.shape != (SIZE, SIZE, 4):
                    fail(f"{label} frame {f}: non-finite image or display {tuple(host.shape)}")
        counts = (flash_attention.launches, rasterize_kernel.launches, conv3x3_kernel.launches,
                  group_norm_kernel.launches)
        by_class = per_frame_classes(seen, n_t)
        if counts != tuple(c * n_t for c in want) or by_class != classes:
            fail(f"{label} frame_step: launches K1, K2, K3, K4 over {n_t} frames = {counts}, "
                 f"want {want} a frame; K3 by class {by_class}, want {classes}")
        t_step_ms[label] = statistics.median(times[-FRAMES_TIMED:])
        syncs = {}
        if stream:  # one more steady call of the stream program alone
            _, ctx_t, nctx_t, _, _ = p_.prepare_conditioning(sprites, env, 1)
            syncs = host_syncs(lambda: p_._render_stream(
                *p_.compute_params()[:2], pack["color"][None], pack["noise"][None],
                pack["id"][None], state[0], p_.scheduler_sigmas(),
                torch.Generator(device=dev).manual_seed(99), ctx_t, nctx_t, kv_state=state[1],
                corresponder=OverlapCorresponder(vertex_segments=4096, update_corrmap=False)))
            if syncs:
                fail(f"the stream + TAESD program synchronized the host: {syncs}")
        k1_a_frame[label] = counts[0] // n_t
        if want[2]:
            k3_a_frame[label] = counts[2] // n_t
        print(f"[17 taesd] {label}: frame_step median {t_step_ms[label]:.1f} ms over "
              f"{FRAMES_TIMED} frames ({transient} transient, 1 warm); launches a frame K1 "
              f"{counts[0] // n_t}, K2 {counts[1] // n_t}, K3 {counts[2] // n_t} by class "
              f"{by_class}, K4 {counts[3] // n_t}"
              + (f"; a steady _render_stream call made no host sync" if stream else "")
              + f" | {card}", flush=True)
        engine_ms[label] = run_engine_phase(17, label, p_, t_step_ms[label], transient, want,
                                            stream=stream)
    # the engine frame, TAESD against the VAE of the same mode, in alternating
    # runs; the first sequential TAESD run's presents and id maps feed the metrics
    flicker_input = {}
    for label, p_vae, p_taesd, transient in (("sequential bf16", pipe, pipe_t, 0),
                                             ("stream int8", pipe_st_vae, pipe_st_t,
                                              STREAM_DEPTH - 1)):
        gaps = {"vae": [], "taesd": []}
        n_eng = transient + ENGINE_WARM + FRAMES_TIMED + PRESENT_DEPTH
        for which in TAESD_ALTERNATION:
            ids = []

            def keep_ids(eng, when):
                if when == "end":
                    ids.append(eng.RenderManager.last_gbuffer.id.clone())

            torch.cuda.synchronize()
            _, presented = run_engine(p_vae if which == "vae" else p_taesd, SIZE, n_eng,
                                      OverlapCorresponder(vertex_segments=4096,
                                                          update_corrmap=False), keep_ids)
            lo = transient + ENGINE_WARM
            stamps = [t for t, _, _ in presented[lo - 1:lo + FRAMES_TIMED]]
            gaps[which] += [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
            if which == "taesd" and not transient and not flicker_input:
                flicker_input.update(frames=[f for _, _, f in presented], ids=ids)
        taesd[f"engine {label}"] = {w: {"median_ms": statistics.median(g),
                                        "p90_ms": statistics.quantiles(
                                            g, n=10, method="inclusive")[-1], "gaps_ms": sorted(g)}
                                    for w, g in gaps.items()}
        t_, v_ = taesd[f"engine {label}"]["taesd"], taesd[f"engine {label}"]["vae"]
        print(f"[17 taesd] Engine.Run {label}, alternating runs {', '.join(TAESD_ALTERNATION)} "
              f"({len(t_['gaps_ms'])} timed presents each): TAESD median {t_['median_ms']:.1f} "
              f"ms, p90 {t_['p90_ms']:.1f}; VAE median {v_['median_ms']:.1f} ms, p90 "
              f"{v_['p90_ms']:.1f} | {card}", flush=True)
    # the flicker metrics of the TAESD frames, on the card and on the CPU; the
    # bench scene draws in NORMAL mode, whose map index marks every pixel
    # non-AI, so the ball's pixels are counted by setting that index to 0
    import numpy as np

    frames_t = torch.from_numpy(np.stack(flicker_input["frames"]))[..., :3].float() / 255.0
    ids_t = torch.stack(flicker_input["ids"]).cpu()
    ids_t[..., 2] = torch.where(ids_t[..., 2] == NON_AI_MAP_INDEX, 0, ids_t[..., 2])
    flicker = {}
    for metric, fn in (("temporal_flicker_l1", metrics.temporal_flicker_l1),
                     ("temporal_flicker_ssim", metrics.temporal_flicker_ssim),
                     ("vertex_flicker", lambda f_, i_: metrics.vertex_flicker(
                         f_, i_, num_segments=4096))):
        args = (frames_t,) if metric != "vertex_flicker" else (frames_t, ids_t)
        on_card = fn(*(a.to(dev) for a in args)).item()
        on_cpu = fn(*args).item()
        flicker[metric] = {"card": on_card, "cpu": on_cpu}
        if not (math.isfinite(on_card) and on_cpu > 0
                and abs(on_card - on_cpu) <= METRIC_REL_TOL * abs(on_cpu)):
            fail(f"{metric} of the TAESD frames: card {on_card!r}, CPU {on_cpu!r} (relative tol "
                 f"{METRIC_REL_TOL})")
    taesd["flicker"] = dict(flicker, frames=len(frames_t))
    print(f"[17 taesd] flicker of the {len(frames_t)} presented sequential TAESD frames (card, "
          f"CPU): " + ", ".join(f"{k_} {v_['card']!r}, {v_['cpu']!r}" for k_, v_ in flicker.items())
          + f" (relative tol {METRIC_REL_TOL}) | {card}", flush=True)
    taesd["frame_step_ms"] = t_step_ms
    del pipe_t, pipe_st_vae, pipe_st_t, pipe_i8

    # --- 18. the frame's options ------------------------------------------------------
    options = option_phases(pipe, dev, card, run_engine)

    # --- 19. bench_torch.py ------------------------------------------------------------
    bench = bench_phase(card)

    # --- 20. checkpoint: phase 6's trees through files and from_checkpoint ------------
    # the checkpoint file stays for phase 22, in a directory removed at the end
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="checkpoint-", dir=build_dir))
    try:
        checkpoint = checkpoint_phase(pipe, dev, card, k1, run_frame, run_engine_phase,
                                      engine_ms, bg, ckpt_dir)

        # --- 21. the frame's left-outs ---------------------------------------------------
        left_outs = left_outs_phase(pipe, dev, card, k1, run_frame, bg)

        # --- 22. meshes from files, the command line and the scripts ------------------------
        files = files_phase(dev, card, k1, k2, checkpoint["path"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    wall_s = time.perf_counter() - t_start
    print(f"[total] chip_smoke wall time {wall_s:.1f} s | {card}", flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4], "frame_ms": ms, "int8_frame_ms": ms_i8,
                      "stream_frame_step_ms": st_ms, "control_frame_ms": cn_ms,
                      "host_syncs_a_frame": frame_syncs,
                      "engine_frame_ms": engine_ms, **bake, "taesd": taesd,
                      "options": options, "bench": bench, "checkpoint": checkpoint,
                      "left_outs": left_outs, "files": files, "wall_s": wall_s,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
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
    prof_want = {"flash_wg": sum(n for key, n in K1_BAKE_SHAPES.items() if key[3] <= 64),
                 "flash_wide": sum(n for key, n in K1_BAKE_SHAPES.items() if key[3] > 64),
                 "raster_setup": 1, "raster_binned": 1}
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=BAKE_INTERVAL - 2, warmup=1, active=1,
                                       repeat=1)) as prof:
            def on_prof_frame(eng_, when):
                if when == "end":
                    torch.cuda.synchronize()
                    prof.step()

            run_engine(pipe, SIZE, BAKE_INTERVAL,
                       DefaultCorresponder(update_corrmap_mode="first"), on_prof_frame,
                       lambda: bake_scene(CorrespondMap(k=3, height=SIZE, width=SIZE)),
                       bake=True, baking_interval=BAKE_INTERVAL)
        kernels = [e for e in prof.events()
                   if e.device_type.name == "CUDA" and not e.name.startswith("ProfilerStep")]
        names = [e.name for e in kernels]
        prof_counts = {key: sum(key in n_ for n_ in names) for key in prof_want}
        if not tracer_dropped("bake: the submit frame's " + ", ".join(prof_want),
                              prof_counts.values(), prof_want.values(), attempt):
            break
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    k1_ms = sum(e.time_range.elapsed_us() for e in kernels if "flash_" in e.name) / 1e3
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
                        f"(K1 bh={heads} lq=lk={n * l})", "route": k1_route(d)}
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
        routes = k1_routes(seen_af)
        levels = {k1_route(shape[3]) for shape in K1_LEVEL_SHAPES}
        if levels != {"flash_wg 64<d<=256"} or routes.get("flash_wg 64<d<=256") != sum(
                K1_ALL_FRAMES_SHAPES[shape] for shape in K1_LEVEL_SHAPES):
            fail(f"all-frames submit: K1 launches by kernel {routes}; levels 1 and 2 take "
                 f"{levels}, want the mid wgmma route")
        if tuple(images.shape) != (BAKE_INTERVAL, SIZE, SIZE, 3) or not (
                torch.isfinite(images).all() and torch.isfinite(disp.float()).all()):
            fail(f"all-frames submit: images {tuple(images.shape)}, finite "
                 f"{bool(torch.isfinite(images).all())}")
    af_mem = torch.cuda.max_memory_allocated()
    k1["launches_a_frame"]["all-frames bake submit"] = sum(seen_af.values())
    for bh, lq, lk, d in K1_LEVEL_SHAPES:  # phase 3's rows of the levels' shapes
        row = next(r for r in k1["shapes"]
                   if r["shape"] == f"bh={bh} lq={lq} lk={lk} d={d} bfloat16")
        row["launches_a_frame"] = {"all-frames bake submit": seen_af[(bh, lq, lk, d)]}
    out["all_frames"] = {"submit_ms": times[-1], "first_submit_ms": times[0],
                         "peak_memory_gib": af_mem / 2**30,
                         "k1_a_submit": {str(key): n for key, n in seen_af.items()},
                         "k1_routes_a_submit": routes}
    print(f"[16 all-frames] a bake submit of {BAKE_INTERVAL} frames through frame_step with "
          f"OverlapCorresponder(all_frames=True, layer_range=None): {times[-1]:.1f} ms (first "
          f"{times[0]:.1f} ms), finite {tuple(images.shape)} frames; K1 a submit by (BH, Lq, "
          f"Lk, d) {dict(seen_af)}, by kernel {routes}; peak memory {af_mem / 2**30:.2f} GiB "
          f"| {card}", flush=True)
    return out


@contextlib.contextmanager
def passed_vertex_noise(draws):
    """Inside the block, the pipeline's vertex_noise takes ``draws`` (table,
    fallback, indep) instead of drawing from its generator."""
    import functools

    from stable_renderer_tpu_torch.engine import pipeline as pipeline_mod

    vertex_noise = pipeline_mod.vertex_noise
    table, fallback, indep = draws
    pipeline_mod.vertex_noise = functools.partial(vertex_noise, table=table, fallback=fallback,
                                                  indep=indep)
    try:
        yield
    finally:
        pipeline_mod.vertex_noise = vertex_noise


def option_batch(pipe, size: int, bg):
    """Two bench views (frames 0 and 1) drawn in BAKING mode, so that their
    id maps mark the ball's pixels valid, stacked into a batch of 2: the
    packs frame_step hands the sequential program with one pending frame."""
    import torch

    from stable_renderer_tpu_torch.engine.frame_program import frame_step
    from stable_renderer_tpu_torch.engine.mesh import Mesh
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms
    from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams

    sigs = ((DrawUniforms(sprite_id=1, material_id=1, render_mode=RENDER_MODE_BAKING),
             (512, 512), None, None),)
    buffers = mesh_device_buffers(Mesh.Sphere(1.0, 48), pipe.device)
    packs = []
    for f in range(2):
        mv, proj = bench_matrices(f)
        draws = (dict(buffers=buffers, mv=mv, diffuse=None, noise=None, corrmap=None),)
        packs.append(frame_step(None, None, (), sigs, size, size, False, True,
                                PostProcessParams(), (), False, draws, proj, bg, None, None,
                                None, None, None, None, None, ())[2])
    return {k: torch.stack([p[k] for p in packs]) for k in packs[0]}


def option_frame(pipe, batch, option: str, step_noise):
    """The sequential program on ``batch`` with ``option``: a weighting of
    OverlapCorresponder, "vertex_noise" (no noise maps: the starting noise
    is one draw a vertex) or "average" (neither)."""
    import torch

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    corr = OverlapCorresponder(vertex_segments=4096, update_corrmap=False,
                               weighting=option if option in OPTION_WEIGHTINGS else "average")
    _, ctx, nctx, _, _ = pipe.prepare_conditioning(
        {1: Sprite(spriteID=1, prompt="a shiny ball")}, (EnvPrompt("a ball"),), 2)
    key = torch.Generator(device=pipe.device).manual_seed(18)
    noise = None if option == "vertex_noise" else batch["noise"]
    return pipe._render(corr, (), *pipe.compute_params(), batch["color"], noise, batch["id"],
                        (), ctx, nctx, pipe.scheduler_sigmas(), key,
                        normal_maps=batch["normal"], step_noise=step_noise)


def option_phases(pipe, dev, card: str, run_engine_fn) -> dict:
    """Phase 18: vertex_noise, the three weightings and output_ai_canny on
    the card at 512x512, and each held at 64x64 against the CPU."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.ops.canny import canny, unstable_pixels
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.ops.flash_attention import flash_attention
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    out = {}
    gen = torch.Generator(device=dev).manual_seed(18)
    bg = torch.randn((1, SIZE, SIZE, 4), generator=gen, device=dev)
    batch = option_batch(pipe, SIZE, bg)
    f = 2 ** (len(pipe.vae.config.ch_mult) - 1)  # the VAE's downsampling
    lat = (2, SIZE // f, SIZE // f, 4)
    step_noise = [torch.randn(lat, generator=gen, device=dev) for _ in range(pipe.config.steps)]
    flash_attention.launches = 0
    avg = [option_frame(pipe, batch, "average", step_noise) for _ in range(2)]
    spread = (avg[0] - avg[1]).abs().max().item()
    if spread != 0:
        fail(f"options: two average frames of the same inputs differ by max abs {spread:.3e}: "
             "the sequential program does not repeat itself (its segment sums: "
             "ops.math.segment_add_)")
    rows = {}
    for option in ("vertex_noise",) + OPTION_WEIGHTINGS:
        t0 = time.perf_counter()
        img = option_frame(pipe, batch, option, step_noise)
        torch.cuda.synchronize()
        moved = (img - avg[0]).abs()
        rows[option] = {"ms": (time.perf_counter() - t0) * 1e3,
                        "max_abs_vs_average": moved.max().item(),
                        "mean_abs_vs_average": moved.mean().item()}
        if not (torch.isfinite(img).all() and rows[option]["max_abs_vs_average"] > 2 * spread
                and tuple(img.shape) == (2, SIZE, SIZE, 3)):
            fail(f"option {option} at {SIZE}x{SIZE}: {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}, moved from the average frame "
                 f"{rows[option]} (two average frames differ by {spread:.3e})")
    k1_per = flash_attention.launches // (2 + len(rows))
    if flash_attention.launches != K1_CALLS_PER_FRAME * (2 + len(rows)):
        fail(f"options: K1 {flash_attention.launches} launches in {2 + len(rows)} programs, "
             f"want {K1_CALLS_PER_FRAME} each")
    out["512"] = {"average_spread": spread, "k1_a_program": k1_per, **rows}
    print(f"[18 options] {SIZE}x{SIZE}, two BAKING views through the sequential bf16 program "
          f"(K1 {k1_per} a program), moved from the average frame (two average frames differ "
          f"by max abs {spread:.3e}): " + ", ".join(
              f"{k_} max {v_['max_abs_vs_average']:.4f} mean {v_['mean_abs_vs_average']:.5f}"
              for k_, v_ in rows.items()) + f" | {card}", flush=True)
    # 64x64: a tiny pipeline on the card against the same pipeline on the CPU
    small = 64
    tcfg = RenderConfig(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm",
                        scheduler="sgm_uniform")
    tiny_gpu = DiffusionPipeline.from_random(tcfg, tiny=True, device=dev)
    tiny_cpu = DiffusionPipeline.from_random(tcfg, tiny=True, device="cpu")
    tiny_cpu.unet_params, tiny_cpu.vae_params, tiny_cpu.clip_params = (
        _to_cpu(tiny_gpu.unet_params), _to_cpu(tiny_gpu.vae_params), _to_cpu(tiny_gpu.clip_params))
    bg_s = torch.randn((1, small, small, 4), generator=gen, device=dev)
    b_gpu = option_batch(tiny_gpu, small, bg_s)
    b_cpu = {k: v.cpu() for k, v in b_gpu.items()}
    f = 2 ** (len(tiny_gpu.vae.config.ch_mult) - 1)
    lat_s = (2, small // f, small // f, 4)
    sn = [torch.randn(lat_s, generator=gen, device=dev) for _ in range(tcfg.steps)]
    n_rows = 2 * lat_s[1] * lat_s[2]
    draws = (torch.randn((262144, 4), generator=gen, device=dev),
             torch.randn((n_rows, 4), generator=gen, device=dev),
             torch.randn((n_rows, 4), generator=gen, device=dev))
    errs = {}
    for option in ("average", "vertex_noise") + OPTION_WEIGHTINGS:
        with passed_vertex_noise(draws):
            a = option_frame(tiny_gpu, b_gpu, option, sn)
        with passed_vertex_noise(tuple(d.cpu() for d in draws)):
            b = option_frame(tiny_cpu, b_cpu, option, [n.cpu() for n in sn])
        errs[option] = (a.cpu() - b).abs().max().item()
        if not (torch.isfinite(a).all() and errs[option] < REF_TOL):
            fail(f"option {option} at {small}x{small}: card vs CPU max abs {errs[option]:.3e} "
                 f"(tol {REF_TOL})")
    # canny at 64x64: equal to the CPU's but at pixels f32 rounding may flip
    c_gpu, c_cpu = canny(b_gpu["color"]).cpu(), canny(b_cpu["color"])
    c_diff = (c_gpu != c_cpu).any(-1)
    if (c_diff & ~unstable_pixels(b_cpu["color"])).any() or not c_cpu.any():
        fail(f"canny {small}x{small}: card and CPU differ at "
             f"{int((c_diff & ~unstable_pixels(b_cpu['color'])).sum())} stable pixels")
    out["64"] = {"max_abs_err": errs, "canny_differ": int(c_diff.sum())}
    print(f"[18 options] {small}x{small} tiny pipeline, card vs CPU plain path (noise and "
          f"vertex-noise draws passed in): max abs err {errs} (tol {REF_TOL}); canny differs "
          f"at {int(c_diff.sum())} pixels, each one f32 rounding may flip | {card}", flush=True)
    del tiny_gpu, tiny_cpu
    # output_ai_canny through Engine.Run with the map dumps on
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="smoke_maps_", dir=build))
    dumped = []

    def ai_canny_on(eng, when):
        dm = eng.DiffusionManager
        if when == "begin" and not dm.output_ai_canny:
            dm.output_ai_canny = True
            dump = dm._dump_maps
            dm._dump_maps = lambda arrays, frames, out_dir: (
                dumped.append((frames, arrays)), dump(arrays, frames, out_dir))

    eng, presented = run_engine_fn(pipe, SIZE, 2, OverlapCorresponder(
        vertex_segments=4096, update_corrmap=False), ai_canny_on, output_maps=True,
        map_output_dir=str(work))
    png = work / "ai_canny" / "ai_canny_0.png"
    if len(dumped) != 2 or not png.exists():
        fail(f"output_ai_canny: {len(dumped)} dumps, {png} written: {png.exists()}")
    from PIL import Image

    written = np.asarray(Image.open(png))
    arrays = next(a for frames, a in dumped if frames == [0])
    color, ai = torch.from_numpy(arrays["color"]), torch.from_numpy(arrays["ai_canny"])
    ref = canny(color)
    differ = (ai != ref).any(-1)
    stable_differ = int((differ & ~unstable_pixels(color)).sum())
    if (stable_differ or not ai.any() or written.shape[:2] != (SIZE, SIZE)
            or not np.array_equal(written[..., 0] > 127, ai[0, ..., 0].numpy() > 0.5)):
        fail(f"output_ai_canny: the card's map differs from the CPU's canny at {stable_differ} "
             f"stable pixels, edges {int(ai[..., 0].sum())}, png {written.shape}")
    out["ai_canny"] = {"edge_pixels": int(ai[0, ..., 0].sum()), "differ": int(differ.sum())}
    print(f"[18 options] output_ai_canny: Engine.Run with map dumps, {len(dumped)} frames "
          f"dumped; frame 0's ai_canny ({int(ai[0, ..., 0].sum())} edge pixels, written as "
          f"{png.name}) equal to the CPU's canny of the same colour map but at "
          f"{int(differ.sum())} pixels that f32 rounding may flip | {card}", flush=True)
    return out


def bench_phase(card: str) -> dict:
    """Phase 19: ``python bench_torch.py`` in its default mode with
    SR_BENCH_FRAMES=4, as its own process from the repository root."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if not k.startswith("SR_")}
    env["SR_BENCH_FRAMES"] = "4"
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(root / "bench_torch.py")], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = run.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        line = None
    if (run.returncode != 0 or not isinstance(line, dict)
            or set(line) != {"metric", "value", "unit", "vs_baseline"}
            or "(cuda)" not in line["metric"] or not line["value"] > 0):
        fail(f"bench_torch.py: exit {run.returncode}, last stdout line "
             f"{lines[-1] if lines else None!r}; stderr {run.stderr[-1500:]}")
    notes = [ln for ln in run.stderr.splitlines() if ln.startswith("# ")]
    if not notes or notes[0] != "# matmul.allow_tf32=False cudnn.allow_tf32=False":
        fail(f"bench_torch.py: its first stderr note is {notes[:1]}, want both TF32 switches "
             f"off")
    print(f"[19 bench] python bench_torch.py (default mode, SR_BENCH_FRAMES=4) in {wall:.1f} s: "
          f"{json.dumps(line)} {notes} | {card}", flush=True)
    return {"line": line, "stderr": notes, "wall_s": wall}


def checkpoint_phase(pipe, dev, card: str, k1: dict, run_frame, run_engine_phase,
                     engine_ms: dict, bg, tmp) -> dict:
    """Phase 20: weights from files, at full SD1.5 widths (see the module
    docstring). ``pipe`` is phase 6's bf16 pipeline; ``run_frame`` and
    ``run_engine_phase`` are main's; K1's f32 row joins ``k1["shapes"]``
    and the engine run ``engine_ms``. The files go to ``tmp``; all but the
    checkpoint (``out["path"]``, which phase 22 reads) are removed at the
    end."""
    from dataclasses import replace as dc_replace

    import torch

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.clip import (
        SD15_CLIP_CONFIG,
        Tokenizer,
        encode_token_weights_batch,
    )
    from stable_renderer_tpu_torch.models.lora import merge_lora
    from stable_renderer_tpu_torch.models.t2i_adapter import T2IAdapter, T2IAdapterConfig
    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG
    from stable_renderer_tpu_torch.models.weights import (
        flatten,
        read_safetensors,
        split_checkpoint,
        tree_to,
        write_safetensors,
    )
    from stable_renderer_tpu_torch.ops.conv_kernel import use_pallas_conv
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.workflow.config import ControlNetSpec

    def corr():
        return OverlapCorresponder(vertex_segments=4096, update_corrmap=False)

    def frame0(p_):
        """The decoded frame 0 of frame_step with pipeline ``p_``, f32."""
        images = run_frame(p_, SIZE, 0, corr(), bg)[3]
        if not torch.isfinite(images).all():
            fail("phase 20: non-finite decoded frame")
        return images.float()

    cfg, out = pipe.config, {}
    tmp = Path(tmp)
    path = tmp / "sd15.safetensors"
    try:
        # --- 20.1 the checkpoint file: write, then read back -----------------------
        flat = {prefix + k: v.to(torch.bfloat16) for prefix, tree in (
            ("model.diffusion_model.", pipe.unet_params), ("first_stage_model.", pipe.vae_params),
            ("cond_stage_model.transformer.", pipe.clip_params)) for k, v in flatten(tree).items()}
        out["path"] = str(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        size = write_safetensors(flat, path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mapped = read_safetensors(path)
        map_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = {k: v.to(dev) for k, v in mapped.items()}
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        if sorted(back) != sorted(flat) or not all(same_bits(back[k], v) for k, v in flat.items()):
            fail("phase 20: the checkpoint did not read back bit for bit")
        del mapped, back
        out["file"] = {"bytes": size, "tensors": len(flat), "write_s": write_s, "map_s": map_s,
                       "read_to_card_s": read_s}
        print(f"[20 checkpoint] {len(flat)} tensors, {size / 2**30:.3f} GiB BF16 written in "
              f"{write_s:.2f} s ({size / write_s / 1e9:.2f} GB/s, the card's trees copied to the "
              f"host included); mapped in {map_s * 1e3:.1f} ms, read to the card in {read_s:.2f} "
              f"s ({size / read_s / 1e9:.2f} GB/s, from the page cache), bit for bit | {card}",
              flush=True)

        # --- 20.2 from_checkpoint ------------------------------------------------------
        t0 = time.perf_counter()
        pipe_l = DiffusionPipeline.from_checkpoint(str(path), config=cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if pipe_l.unet.config != SD15_UNET_CONFIG or pipe_l.model_family != "sd1":
            fail(f"phase 20: detected {pipe_l.unet.config}, family {pipe_l.model_family}")
        n_leaves = 0
        for prefix, tree, dt in (("model.diffusion_model.", pipe_l.unet_params, torch.bfloat16),
                                 ("first_stage_model.", pipe_l.vae_params, torch.float32),
                                 ("cond_stage_model.transformer.", pipe_l.clip_params,
                                  torch.float32)):
            for k, v in flatten(tree).items():
                n_leaves += 1
                want = flat.get(prefix + k)
                if (want is None or v.device.type != "cuda"
                        or not same_bits(v, want.to(dt))):
                    fail(f"phase 20: loaded leaf {prefix + k} ({v.dtype}, {v.device}) is not "
                         f"what was written, cast to {dt}")
        if n_leaves != len(flat):
            fail(f"phase 20: {len(flat) - n_leaves} keys of the file were left unconsumed")
        out["from_checkpoint_s"] = load_s
        print(f"[20 checkpoint] from_checkpoint on the card in {load_s:.2f} s: SD1.5 detected, "
              f"{n_leaves} leaves, none left over, each equal to the file's (UNet bf16; VAE and "
              f"CLIP cast to f32) | {card}", flush=True)

        # --- 20.3 its frames: frame_step, then Engine.Run ------------------------------
        unet_t, vae_t, clip_t = split_checkpoint(flat)
        pipe_mem = DiffusionPipeline(
            unet=pipe.unet, vae=pipe.vae, clip=pipe.clip, tokenizer=pipe.tokenizer,
            unet_params=unet_t, vae_params=tree_to(vae_t, dev, torch.float32),
            clip_params=tree_to(clip_t, dev, torch.float32), config=cfg,
            model_sampling=pipe.model_sampling, device=dev)
        zero_counts()
        times = []
        with k1_shape_tally() as seen:
            for f in range(1 + FRAMES_TIMED):
                t0 = time.perf_counter()
                disp, _, _, images, _, _ = run_frame(pipe_l, SIZE, f, corr(), bg)
                host = disp.cpu()
                times.append((time.perf_counter() - t0) * 1e3)
                if not torch.isfinite(images).all() or host.shape != (SIZE, SIZE, 4):
                    fail(f"phase 20: loaded frame {f} non-finite or display {tuple(host.shape)}")
                if f == 0:
                    loaded0 = images.float().clone()
        n = 1 + FRAMES_TIMED
        want = (K1_CALLS_PER_FRAME, 1, 0, 0)
        if counts() != tuple(c * n for c in want):
            fail(f"phase 20: loaded frames launched K1, K2, K3, K4 = {counts()} over {n} "
                 f"frames, want {want} a frame")
        # the f32 VAE's two mid-block attentions (encode, decode) take the f32
        # route (flash_f32); the UNet's 20 the bf16 one at d = 40
        routes = k1_routes(seen)
        want_routes = {k1_route(VAE_ATTN_SHAPE[3], True): K1_F32_CALLS_LOADED * n,
                       k1_route(40): (K1_CALLS_PER_FRAME - K1_F32_CALLS_LOADED) * n}
        f32_a_frame = sum(c for key, c in seen.items() if len(key) == 5) // n
        bf16_a_frame = K1_CALLS_PER_FRAME - f32_a_frame
        if routes != want_routes or seen[VAE_ATTN_SHAPE + ("f32",)] != K1_F32_CALLS_LOADED * n:
            fail(f"phase 20: loaded frames' K1 launches over {n} frames by kernel {routes}, by "
                 f"shape {dict(seen)}; want {want_routes}")
        step_ms = statistics.median(times[1:])
        k1.setdefault("launches_a_frame", {})["checkpoint"] = K1_CALLS_PER_FRAME
        engine = engine_ms["checkpoint bf16"] = run_engine_phase(
            20, "checkpoint bf16", pipe_l, step_ms, 0, want, ref=pipe_mem)
        out["frame_step_median_ms"] = step_ms
        print(f"[20 checkpoint] loaded pipeline (UNet bf16, VAE and CLIP f32): frame_step median "
              f"{step_ms:.1f} ms over {FRAMES_TIMED} frames (warm {times[0]:.1f} ms), K1 "
              f"{bf16_a_frame} bf16 + {f32_a_frame} f32 launches a frame (by kernel over "
              f"{n} frames: {routes}); Engine.Run "
              f"median {engine['median_ms']:.1f} ms, p90 {engine['p90_ms']:.1f} ms beside phase "
              f"11's bf16 {engine_ms['bf16']['median_ms']:.1f} / {engine_ms['bf16']['p90_ms']:.1f}"
              f" ms; its frame 0 identical to frame_step's for the in-memory pipeline | {card}",
              flush=True)
        del pipe_mem, unet_t, vae_t, clip_t

        # --- 20.4 K1's f32 route: phase 3 timed it; these are its launches -----------
        bh, lq, _, d = VAE_ATTN_SHAPE
        row = next(r for r in k1["shapes"]
                   if r["shape"] == f"bh={bh} lq={lq} lk={lq} d={d} float32")
        row["launches_a_frame"] = {"checkpoint": f32_a_frame}
        out["k1_f32_vae"] = row
        print(f"[20 K1 f32] {row} | {card}", flush=True)

        # --- 20.5 an LCM-LoRA-shaped file ------------------------------------------------
        pre = "model.diffusion_model."
        targets = [k for k in flat if k.startswith(pre) and k.endswith(".weight") and any(
            t in k for t in ("to_q", "to_k", "to_v", "to_out", "ff.net", "proj_in", "proj_out"))]
        gl = torch.Generator(device=dev).manual_seed(21)
        lora = {}
        for k in targets:
            w, r = flat[k], CKPT_LORA_RANK
            name = "lora_unet_" + k[len(pre):-len(".weight")].replace(".", "_")
            ones = (1,) * (w.dim() - 2)  # 1x1 convs (proj_in, proj_out): (O, r, 1, 1)
            lora[name + ".lora_up.weight"] = (torch.randn(
                (w.shape[0], r) + ones, generator=gl, device=dev) * 0.01).half()
            lora[name + ".lora_down.weight"] = (torch.randn(
                (r,) + tuple(w.shape[1:]), generator=gl, device=dev) * 0.01).half()
            lora[name + ".alpha"] = torch.tensor(CKPT_LORA_ALPHA, dtype=torch.float16)
        lora_path = tmp / "lcm-lora-shaped.safetensors"
        lora_bytes = write_safetensors(lora, lora_path)
        t0 = time.perf_counter()
        pipe_lora = DiffusionPipeline.from_checkpoint(str(path), config=cfg, device=dev,
                                                      loras=[(str(lora_path), 1.0)])
        torch.cuda.synchronize()
        lora_load_s = time.perf_counter() - t0
        applied = pipe_lora.lora_modules_applied
        if applied != [{"path": str(lora_path), "strength": 1.0, "unet": len(targets), "te": 0}]:
            fail(f"phase 20: LoRA modules applied {applied}, want {len(targets)} in the UNet")
        unet_cpu = split_checkpoint(read_safetensors(path))[0]
        lora_cpu = read_safetensors(lora_path)
        t0 = time.perf_counter()
        _, n_merged = merge_lora(unet_cpu, lora_cpu, 1.0)
        merge_s = time.perf_counter() - t0
        merged = flatten(pipe_lora.unet_params)
        sample = [targets[0], targets[len(targets) // 2], targets[-1],
                  next(k for k in targets if "proj_in" in k),
                  next(k for k in targets if "ff.net.0.proj" in k)]
        for k in sample:  # the plain f32 merge on the CPU, in the JAX package's order
            name = "lora_unet_" + k[len(pre):-len(".weight")].replace(".", "_")
            w = flat[k].float().cpu().numpy()
            up = lora[name + ".lora_up.weight"].float().cpu().numpy()
            down = lora[name + ".lora_down.weight"].float().cpu().numpy()
            delta = (up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)).reshape(w.shape)
            plain_w = torch.from_numpy(w + (1.0 * CKPT_LORA_ALPHA / CKPT_LORA_RANK) * delta)
            if not same_bits(merged[k[len(pre):]].cpu(), plain_w.to(torch.bfloat16)):
                fail(f"phase 20: merged leaf {k} differs from the plain f32 merge on the CPU")
        untouched = "input_blocks.1.0.in_layers.2.weight"
        if not same_bits(merged[untouched], flat[pre + untouched]):
            fail(f"phase 20: the LoRA changed {untouched}, which it does not target")
        out["lora"] = {"modules": len(targets), "applied": applied, "bytes": lora_bytes,
                       "from_checkpoint_s": lora_load_s, "merge_s": merge_s,
                       "sampled_leaves_equal": len(sample)}
        print(f"[20 lora] LCM-LoRA-shaped file (rank {CKPT_LORA_RANK}, F16, {len(targets)} "
              f"modules, {lora_bytes / 2**20:.1f} MiB): from_checkpoint with it "
              f"{lora_load_s:.2f} s (without: {load_s:.2f} s), {applied[0]['unet']} UNet modules "
              f"applied; "
              f"merge_lora alone {merge_s:.2f} s on the host ({n_merged} modules); {len(sample)} "
              f"sampled leaves equal to the plain f32 merge on the CPU bit for bit | {card}",
              flush=True)
        del pipe_lora, unet_cpu, lora_cpu, merged, lora
        lora_path.unlink()

        # --- 20.6 the loaded pipeline quantized -------------------------------------------
        pipe_q = dc_replace(pipe_l, config=dc_replace(cfg, int8_conv=True))
        t0 = time.perf_counter()
        pipe_q.quantize_convs()
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        zero_counts()
        with k3_shape_tally() as seen:
            q_images = frame0(pipe_q)
        by_class, c = per_frame_classes(seen, 1), counts()
        if c != (K1_CALLS_PER_FRAME, 1, K3_INT8_CALLS_PER_FRAME, 0) or (
                by_class != K3_INT8_FRAME_SHAPES):
            fail(f"phase 20 int8: launches K1, K2, K3, K4 = {c}, K3 by class {by_class}")
        out["int8"] = {"quantize_s": q_s, "launches": c}
        print(f"[20 int8] the loaded pipeline quantized in {q_s:.2f} s; one frame: K1 {c[0]}, K2 "
              f"{c[1]}, K3 {c[2]} by the int8 frame's {len(by_class)} classes, finite; vs the "
              f"bf16 loaded frame mean abs {(q_images - loaded0).abs().mean().item():.4f} | "
              f"{card}", flush=True)
        del pipe_q

        # --- 20.7 control checkpoints ----------------------------------------------------
        specs = (ControlNetSpec(source="normal", strength=0.6),
                 ControlNetSpec(source="depth", strength=0.6))
        pipe_a, pipe_b = dc_replace(pipe_l, controlnets=[]), dc_replace(pipe_l, controlnets=[])
        for i, spec in enumerate(specs):
            perturbed_controlnet(pipe_a, spec, seed=5 + i)
            cn_path = tmp / f"controlnet-{spec.source}.safetensors"
            write_safetensors({"control_model." + k: v for k, v in
                               flatten(pipe_a.controlnets[-1][1]).items()}, cn_path)
            pipe_b.add_control_from_state_dict(read_safetensors(cn_path), spec)
            cn_path.unlink()
        zero_counts()
        cn_images = frame0(pipe_b)
        c = counts()
        same = torch.equal(cn_images, frame0(pipe_a))
        kinds = [type(m).__name__ for m, _, _ in pipe_b.controlnets]
        if not same or c[0] != K1_CONTROL_CALLS_PER_FRAME or kinds != ["ControlNet"] * 2:
            fail(f"phase 20 ControlNet files: frame equal to add_controlnet's {same}, K1 {c[0]} "
                 f"(want {K1_CONTROL_CALLS_PER_FRAME}), controls {kinds}")
        # a control-LoRA: the first net's control-only tensors in full, rank-8
        # factors (F32) for every 2-D and 4-D weight of the UNet's trunk
        cn0 = flatten(pipe_a.controlnets[0][1])
        gc = torch.Generator(device=dev).manual_seed(22)
        control_lora = {"lora_controlnet": torch.zeros(0)}
        control_lora.update({k: v for k, v in cn0.items() if k.startswith(
            ("input_hint_block.", "zero_convs.", "middle_block_out."))})
        for k, w in flatten(pipe_l.unet_params).items():
            if (k.startswith(("time_embed.", "input_blocks.", "middle_block."))
                    and k.endswith(".weight") and w.dim() in (2, 4)):
                base, r = k[:-len(".weight")], CONTROL_LORA_RANK
                control_lora[base + ".up"] = torch.randn((w.shape[0], r), generator=gc,
                                                         device=dev) * 0.01
                control_lora[base + ".down"] = torch.randn((r,) + tuple(w.shape[1:]),
                                                           generator=gc, device=dev) * 0.01
        cl_path = tmp / "control-lora.safetensors"
        write_safetensors(control_lora, cl_path)
        pipe_c = dc_replace(pipe_l, controlnets=[])
        t0 = time.perf_counter()
        pipe_c.add_control_from_state_dict(read_safetensors(cl_path), specs[1])
        cl_s = time.perf_counter() - t0
        cl_pairs = sum(k.endswith(".up") for k in control_lora)
        del control_lora, cn0
        cl_path.unlink()
        zero_counts()
        cl_images = frame0(pipe_c)
        c_cl = counts()
        cl_moved = (cl_images - loaded0).abs().mean().item()
        if type(pipe_c.controlnets[0][0]).__name__ != "ControlNet" or not (
                cl_moved > CONTROL_DIFF_FLOOR):
            fail(f"phase 20 control-LoRA: moved {cl_moved:.3e} (floor {CONTROL_DIFF_FLOOR})")
        # a full-width T2I-Adapter, f32 weights from a seed, as a file
        ad = T2IAdapter(T2IAdapterConfig())
        ad_flat = flatten(ad.init(torch.Generator(device=dev).manual_seed(23), device=dev))
        ad_path = tmp / "t2i-adapter.safetensors"
        write_safetensors(ad_flat, ad_path)
        pipe_t = dc_replace(pipe_l, controlnets=[])
        pipe_t.add_control_from_state_dict(read_safetensors(ad_path), specs[0])
        ad_path.unlink()
        zero_counts()
        ad_images = frame0(pipe_t)
        c_ad = counts()
        ad_moved = (ad_images - loaded0).abs().mean().item()
        if (type(pipe_t.controlnets[0][0]).__name__ != "T2IAdapter"
                or c_ad != (K1_CALLS_PER_FRAME, 1, 0, 0) or not ad_moved > CONTROL_DIFF_FLOOR):
            fail(f"phase 20 T2I-Adapter: launches {c_ad}, moved {ad_moved:.3e}")
        # its features under the float K3 switch, from a 512x512 hint
        hint = torch.rand((1, SIZE, SIZE, 3), generator=torch.Generator(device=dev).manual_seed(
            24), device=dev)
        ad_t, ad_params, _ = pipe_t.controlnets[0]
        use_pallas_conv(True)
        try:
            with k3_shape_tally() as seen:
                feats = ad_t.apply_hint(ad_params, hint, torch.bfloat16)
                torch.cuda.synchronize()
        finally:
            use_pallas_conv(False)
        ad_classes = per_frame_classes(seen, 1)
        if ad_classes != T2I_K3_CLASSES or not all(torch.isfinite(f).all() for f in feats
                                                   if f is not None):
            fail(f"phase 20 T2I-Adapter under the K3 switch: classes {ad_classes}, want "
                 f"{T2I_K3_CLASSES}")
        out["control"] = {
            "controlnet_files": {"frame_equal": same, "k1_a_frame": c[0]},
            "control_lora": {"pairs": cl_pairs, "rank": CONTROL_LORA_RANK, "compose_s": cl_s,
                             "moved_mean_abs": cl_moved, "launches": c_cl},
            "t2i_adapter": {"moved_mean_abs": ad_moved, "launches": c_ad,
                            "k3_classes_switched": {str(k): n for k, n in ad_classes.items()}}}
        k1["launches_a_frame"]["checkpoint control"] = c[0]
        print(f"[20 control] two ControlNet files (control_model.): frame identical to "
              f"add_controlnet's, K1 {c[0]} a frame; control-LoRA (rank {CONTROL_LORA_RANK}, "
              f"{cl_pairs} factor pairs) composed in {cl_s:.2f} s, frame finite, moved "
              f"{cl_moved:.4f} mean abs, launches {c_cl}; T2I-Adapter (full width): frame finite, "
              f"moved {ad_moved:.4f}, launches {c_ad}; its features under the K3 switch: K3 "
              f"{sum(ad_classes.values())} launches {ad_classes} | {card}", flush=True)
        del pipe_a, pipe_b, pipe_c, pipe_t, ad_flat, feats

        # --- 20.8 textual inversion -------------------------------------------------------
        emb_dir = tmp / "embeddings"
        emb_dir.mkdir()
        vecs = torch.randn((TI_VECTORS, SD15_CLIP_CONFIG.hidden_size),
                           generator=torch.Generator().manual_seed(25)) * 0.3
        write_safetensors({"emb_params": vecs}, emb_dir / "shinything.safetensors")
        tok = Tokenizer(SD15_CLIP_CONFIG, embedding_directory=str(emb_dir))
        pipe_e = dc_replace(pipe_l, tokenizer=tok, controlnets=[])
        prompt = "a shiny ball embedding:shinything"
        ctx, _ = pipe_e.encode_prompts([prompt], [""])
        ids, weights, custom = tok.tokenize_weighted_batch([prompt, ""])
        with torch.no_grad():
            ref, _ = encode_token_weights_batch(
                pipe_e.clip, _to_cpu(pipe_e.clip_params), torch.as_tensor(ids),
                torch.as_tensor(weights), custom_embeds=torch.as_tensor(custom),
                clip_skip=cfg.clip_skip)
        ti_err = (ctx.cpu() - ref[:1]).abs().max().item()
        ti_moved = (ctx - pipe_e.encode_prompts(["a shiny ball"], [""])[0]).abs().max().item()
        if custom is None or custom.shape[0] != TI_VECTORS or not (
                ti_err <= TI_TOL and ti_moved > 1e-2):
            fail(f"phase 20 textual inversion: vectors {None if custom is None else custom.shape}"
                 f", card vs CPU max abs {ti_err:.3e} (tol {TI_TOL}), moved {ti_moved:.3e}")
        out["textual_inversion"] = {"vectors": TI_VECTORS, "max_abs_err": ti_err,
                                    "moved": ti_moved}
        print(f"[20 textual inversion] {prompt!r}: {TI_VECTORS} vectors spliced, card vs CPU "
              f"encoding max abs {ti_err:.3e} (tol {TI_TOL}), moved {ti_moved:.3f} from the "
              f"prompt without them | {card}", flush=True)
    finally:
        for f in tmp.iterdir():
            if f != path:
                shutil.rmtree(f) if f.is_dir() else f.unlink()
    return out


# --- phase 22: mesh files -----------------------------------------------------------
# the formats chip_smoke writes a mesh in, with their suffixes; Mesh.Load
# reads each by its suffix
MESH_WRITERS = {"obj": ".obj", "stl": ".stl", "stl-ascii": ".stl", "ply": ".ply",
                "glb": ".glb", "dae": ".dae", "fbx-ascii": ".fbx"}


def _num(x) -> str:
    """A float32 as the shortest decimal of its exact double value: strtof
    and float() then float32 both read it back to the same float32."""
    return repr(float(x))


def write_mesh(mesh, path, fmt: str):
    """Write ``mesh`` (positions, uvs, normals, tris) as ``fmt`` (a key of
    MESH_WRITERS) at ``path``; returns the path. OBJ carries vt and vn and
    two usemtl groups (the first half of the triangles matA, the rest matB);
    GLB one primitive with normals, uvs and uint32 indices; DAE two
    <triangles> (matA, matB) with normals and uvs; ascii FBX the vertices,
    the polygon indices and per-corner normals and uvs; STL and PLY the
    positions and triangles only."""
    import struct

    import numpy as np

    path = Path(path)
    pos = np.asarray(mesh.positions, np.float32)
    uv = np.asarray(mesh.uvs, np.float32)
    nrm = np.asarray(mesh.normals, np.float32)
    tris = np.asarray(mesh.tris, np.int64)
    half = len(tris) // 2
    if fmt == "obj":
        lines = [f"v {_num(a)} {_num(b)} {_num(c)}" for a, b, c in pos]
        lines += [f"vt {_num(a)} {_num(b)}" for a, b in uv]
        lines += [f"vn {_num(a)} {_num(b)} {_num(c)}" for a, b, c in nrm]
        for name, part in (("matA", tris[:half]), ("matB", tris[half:])):
            lines.append(f"usemtl {name}")
            lines += [f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}" for a, b, c in part + 1]
        path.write_text("\n".join(lines) + "\n")
    elif fmt == "stl":
        rec = np.zeros(len(tris), [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
        rec["v"] = pos[tris]
        path.write_bytes(b"\x00" * 80 + struct.pack("<I", len(tris)) + rec.tobytes())
    elif fmt == "stl-ascii":
        lines = ["solid mesh"]
        for corners in pos[tris]:
            lines += ["facet normal 0 0 0", "outer loop"]
            lines += [f"vertex {_num(a)} {_num(b)} {_num(c)}" for a, b, c in corners]
            lines += ["endloop", "endfacet"]
        path.write_text("\n".join(lines + ["endsolid mesh"]) + "\n")
    elif fmt == "ply":
        header = "\n".join(["ply", "format binary_little_endian 1.0",
                            f"element vertex {len(pos)}", "property float x",
                            "property float y", "property float z", f"element face {len(tris)}",
                            "property list uchar int vertex_indices", "end_header"]) + "\n"
        faces = np.zeros(len(tris), [("n", "u1"), ("i", "<i4", 3)])
        faces["n"], faces["i"] = 3, tris
        path.write_bytes(header.encode() + pos.astype("<f4").tobytes() + faces.tobytes())
    elif fmt == "glb":
        import json

        blobs = [pos.tobytes(), nrm.tobytes(), uv.tobytes(), tris.astype("<u4").tobytes()]
        views, off = [], 0
        for b in blobs:
            views.append({"buffer": 0, "byteOffset": off, "byteLength": len(b)})
            off += len(b)
        acc = [{"bufferView": 0, "componentType": 5126, "count": len(pos), "type": "VEC3"},
               {"bufferView": 1, "componentType": 5126, "count": len(pos), "type": "VEC3"},
               {"bufferView": 2, "componentType": 5126, "count": len(pos), "type": "VEC2"},
               {"bufferView": 3, "componentType": 5125, "count": tris.size, "type": "SCALAR"}]
        gltf = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
                "nodes": [{"mesh": 0}], "materials": [{"name": "matA"}],
                "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                           "TEXCOORD_0": 2},
                                            "indices": 3, "material": 0}]}],
                "buffers": [{"byteLength": off}], "bufferViews": views, "accessors": acc}
        js = json.dumps(gltf).encode()
        js += b" " * (-len(js) % 4)
        blob = b"".join(blobs)
        blob += b"\x00" * (-len(blob) % 4)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(blob)))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)
    elif fmt == "dae":
        def floats(a):
            return " ".join(_num(x) for x in np.asarray(a).ravel())

        prims = "".join(
            f'<triangles material="{name}" count="{len(part)}">'
            '<input semantic="VERTEX" source="#m-verts" offset="0"/>'
            '<input semantic="NORMAL" source="#m-nrm" offset="1"/>'
            '<input semantic="TEXCOORD" source="#m-uv" offset="2"/>'
            f'<p>{" ".join(str(i) for i in np.repeat(part.ravel(), 3))}</p></triangles>'
            for name, part in (("matA", tris[:half]), ("matB", tris[half:])))
        path.write_text(
            '<?xml version="1.0" encoding="utf-8"?>\n'
            '<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">'
            "<asset><up_axis>Y_UP</up_axis></asset><library_geometries>"
            '<geometry id="m"><mesh>'
            f'<source id="m-pos"><float_array count="{pos.size}">{floats(pos)}</float_array>'
            '<technique_common><accessor stride="3"/></technique_common></source>'
            f'<source id="m-nrm"><float_array count="{nrm.size}">{floats(nrm)}</float_array>'
            '<technique_common><accessor stride="3"/></technique_common></source>'
            f'<source id="m-uv"><float_array count="{uv.size}">{floats(uv)}</float_array>'
            '<technique_common><accessor stride="2"/></technique_common></source>'
            '<vertices id="m-verts"><input semantic="POSITION" source="#m-pos"/></vertices>'
            f"{prims}</mesh></geometry></library_geometries></COLLADA>\n")
    elif fmt == "fbx-ascii":
        pvi = tris.copy()
        pvi[:, 2] = -pvi[:, 2] - 1  # a polygon ends at its negative index

        def arr(name, a, indent="\t\t"):
            flat = np.asarray(a).ravel()
            body = ",".join(str(int(x)) if flat.dtype.kind == "i" else _num(x) for x in flat)
            return f"{indent}{name}: *{flat.size} {{\n{indent}\ta: {body}\n{indent}}}\n"

        layer = ("\t\tLayerElement{0}: 0 {{\n"
                 '\t\t\tMappingInformationType: "ByPolygonVertex"\n'
                 '\t\t\tReferenceInformationType: "Direct"\n{1}\t\t}}\n')
        path.write_text(
            "; FBX 7.4.0 project file\nObjects:  {\n"
            '\tGeometry: 1, "Geometry::mesh", "Mesh" {\n'
            + arr("Vertices", pos) + arr("PolygonVertexIndex", pvi)
            + layer.format("Normal", arr("Normals", nrm[tris], "\t\t\t"))
            + layer.format("UV", arr("UV", uv[tris], "\t\t\t"))
            + "\t}\n}\n")
    else:
        raise ValueError(f"no writer for {fmt!r} (have {sorted(MESH_WRITERS)})")
    return path


def check_loaded_mesh(src, loaded, fmt: str) -> list:
    """What is wrong with ``loaded`` (Mesh.Load of ``write_mesh(src, ...,
    fmt)``), as a list of strings (empty: nothing). Triangle corners are
    compared, so each format's own vertex dedup or per-corner vertices do
    not matter: every corner's position equal to the source's within the
    printed precision (1e-6), and where the format carries them its uvs and
    normals, and for OBJ and DAE the two materials."""
    import numpy as np

    bad = []
    if loaded.tris.dtype != np.int32 or loaded.tris.shape != src.tris.shape:
        return [f"{fmt}: triangles {loaded.tris.dtype} {loaded.tris.shape}, want int32 "
                f"{src.tris.shape}"]
    for field in ("positions",) + (("uvs", "normals") if fmt in ("obj", "glb", "dae",
                                                                 "fbx-ascii") else ()):
        got = getattr(loaded, field)[loaded.tris]
        want = getattr(src, field)[src.tris]
        err = float(np.abs(got - want).max())
        if err > 1e-6:
            bad.append(f"{fmt}: corner {field} differ by {err:.3e}")
    if fmt in ("obj", "dae"):
        half = len(src.tris) // 2
        want_mat = np.repeat(np.int32([0, 1]), [half, len(src.tris) - half])
        if (loaded.material_names != ["matA", "matB"]
                or not np.array_equal(loaded.tri_material, want_mat)):
            bad.append(f"{fmt}: materials {loaded.material_names}, "
                       f"{np.bincount(loaded.tri_material + 1)}")
    if not np.isfinite(loaded.normals).all() or not np.isfinite(loaded.tangents).all():
        bad.append(f"{fmt}: non-finite normals or tangents")
    return bad


def _png_frames(d):
    """The frame_*.png under ``d`` in frame order, as uint8 numpy arrays."""
    from pathlib import Path

    import numpy as np
    from PIL import Image

    files = sorted(Path(d).glob("frame_*.png"), key=lambda f: int(f.stem.split("_")[1]))
    return [np.asarray(Image.open(f)) for f in files]


def _check_frames(what: str, frames, n: int, size: int) -> None:
    if len(frames) != n:
        fail(f"phase 22 {what}: {len(frames)} frames written, want {n}")
    for i, f in enumerate(frames):
        if f.shape != (size, size, 3) or int(f.max()) == int(f.min()):
            fail(f"phase 22 {what}: frame {i} {f.shape} constant {int(f.max()) == int(f.min())}")


def files_phase(dev, card: str, k1: dict, k2: dict, ckpt: str) -> dict:
    """Phase 22: meshes from files, the command line and the scripts (see the
    module docstring). ``ckpt`` is phase 20's checkpoint file, and
    ``k1["launches_a_frame"]["checkpoint"]`` its loaded frame's K1 launches;
    K2's row at the big mesh joins ``k2``. The files go to a temporary
    directory under build/, removed at the end."""
    import importlib.util
    import os

    import numpy as np
    import torch

    from stable_renderer_tpu_torch import cli, native
    from stable_renderer_tpu_torch.engine import Engine, Mesh
    from stable_renderer_tpu_torch.engine.mesh import load_obj
    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
    from stable_renderer_tpu_torch.ops.raster import rasterize, vertex_stage
    from stable_renderer_tpu_torch.ops.raster_kernel import (
        rasterize_kernel,
        rasterize_tiles_reference,
        tile_ranges,
        triangle_setup,
        triangle_setup_kernel,
    )
    from stable_renderer_tpu_torch.utils import paths

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="files-", dir=root / "build"))
    out = {}
    ckpt_args = ["--checkpoint", str(ckpt)]
    t_phase = time.perf_counter()
    try:
        # --- 22.1 files: the bench sphere in every format, the big sphere as OBJ and GLB ---
        small, big = Mesh.Sphere(1.0, 48), Mesh.Sphere(1.0, BIG_MESH_SEGMENTS)
        loads = {}
        for label, mesh, fmts in (("bench sphere", small, list(MESH_WRITERS)),
                                  ("big sphere", big, ["obj", "glb"])):
            for fmt in fmts:
                path = write_mesh(mesh, tmp / f"{label.split()[0]}-{fmt}{MESH_WRITERS[fmt]}", fmt)
                parses = native.parses
                t0 = time.perf_counter()
                loaded = Mesh.Load(path)
                load_s = time.perf_counter() - t0
                bad = check_loaded_mesh(mesh, loaded, fmt)
                if fmt == "obj":
                    if native.parses != parses + 1:
                        fail(f"phase 22: Mesh.Load of the {label} OBJ did not use the native "
                             f"parser ({native.library_path()})")
                    t0 = time.perf_counter()
                    py = load_obj(path)
                    py_s = time.perf_counter() - t0
                    bad += [f"{fmt}: {f} differs from load_obj's" for f in (
                        "positions", "normals", "uvs", "colors", "tris", "tri_material",
                        "tangents", "bitangents") if not np.array_equal(getattr(loaded, f),
                                                                         getattr(py, f))]
                    if loaded.material_names != py.material_names:
                        bad.append(f"{fmt}: materials {loaded.material_names} vs load_obj's")
                    loads[label] = {"native_s": load_s, "python_s": py_s,
                                    "bytes": path.stat().st_size}
                if bad:
                    fail(f"phase 22 {label} {fmt}: {bad}")
                if label == "big sphere" and fmt == "obj":
                    big_obj, big_loaded = path, loaded
        out["files"] = {"formats": list(MESH_WRITERS), "obj_load_s": loads,
                        "big_mesh": {"triangles": int(big_loaded.triangle_count),
                                     "vertices": int(big_loaded.vertex_count)}}
        print(f"[22 files] the bench sphere ({small.triangle_count} triangles) as "
              f"{', '.join(MESH_WRITERS)} and the big sphere ({big_loaded.triangle_count} "
              f"triangles, {big_loaded.vertex_count} vertices) as OBJ and GLB, each through "
              f"Mesh.Load: corners, uvs, normals and materials as written; OBJ by the native "
              f"parser, equal to load_obj array for array; big OBJ "
              f"({loads['big sphere']['bytes'] / 2**20:.1f} MiB) loaded in "
              f"{loads['big sphere']['native_s']:.3f} s native, "
              f"{loads['big sphere']['python_s']:.3f} s by load_obj | {card}", flush=True)

        # --- 22.2 K2 on the big mesh, from the bench camera --------------------------------
        bufs = mesh_device_buffers(big_loaded, dev)
        mv, proj = bench_matrices(0)
        clip, _, _ = vertex_stage(bufs["positions"], bufs["normals"],
                                  torch.from_numpy(mv).to(dev), torch.from_numpy(proj).to(dev))
        tris = bufs["tris"]
        call = lambda: rasterize_kernel(clip, tris, SIZE, SIZE, cull_backface=True)  # noqa: E731
        vis = call()
        tri_ref = triangle_setup(clip, tris, SIZE, SIZE, True)
        tri_k, ranges_k = triangle_setup_kernel(clip, tris, SIZE, SIZE, True)
        exact = rasterize_tiles_reference(tri_ref, SIZE, SIZE, chunk=K2_REF_CHUNK)
        checks = {"setup": same_bits(tri_k, tri_ref),
                  "ranges": torch.equal(ranges_k, tile_ranges(tri_ref, SIZE, SIZE)),
                  **{f: same_bits(a, b) for f, a, b in zip(vis._fields, vis, exact)}}
        if not all(checks.values()):
            fail(f"phase 22 K2 ({tris.shape[0]} triangles): not bit for bit against its "
                 f"plain versions: {checks}")
        del tri_ref, tri_k, ranges_k, exact
        ndc = clip[:, :2] / clip[:, 3:4]
        tri_xy = ((ndc * 0.5 + 0.5) * SIZE)[tris.long()]
        lo = tri_xy.amin(1).floor().clamp(0, SIZE)
        hi = tri_xy.amax(1).ceil().clamp(0, SIZE)
        pairs = ((hi - lo).clamp(min=0).prod(-1)).sum().item()
        b = bound(nbytes(clip, tris, vis.z, vis.tri_id, vis.bary), 10.0 * pairs, "f32")
        row = {"shape": f"{tris.shape[0]} triangles {SIZE}x{SIZE}",
               "ms": graph_ms(call, calls=SHORT_CALLS_A_GRAPH),
               "ms_with_host": cuda_ms(call, 20),
               "plain_ms": cuda_ms(lambda: rasterize(clip, tris, SIZE, SIZE,
                                                     chunk=K2_REF_CHUNK,
                                                     cull_backface=True), 1, warmup=1),
               "plain_chunk": K2_REF_CHUNK, "bound_ms": b[0], "bound_by": b[1],
               "library_ms": None, "covered_pixels": int((vis.tri_id >= 0).sum()),
               "bit_exact": True}
        # culling reads every triangle's tile range once a tile
        row["range_bytes_read"] = (SIZE // 16) ** 2 * tris.shape[0] * 8
        k2.setdefault("shapes", []).append(row)
        out["k2"] = row
        print(f"[22 K2] {row} (setup, ranges, z, tri_id and bary bit for bit against "
              f"triangle_setup, tile_ranges and rasterize_tiles_reference) | {card}",
              flush=True)

        # --- 22.3 the command line as its own process: render the big OBJ ---------------------
        frames = CLI_FRAMES
        render_dir = tmp / "render"
        cmd = [sys.executable, "-m", "stable_renderer_tpu_torch", "render", "--obj",
               str(big_obj), "--size", str(SIZE), "--frames", str(frames), *ckpt_args,
               "--out", str(render_dir)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, SR_TPU_OUTPUT_DIR=str(tmp / "outputs")))
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 22 CLI render exited {proc.returncode}: {' '.join(cmd)}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        fps_line = next((ln for ln in proc.stdout.splitlines()
                         if ln.startswith(f"{frames} frames -> ") and "(fps " in ln), None)
        launch_line = next((ln for ln in proc.stdout.splitlines()
                            if ln.startswith("kernel launches over ")), None)
        if fps_line is None or launch_line is None:
            fail(f"phase 22 CLI render printed no fps or launch line:\n{proc.stdout[-2000:]}")
        launches = json.loads(launch_line.split(": ", 1)[1])
        _check_frames("CLI render", _png_frames(render_dir), frames, SIZE)
        want_k1 = k1["launches_a_frame"]["checkpoint"]
        if (launches["rasterize_kernel"] != frames
                or launches["flash_attention"] != want_k1 * frames):
            fail(f"phase 22 CLI render: launches {launches} over {frames} frames, want K2 1 "
                 f"and K1 {want_k1} a frame (phase 20's loaded frame)")
        out["cli_render"] = {"seconds": cli_s, "fps_line": fps_line, "launches": launches,
                             "frames": frames}
        print(f"[22 CLI] python -m stable_renderer_tpu_torch render --obj <big OBJ> --size "
              f"{SIZE} --frames {frames} --checkpoint <phase 20 file>: exit 0 "
              f"in {cli_s:.1f} s (process, imports and checkpoint load included); "
              f"{fps_line!r}; launches {launches}, K1 {want_k1} and K2 1 a frame, as phase 20's "
              f"loaded frame; {frames} frames of {SIZE}x{SIZE}, none constant | {card}",
              flush=True)

        # a mesh given two materials: one draw, and one K2 call, a material a frame
        from stable_renderer_tpu_torch.engine import Camera, GameObject, Material, MeshRenderer

        def two_material_scene():
            cam = GameObject("camera")
            cam.addComponent(Camera)
            cam.transform.position = [0.0, 0.5, 3.0]
            cam.transform.lookAt([0.0, 0.0, 0.0])
            GameObject("subject").addComponent(
                MeshRenderer, mesh=big_loaded, materials=[Material("matA"), Material("matB")])

        Engine._reset()
        zero_counts()
        run_engine(None, SIZE, 2, None, scene=two_material_scene, disableComfyUI=True,
                   device=dev)
        two_mat = counts()[1]
        if two_mat != 4:
            fail(f"phase 22: two materials over 2 frames launched K2 {two_mat} times, want 4")
        out["k2_calls_a_frame_two_materials"] = two_mat / 2
        print(f"[22 materials] the big mesh with two materials: {two_mat / 2:g} K2 calls a "
              f"frame, each over all {big_loaded.triangle_count} triangles (MeshRenderer "
              f"draws the whole mesh once a material, as the JAX package does) | {card}",
              flush=True)

        # --- 22.3b bake, then replay its map, in process -----------------------------------
        bake_dir = tmp / "bake"
        Engine._reset()
        zero_counts()
        t0 = time.perf_counter()
        cli.main(["bake", "--size", str(SIZE), "--frames", str(BAKE_CLI_FRAMES), "--k", "3",
                  *ckpt_args, "--out", str(bake_dir)])
        bake_s = time.perf_counter() - t0
        bake_counts = counts()
        from stable_renderer_tpu_torch.data.corrmap import CorrespondMap

        cmap = CorrespondMap.Load(bake_dir / "bake", device=dev)
        written = int(cmap.written.sum())
        if written == 0 or bake_counts[1] != BAKE_CLI_FRAMES:
            fail(f"phase 22 CLI bake: {written} cells written, launches {bake_counts}")
        _check_frames("CLI bake", _png_frames(bake_dir / "frames"), BAKE_CLI_FRAMES, SIZE)
        Engine._reset()
        cli.main(["render", "--no-diffusion", "--size", str(SIZE), "--frames", "1",
                  "--out", str(tmp / "plain")])
        Engine._reset()
        zero_counts()
        cli.main(["replay", "--size", str(SIZE), "--frames", str(REPLAY_CLI_FRAMES), "--map",
                  str(bake_dir / "bake"), "--out", str(tmp / "replay")])
        replay_counts = counts()
        replayed = _png_frames(tmp / "replay")
        _check_frames("CLI replay", replayed, REPLAY_CLI_FRAMES, SIZE)
        plain0 = _png_frames(tmp / "plain")[0]
        shows_map = float((np.abs(replayed[0].astype(int) - plain0.astype(int)).max(-1)
                           > 2).mean())
        if shows_map < 0.01 or replay_counts[1] != REPLAY_CLI_FRAMES:
            fail(f"phase 22 CLI replay: {shows_map:.4f} of the pixels differ from the unbaked "
                 f"frame; launches {replay_counts}")
        out["cli_bake"] = {"seconds": bake_s, "written": written, "launches": bake_counts,
                           "replay_launches": replay_counts, "replay_share_moved": shows_map}
        print(f"[22 CLI] bake --frames {BAKE_CLI_FRAMES} --k 3: {written} cells written in "
              f"{bake_s:.1f} s, launches {bake_counts}; replay --frames {REPLAY_CLI_FRAMES}: "
              f"launches {replay_counts}, {shows_map:.3f} of frame 0's pixels show the map "
              f"(differ from the unbaked raster frame) | {card}", flush=True)

        # --- 22.4 the five example scripts, in process -------------------------------------
        paths.OUTPUT_DIR = tmp / "outputs"

        def script(name):
            spec = importlib.util.spec_from_file_location(name, root / "scripts" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod

        runs = {}
        for name, frames_, extra, k1_a_frame in (
                ("bake_ball_torch", 4, ckpt_args, None),
                ("boat_example_torch", 2, ckpt_args, None),
                ("corrmap_render_example_torch", 2, [], 0),
                ("miku_controlnet_example_torch", 2, ckpt_args, K1_CONTROL_CALLS_PER_FRAME),
                ("multi_obj_example_torch", 2, [], 0)):
            Engine._reset()
            zero_counts()
            t0 = time.perf_counter()
            run_dir = script(name).main(["--size", str(SIZE), "--frames", str(frames_),
                                         *extra])
            c = counts()
            secs = time.perf_counter() - t0
            frames_dir = run_dir / "frames" if name == "bake_ball_torch" else run_dir
            _check_frames(name, _png_frames(frames_dir), frames_, SIZE)
            draws = 3 if name == "multi_obj_example_torch" else 1
            if c[1] != draws * frames_ or (k1_a_frame is not None
                                          and c[0] != k1_a_frame * frames_):
                fail(f"phase 22 {name}: launches {c} over {frames_} frames")
            if name == "miku_controlnet_example_torch" and (
                    len(Engine._instance.DiffusionManager.pipeline.controlnets) != 2):
                fail("phase 22 miku: not two ControlNets")
            runs[name] = {"frames": frames_, "seconds": secs, "launches": c}
            print(f"[22 scripts] {name} --size {SIZE} --frames {frames_}"
                  f"{' --checkpoint <phase 20 file>' if extra else ''}: {secs:.1f} s, launches "
                  f"K1, K2, K3, K4 = {c}, frames written, none constant | {card}", flush=True)
        out["scripts"] = runs

        # --- 22.5 the correspondence A/B ------------------------------------------------------
        Engine._reset()
        t0 = time.perf_counter()
        ab = script("diffusion_ab_torch").main(["--ckpt", str(ckpt), "--size", str(SIZE),
                                                "--out", str(tmp / "ab")])
        ab_s = time.perf_counter() - t0
        values = [v for r in ("overlap_off", "overlap_on") for v in ab[r].values()]
        values += [ab["latent_level"][r]["vertex_flicker_latent"]
                   for r in ("overlap_off", "overlap_on")]
        if not all(math.isfinite(v) for v in values):
            fail(f"phase 22 diffusion_ab: non-finite metrics {ab}")
        out["diffusion_ab"] = {"seconds": ab_s, **{k: ab[k] for k in (
            "overlap_off", "overlap_on", "latent_level")}}
        print(f"[22 diffusion_ab] --size {SIZE} --ckpt <phase 20 file> in "
              f"{ab_s:.1f} s: flicker_l1 off {ab['overlap_off']['flicker_l1']:.5f} on "
              f"{ab['overlap_on']['flicker_l1']:.5f}, vertex_flicker off "
              f"{ab['overlap_off']['vertex_flicker']:.5f} on "
              f"{ab['overlap_on']['vertex_flicker']:.5f} (random weights: no sign judged) | "
              f"{card}", flush=True)
    finally:
        Engine._reset()
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[22 files] phase 22 in {out['phase_s']:.1f} s | {card}", flush=True)
    return out


def scene_two_sprites():
    """The bench scene with a second prompted sprite (config 5's primitives,
    scripts/multi_obj_example.py): the ball moved left and a cube on the
    right, each with its own SpriteInfo prompt, and an environment prompt.
    Returns the Camera component, the ball and the box."""
    from stable_renderer_tpu_torch.engine import GameObject, Mesh, MeshRenderer, SpriteInfo

    camera, ball = bench_scene()
    camera.env_prompt.prompt = "a sunny garden"
    ball.transform.position = [-0.6, 0.0, 0.0]
    box = GameObject("box")
    box.addComponent(SpriteInfo, prompt="a wooden box")
    box.addComponent(MeshRenderer, mesh=Mesh.Cube(0.9))
    box.transform.position = [0.8, 0.0, 0.0]
    return camera, ball, box


def left_outs_phase(pipe, dev, card: str, k1: dict, run_frame, bg) -> dict:
    """Phase 21: the frame's left-outs on the card (see the module
    docstring). ``pipe`` is phase 6's bf16 pipeline, ``run_frame`` main's,
    ``bg`` phase 6's background noise; the scene frame's K1 row joins
    ``k1["shapes"]``. The inpaint file goes to a temporary directory under
    build/, removed at the end."""
    import shutil
    import tempfile
    from dataclasses import replace as dc_replace
    from pathlib import Path

    import torch
    import torch.nn.functional as F

    from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
    from stable_renderer_tpu_torch.engine import MeshRenderer, SpriteInfo, frame_program
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.engine.shader import Shader
    from stable_renderer_tpu_torch.models.sampling import samplers as smp
    from stable_renderer_tpu_torch.models.sampling.cfg import make_denoiser
    from stable_renderer_tpu_torch.models.sampling.schedules import ModelSampling, calculate_sigmas
    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG, TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder, latent_vertex_ids
    from stable_renderer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from stable_renderer_tpu_torch.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms
    from stable_renderer_tpu_torch.ops.raster import vertex_stage
    from stable_renderer_tpu_torch.ops.raster_kernel import rasterize_kernel

    def corr():
        return OverlapCorresponder(vertex_segments=4096, update_corrmap=False)

    def checked_display(disp, what: str):
        host = disp.cpu()
        if host.shape != (SIZE, SIZE, 4) or host.dtype != torch.uint8:
            fail(f"phase 21 {what}: display {tuple(host.shape)} {host.dtype}")
        if int(host[..., :3].max()) == int(host[..., :3].min()):
            fail(f"phase 21 {what}: constant display")
        return host

    cfg, out = pipe.config, {}
    t_phase = time.perf_counter()

    # --- 21a. the scene frame: two prompted sprites, scene conditioning ------------
    if not cfg.scene_conditioning:
        fail("phase 21: phase 6's config has scene_conditioning off")
    n_eng = ENGINE_WARM + FRAMES_TIMED + PRESENT_DEPTH
    first, calls = {}, []

    def keep_first(eng, when):
        if when == "end" and eng.RuntimeManager.FrameCount == 0:
            first["images"] = eng.RenderManager.last_diffusion_frames.float().clone()

    engine_step = frame_program.frame_step

    def recorded(*a, **kw):  # the managers look frame_step up on the module
        if not calls:
            calls.append((a, kw))
        return engine_step(*a, **kw)

    zero_counts()
    frame_program.frame_step = recorded
    try:
        with k1_shape_tally() as seen:
            t0 = time.perf_counter()
            eng, presented = run_engine(pipe, SIZE, n_eng, corr(), keep_first,
                                        scene=scene_two_sprites)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    finally:
        frame_program.frame_step = engine_step
    k1_count = flash_attention.launches
    _, ball, box = eng.scene
    want_ids = tuple(o.getComponent(SpriteInfo).sprite.spriteID for o in (ball, box))
    a, kw = calls[0]
    sprite_ids, ctx = a[2], a[15]
    if sorted(sprite_ids) != sorted(want_ids) or tuple(ctx.shape[:2]) != (3, 1):
        fail(f"phase 21 scene: sprite ids {sprite_ids} (want {want_ids}), contexts "
             f"{tuple(ctx.shape)} (want (3, 1, L, D))")
    for _, i, frame in presented:
        if frame.shape != (SIZE, SIZE, 4) or frame.dtype.name != "uint8":
            fail(f"phase 21 scene frame {i}: presented {frame.shape} {frame.dtype}")
        if int(frame[..., :3].max()) == int(frame[..., :3].min()):
            fail(f"phase 21 scene frame {i}: constant frame")
    if [i for _, i, _ in presented] != list(range(n_eng)) or eng.device.type != "cuda":
        fail(f"phase 21 scene: device {eng.device}, presented {[i for _, i, _ in presented]}")
    want_seen = {SCENE_K1_SHAPE: (K1_CALLS_PER_FRAME - 2) * n_eng, VAE_ATTN_SHAPE: 2 * n_eng}
    if dict(seen) != want_seen or k1_count != K1_CALLS_PER_FRAME * n_eng:
        fail(f"phase 21 scene: K1 launches {k1_count} over {n_eng} frames by shape {dict(seen)}, "
             f"want {want_seen}")
    if not torch.isfinite(first["images"]).all():
        fail("phase 21 scene: non-finite decoded frame 0")
    # frame 0 again through frame_step at the engine's inputs, its generator
    # seeded as the engine seeds frame 0's
    def replay(ctx_, nctx_, ids_):
        key = torch.Generator(device=dev).manual_seed(cfg.seed)
        args = a[:2] + (ids_,) + a[3:15] + (ctx_, nctx_, a[17], key) + a[19:]
        return frame_program.frame_step(*args, **kw)

    times = []
    for _ in range(1 + FRAMES_TIMED):
        t0 = time.perf_counter()
        disp, _, _, images, _, _ = replay(ctx, a[16], sprite_ids)
        checked_display(disp, "scene frame_step")
        times.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(first["images"], images.float()):
        fail(f"phase 21 scene: engine frame 0 differs from frame_step's, max abs "
             f"{(first['images'] - images.float()).abs().max().item():.3e}")
    # the same scene with one prompt: the box unprompted joins no scene
    one = {want_ids[0]: Sprite(spriteID=want_ids[0], prompt="a shiny ball"),
           want_ids[1]: Sprite(spriteID=want_ids[1], prompt="")}
    one_ids, one_ctx, one_nctx, _, _ = pipe.prepare_conditioning(
        one, (EnvPrompt("a sunny garden"),), 1, image_size=(SIZE, SIZE))
    one_images = replay(one_ctx, one_nctx, one_ids)[3]
    moved = (one_images.float() - images.float()).abs().mean().item()
    if one_ids != () or not moved > CONTROL_DIFF_FLOOR:
        fail(f"phase 21 scene: one-prompt frame (ids {one_ids}) moved by {moved:.3e} "
             f"(floor {CONTROL_DIFF_FLOOR})")
    lo = ENGINE_WARM
    stamps = [t for t, _, _ in presented[lo - 1:lo + FRAMES_TIMED]]
    gaps = sorted((b - a_) * 1e3 for a_, b in zip(stamps, stamps[1:]))
    out["scene"] = {"frame_step_ms": statistics.median(times[1:]), "warm_ms": times[0],
                    "engine_median_ms": statistics.median(gaps),
                    "engine_p90_ms": statistics.quantiles(gaps, n=10, method="inclusive")[-1],
                    "engine_frames": n_eng, "engine_run_s": run_s,
                    "k1_a_frame": k1_count // n_eng, "one_prompt_mean_abs": moved}
    # K1 at the scene frame's level-0 shape, timed beside SDPA
    bh, lq, lk, d = SCENE_K1_SHAPE
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k_, v = (torch.randn((bh, lq, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3))
    row = {"shape": f"bh={bh} lq={lq} lk={lk} d={d} bfloat16 (scene frame, 2 sprites)",
           "route": k1_route(d)}
    _k1_case(row, torch.bfloat16, K1_BF16_TOL, lambda: flash_attention(q, k_, v),
             lambda: flash_attention_reference(q, k_, v),
             lambda: F.scaled_dot_product_attention(q[None], k_[None], v[None]),
             k1_bound(bh, lq, lk, d))
    row["launches_a_frame"] = {"scene": seen[SCENE_K1_SHAPE] // n_eng}
    k1["shapes"].append(row)
    k1.setdefault("launches_a_frame", {})["scene"] = k1_count // n_eng
    del q, k_, v
    print(f"[21 left-outs] scene frame (two prompted sprites + environment, scene "
          f"conditioning, bf16 {SIZE}x{SIZE}): frame_step median "
          f"{out['scene']['frame_step_ms']:.1f} ms (warm {times[0]:.1f}); Engine.Run of "
          f"{n_eng} frames, present-to-present median {out['scene']['engine_median_ms']:.1f} ms, "
          f"p90 {out['scene']['engine_p90_ms']:.1f} ms; K1 {k1_count // n_eng} a frame, "
          f"{seen[SCENE_K1_SHAPE] // n_eng} at BH {bh}; frame 0 identical to frame_step's; "
          f"one-prompt frame moved {moved:.3e}; K1 at BH {bh}: {row} | {card}", flush=True)

    # --- 21b. samplers at full width ----------------------------------------------------
    out["samplers"] = {}
    for name, sched, steps, cfg_scale, evals in LEFT_OUT_SAMPLERS:
        p_ = dc_replace(pipe, config=dc_replace(cfg, sampler=name, scheduler=sched, steps=steps,
                                                cfg_scale=cfg_scale),
                        model_sampling=ModelSampling())
        zero_counts()
        t0 = time.perf_counter()
        disp, _, _, images, _, _ = run_frame(p_, SIZE, 0, corr(), bg)
        host = checked_display(disp, name)
        f_ms = (time.perf_counter() - t0) * 1e3
        want = 5 * evals + 2
        if not torch.isfinite(images).all() or flash_attention.launches != want:
            fail(f"phase 21 {name}: finite {bool(torch.isfinite(images).all())}, K1 "
                 f"{flash_attention.launches} launches (want {want})")
        out["samplers"][name] = {"scheduler": sched, "steps": steps, "cfg": cfg_scale,
                                 "frame_ms": f_ms, "k1": flash_attention.launches}
        del p_, host
    print(f"[21 left-outs] full-width sampler frames (bf16 {SIZE}x{SIZE}, one frame_step each, "
          f"warm-up included): " + ", ".join(
              f"{n_} + {v_['scheduler']} {v_['steps']} steps cfg {v_['cfg']}: "
              f"{v_['frame_ms']:.1f} ms, K1 {v_['k1']}" for n_, v_ in out["samplers"].items())
          + f" | {card}", flush=True)

    # --- 21c. the 19 samplers at the tiny size, card against CPU ----------------------
    unet = UNetModel(TINY_UNET_CONFIG)
    p_gpu = unet.init(torch.Generator(device=dev).manual_seed(21), device=dev)
    p_cpu = _to_cpu(p_gpu)
    g = torch.Generator().manual_seed(21)
    lat = (1, 16, 16, 4)
    ctx_c, unc_c, noise_c, latent_c = (torch.randn(s_, generator=g) for s_ in (
        (1, 77, TINY_UNET_CONFIG.context_dim), (1, 77, TINY_UNET_CONFIG.context_dim), lat, lat))
    ms_ = ModelSampling()
    log_sigmas = torch.as_tensor(ms_.log_sigmas)
    sig = torch.as_tensor(calculate_sigmas(ms_, "karras", 4))
    s_host = [float(s_) for s_ in sig]
    bridge = smp.BrownianBridge(7, s_host[-2], s_host[0], lat)
    dens = {d_: make_denoiser(unet, p_, c_, u_, log_sigmas, cfg_scale=2.0) for d_, p_, c_, u_ in (
        ("cpu", p_cpu, ctx_c, unc_c), ("cuda", p_gpu, ctx_c.to(dev), unc_c.to(dev)))}
    sampler_err = {}
    for name in smp.SAMPLER_NAMES:
        draws = []
        for i in range(4):
            s_, sn = s_host[i], s_host[i + 1]
            if name.endswith("sde"):  # the Brownian increments the sites would draw
                mid = math.exp(-(-math.log(s_) + 0.5 * (-math.log(max(sn, 1e-10))
                                                        + math.log(s_))))
                draws.append((bridge.increment(s_, mid if name == "dpmpp_sde" else sn),
                               bridge.increment(s_, sn)))
            else:
                draws.append((torch.randn(lat, generator=g), torch.randn(lat, generator=g)))
        on_cpu = smp.sample(dens["cpu"], noise_c, sig, latent_c, sampler=name, step_noise=draws)
        on_card = smp.sample(dens["cuda"], noise_c.to(dev), sig, latent_c.to(dev), sampler=name,
                             step_noise=[tuple(t_.to(dev) for t_ in d_) for d_ in draws])
        err = (on_card.cpu() - on_cpu).abs().max().item()
        if not (torch.isfinite(on_card).all() and err <= SAMPLER_TOL):
            fail(f"phase 21 tiny {name}: card vs CPU max abs {err:.3e} (tol {SAMPLER_TOL})")
        sampler_err[name] = err
    # the Brownian bridge drawn on the card: deterministic, additive, unit variance
    br = smp.BrownianBridge(1234, s_host[-2], s_host[0], (1, 64, 64, 4), device=dev)
    br2 = smp.BrownianBridge(1234, s_host[-2], s_host[0], (1, 64, 64, 4), device=dev)
    a_, b_, c_ = s_host[0], s_host[1], s_host[3]
    inc = br.increment(a_, b_)
    add_err = (br.increment(a_, c_) * math.sqrt(a_ - c_)
               - (inc * math.sqrt(a_ - b_) + br.increment(b_, c_) * math.sqrt(b_ - c_))
               ).abs().max().item()
    std = inc.std().item()
    if not (torch.equal(inc, br2.increment(a_, b_)) and torch.equal(inc, br.increment(a_, b_))
            and add_err < 1e-4 and abs(std - 1.0) < 0.05 and inc.device.type == "cuda"):
        fail(f"phase 21 Brownian bridge on the card: additivity err {add_err:.3e}, std {std:.4f}")
    out["tiny_samplers_max_abs_err"] = sampler_err
    out["bridge"] = {"additivity_err": add_err, "std": std}
    print(f"[21 left-outs] the {len(sampler_err)} samplers at the tiny f32 size, 4 karras "
          f"steps, card vs CPU with the same draws: max abs err "
          f"{max(sampler_err.values()):.3e} (tol {SAMPLER_TOL}; by sampler "
          f"{ {k: float(f'{v:.2e}') for k, v in sampler_err.items()} }); Brownian bridge on the "
          f"card: repeat identical, additivity err {add_err:.2e}, std {std:.4f} | {card}",
          flush=True)
    del p_gpu, p_cpu, dens

    # --- 21d. a 9-channel inpaint file --------------------------------------------------
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="inpaint-", dir=root))
    try:
        w4 = pipe.unet_params["input_blocks"]["0"]["0"]["weight"]
        extra = torch.randn((w4.shape[0], 5) + tuple(w4.shape[2:]),
                            generator=torch.Generator(device=dev).manual_seed(9), device=dev)
        w9 = torch.cat([w4.float(), extra / math.sqrt(9 * 9)], 1).to(torch.bfloat16)
        flat = {prefix + k_: v_.to(torch.bfloat16) for prefix, tree in (
            ("model.diffusion_model.", pipe.unet_params), ("first_stage_model.", pipe.vae_params),
            ("cond_stage_model.transformer.", pipe.clip_params))
            for k_, v_ in flatten(tree).items()}
        flat["model.diffusion_model.input_blocks.0.0.weight"] = w9
        path = tmp / "sd15-inpaint.safetensors"
        write_safetensors(flat, path)
        pipe_in = DiffusionPipeline.from_checkpoint(
            str(path), config=dc_replace(cfg, keep_background=True), device=dev)
        if pipe_in.unet.config != dc_replace(SD15_UNET_CONFIG, in_channels=9):
            fail(f"phase 21 inpaint: detected {pipe_in.unet.config}")
        n_leaves = 0
        for prefix, tree, dt in (("model.diffusion_model.", pipe_in.unet_params, torch.bfloat16),
                                 ("first_stage_model.", pipe_in.vae_params, torch.float32),
                                 ("cond_stage_model.transformer.", pipe_in.clip_params,
                                  torch.float32)):
            for k_, v_ in flatten(tree).items():
                n_leaves += 1
                want_v = flat.get(prefix + k_)
                if want_v is None or not same_bits(v_, want_v.to(dt)):
                    fail(f"phase 21 inpaint: loaded leaf {prefix + k_} is not the file's")
        if n_leaves != len(flat):
            fail(f"phase 21 inpaint: {len(flat) - n_leaves} keys of the file left unconsumed")
        seen_lat = {}
        encode, decode = pipe_in._encode, pipe_in._decode

        def enc(*a_):
            seen_lat["in"] = encode(*a_)
            return seen_lat["in"]

        def dec(vp, latent, dt):
            seen_lat["out"] = latent
            return decode(vp, latent, dt)

        pipe_in._encode, pipe_in._decode = enc, dec
        # drawn in BAKING mode, so the ball's pixels are AI pixels (in NORMAL
        # mode every pixel keeps its latent)
        baking = ((DrawUniforms(sprite_id=1, material_id=1, render_mode=RENDER_MODE_BAKING),
                   (512, 512), None, None),)
        zero_counts()
        t0 = time.perf_counter()
        disp, _, pack, images, _, _ = run_frame(pipe_in, SIZE, 0, corr(), bg, draw_sigs=baking)
        checked_display(disp, "inpaint")
        in_ms = (time.perf_counter() - t0) * 1e3
        _, valid = latent_vertex_ids(pack["id"][None], *seen_lat["in"].shape[1:3])
        background = ~valid
        kept = torch.equal(seen_lat["out"][background], seen_lat["in"][background])
        ai_moved = (seen_lat["out"][valid] - seen_lat["in"][valid]).abs().mean().item()
        if not (torch.isfinite(images).all() and kept and background.any() and ai_moved > 1e-3
                and flash_attention.launches == K1_CALLS_PER_FRAME):
            fail(f"phase 21 inpaint: finite {bool(torch.isfinite(images).all())}, background "
                 f"latent kept {kept} ({int(background.sum())} pixels), AI pixels moved "
                 f"{ai_moved:.3e}, K1 {flash_attention.launches}")
        out["inpaint"] = {"frame_ms": in_ms, "background_latent_pixels": int(background.sum()),
                          "ai_latent_moved": ai_moved, "tensors": len(flat)}
        print(f"[21 left-outs] 9-channel inpaint file ({len(flat)} tensors, conv_in widened by 5 "
              f"seeded channels): from_checkpoint detected in_channels 9, every leaf the file's; "
              f"keep_background frame {in_ms:.1f} ms (warm-up included), finite, "
              f"{int(background.sum())} background latent pixels kept bit for bit, AI pixels "
              f"moved {ai_moved:.3e}, K1 {flash_attention.launches} | {card}", flush=True)
        del pipe_in, flat, seen_lat
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # --- 21e. user shaders through Engine.Run -------------------------------------------
    def shaded(shader):
        def scene():
            camera, ball = bench_scene()
            if shader is not None:
                ball.getComponent(MeshRenderer).materials[0].shader = shader
            return camera, ball
        return scene

    def run_shaded(shader):
        colors = []

        def keep_color(eng, when):
            if when == "end":
                colors.append(eng.RenderManager.last_gbuffer.color.clone())

        zero_counts()
        _, presented_ = run_engine(pipe, SIZE, 2, corr(), keep_color, scene=shaded(shader))
        torch.cuda.synchronize()
        return [f_ for _, _, f_ in presented_], colors, rasterize_kernel.launches

    identity = Shader("chip_smoke_identity", fragment_fn=lambda frag, u: frag.color,
                      vertex_fn=lambda p_, n_, mv, proj: vertex_stage(p_, n_, mv, proj))
    fixed, fixed_color, _ = run_shaded(None)
    same, same_color, k2_same = run_shaded(identity)
    debug_frames, debug_color, _ = run_shaded(Shader.DefaultDebug())
    bit_equal = (len(same) == len(fixed) == 2
                 and all((x == y).all() for x, y in zip(same, fixed))
                 and all(torch.equal(x, y) for x, y in zip(same_color, fixed_color)))
    debug_moved = (debug_color[0] - fixed_color[0]).abs().mean().item()
    if not bit_equal or k2_same != 2 or not debug_moved > 1e-3:
        fail(f"phase 21 shaders: identity frames equal to the fixed pipeline's {bit_equal}, "
             f"K2 {k2_same} launches in 2 frames, debug G-buffer color moved {debug_moved:.3e}")
    out["shaders"] = {"identity_bit_equal": bit_equal, "debug_color_mean_abs": debug_moved}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[21 left-outs] user shaders through Engine.Run (2 frames each): identity vertex + "
          f"fragment shaders equal to the fixed pipeline bit for bit (K2 on the user vertex "
          f"stage, {k2_same} launches), DefaultDebug's G-buffer color moved "
          f"{debug_moved:.3f}; phase 21 in {out['phase_s']:.1f} s | {card}", flush=True)
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
