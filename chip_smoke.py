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
                wrapper), and phase 23's two executor shapes (its VAE's two frames
                at d = 512, its UNet level 0 with PerpNeg's third group). Each row
                names its kernel (k1_route).
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
                1 warm + 3 timed frames of frame_step at 512x512, with the
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
                from_random -> quantize_convs, 1 warm + 3 timed 512x512
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
                2 warm + 3 timed presented frames each (and PRESENT_DEPTH more,
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
                warm + 3 timed frames (and the stream's 3 transient) with K1,
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
 23. executor — the workflow executor with phase 20's file: two full-width ControlNet
                files (zero convs perturbed) beside it, a miku-control-shaped workflow
                (checkpoint, two prompts, EngineData, two ControlNetApplyAdvanced from
                its normal and depth maps, VAEEncode, KSampler lcm / sgm_uniform 4
                steps cfg 2, VAEDecode) and two frames of 512x512 dumped maps.
                `python -m stable_renderer_tpu_torch execute` as its own process: exit
                0, two 512x512 frames, not constant. In process: the full-width UNet
                and VAE loaded in bf16 on the card, 1 warm + EXEC_TIMED executes, the
                loader outputs the same objects across executes, K1 EXEC_K1 an
                execute by the counters and by torch.profiler and EXEC_K1_SHAPES
                by shape, the ControlNet file reads inside an execute timed. Seven
                2-step variants (FreeU, HyperTile, SAG, PerpNeg, DifferentialDiffusion
                on an inpaint encode, CorrespondSampler with OverlapCorresponder and
                ddim, KSamplerAdvanced in two windows): frames finite and not
                constant, K1 by shape and ms printed (PerpNeg's shapes required).
                Every K1 shape of the phase that no phase held yet is held against
                its plain version and timed beside SDPA. A tiny graph at 128x128,
                the same params in a card and a CPU executor, within REF_TOL.
                decode_tiled with the graph's loaded VAE tree in f32: one tile
                against decode within TILED_REL_TOL relative, a 128x128 latent in
                TILED_TILES tiles, flash_f32 once a tile.
 24. server   — serving, with phase 20's checkpoint and LoRA files and phase 23's
                ControlNet files and maps. `python -m stable_renderer_tpu_torch serve
                --max-prompts 3` as its own process on a free port: the miku-shaped
                workflow (with a SaveImage) POSTed twice; /history shows success,
                success; /view serves the saved 512x512 frame (not constant); then a
                bad prompt, the third and last, whose "error" comes over /events;
                /system_stats names the card; /events carries 4 progress events a good
                prompt, each with a JPEG preview; exit 0, its launch line K1 EXEC_K1 a
                prompt; both executes timed from the events. In process, FrameServer + serve_workflows(device="cuda") on a
                workflow of the new nodes (server_rows): the frame finite and not
                constant, K1 by shape (new shapes held as in phase 23), SaveLatent ->
                LoadLatent bit for bit through a second prompt, /interrupt during a
                third prompt gives "interrupted", /free with unload_models and
                free_memory lowers memory_allocated by at least the UNet's bytes.
                Engine.RunEditor of the bench scene (EDITOR_FRAMES frames): K1 22 and
                K2 1 call a frame by the counters, /frame.png 512x512, /stream one MJPEG
                part, /scene lists the ball.
 25. families — SD2, SDXL and the refiner. (a) SDXL base at full width
                (from_random(family="sdxl"): the 2.57 B-parameter UNet in bf16,
                CLIP-L and CLIP-G in f32, SDXL_VAE_CONFIG) through Engine.Run
                of the bench scene at 1024x1024 (4-step LCM over sgm_uniform,
                cfg 2.0, the ADM vector at the frame's size): frames (1024,
                1024, 4) uint8, finite, not constant; K1 42 a frame by shape
                (XL_K1_SHAPES), K2 1 call; the present-to-present median, a
                profiled frame's busy share, max_memory_allocated. (b) its
                int8 frame (quantize_convs at the cfg batch of every sigma):
                K3's classes a frame (k3_shape_tally), each new one held
                exact against its plain version and timed. (c) an SD2 768-v
                file written at full width (bf16, ~2.6 GB) by the port's
                writer, loaded by from_checkpoint (v-prediction, SD2ClipH,
                the f32 VAE) and drawn at 768x768: K1 42 a frame
                (SD2_K1_SHAPES, the VAE's on flash_f32). (d) tiny SD2, SDXL
                and refiner files through the executor
                (CheckpointLoaderSimple -> the family's text encode ->
                KSampler -> VAEDecode), card against CPU within REF_TOL.
                Every new K1 shape is held against its plain version and
                timed beside SDPA.
 26. image    — the image-conditioned models. (a) an SD2.1-unclip-H file
                written at full width (bf16, ~3.9 GB: the 768-v UNet with a
                2048-wide ADM, OpenCLIP-H, the VAE, a ViT-H/14 vision tower at
                embedder.model.visual.) through unCLIPCheckpointLoader ->
                CLIPVisionEncode of a 512x512 frame -> two unCLIPConditioning
                (the merge path) -> KSampler (euler, 4 steps, cfg 4) at
                768x768 -> VAEDecode -> SaveImage: in process (1 warm and
                IMAGE_TIMED timed executes, K1 by shape UNCLIP_K1_SHAPES) and
                as its own `execute` process. (b) SD1.5 at 512x512 with phase
                20's checkpoint, a GLIGEN file (16 fusers at SD1.5's widths),
                a style-adapter file (transformer_layes. keys) and a ViT-L/14
                file: two grounded boxes and the style tokens (77 + 8 on both
                conds) -> KSampler (lcm, sgm_uniform, 4 steps, cfg 2): K1 by
                shape GLIGEN_K1_SHAPES, the fusers' (8, 4126^2, 40) held
                against the plain version; the fusers' gates zeroed give the
                ungrounded image bit for bit, the file's move it. (c) tiny
                Zero123 (both nodes), PhotoMaker on a tiny SDXL, the x4
                upscaler's noise augmentation, unCLIP with three entries, the
                style adapter and GLIGEN at both paths: card against CPU
                within REF_TOL.
 27. video    — video and Stable Cascade. (a) an SVD img2vid file written at
                its published widths (bf16, ~4.5 GB: SVD_UNET_CONFIG's temporal
                UNet, ViT-H/14 at conditioner.embedders.0.open_clip.model.
                visual., the SD VAE) through ImageOnlyCheckpointLoader ->
                SVD_img2vid_Conditioning of a 512x512 frame (14 frames at
                1024x576, motion 127, fps 6) -> VideoLinearCFGGuidance(1.0)
                -> KSampler (euler, karras, 4 steps, cfg 2.5: CFG's batch of
                28 in two groups of 14) -> VAEDecode of the 14 frames: in
                process (1 warm and VIDEO_TIMED timed executes, K1 by shape
                SVD_K1_SHAPES, max_memory_allocated, the file's write and
                load) and as its own `execute` process (14 PNG frames).
                (b) Stable Cascade's Stage C (STAGE_C_CONFIG, ~7.2 GB) and
                Stage B (STAGE_B_CONFIG, ~3 GB) files, each removed once
                loaded, through CascadeStageLoader x2 -> StableCascade_
                EmptyLatentImage(1024, 1024, 42) -> KSampler on Stage C (4
                steps, cfg 4) over the full-width OpenCLIP-G's context (a
                G-only CLIP in the loader node's cache slot, encoded by
                CLIPTextEncode) -> StableCascade_StageB_Conditioning ->
                KSampler on Stage B (2 steps, cfg 1.1): the (1, 256, 256, 4)
                latent finite and not constant, K1 0 launches. (c) tiny SVD,
                Zero123 and Cascade C -> B files through the executor, card
                against CPU within REF_TOL. (d) the EDM and Cascade sigma
                tables built here against the JAX package's digests
                (SCHEDULE_DIGESTS). Every new K1 shape is held against its
                plain version and timed beside SDPA.
 28. zoo      — the restoration and upscale zoo (models/upscale.py and its
                twelve architectures), files written from the port's random
                init. (a) Real-ESRGAN x4plus's widths (RRDBConfig(): 64
                features, 23 RRDBs, growth 32) as a .pth in the published
                {"params_ema": ...} nesting, through LoadImage (phase 11's
                presented 512x512 frame) -> UpscaleModelLoader ->
                ImageUpscaleWithModel -> SaveImage in a PromptExecutor: the
                family detected as RRDBNet at those widths, the (1, 2048,
                2048, 3) f32 image finite, in [0, 1] and not constant, no
                kernel launched (f32, switches off); 1 warm and ZOO_TIMED
                timed executes, one profiled, max_memory_allocated. (b) the
                classical SwinIR-M x4 (SWINIR_M_X4_CONFIG: embed 180, six
                groups of 6 blocks, 6 heads, window 8) through the same
                graph. (c) CodeFormer at its published widths in bf16 on a
                512x512 crop in [-1, 1], unswitched and with both switches:
                K3 and K4 launches by shape class; the switched image within
                SWITCH_MEAN_BAR / SWITCH_MAX_BAR of the unswitched one
                (both decoded from the unswitched run's code indices, the
                tokens whose argmax flips counted); every new K3 and K4
                class held against its plain version and timed beside its
                bound and cuDNN or F.group_norm. (d) a tiny file of each of
                the twelve architectures (LaMa through lama.load_lama; its
                file raises KeyError in load_upscale_model, as in the JAX
                package) loaded on the card: the detected class the one the
                JAX package's dispatch picks, the output within ZOO_TOL of
                the CPU plain run (the code indices of CodeFormer and
                RestoreFormer compared where their best code leads by
                ZOO_MARGIN, their images decoded from the CPU's indices).
                (e) `python -m stable_renderer_tpu_torch upscale` on (a)'s
                file as its own process: exit 0 and the JAX CLI's line.
The script re-runs itself under PYTHONHASHSEED=HASH_SEED, so phase 23's HyperTile
variant draws the same tile split in every run.
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
FRAMES_TIMED = 3  # 4 until phase 28 joined: the whole script keeps within 900 s
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
# the K1 shapes, as k1_shape_tally keys them, that a phase has held against
# flash_attention_reference; phase 23 holds the rest of what it launches
HELD_K1 = set()
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
# phase 17's engine runs, VAE and TAESD frames of one mode in turns (four runs
# since phase 28 joined, from six: the whole script keeps within 900 s)
TAESD_ALTERNATION = ("vae", "taesd", "taesd", "vae")
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
# phase 23: the miku-control-shaped workflow over two 512x512 frames (one
# batch of 2): K1 an execute is the UNet's 5 level-0 self-attentions and
# the two ControlNets' 2 each, at each of 4 steps, plus the bf16 VAE's
# mid-block attention in encode and decode (flash_wide, d = 512)
EXEC_FRAMES = 2
EXEC_TIMED = 2
EXEC_UNET_K1_SHAPE = (2 * EXEC_FRAMES * 8, 4096, 4096, 40)  # (BH, Lq, Lk, d), CFG
EXEC_PERP_NEG_K1_SHAPE = (3 * EXEC_FRAMES * 8, 4096, 4096, 40)  # PerpNeg's third group
EXEC_VAE_K1_SHAPE = (EXEC_FRAMES, 4096, 4096, 512)  # bf16, both frames in one batch
EXEC_K1_SHAPES = {EXEC_UNET_K1_SHAPE: (5 + 2 * 2) * 4, EXEC_VAE_K1_SHAPE: 2}
EXEC_K1 = sum(EXEC_K1_SHAPES.values())
EXEC_VARIANT_STEPS = 2
# HyperTile draws its tile split from random.Random(hash(<a string>)), as the
# JAX package does, so the split (and the variant's K1 work) follows
# PYTHONHASHSEED: main() runs the script under this one
HASH_SEED = "0"
# decode_tiled of a 128x128 latent: 3 x 3 tiles of 64 (stride 48), each one
# mid-block attention of the f32 VAE (flash_f32); one tile against decode
TILED_TILES = 9
TILED_REL_TOL = 1e-5
# phase 24: EDITOR mode's frames
EDITOR_FRAMES = 3


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


def same_unet_layout(detected, preset) -> bool:
    """A detected UNetConfig (per-block depths spelled out, as the JAX
    package's detection gives them) builds ``preset``'s UNet: the same block
    plan, input and output channels, context width, heads, ADM and class
    widths."""
    from stable_renderer_tpu_torch.models.unet import UNetModel

    def key(c):
        return (UNetModel(c).block_plan(), c.in_channels, c.out_channels, c.context_dim,
                c.middle_depth(), [c.heads_for(c.model_channels * m) for m in c.channel_mult],
                c.adm_in_channels, c.num_classes)

    return key(detected) == key(preset)


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
               bake: bool = False, editor: bool = False, **kw):
    """``scene()`` (bench.py's by default) through the port's Engine.Bake
    (``bake``), Engine.RunEditor (``editor``) or Engine.Run with
    ``debug=True``, its result kept as the
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
    eng = (App.Bake if bake else App.RunEditor if editor else App.Run)(
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
    import os

    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  dict(os.environ, PYTHONHASHSEED=HASH_SEED))
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
             (EXEC_VAE_K1_SHAPE, torch.bfloat16, K1_BF16_TOL, True),     # the executor's VAE
             (EXEC_PERP_NEG_K1_SHAPE, torch.bfloat16, K1_BF16_TOL, True),  # ... with PerpNeg
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
        HELD_K1.add((bh, lq, lk, d) + (("f32",) if f32 else ()))
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
        HELD_K1.add((b * heads, l, l, d))
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
    engine_frames = {}  # label -> the last presented frame of the run

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
        engine_frames[label] = presented[-1][2]  # phase 28 upscales phase 11's bf16 one
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

        # --- 23. the workflow executor ---------------------------------------------------------
        executor = executor_phase(dev, card, k1, checkpoint["path"])

        # --- 24. serving: the prompt server, the new nodes, EDITOR mode --------------------------
        server = server_phase(pipe, dev, card, k1, k2, checkpoint["path"],
                              checkpoint["lora_path"], corr)

        # --- 25. SD2, SDXL and the refiner -------------------------------------------------
        del pipe
        torch.cuda.empty_cache()
        families = families_phase(dev, card, k1, k3)

        # --- 26. the image-conditioned models (phase 20's checkpoint for 26b) -----------------
        image = image_conditioning_phase(dev, card, k1, checkpoint["path"])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # --- 27. video and Stable Cascade ---------------------------------------------------
    video = video_cascade_phase(dev, card, k1)

    # --- 28. the restoration and upscale zoo ---------------------------------------------
    zoo = zoo_phase(dev, card, k3, k4, engine_frames["bf16"])

    wall_s = time.perf_counter() - t_start
    print(f"[total] chip_smoke wall time {wall_s:.1f} s | {card}", flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4], "frame_ms": ms, "int8_frame_ms": ms_i8,
                      "stream_frame_step_ms": st_ms, "control_frame_ms": cn_ms,
                      "host_syncs_a_frame": frame_syncs,
                      "engine_frame_ms": engine_ms, **bake, "taesd": taesd,
                      "options": options, "bench": bench, "checkpoint": checkpoint,
                      "left_outs": left_outs, "files": files, "executor": executor,
                      "server": server, "families": families, "image_conditioning": image,
                      "video_cascade": video, "zoo": zoo, "wall_s": wall_s,
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
    checkpoint (``out["path"]``, which phases 22-24 read) and the LoRA
    (``out["lora_path"]``, phase 24's) are removed at the end."""
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
        if not same_unet_layout(pipe_l.unet.config, SD15_UNET_CONFIG) or \
                pipe_l.model_family != "sd1":
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
        out["lora_path"] = str(lora_path)  # phase 24's LoraLoader reads it

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
            if f not in (path, tmp / "lcm-lora-shaped.safetensors"):
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
    HELD_K1.add(SCENE_K1_SHAPE)
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
        if not same_unet_layout(pipe_in.unet.config, dc_replace(SD15_UNET_CONFIG, in_channels=9)):
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


def ui_workflow(rows) -> dict:
    """A ComfyUI UI-format workflow (what ``Workflow.Load`` reads) from rows
    (id, type, widgets, {input: (source id, slot)})."""
    links, inputs = [], {}
    for nid, _, _, ins in rows:
        for name, (src, slot) in ins.items():
            links.append([len(links) + 1, src, slot, nid, 0, "*"])
            inputs.setdefault(nid, []).append({"name": name, "link": len(links)})
    return {"nodes": [{"id": nid, "type": t, "widgets_values": list(w),
                       "inputs": inputs.get(nid, [])} for nid, t, w, _ in rows],
            "links": links}


def miku_rows(ckpt_name: str, steps: int = 4, seed: int = 7) -> list:
    """The miku-control graph's shape: a checkpoint, two prompts, EngineData,
    two ControlNet files applied from its normal and depth maps
    (ControlNetApplyAdvanced), VAEEncode of its colour, KSampler (lcm,
    sgm_uniform, cfg 2), VAEDecode, InferenceOutput. The negative prompt
    reaches the applies and the KSampler from its CLIPTextEncode: both
    packages' specs declare one output for ControlNetApplyAdvanced."""
    return [
        (1, "CheckpointLoaderSimple", [ckpt_name], {}),
        (2, "CLIPTextEncode", ["hatsune miku, masterpiece, best quality"], {"clip": (1, 1)}),
        (3, "CLIPTextEncode", ["lowres, bad anatomy, blurry"], {"clip": (1, 1)}),
        (4, "EngineData", [], {}),
        (5, "ControlNetLoader", ["cn_normal.safetensors"], {}),
        (6, "ControlNetLoader", ["cn_depth.safetensors"], {}),
        (7, "ControlNetApplyAdvanced", [0.6, 0.0, 1.0],
         {"positive": (2, 0), "negative": (3, 0), "control_net": (5, 0), "image": (4, 3)}),
        (8, "ControlNetApplyAdvanced", [0.6, 0.0, 1.0],
         {"positive": (7, 0), "negative": (3, 0), "control_net": (6, 0), "image": (4, 4)}),
        (9, "VAEEncode", [], {"pixels": (4, 0), "vae": (1, 2)}),
        (10, "KSampler", [seed, "fixed", steps, 2.0, "lcm", "sgm_uniform", 1.0],
         {"model": (1, 0), "positive": (8, 0), "negative": (3, 0), "latent_image": (9, 0)}),
        (11, "VAEDecode", [], {"samples": (10, 0), "vae": (1, 2)}),
        (12, "InferenceOutput", [], {"images": (11, 0)}),
    ]


def variant_rows(base: list, variant: str) -> list:
    """``base`` (miku_rows at EXEC_VARIANT_STEPS) with one change: a model
    patch node between the checkpoint and the KSampler, the KSampler
    replaced, or an inpaint latent."""
    rows = {r[0]: r for r in base}
    ks = rows[10]
    patch = {"freeu": ("FreeU", [1.3, 1.4, 0.9, 0.2], {}),
             "hypertile": ("HyperTile", [256, 2, 0], {}),
             "sag": ("SelfAttentionGuidance", [0.5, 2.0], {}),
             "perp_neg": ("PerpNeg", [1.0], {"empty_conditioning": (14, 0)}),
             "diff_diffusion": ("DifferentialDiffusion", [], {})}.get(variant)
    if patch is not None:
        rows[13] = (13, patch[0], patch[1], {"model": (1, 0), **patch[2]})
        rows[10] = (10, ks[1], ks[2], {**ks[3], "model": (13, 0)})
    if variant == "perp_neg":
        rows[14] = (14, "CLIPTextEncode", [""], {"clip": (1, 1)})
    if variant == "diff_diffusion":  # the background (EngineData's masks) inpainted
        rows[9] = (9, "VAEEncodeForInpaint", [6], {"pixels": (4, 0), "vae": (1, 2),
                                                     "mask": (4, 7)})
    if variant == "correspond":
        rows[15] = (15, "OverlapCorresponder", [], {})
        rows[10] = (10, "CorrespondSampler", [EXEC_VARIANT_STEPS, 2.0, "ddim", "sgm_uniform",
                                              1.0], {**ks[3], "corresponder": (15, 0)})
    if variant == "advanced_windows":
        io = {k: v for k, v in ks[3].items() if k != "latent_image"}
        n = 2 * EXEC_VARIANT_STEPS
        rows[10] = (10, "KSamplerAdvanced", ["enable", 7, "fixed", n, 2.0, "lcm", "sgm_uniform",
                                             0, EXEC_VARIANT_STEPS, "enable"],
                    {**io, "latent_image": (9, 0)})
        rows[16] = (16, "KSamplerAdvanced", ["disable", 7, "fixed", n, 2.0, "lcm",
                                             "sgm_uniform", EXEC_VARIANT_STEPS, 10000, "disable"],
                    {**io, "latent_image": (10, 0)})
        rows[11] = (11, "VAEDecode", [], {"samples": (16, 0), "vae": (1, 2)})
    return [rows[k] for k in sorted(rows)]


def write_engine_maps(d: Path, frames: int, size: int, seed: int = 0) -> dict:
    """Dumped maps in the layout ``data.loaders.virtual_engine_data`` reads:
    color, normal and depth frame_<i>.png, id and noise frame_<i>.npy (ids: a
    sprite disc whose pixels carry vertex ids; noise at full resolution, 4
    channels). Returns {kind: directory}."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    dirs = {k: d / k for k in ("color", "id", "noise", "normal", "depth")}
    for p in dirs.values():
        p.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(frames):
        cx, cy = size * (0.45 + 0.1 * i), size * 0.5
        disc = (xx - cx) ** 2 + (yy - cy) ** 2 < (size * 0.3) ** 2
        ids = np.zeros((size, size, 4), np.int32)
        ids[disc, 0], ids[disc, 1] = 1, 1
        ids[disc, 3] = ((yy[disc] // 4) * (size // 4) + (xx[disc] - int(cx) + size) // 4)
        np.save(dirs["id"] / f"frame_{i}.npy", ids)
        np.save(dirs["noise"] / f"frame_{i}.npy",
                rng.standard_normal((size, size, 4)).astype(np.float32))
        shade = np.clip(1.0 - ((xx - cx) ** 2 + (yy - cy) ** 2) / (size * 0.3) ** 2, 0, 1)
        color = np.where(disc[..., None], np.stack([shade, 0.4 * shade, 0.7 + 0.3 * shade], -1),
                         rng.uniform(0.2, 0.3, (size, size, 3)))
        nx, ny = (xx - cx) / (size * 0.3), (yy - cy) / (size * 0.3)
        nz = np.sqrt(np.clip(1 - nx ** 2 - ny ** 2, 0, 1))
        normal = np.where(disc[..., None], np.stack([nx, ny, nz], -1) * 0.5 + 0.5, 0.5)
        depth = np.repeat(np.where(disc, 0.3 + 0.7 * nz, 0.0)[..., None], 3, -1)
        for kind, img in (("color", color), ("normal", normal), ("depth", depth)):
            Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                dirs[kind] / f"frame_{i}.png")
    return dirs


def _check_exec_frames(what: str, frames, n: int, size: int) -> None:
    import torch

    if isinstance(frames, torch.Tensor):
        if not torch.isfinite(frames).all():
            fail(f"phase 23 {what}: non-finite output")
        frames = [(f.float().cpu().numpy() * 255).round() for f in frames]
    if len(frames) != n:
        fail(f"phase 23 {what}: {len(frames)} frames, want {n}")
    for i, f in enumerate(frames):
        if tuple(f.shape) != (size, size, 3) or float(f.max()) == float(f.min()):
            fail(f"phase 23 {what}: frame {i} {tuple(f.shape)}, constant "
                 f"{float(f.max()) == float(f.min())}")


def executor_phase(dev, card: str, k1: dict, ckpt: str) -> dict:
    """Phase 23: the workflow executor (see the module docstring), with
    phase 20's checkpoint file; the ControlNet files and the maps go beside
    it (phase 24 reads them), the outputs to a temporary directory under
    build/, removed at the end.
    K1's launches an execute join ``k1["launches_a_frame"]``."""
    import os

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from stable_renderer_tpu_torch.data.loaders import virtual_engine_data
    from stable_renderer_tpu_torch.models.controlnet import ControlNet, ControlNetConfig
    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.models.weights import flatten, tree_to, write_safetensors
    from stable_renderer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from stable_renderer_tpu_torch.workflow import Workflow
    from stable_renderer_tpu_torch.workflow import executor as wex

    root = Path(__file__).resolve().parent
    model_dir = Path(ckpt).parent
    tmp = Path(tempfile.mkdtemp(prefix="executor-", dir=root / "build"))
    out = {}
    t_phase = time.perf_counter()
    try:
        # --- 23.1 files: two ControlNets, the workflow, the maps ---------------------------
        t0 = time.perf_counter()
        cn_bytes = 0
        for name, seed in (("cn_normal", 23), ("cn_depth", 24)):
            params = ControlNet(ControlNetConfig(unet=SD15_UNET_CONFIG)).init(
                torch.Generator(device=dev).manual_seed(seed), dtype=torch.bfloat16, device=dev)
            perturb_zero_convs(params, seed + 100)
            cn_bytes += write_safetensors(
                {"control_model." + k: v for k, v in flatten(params).items()},
                model_dir / f"{name}.safetensors")
            del params
        wf_path = tmp / "miku_control.json"
        wf_path.write_text(json.dumps(ui_workflow(miku_rows(Path(ckpt).name))))
        dirs = write_engine_maps(model_dir / "maps", EXEC_FRAMES, SIZE)  # phase 24 reads them
        out["files_s"] = time.perf_counter() - t0
        print(f"[23 files] two full-width ControlNet files ({cn_bytes / 2**30:.2f} GiB BF16, "
              f"zero convs perturbed), the miku-control-shaped workflow and {EXEC_FRAMES} "
              f"frames of {SIZE}x{SIZE} maps written in {out['files_s']:.1f} s | {card}",
              flush=True)

        # --- 23.2 the command line as its own process ---------------------------------------
        exec_out = tmp / "cli_out"
        map_args = [a for k, d in dirs.items() for a in (f"--{k}-dir", str(d))]
        cmd = [sys.executable, "-m", "stable_renderer_tpu_torch", "execute", "--workflow",
               str(wf_path), *map_args, "--model-dir", str(model_dir), "--out", str(exec_out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, SR_TPU_OUTPUT_DIR=str(tmp / "outputs")))
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase 23 CLI execute exited {proc.returncode}: {' '.join(cmd)}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        if f"{EXEC_FRAMES} frames -> " not in proc.stdout:
            fail(f"phase 23 CLI execute printed no frames line:\n{proc.stdout[-2000:]}")
        _check_exec_frames("CLI execute", _png_frames(exec_out), EXEC_FRAMES, SIZE)
        out["cli_execute_s"] = cli_s
        print(f"[23 CLI] python -m stable_renderer_tpu_torch execute --workflow <miku-control "
              f"shape> --color/id/noise/normal/depth-dir ... --model-dir <phase 20 dir>: exit 0 "
              f"in {cli_s:.1f} s (process, imports, checkpoint and ControlNet loads included); "
              f"{EXEC_FRAMES} frames of {SIZE}x{SIZE}x3, none constant | {card}", flush=True)

        # --- 23.3 in process: 1 warm + EXEC_TIMED timed executes ------------------------------
        ed = virtual_engine_data(color_dir=dirs["color"], id_dir=dirs["id"],
                                 noise_dir=dirs["noise"], normal_dir=dirs["normal"],
                                 depth_dir=dirs["depth"], device=dev)
        t0 = time.perf_counter()
        ex = wex.PromptExecutor(Workflow.Load(wf_path), model_dirs=(str(model_dir),),
                                device=dev)
        model, _, vae = ex.execute(engine_data=ed).outputs[1]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if (not same_unet_layout(model["unet"].config, SD15_UNET_CONFIG)
                or model["params"]["time_embed"]["0"]["weight"].dtype != torch.bfloat16
                or vae["params"]["quant_conv"]["weight"].dtype != torch.bfloat16
                or model["params"]["time_embed"]["0"]["weight"].device.type != "cuda"):
            fail("phase 23: the graph did not load the full-width SD1.5 UNet and VAE "
                 "(bf16, on the card) from the checkpoint file")
        load_control = wex.load_control
        reads = []

        def timed_load(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = load_control(*a, **kw)
            torch.cuda.synchronize()
            reads.append((time.perf_counter() - t) * 1e3)
            return r

        times, first = [], None
        wex.load_control = timed_load
        try:
            for i in range(EXEC_TIMED):
                reads.clear()
                zero_counts()
                with k1_shape_tally() as seen:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    ctx = ex.execute(engine_data=ed)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
                c = counts()
                if c[0] != EXEC_K1 or dict(seen) != EXEC_K1_SHAPES:
                    fail(f"phase 23: an execute launched K1 {c[0]} times, by shape "
                         f"{dict(seen)}; want {EXEC_K1}, {EXEC_K1_SHAPES}")
                if ctx.outputs[1] is not ex._cache[1] or (first and first is not ctx.outputs[1]):
                    fail("phase 23: the loader outputs were not the same objects across "
                         "executes")
                first = ctx.outputs[1]
                read_ms = sum(reads)
        finally:
            wex.load_control = load_control
        _check_exec_frames("execute", ctx.final_output, EXEC_FRAMES, SIZE)
        for attempt in range(PROFILE_ATTEMPTS):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                ex.execute(engine_data=ed)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
            prof_k1 = sum(any(k in n for k in K1_KERNELS) for n in names)
            if not tracer_dropped("phase 23 execute", (prof_k1,), (EXEC_K1,), attempt):
                break
        k1["launches_a_frame"]["executor"] = EXEC_K1
        med = statistics.median(times)
        out["execute"] = {"ms": times, "median_ms": med, "warm_s": warm_s,
                          "k1_launches": c[0], "k1_profiled": prof_k1,
                          "k1_by_shape": {str(key): n for key, n in seen.items()},
                          "k1_routes": k1_routes(seen),
                          "controlnet_read_ms": read_ms,
                          "controlnet_read_share": read_ms / med}
        print(f"[23 execute] {EXEC_FRAMES} frames a batch at {SIZE}x{SIZE}, lcm 4 steps, cfg 2, "
              f"two ControlNets: first execute (checkpoint load included) {warm_s:.2f} s; "
              f"{EXEC_TIMED} executes {', '.join(f'{t:.1f}' for t in times)} ms (median "
              f"{med:.1f}); K1 {c[0]} an execute by the counters and {prof_k1} by torch.profiler "
              f"(predicted {EXEC_K1}), by (BH, Lq, Lk, d) {dict(seen)}, by kernel "
              f"{k1_routes(seen)}; the ControlNet files read again in each execute: "
              f"{read_ms:.1f} ms ({100 * read_ms / med:.1f}% of it); loader outputs the same "
              f"objects across executes | {card}", flush=True)

        # --- 23.4 variants, one execute each, EXEC_VARIANT_STEPS steps ------------------------
        base = miku_rows(Path(ckpt).name, steps=EXEC_VARIANT_STEPS)
        out["variants"] = {}
        launched = collections.Counter(seen)  # K1's shapes over phase 23's executes
        for variant in ("freeu", "hypertile", "sag", "perp_neg", "diff_diffusion", "correspond",
                        "advanced_windows"):
            vpath = tmp / f"{variant}.json"
            vpath.write_text(json.dumps(ui_workflow(variant_rows(base, variant))))
            vex = wex.PromptExecutor(Workflow.Load(vpath), model_dirs=(str(model_dir),),
                                     device=dev)
            vex._cache[1] = ex._cache[1]  # the loaded models, not read again
            vex.execute(engine_data=ed)  # warm
            zero_counts()
            with k1_shape_tally() as vseen:
                torch.cuda.synchronize()
                t = time.perf_counter()
                vctx = vex.execute(engine_data=ed)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
            vk1 = counts()[0]
            _check_exec_frames(variant, vctx.final_output, EXEC_FRAMES, SIZE)
            if variant == "perp_neg" and dict(vseen) != {
                    EXEC_PERP_NEG_K1_SHAPE: (5 + 2 * 2) * EXEC_VARIANT_STEPS,
                    EXEC_VAE_K1_SHAPE: 2}:
                fail(f"phase 23 perp_neg: K1 by shape {dict(vseen)}")
            launched.update(vseen)
            out["variants"][variant] = {"ms": ms, "k1_launches": vk1,
                                        "k1_by_shape": {str(key): n for key, n in vseen.items()}}
            print(f"[23 variant] {variant}: K1 {vk1}, by (BH, Lq, Lk, d) {dict(vseen)}, "
                  f"{ms:.1f} ms an execute, frames finite and not constant | {card}",
                  flush=True)
        # every K1 shape of phase 23 against flash_attention_reference: those
        # no earlier phase held are held here, timed beside SDPA
        hold_new_k1_shapes(launched, 23, dev, card, k1)
        out["k1_shapes_held"] = len(launched)

        # --- 23.5 the executor on the card against the executor on the CPU -------------------
        tiny_rows = [(1, "CheckpointLoaderSimple", ["absent.safetensors"], {}),
                     (2, "CLIPTextEncode", ["a red boat"], {"clip": (1, 1)}),
                     (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
                     (4, "EngineData", [], {}),
                     (5, "KSampler", [3, "fixed", 3, 2.0, "euler", "karras", 1.0],
                      {"model": (1, 0), "positive": (2, 0), "negative": (3, 0),
                       "latent_image": (4, 6)}),
                     (6, "VAEDecode", [], {"samples": (5, 0), "vae": (1, 2)}),
                     (7, "InferenceOutput", [], {"images": (6, 0)})]
        tiny_path = tmp / "tiny.json"
        tiny_path.write_text(json.dumps(ui_workflow(tiny_rows)))
        models = wex.tiny_models(torch.device("cpu"), torch.Generator().manual_seed(0))
        small = 128  # the tiny VAE downsamples by 2: a 64x64 latent
        g = torch.Generator().manual_seed(5)
        maps = dict(color_maps=torch.rand((1, small, small, 3), generator=g),
                    noise_maps=torch.randn((1, small // 2, small // 2, 4), generator=g),
                    id_maps=torch.zeros((1, small, small, 4), dtype=torch.int32))
        finals = []
        from stable_renderer_tpu_torch.data.engine_data import EngineData

        for d in (torch.device("cpu"), dev):
            tex = wex.PromptExecutor(Workflow.Load(tiny_path), device=d)
            tex._cache[1] = tuple({k: (tree_to(v, d) if k == "params" else v)
                                   for k, v in m.items()} for m in models)
            ed_t = EngineData(frame_indices=torch.arange(1),
                              **{k: v.to(d) for k, v in maps.items()})
            finals.append(tex.execute(engine_data=ed_t).final_output.float().cpu())
        tiny_err = float((finals[1] - finals[0]).abs().max())
        if not (torch.isfinite(finals[1]).all() and tiny_err < REF_TOL):
            fail(f"phase 23: the tiny graph on the card against the CPU: max abs err "
                 f"{tiny_err:.3e} (tol {REF_TOL})")
        out["tiny_card_vs_cpu_max_abs_err"] = tiny_err
        print(f"[23 tiny] the tiny graph at {small}x{small} (the same tiny params in both "
              f"executors' caches, EngineData's noise as the latent and its noise): card "
              f"against CPU max abs err {tiny_err:.3e} (tol {REF_TOL}) | {card}", flush=True)

        # --- 23.6 decode_tiled with the loaded VAE in f32 ------------------------------------
        vae_f32 = VAE(SD15_VAE_CONFIG)
        vparams = tree_to(vae["params"], dev, torch.float32)  # the graph's loaded tree
        z1 = torch.randn((1, 64, 64, 4), generator=torch.Generator(device=dev).manual_seed(3),
                         device=dev)
        whole = vae_f32.decode(vparams, z1)
        one = vae_f32.decode_tiled(vparams, z1)
        rel = float((one - whole).abs().max() / whole.abs().max())
        if not rel < TILED_REL_TOL:
            fail(f"phase 23: decode_tiled of one tile against decode: {rel:.3e} relative "
                 f"(tol {TILED_REL_TOL})")
        z9 = torch.randn((1, 128, 128, 4), generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev)
        vae_f32.decode_tiled(vparams, z9)  # warm
        with k1_shape_tally() as seen:
            torch.cuda.synchronize()
            t = time.perf_counter()
            img9 = vae_f32.decode_tiled(vparams, z9)
            torch.cuda.synchronize()
            tiled_ms = (time.perf_counter() - t) * 1e3
        routes = k1_routes(seen)
        if (not torch.isfinite(img9).all() or tuple(img9.shape) != (1, 1024, 1024, 3)
                or routes != {"flash_f32": TILED_TILES}):
            fail(f"phase 23: decode_tiled of a 128x128 latent: shape {tuple(img9.shape)}, "
                 f"finite {bool(torch.isfinite(img9).all())}, K1 {routes} (want flash_f32 "
                 f"{TILED_TILES})")
        out["decode_tiled"] = {"one_tile_rel_err": rel, "ms_128": tiled_ms,
                               "k1_routes": routes}
        print(f"[23 decode_tiled] the loaded f32 VAE: one 64x64 tile against decode {rel:.2e} "
              f"relative (tol {TILED_REL_TOL}); a 128x128 latent in {TILED_TILES} tiles "
              f"-> 1024x1024 in {tiled_ms:.1f} ms, finite, K1 {routes} | {card}", flush=True)
        del vparams
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[23 executor] phase 23 in {out['phase_s']:.1f} s | {card}", flush=True)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(url: str, payload=None, timeout: float = 5.0):
    """(status, body) of a GET, or of a JSON POST when ``payload`` is given."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _sse_reader(url: str, events: list, timeout: float = 60.0):
    """A daemon thread appending (host time, event) for each server-sent
    event of ``url`` until the stream ends."""
    import threading
    import urllib.request

    def read():
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                for line in r:
                    if line.startswith(b"data: "):
                        events.append((time.perf_counter(), json.loads(line[6:])))
        except OSError:
            return  # the server went away

    t = threading.Thread(target=read, daemon=True)
    t.start()
    return t


def _png_array(body: bytes):
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def server_rows(ckpt_name: str, lora_name: str, seed: int) -> list:
    """Phase 24's workflow of the new nodes: CheckpointLoader, LoraLoader,
    ModelMergeSimple (the LoRA'd model with the plain one), RescaleCFG,
    PatchModelAddDownscale, TomePatchModel, two SamplerCustom (dpmpp_2m
    from KSamplerSelect) over a KarrasScheduler's 4 steps cut by
    SplitSigmas (the second without noise), LatentBlend, VAEDecodeTiled,
    InferenceOutput, then SaveLatent last (so that its entry is the node
    boundary after the decode)."""
    return [
        (1, "CheckpointLoader", ["v1-inference.yaml", ckpt_name], {}),
        (2, "LoraLoader", [lora_name, 1.0, 1.0], {"model": (1, 0), "clip": (1, 1)}),
        (3, "ModelMergeSimple", [0.5], {"model1": (2, 0), "model2": (1, 0)}),
        (4, "RescaleCFG", [0.7], {"model": (3, 0)}),
        (5, "PatchModelAddDownscale", [3, 2.0, 0.0, 0.35, True, "bicubic", "bicubic"],
         {"model": (4, 0)}),
        (6, "TomePatchModel", [0.3], {"model": (5, 0)}),
        (7, "CLIPTextEncode", ["a shiny ball, masterpiece"], {"clip": (2, 1)}),
        (8, "CLIPTextEncode", ["lowres, blurry"], {"clip": (2, 1)}),
        (9, "KSamplerSelect", ["dpmpp_2m"], {}),
        (10, "KarrasScheduler", [4, 14.614642, 0.0291675, 7.0], {}),
        (11, "SplitSigmas", [2], {"sigmas": (10, 0)}),
        (12, "EmptyLatentImage", [SIZE, SIZE, 1], {}),
        (13, "SamplerCustom", [True, seed, "fixed", 2.0],
         {"model": (6, 0), "positive": (7, 0), "negative": (8, 0), "sampler": (9, 0),
          "sigmas": (11, 0), "latent_image": (12, 0)}),
        (14, "SamplerCustom", [False, seed, "fixed", 2.0],
         {"model": (6, 0), "positive": (7, 0), "negative": (8, 0), "sampler": (9, 0),
          "sigmas": (11, 1), "latent_image": (13, 0)}),
        (15, "LatentBlend", [0.75], {"samples1": (14, 0), "samples2": (13, 1)}),
        (16, "VAEDecodeTiled", [512], {"samples": (15, 0), "vae": (1, 2)}),
        (17, "InferenceOutput", [], {"images": (16, 0)}),
        (18, "SaveLatent", ["latents/phase24"], {"samples": (15, 0)}),
    ]


def server_phase(pipe, dev, card: str, k1: dict, k2: dict, ckpt: str, lora: str,
                 corr) -> dict:
    """Phase 24: serving (see the module docstring). ``ckpt`` and ``lora``
    are phase 20's files; phase 23's ControlNet files and maps lie beside
    them. ``pipe`` and ``corr`` are phase 6's, for EDITOR mode. Outputs go
    to a temporary directory under build/, removed at the end."""
    import base64
    import os
    import threading

    import numpy as np
    import torch

    from stable_renderer_tpu_torch.models.weights import flatten
    from stable_renderer_tpu_torch.server import FrameServer, serve_workflows
    from stable_renderer_tpu_torch.utils import paths as ppaths

    root = Path(__file__).resolve().parent
    model_dir = Path(ckpt).parent
    dirs = {k: model_dir / "maps" / k for k in ("color", "id", "noise", "normal", "depth")}
    tmp = Path(tempfile.mkdtemp(prefix="server-", dir=root / "build"))
    out = {}
    t_phase = time.perf_counter()
    saved_output_dir = ppaths.OUTPUT_DIR
    try:
        # --- 24.1 `serve` as its own process: two miku-shaped prompts and a bad one -----
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        map_args = [a for k, d in dirs.items() for a in (f"--{k}-dir", str(d))]
        cmd = [sys.executable, "-m", "stable_renderer_tpu_torch", "serve", "--port", str(port),
               "--max-prompts", "3", "--model-dir",
               str(model_dir), *map_args]
        t0 = time.perf_counter()
        with open(tmp / "serve.out", "w") as so, open(tmp / "serve.err", "w") as se:
            proc = subprocess.Popen(cmd, cwd=root, stdout=so, stderr=se,
                                    env=dict(os.environ, SR_TPU_OUTPUT_DIR=str(tmp / "serve")))

        def served(what: str) -> str:
            return (f"{what}\n{(tmp / 'serve.out').read_text()[-3000:]}\n"
                    f"{(tmp / 'serve.err').read_text()[-3000:]}")

        try:
            while True:
                try:
                    _http(base + "/status", timeout=1.0)
                    break
                except OSError:
                    if proc.poll() is not None or time.perf_counter() - t0 > 180:
                        fail(served(f"phase 24: `serve` did not answer (exit {proc.poll()})"))
                    time.sleep(0.1)
            up_s = time.perf_counter() - t0
            events: list = []
            reader = _sse_reader(base + "/events", events)
            stats = json.loads(_http(base + "/system_stats")[1])
            devs = stats["devices"]
            if not (devs and devs[0]["type"] == "cuda" and devs[0]["vram_total"] > 0
                    and devs[0]["name"] == torch.cuda.get_device_name(0)):
                fail(f"phase 24: /system_stats {devs} does not name the card")
            rows = miku_rows(Path(ckpt).name) + [(13, "SaveImage", ["phase24"],
                                                  {"images": (11, 0)})]
            good = ui_workflow(rows)
            bad = {"nodes": [{"id": 1, "type": "NopeNode", "widgets_values": []}], "links": []}
            # the two good prompts first: their history and frame are read while
            # the server still answers; the bad one, the last it takes, ends it
            pids = [json.loads(_http(base + "/prompt", {"prompt": wf})[1])["prompt_id"]
                    for wf in (good, good)]
            while True:
                hist = {h["prompt_id"]: h["status"]
                        for h in json.loads(_http(base + "/history")[1])}
                if len(hist) == 2:
                    break
                if proc.poll() is not None or time.perf_counter() - t0 > 600:
                    fail(served(f"phase 24: `serve` history {hist} (exit {proc.poll()})"))
                time.sleep(0.05)
            statuses = [hist[p] for p in pids]
            if statuses != ["success", "success"]:
                fail(served(f"phase 24: `serve` history {statuses}, want success, success"))
            png = _png_array(_http(base + "/view?filename=frame_0.png&subfolder=workflow")[1])
            if png.shape != (SIZE, SIZE, 3) or int(png.max()) == int(png.min()):
                fail(f"phase 24: /view of the saved frame: {png.shape}, constant "
                     f"{int(png.max()) == int(png.min())}")
            pids.append(json.loads(_http(base + "/prompt", {"prompt": bad})[1])["prompt_id"])
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reader.join(timeout=5)
        stdout = (tmp / "serve.out").read_text()
        if rc != 0:
            fail(served(f"phase 24: `serve` exited {rc}"))
        bad_done = [e["data"] for _, e in events if e["type"] == "executed"
                    and e["data"].get("prompt_id") == pids[2]]
        if [d["status"] for d in bad_done] != ["error"]:
            fail(served(f"phase 24: the bad prompt's `executed` events {bad_done}, want one "
                        f"with status error"))
        statuses.append("error")
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("kernel launches over 2 successful prompts: ")]
        launches = json.loads(line[0].split(": ", 1)[1]) if line else {}
        if launches.get("flash_attention") != 2 * EXEC_K1:
            fail(served(f"phase 24: `serve`'s launch line {line}: want K1 {EXEC_K1} a prompt"))
        exec_s = []
        for pid in pids[:2]:
            mine = [(t, e) for t, e in events if e.get("data", {}).get("prompt_id") == pid]
            prog = [e["data"] for _, e in mine if e["type"] == "progress"]
            if len(prog) != 4 or not all(
                    base64.b64decode(p.get("preview", ""))[:2] == b"\xff\xd8" for p in prog):
                fail(f"phase 24: prompt {pid}: {len(prog)} progress events over /events, want "
                     f"4 with a JPEG preview each")
            start = [t for t, e in mine if e["type"] == "execution_start"]
            done = [t for t, e in mine if e["type"] == "executed"]
            exec_s.append(done[0] - start[0])
        out["serve"] = {"up_s": up_s, "process_s": time.perf_counter() - t0,
                        "execute_s": exec_s, "statuses": statuses, "launches": launches}
        print(f"[24 serve] python -m stable_renderer_tpu_torch serve --max-prompts 3 as its own "
              f"process: answering after {up_s:.1f} s; history {statuses[:2]}, then the bad "
              f"prompt's {statuses[2]!r} over /events; /view frame_0.png "
              f"{png.shape}, not constant; /system_stats names {devs[0]['name']!r}, "
              f"{devs[0]['vram_total'] / 2**30:.1f} GiB; 4 progress events a good prompt with "
              f"JPEG previews; executes (SSE start to done, host clock) first {exec_s[0]:.2f} s "
              f"(checkpoint and ControlNet loads included), second {exec_s[1]:.2f} s (the "
              f"executor reused); exit 0 after {out['serve']['process_s']:.1f} s; launches {launches}: K1 {EXEC_K1} a prompt | {card}",
              flush=True)

        # --- 24.2 in process: FrameServer + serve_workflows on the new nodes ------------
        ppaths.OUTPUT_DIR = tmp / "outputs"
        server = FrameServer(port=0).start()
        base = f"http://127.0.0.1:{server.port}"
        bus = server._subscribe()
        mdirs = (str(model_dir),)
        wf_b = ui_workflow(server_rows(Path(ckpt).name, Path(lora).name, seed=24))
        key_b = json.dumps(wf_b, sort_keys=True, default=str)
        try:
            pid = json.loads(_http(base + "/prompt", {"prompt": wf_b})[1])["prompt_id"]
            zero_counts()
            with k1_shape_tally() as seen:
                t0 = time.perf_counter()
                serve_workflows(server, model_dirs=mdirs, max_prompts=1, poll_timeout=0.1,
                                device="cuda")
                first_s = time.perf_counter() - t0
            c = counts()
            hist = server.queue.get_history_item(pid)
            if hist["status"] != "success":
                fail(f"phase 24: the new-node workflow: {hist['status']} {hist['messages']}")
            ex = server.executor_cache[key_b]
            img = ex._cache[16][0]
            frame = server._frame
            if (tuple(img.shape) != (1, SIZE, SIZE, 3) or not torch.isfinite(img).all()
                    or float(img.max()) == float(img.min()) or frame.shape != (SIZE, SIZE, 3)
                    or int(frame.max()) == int(frame.min())):
                fail(f"phase 24: the new-node workflow's frame {tuple(img.shape)}, finite "
                     f"{bool(torch.isfinite(img).all())}, published {frame.shape}")
            unet_bytes = sum(t.numel() * t.element_size()
                             for t in flatten(ex._cache[1][0]["params"]).values())
            blended = ex._cache[15][0]["samples"]
            latent_file = ex._cache[18][0]
            # SaveLatent -> LoadLatent, through a second prompt
            wf_load = ui_workflow([(1, "LoadLatent", [latent_file], {}),
                                   (2, "InferenceOutput", [], {"value": (1, 0)})])
            _http(base + "/prompt", {"prompt": wf_load})
            serve_workflows(server, model_dirs=mdirs, max_prompts=1, poll_timeout=0.1,
                            device="cuda")
            loaded = server.executor_cache[json.dumps(wf_load, sort_keys=True,
                                                      default=str)]._cache[1][0]["samples"]
            if loaded.device.type != "cuda" or not same_bits(loaded, blended):
                fail(f"phase 24: LoadLatent of SaveLatent's {latent_file} differs from the "
                     f"saved latent (device {loaded.device})")
            del ex, img, blended, loaded
            k1_seen = {str(k_): n for k_, n in seen.items()}
            out["workflow"] = {"first_s": first_s, "k1_launches": c[0], "k1_by_shape": k1_seen,
                               "k1_routes": k1_routes(seen), "unet_bytes": unet_bytes}
            print(f"[24 workflow] FrameServer + serve_workflows(device='cuda'): CheckpointLoader, "
                  f"LoraLoader (phase 20's LoRA), ModelMergeSimple, RescaleCFG, "
                  f"PatchModelAddDownscale, TomePatchModel, SamplerCustom x2 (dpmpp_2m, Karras 4 "
                  f"steps split 2 + 2), LatentBlend, VAEDecodeTiled at {SIZE}x{SIZE}: success in "
                  f"{first_s:.2f} s (loads and the host LoRA merge included); frame finite, not "
                  f"constant; K1 {c[0]} by (BH, Lq, Lk, d) {dict(seen)}, by kernel "
                  f"{k1_routes(seen)}; SaveLatent -> LoadLatent bit for bit on the card | {card}",
                  flush=True)
            out["k1_rows"] = [r["shape"] for r in hold_new_k1_shapes(seen, 24, dev, card, k1)]

            # /interrupt during a prompt: the same graph at another seed (a new
            # executor: its loads and merges run again); the interrupt lands at
            # the first node entered after it, the positive CLIPTextEncode
            wf_i = ui_workflow(server_rows(Path(ckpt).name, Path(lora).name, seed=25))
            pid_i = json.loads(_http(base + "/prompt", {"prompt": wf_i})[1])["prompt_id"]
            worker = threading.Thread(target=serve_workflows, daemon=True, args=(server,),
                                      kwargs=dict(model_dirs=mdirs, max_prompts=1,
                                                  poll_timeout=0.1, device="cuda"))
            worker.start()
            t0 = time.perf_counter()
            while True:
                evt = bus.get(timeout=60)
                if evt["type"] == "execution_start" and evt["data"]["prompt_id"] == pid_i:
                    break
            _http(base + "/interrupt", {})
            worker.join(timeout=300)
            status_i = server.queue.get_history_item(pid_i)["status"]
            if worker.is_alive() or status_i != "interrupted":
                fail(f"phase 24: /interrupt during a prompt gave {status_i!r} "
                     f"(worker alive {worker.is_alive()})")
            interrupt_s = time.perf_counter() - t0

            # /free: the executors and the models they hold on the card go
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            freed = json.loads(_http(base + "/free", {"unload_models": True,
                                                     "free_memory": True}, timeout=60)[1])
            after = torch.cuda.memory_allocated()
            if before - after < unet_bytes or server.executor_cache:
                fail(f"phase 24: /free lowered memory_allocated by {before - after} bytes, "
                     f"want >= the UNet's {unet_bytes} ({freed})")
            out["interrupt_s"], out["free"] = interrupt_s, {
                "allocated_before": before, "allocated_after": after, **freed}
            print(f"[24 interrupt, free] /interrupt after execution_start: history "
                  f"'interrupted' {interrupt_s:.2f} s later; /free (unload_models, free_memory): "
                  f"{freed}, memory_allocated {before / 2**30:.2f} -> {after / 2**30:.2f} GiB "
                  f"(the UNet alone {unet_bytes / 2**30:.2f} GiB) | {card}", flush=True)
        finally:
            server.stop()

        # --- 24.3 EDITOR mode: Engine.RunEditor of the bench scene -----------------------
        zero_counts()
        t0 = time.perf_counter()
        eng, presented = run_engine(pipe, SIZE, EDITOR_FRAMES, corr, editor=True, editor_port=0)
        editor_s = time.perf_counter() - t0
        c = counts()
        try:
            base = f"http://127.0.0.1:{eng.editor_server.port}"
            png = _png_array(_http(base + "/frame.png")[1])
            got = {}

            def stream():
                import urllib.request

                with urllib.request.urlopen(base + "/stream", timeout=5) as r:
                    data = b""
                    while data.count(b"\xff\xd8") < 1 or b"\r\n--" not in data[2:]:
                        data += r.read(4096)
                    got["part"] = data

            t = threading.Thread(target=stream, daemon=True)
            t.start()
            t.join(timeout=10)
            scene = json.loads(_http(base + "/scene")[1])["scene"]
            ball = [n for n in scene if n["name"] == "ball"]
        finally:
            eng.editor_server.stop()
        if (c[0] != K1_CALLS_PER_FRAME * EDITOR_FRAMES or c[1] != EDITOR_FRAMES
                or len(presented) != EDITOR_FRAMES or png.shape[:2] != (SIZE, SIZE)
                or b"image/jpeg" not in got.get("part", b"")
                or not ball or "SpriteInfo" not in ball[0]["components"]):
            fail(f"phase 24 EDITOR: K1 {c[0]}, K2 {c[1]} over {EDITOR_FRAMES} frames (want "
                 f"{K1_CALLS_PER_FRAME} and 1 a frame), {len(presented)} presented, /frame.png "
                 f"{png.shape}, /stream part {'part' in got}, /scene ball {ball}")
        out["editor"] = {"s": editor_s, "k1": c[0], "k2_calls": c[1]}
        print(f"[24 editor] Engine.RunEditor of the bench scene, {EDITOR_FRAMES} frames at "
              f"{SIZE}x{SIZE} in {editor_s:.1f} s: K1 {c[0] // EDITOR_FRAMES} and K2 "
              f"{c[1] // EDITOR_FRAMES} call a frame by the counters; /frame.png {png.shape}, "
              f"/stream one MJPEG part, /scene lists the ball with its SpriteInfo | {card}",
              flush=True)
        k1["launches_a_frame"]["editor"] = c[0] // EDITOR_FRAMES
        k2.setdefault("launches_a_frame", {})["editor"] = c[1] // EDITOR_FRAMES
    finally:
        ppaths.OUTPUT_DIR = saved_output_dir
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[24 server] phase 24 in {out['phase_s']:.1f} s | {card}", flush=True)
    return out


# --- phase 25: SD2, SDXL and the refiner ------------------------------------------------

# the text towers of the tiny family files (tests/test_torch_model_families.py
# and phase 25d): the widths the family rule reads from the UNet's context,
# one narrow layer each
FAMILY_TOWERS = {
    "h": dict(vocab_size=1000, width=1024, num_layers=1, num_heads=16, mlp_ratio=1,
              projection_dim=64),
    "l": dict(vocab_size=1000, hidden_size=1024, num_layers=1, num_heads=2,
              intermediate_size=128),
    "g": dict(vocab_size=1000, width=1024, num_layers=1, num_heads=2, mlp_ratio=1,
              projection_dim=32),
    "r": dict(vocab_size=1000, width=1280, num_layers=1, num_heads=2, mlp_ratio=1,
              projection_dim=32),
}
FAMILY_V_STD = 0.2  # an SD2 file's out-layer statistic above 0.09 marks it 768-v
XL_SIZE = 1024      # SDXL's published resolution
SD2_SIZE = 768      # SD2 768-v's
FAMILY_WARM = 1
FAMILY_TIMED = 2
# K1 launches a frame by (BH, Lq, Lk, d[, "f32"]). SDXL at 1024x1024 (128x128
# latents): level 1's 10 self-attentions an evaluation (two transformers of
# depth 2 in, three out) at 640 channels = 10 heads of 64, batch 2 (cfg), 4
# evaluations; level 2 (1024 tokens) stays plain; the VAE's mid-block
# attention in encode and decode at 16,384 tokens
XL_K1_SHAPES = {(20, 4096, 4096, 64): 40, (1, 16384, 16384, 512): 2}
# SD2 at 768x768 (96x96 latents): level 0's 5 self-attentions an evaluation
# at 5 heads of 64 (9216 tokens), level 1's 5 at 10 heads (2304 tokens),
# level 2 (576 tokens) plain; the loaded f32 VAE's mid-block at 9216 tokens
SD2_K1_SHAPES = {(10, 9216, 9216, 64): 20, (20, 2304, 2304, 64): 20,
                 (1, 9216, 9216, 512, "f32"): 2}
FAMILY_GRAPH_SIZE = 64  # phase 25d's tiny graphs: 64x64 frames, 32x32 latents
# the tiny unCLIP file's vision tower (tests and phase 26c): ViT-H's depth,
# so that the loader's rule reads ViT-H, and its projection width, 1024 =
# the ADM's noise_aug_dim; narrow otherwise
# phase 26: K1 launches an execute by (BH, Lq, Lk, d). SD2.1-unclip-H at
# 768x768 (96x96 latents): SD2's level-0 and level-1 self-attentions at cfg
# batch 2, 4 evaluations; the executor's bf16 VAE decodes at 9216 tokens
UNCLIP_K1_SHAPES = {(10, 9216, 9216, 64): 20, (20, 2304, 2304, 64): 20,
                    (1, 9216, 9216, 512): 1}
# grounded SD1.5 at 512x512: level 0's 5 self-attentions at cfg batch 2 (8
# heads of 40); its 5 GLIGEN fusers on the positive row over 4096 visual +
# 30 grounding tokens (8 heads: key width 768); the bf16 decode
GLIGEN_K1_SHAPES = {(16, 4096, 4096, 40): 20, (8, 4126, 4126, 40): 20,
                    (1, 4096, 4096, 512): 1}
UNCLIP_SIZE = 768    # SD2.1-unclip-H's published resolution (768-v)
IMAGE_TIMED = 2      # phase 26's timed executes a graph, after one warm
IMAGE_SEED = 26
GROUNDED_MOVED_FLOOR = 1e-3  # grounded vs ungrounded SD1.5 image, max abs on [0, 1]
IMAGE_GRAPH_SIZE = 64        # phase 26c's tiny graphs
# the tiny CLIP vision files' ViT-L (tests and phase 26c): ViT-L's depth, so
# that the loaders read ViT-L, narrow otherwise
VITL_TINY_VISION = dict(hidden_size=32, num_layers=24, num_heads=2, intermediate_size=64,
                        image_size=28, patch_size=14, projection_dim=32)
UNCLIP_TINY_VISION = dict(hidden_size=32, num_layers=32, num_heads=2, intermediate_size=64,
                          image_size=28, patch_size=14, projection_dim=1024)


def family_configs(kind: str):
    """(UNetConfig, CLIP-L config or None, OpenCLIP config or None) of a tiny
    ``kind`` file: "sd1" (the tiny UNet at SD1.x's context 768, 8 heads,
    and a 768-wide CLIP-L), "sd2" (SD1.5's four levels at 32 channels, so output
    block 11 carries the 768-v statistic), "sd2_small" (the tiny UNet's two
    levels), "x4" (the class table, 7 input channels, self-attention off at
    level 0), "unclip" (sd2_small with SD2.1-unclip-H's 2048-wide ADM),
    "sdxl" (the tiny SDXL UNet at context 2048 = L + G) or "refiner"
    (context 1280, the 2560-style ADM)."""
    from dataclasses import replace

    from stable_renderer_tpu_torch.models.clip import CLIPConfig, OpenCLIPConfig
    from stable_renderer_tpu_torch.models.unet import (
        SD15_UNET_CONFIG,
        TINY_SDXL_UNET_CONFIG,
        TINY_UNET_CONFIG,
        UNetConfig,
    )

    h = OpenCLIPConfig(**FAMILY_TOWERS["h"])
    if kind == "sd1":
        return (replace(TINY_UNET_CONFIG, num_heads=8, context_dim=768),
                CLIPConfig(vocab_size=1000, hidden_size=768, num_layers=2, num_heads=2,
                           intermediate_size=128), None)
    if kind == "sd2":
        return replace(SD15_UNET_CONFIG, model_channels=32, context_dim=1024, head_dim=64), None, h
    if kind == "sd2_small":
        return replace(TINY_UNET_CONFIG, context_dim=1024, head_dim=64), None, h
    if kind == "unclip":
        return replace(TINY_UNET_CONFIG, context_dim=1024, head_dim=64, adm_in_channels=2048), None, h
    if kind == "x4":
        return (UNetConfig(in_channels=7, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                           attention_levels=(0, 1), context_dim=1024, head_dim=64,
                           disable_self_attn_levels=(True, False), num_classes=350), None, h)
    if kind == "sdxl":
        return (replace(TINY_SDXL_UNET_CONFIG, context_dim=2048, head_dim=64,
                        adm_in_channels=32 + 6 * 256),
                CLIPConfig(**FAMILY_TOWERS["l"]), OpenCLIPConfig(**FAMILY_TOWERS["g"]))
    return (replace(TINY_SDXL_UNET_CONFIG, context_dim=1280, head_dim=64,
                    adm_in_channels=32 + 5 * 256), None, OpenCLIPConfig(**FAMILY_TOWERS["r"]))


def family_trees(kind: str, ucfg, lcfg, gcfg, vcfg, generator, dtype, device=None,
                 vision=None) -> dict:
    """{key prefix: tree} of a ``kind`` checkpoint in its family's layout,
    drawn from ``generator`` in ``dtype``: the UNet, the VAE, then the
    towers (SD1.x: CLIP-L at cond_stage_model.transformer.; SD2, unCLIP and
    x4: OpenCLIP-H at cond_stage_model.model.; SDXL:
    CLIP-L at conditioner.embedders.0.transformer. and CLIP-G at
    embedders.1.model.; the refiner: CLIP-G at embedders.0.model.), and a
    ``vision`` config's CLIP vision tower at embedder.model.visual. in the
    transformers layout (unCLIP's)."""
    from stable_renderer_tpu_torch.models.clip import CLIPTextModel, OpenCLIPTextModel
    from stable_renderer_tpu_torch.models.clip_vision import CLIPVisionModel
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.vae import VAE

    trees = {"model.diffusion_model.": UNetModel(ucfg).init(generator, dtype=dtype, device=device),
             "first_stage_model.": VAE(vcfg).init(generator, dtype=dtype, device=device)}
    if kind == "sd1":
        trees["cond_stage_model.transformer."] = CLIPTextModel(lcfg).init(
            generator, dtype=dtype, device=device)
        return trees
    if kind == "sdxl":
        trees["conditioner.embedders.0.transformer."] = CLIPTextModel(lcfg).init(
            generator, dtype=dtype, device=device)
    prefix = {"sdxl": "conditioner.embedders.1.model.",
              "refiner": "conditioner.embedders.0.model."}.get(kind, "cond_stage_model.model.")
    trees[prefix] = OpenCLIPTextModel(gcfg).init(generator, dtype=dtype, device=device)["model"]
    if vision is not None:
        trees["embedder.model.visual."] = CLIPVisionModel(vision).init(generator, dtype=dtype,
                                                                       device=device)
    return trees


def mark_v(flat: dict, generator) -> None:
    """Set an SD-topology file's out-layer statistic to 768-v's."""
    import torch

    key = "model.diffusion_model.output_blocks.11.1.transformer_blocks.0.norm1.bias"
    t = flat[key]
    flat[key] = (torch.randn(t.shape, generator=generator, device=t.device)
                 * FAMILY_V_STD).to(t.dtype)


def write_family_file(kind: str, path, dtype=None) -> dict:
    """A tiny ``kind`` checkpoint (family_configs) written to ``path`` from
    the port's inits (a CPU generator seeded with 0) in ``dtype`` (default
    f16), the SD2 file marked 768-v, the unCLIP file with
    UNCLIP_TINY_VISION's tower. Returns the flat dict written."""
    import torch

    from stable_renderer_tpu_torch.models.clip_vision import CLIPVisionConfig
    from stable_renderer_tpu_torch.models.vae import TINY_VAE_CONFIG
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    ucfg, lcfg, gcfg = family_configs(kind)
    g = torch.Generator().manual_seed(0)
    vision = CLIPVisionConfig(**UNCLIP_TINY_VISION) if kind == "unclip" else None
    trees = family_trees(kind, ucfg, lcfg, gcfg, TINY_VAE_CONFIG, g, torch.float32,
                         vision=vision)
    flat = {p + k: v.to(dtype or torch.float16) for p, t in trees.items()
            for k, v in flatten(t).items()}
    if kind == "sd2":
        mark_v(flat, g)
    write_safetensors(flat, path)
    return flat


@contextlib.contextmanager
def tiny_family_loaders(kind: str):
    """The executor's loader configs, which it reads by module name at call
    time, set to ``kind``'s tiny ones inside the block: SD1.x's VAE and
    CLIP-L names (the tokenizer's; SDXL's L tower), SD2's OpenCLIP-H,
    SDXL's CLIP-G, and ViT-H's and ViT-L's (the vision files' towers)."""
    from stable_renderer_tpu_torch.models import clip as clip_mod
    from stable_renderer_tpu_torch.models import clip_vision as vision_mod
    from stable_renderer_tpu_torch.models import vae as vae_mod

    _, lcfg, gcfg = family_configs(kind)
    names = [(clip_mod, "SD15_CLIP_CONFIG", lcfg or clip_mod.TINY_CLIP_CONFIG),
             (clip_mod, "SD2_CLIP_H_CONFIG", clip_mod.OpenCLIPConfig(**FAMILY_TOWERS["h"])),
             (clip_mod, "SDXL_CLIP_G_CONFIG", gcfg),
             (vae_mod, "SD15_VAE_CONFIG", vae_mod.TINY_VAE_CONFIG),
             (vision_mod, "VITH_CONFIG", vision_mod.CLIPVisionConfig(**UNCLIP_TINY_VISION)),
             (vision_mod, "VITL_CONFIG", vision_mod.CLIPVisionConfig(**VITL_TINY_VISION))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in names]
    for mod, name, value in names:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def family_rows(kind: str, name: str) -> list:
    """CheckpointLoaderSimple -> the family's text encodes (CLIPTextEncodeSDXL
    with sizes and a crop, ...Refiner with aesthetic scores 6.0 and 2.5,
    CLIPTextEncode for SD2) -> EngineData's latent and noise -> KSampler
    (euler, karras, 3 steps, cfg 2.0) -> VAEDecode -> InferenceOutput."""
    s = FAMILY_GRAPH_SIZE
    if kind == "sdxl":
        enc = [(2, "CLIPTextEncodeSDXL", [s, s, 0, 8, s, s, "a red boat", "a boat"],
                {"clip": (1, 1)}),
               (3, "CLIPTextEncodeSDXL", [s, s, 0, 0, s, s, "blurry", "blurry"], {"clip": (1, 1)})]
    elif kind == "refiner":
        enc = [(2, "CLIPTextEncodeSDXLRefiner", [6.0, s, s, "a red boat"], {"clip": (1, 1)}),
               (3, "CLIPTextEncodeSDXLRefiner", [2.5, s, s, "blurry"], {"clip": (1, 1)})]
    else:
        enc = [(2, "CLIPTextEncode", ["a red boat"], {"clip": (1, 1)}),
               (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)})]
    return [(1, "CheckpointLoaderSimple", [name], {}), *enc, (4, "EngineData", [], {}),
            (5, "KSampler", [3, "fixed", 3, 2.0, "euler", "karras", 1.0],
             {"model": (1, 0), "positive": (2, 0), "negative": (3, 0), "latent_image": (4, 6)}),
            (6, "VAEDecode", [], {"samples": (5, 0), "vae": (1, 2)}),
            (7, "InferenceOutput", [], {"images": (6, 0)})]


def hold_new_k3_classes(per_frame: dict, phase: int, dev, card: str, k3: dict) -> list:
    """Each int8 K3 class of ``per_frame`` ((N, H, W, Cin, Cout) -> launches
    a frame) that phase 7 did not check, against conv3x3_kernel_reference
    (exact, as phase 7's int8 rows), timed by graph replay beside the plain
    version and its bound; its row joins ``k3["shapes"]`` with its launches
    a frame. Returns the rows."""
    import torch

    from stable_renderer_tpu_torch.ops.conv_kernel import (
        conv3x3_kernel,
        conv3x3_kernel_reference,
        conv_tiles,
    )

    checked = set(K3_INT8_FRAME_SHAPES) | set(K3_STREAM_FRAME_SHAPES)
    gen = torch.Generator(device=dev).manual_seed(phase)
    rows = []
    for (n, h, w, cin, cout), launches in sorted(per_frame.items()):
        if (n, h, w, cin, cout) in checked:
            continue
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
        wf = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / (3.0 * cin ** 0.5)
        b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        ws = wf.abs().amax((0, 1, 2)) / 127.0
        wk = torch.clamp(torch.round(wf / ws), -127, 127).to(torch.int8)
        kw = dict(a_scale=(x.float().abs().amax() / 127.0).reshape(()), w_scale=ws)
        out = conv3x3_kernel(x, wk, b, **kw)
        torch.cuda.synchronize()
        err = (out.float() - conv3x3_kernel_reference(x, wk, b, **kw).float()).abs().max().item()
        shape = f"{n}x{h}x{w}x{cin}->{cout} int8 (phase {phase})"
        if err != 0.0:
            fail(f"K3 {shape}: max abs err {err:.3e} (bar: exact)")
        t = conv_tiles(n, h, w, cin, cout, True)
        row = {"shape": shape, "max_abs_err": err, "bar": "exact", "tiles": f"bn {t.bn} rows "
               f"{t.rows}", f"launches_a_frame_phase_{phase}": launches,
               "ms": graph_ms(lambda: conv3x3_kernel(x, wk, b, **kw)),
               "plain_ms": graph_ms(lambda: conv3x3_kernel_reference(x, wk, b, **kw), 5),
               "library_ms": None,  # no PyTorch call convolves int8
               "ms_with_host": cuda_ms(lambda: conv3x3_kernel(x, wk, b, **kw), 20)}
        row["bound_ms"], row["bound_by"] = bound(nbytes(x, wk, b, out),
                                                 2.0 * n * h * w * cout * 9 * cin, "int8")
        k3["shapes"].append(row)
        rows.append(row)
        print(f"[{phase} K3] {row} | {card}", flush=True)
        del x, wk, out
    return rows


def family_engine_run(label: str, pipe, size: int, want_k1: dict, card: str) -> dict:
    """The bench scene through Engine.Run at ``size`` x ``size`` with
    ``pipe``: FAMILY_WARM warm and FAMILY_TIMED timed presents (and
    PRESENT_DEPTH more); each presented frame (size, size, 4) uint8, finite
    and not constant; K1 launches by shape ``want_k1`` a frame, K2 one call a
    frame. Returns (a summary: the present-to-present median, one profiled
    frame's kernel ms and the busy share, K1 by shape and by kernel, K2 and
    K3 a frame, the peak device memory; K1's tally; K3's tally by class,
    k3_shape_tally's)."""
    import torch

    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    n = FAMILY_WARM + FAMILY_TIMED + PRESENT_DEPTH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with k1_shape_tally() as seen, k3_shape_tally() as k3_seen:
        eng, presented = run_engine(pipe, size, n, OverlapCorresponder(
            vertex_segments=4096, update_corrmap=False))
        c = counts()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if dict(seen) != {k: v * n for k, v in want_k1.items()} or c[1] != n:
        fail(f"phase 25 {label}: K1 by shape {dict(seen)} and K2 {c[1]} over {n} frames; "
             f"want {want_k1} and 1 a frame")
    if eng.device.type != "cuda" or [i for _, i, _ in presented] != list(range(n)):
        fail(f"phase 25 {label}: device {eng.device}, presented {[i for _, i, _ in presented]}")
    for _, i, frame in presented:
        if frame.shape != (size, size, 4) or frame.dtype.name != "uint8" or int(
                frame[..., :3].max()) == int(frame[..., :3].min()):
            fail(f"phase 25 {label} frame {i}: {frame.shape} {frame.dtype}, or constant")
    images = eng.RenderManager.last_diffusion_frames
    if not torch.isfinite(images.float()).all():
        fail(f"phase 25 {label}: non-finite decoded frame")
    lo = FAMILY_WARM
    stamps = [t for t, _, _ in presented[lo - 1:lo + FAMILY_TIMED]]
    gaps = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    median = statistics.median(gaps)
    # one frame's kernels by the profiler, after a warm frame: the busy share
    _, device_ms = engine_frame_kernels(pipe, size, OverlapCorresponder(
        vertex_segments=4096, update_corrmap=False))
    if not device_ms > 0:
        fail(f"phase 25 {label}: the profiled frame recorded no device time")
    out = {"median_ms": median, "gaps_ms": gaps, "frames": n, "run_s": run_s,
           "profiled_frame_device_ms": device_ms, "busy_share": device_ms / median,
           "k1_a_frame": {str(k): v // n for k, v in seen.items()},
           "k1_by_kernel": {k: v // n for k, v in k1_routes(seen).items()},
           "k2_calls_a_frame": c[1] // n, "k3_a_frame": c[2] / n,
           "max_memory_allocated_gib": peak / 2 ** 30}
    print(f"[25 {label}] Engine.Run of the bench scene at {size}x{size}, {n} frames in "
          f"{run_s:.1f} s: present-to-present median {median:.1f} ms over "
          f"{FAMILY_TIMED} timed frames, one profiled frame's kernels {device_ms:.1f} ms (busy "
          f"share {device_ms / median:.3f}); K1 a frame {out['k1_a_frame']} "
          f"({out['k1_by_kernel']}), K2 {c[1] // n} call a frame, K3 {c[2] / n:g} a frame; "
          f"max_memory_allocated {out['max_memory_allocated_gib']:.2f} GiB; frames "
          f"({size}, {size}, 4) uint8, finite, not constant | {card}", flush=True)
    return out, seen, k3_seen


def families_phase(dev, card: str, k1: dict, k3: dict) -> dict:
    """Phase 25: (a) SDXL base at full width from random weights through
    Engine.Run at 1024x1024; (b) its int8 frame, K3's new classes held;
    (c) SD2 768-v written to a full-width file, loaded by from_checkpoint and
    drawn at 768x768; (d) tiny SD2, SDXL and refiner files through the
    executor on the card against the CPU. Every new K1 shape is held."""
    import torch
    from dataclasses import replace as dc_replace

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.clip import SD2_CLIP_H_CONFIG
    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG
    from stable_renderer_tpu_torch.models.weights import flatten, tree_to, write_safetensors
    from stable_renderer_tpu_torch.workflow import executor as wex
    from stable_renderer_tpu_torch.workflow.config import RenderConfig
    from stable_renderer_tpu_torch.workflow.loader import Workflow

    t_phase = time.perf_counter()
    out = {}
    # --- 25a. SDXL base at full width ------------------------------------------------------
    cfg = RenderConfig(prompt="a ball")  # 4-step LCM over sgm_uniform at cfg 2.0
    t0 = time.perf_counter()
    pipe = DiffusionPipeline.from_random(cfg, tiny=False, family="sdxl", device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    uc = pipe.unet.config
    if not (pipe.is_sdxl and uc.adm_in_channels == 2816 and uc.context_dim == 2048
            and pipe.clip_g.config.width == 1280 and pipe.clip.config.hidden_size == 768
            and pipe.vae.config.scale_factor == 0.13025
            and pipe.unet_params["time_embed"]["0"]["weight"].dtype == torch.bfloat16):
        fail(f"phase 25a: the SDXL pipeline's widths or types ({uc})")
    n_params = sum(v.numel() for v in flatten(pipe.unet_params).values())
    out["sdxl"], seen, _ = family_engine_run("sdxl bf16", pipe, XL_SIZE, XL_K1_SHAPES, card)
    out["sdxl"].update(init_s=init_s, unet_params=n_params)
    hold_new_k1_shapes(seen, 25, dev, card, k1)

    # --- 25b. the int8 SDXL frame --------------------------------------------------------
    pipe_i8 = dc_replace(pipe, config=dc_replace(cfg, int8_conv=True))
    t0 = time.perf_counter()
    pipe_i8.quantize_convs(render_size=(XL_SIZE, XL_SIZE))  # the cfg batch of every sigma
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    out["sdxl_int8"], _, k3_seen = family_engine_run("sdxl int8", pipe_i8, XL_SIZE,
                                                     XL_K1_SHAPES, card)
    n_i8 = out["sdxl_int8"]["frames"]
    classes = per_frame_classes(k3_seen, n_i8)
    if not classes or sum(classes.values()) != out["sdxl_int8"]["k3_a_frame"]:
        fail(f"phase 25b: K3 classes {classes}, {out['sdxl_int8']['k3_a_frame']} a frame")
    out["sdxl_int8"].update(quantize_s=quantize_s,
                            k3_classes={str(k): v for k, v in classes.items()})
    held = hold_new_k3_classes(classes, 25, dev, card, k3)
    out["sdxl_int8"]["k3_classes_held"] = len(held)
    print(f"[25 sdxl int8] {len(classes)} K3 classes a frame, {len(held)} new ones held "
          f"(exact) and timed | {card}", flush=True)
    del pipe, pipe_i8
    torch.cuda.empty_cache()

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="families-", dir=build_dir))
    try:
        # --- 25c. SD2 768-v from a written file --------------------------------------------
        gen = torch.Generator(device=dev).manual_seed(25)
        sd2_unet = dc_replace(SD15_UNET_CONFIG, context_dim=1024, head_dim=64)
        trees = family_trees("sd2", sd2_unet, None, SD2_CLIP_H_CONFIG, SD15_VAE_CONFIG, gen,
                             torch.bfloat16, dev)
        flat = {p + k: v for p, t in trees.items() for k, v in flatten(t).items()}
        del trees
        mark_v(flat, gen)
        path = tmp / "sd2_768_v.safetensors"
        t0 = time.perf_counter()
        size = write_safetensors(flat, path)
        write_s = time.perf_counter() - t0
        del flat
        torch.cuda.empty_cache()
        sd2_cfg = RenderConfig(prompt="a ball", sampler="euler")  # v-prediction, 4 steps
        t0 = time.perf_counter()
        pipe2 = DiffusionPipeline.from_checkpoint(str(path), sd2_cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if (pipe2.model_family, pipe2.model_sampling.prediction, type(pipe2.clip).__name__,
                pipe2.vae_params["quant_conv"]["weight"].dtype,
                pipe2.unet.config.head_dim) != ("sd2", "v", "SD2ClipH", torch.float32, 64):
            fail(f"phase 25c: the loaded SD2 file: family {pipe2.model_family}, prediction "
                 f"{pipe2.model_sampling.prediction}, tower {type(pipe2.clip).__name__}")
        out["sd2"], seen, _ = family_engine_run("sd2 768-v", pipe2, SD2_SIZE, SD2_K1_SHAPES,
                                                card)
        if out["sd2"]["k1_by_kernel"].get("flash_f32") != 2:
            fail(f"phase 25c: the f32 VAE's attention on {out['sd2']['k1_by_kernel']}")
        out["sd2"].update(file_gb=size / 1e9, write_s=write_s, load_s=load_s)
        print(f"[25 sd2] the file: {size / 1e9:.2f} GB (bf16) written in {write_s:.1f} s, "
              f"loaded by from_checkpoint in {load_s:.1f} s: family sd2, v-prediction, "
              f"SD2ClipH, f32 VAE | {card}", flush=True)
        hold_new_k1_shapes(seen, 25, dev, card, k1)
        del pipe2
        path.unlink()
        torch.cuda.empty_cache()

        # --- 25d. tiny SD2, SDXL and refiner files: the executor, card against CPU ----------
        s = FAMILY_GRAPH_SIZE
        g = torch.Generator().manual_seed(6)
        maps = dict(color_maps=torch.rand((1, s, s, 3), generator=g),
                    noise_maps=torch.randn((1, s // 2, s // 2, 4), generator=g),
                    id_maps=torch.zeros((1, s, s, 4), dtype=torch.int32))
        from stable_renderer_tpu_torch.data.engine_data import EngineData

        out["tiny_graphs"] = {}
        for kind in ("sd2_small", "sdxl", "refiner"):
            write_family_file(kind, tmp / f"{kind}.safetensors", torch.float32)
            wf_path = tmp / f"{kind}.json"
            wf_path.write_text(json.dumps(ui_workflow(family_rows(kind, f"{kind}.safetensors"))))
            finals = []
            with tiny_family_loaders(kind):
                for d in (torch.device("cpu"), dev):
                    ex = wex.PromptExecutor(Workflow.Load(wf_path), model_dirs=(str(tmp),),
                                            device=d)
                    ed = EngineData(frame_indices=torch.arange(1),
                                    **{k: v.to(d) for k, v in maps.items()})
                    first = ex.execute(engine_data=ed).final_output  # as loaded: UNet, VAE bf16
                    if not torch.isfinite(first.float()).all():
                        fail(f"phase 25d {kind} on {d}: non-finite output as loaded")
                    model, clip, vae = ex._cache[1]  # the loader is not re-run
                    ex._cache = {1: ({**model, "params": tree_to(model["params"], d,
                                                                  torch.float32)}, clip,
                                     {**vae, "params": tree_to(vae["params"], d, torch.float32)})}
                    finals.append(ex.execute(engine_data=ed).final_output.float().cpu())
            err = float((finals[1] - finals[0]).abs().max())
            if not (torch.isfinite(finals[1]).all() and err < REF_TOL
                    and float(finals[1].std()) > 1e-3):
                fail(f"phase 25d {kind}: card against CPU max abs err {err:.3e} (tol {REF_TOL})")
            out["tiny_graphs"][kind] = err
            print(f"[25 tiny] {kind}: CheckpointLoaderSimple -> {family_rows(kind, '')[1][1]} -> "
                  f"KSampler -> VAEDecode at {s}x{s}, the loaded UNet and VAE widened to f32: "
                  f"card against CPU max abs err {err:.3e} (tol {REF_TOL}) | {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[25 families] phase 25 in {out['phase_s']:.1f} s | {card}", flush=True)
    return out


# --- phase 26: the image-conditioned models ------------------------------------------


def transformer_blocks(ucfg) -> list:
    """(checkpoint block prefix, width) of each SpatialTransformer of a UNet
    config, in the UNet's transformer numbering (input blocks, the middle
    block, output blocks): where a GLIGEN file keeps its fusers."""
    from stable_renderer_tpu_torch.models.unet import UNetModel

    params = UNetModel(ucfg).init(device="meta")
    out = []
    for part in ("input_blocks", "middle_block", "output_blocks"):
        blocks = {"": params[part]} if part == "middle_block" else params[part]
        for n in sorted(blocks, key=lambda k: int(k) if k else 0):
            for m, sub in blocks[n].items():
                if isinstance(sub, dict) and "transformer_blocks" in sub:
                    prefix = ".".join(x for x in (part, n, m) if x)
                    out.append((prefix, sub["proj_in"]["weight"].shape[0]))
    return out


def gligen_flat(ucfg, key_dim: int, generator, dtype, device=None, alpha: float = 1.0) -> dict:
    """A GLIGEN file's tensors for a UNet config: one fuser a transformer
    block at its width (``<block>.fuser.*``), the PositionNet (key_dim ->
    key_dim), drawn from ``generator``: linear weights N(0, 1 / fan-in), the
    gates ``alpha``."""
    import torch

    from stable_renderer_tpu_torch.models.gligen import init_random_gligen
    from stable_renderer_tpu_torch.models.weights import flatten

    def scaled(tree):
        flat = flatten(tree)
        for k, v in flat.items():
            if k.endswith("weight") and v.dim() == 2:
                flat[k] = (torch.randn(v.shape, generator=generator, device=device)
                           / v.shape[1] ** 0.5)
            elif k.startswith("alpha_"):
                flat[k] = torch.full((), alpha, device=device)
        return flat

    out = {}
    for prefix, width in transformer_blocks(ucfg):
        fuser = init_random_gligen(generator, 1, width, key_dim, device=device).fusers[0]
        out.update({f"{prefix}.fuser.{k}": v for k, v in scaled(fuser).items()})
    pn = init_random_gligen(generator, 0, key_dim=key_dim, device=device).position_net
    out.update({f"position_net.{k}": v for k, v in scaled(pn).items()})
    return {k: v.to(dtype) for k, v in out.items()}


def style_flat(cfg, generator, dtype, device=None, spelling: str = "transformer_layes") -> dict:
    """A T2I style adapter file's tensors for a StyleAdapterConfig, its
    layers under ``spelling`` (the upstream file's misspelled
    ``transformer_layes`` by default)."""
    from stable_renderer_tpu_torch.models.t2i_adapter import StyleAdapter
    from stable_renderer_tpu_torch.models.weights import flatten

    tree = StyleAdapter(cfg).init(generator, dtype=dtype, device=device)
    return {(spelling + k[len("layers"):] if k.startswith("layers.") else k): v
            for k, v in flatten(tree).items()}


def write_frame_png(path, size: int, seed: int) -> None:
    """A smooth colour frame (gradients and a few discs) as an RGB PNG: the
    image the phase's LoadImage nodes read."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([xx, yy, 0.5 * (xx + yy)], -1)
    for _ in range(4):
        cy, cx, r = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), rng.uniform(0.05, 0.2)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(size=3)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def unclip_rows(name: str, size: int, entries: int = 2, sampler=("euler", "normal", 4, 4.0),
                latent=None, save: bool = True) -> list:
    """unCLIPCheckpointLoader -> two prompts -> LoadImage of frame.png ->
    CLIPVisionEncode with the file's tower -> ``entries`` unCLIPConditioning
    on the positive (strengths 1.0, 0.5, 0.8; noise augmentation 0.1, 0.1,
    0.3: two or more take the merge path) -> KSampler on an empty
    ``size`` latent (or ``latent``, a (node, slot) link) -> VAEDecode
    (-> SaveImage when ``save``)."""
    rows = [(1, "unCLIPCheckpointLoader", [name], {}),
            (2, "CLIPTextEncode", ["a photograph of a house by a lake"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry, lowres"], {"clip": (1, 1)}),
            (4, "LoadImage", ["frame.png"], {}),
            (5, "CLIPVisionEncode", [], {"clip_vision": (1, 3), "image": (4, 0)})]
    src = 2
    for i, (st, aug) in enumerate(((1.0, 0.1), (0.5, 0.1), (0.8, 0.3))[:entries]):
        rows.append((6 + i, "unCLIPConditioning", [st, aug],
                     {"conditioning": (src, 0), "clip_vision_output": (5, 0)}))
        src = 6 + i
    name_, sched, steps, cfg = sampler
    rows += [(10, "EmptyLatentImage", [size, size, 1], {}),
             (11, "KSampler", [IMAGE_SEED, "fixed", steps, cfg, name_, sched, 1.0],
              {"model": (1, 0), "positive": (src, 0), "negative": (3, 0),
               "latent_image": latent or (10, 0)}),
             (12, "VAEDecode", [], {"samples": (11, 0), "vae": (1, 2)})]
    if save:
        rows.append((13, "SaveImage", ["unclip"], {"images": (12, 0)}))
    return rows


def grounded_rows(ckpt_name: str, grounded: bool = True, size: int = 512,
                  sampler=("lcm", "sgm_uniform", 4, 2.0), latent=None, area=None) -> list:
    """SD1.5's CheckpointLoaderSimple -> two prompts -> GLIGENLoader + two
    GLIGENTextBoxApply boxes (when ``grounded``) -> CLIPVisionLoader +
    CLIPVisionEncode of frame.png -> StyleModelLoader + StyleModelApply on
    both conds (77 + 8 tokens: the plain CFG path batches them whole;
    ``area``: ConditioningSetAreaStrength on the positive, the cond-list
    path) -> KSampler on an empty ``size`` latent (or ``latent``) ->
    VAEDecode. The node ids are the same with and without the boxes."""
    rows = [(1, "CheckpointLoaderSimple", [ckpt_name], {}),
            (2, "CLIPTextEncode", ["a cat and a dog in a garden, photograph"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry, lowres"], {"clip": (1, 1)}),
            (7, "CLIPVisionLoader", ["clip_vision_l.safetensors"], {}),
            (8, "LoadImage", ["frame.png"], {}),
            (9, "CLIPVisionEncode", [], {"clip_vision": (7, 0), "image": (8, 0)}),
            (10, "StyleModelLoader", ["style.safetensors"], {})]
    pos = 2
    if grounded:
        q = size // 8
        rows += [(4, "GLIGENLoader", ["gligen.safetensors"], {}),
                 (5, "GLIGENTextBoxApply", ["a cat", size // 2, size // 2, q, q],
                  {"conditioning_to": (2, 0), "clip": (1, 1), "gligen_textbox_model": (4, 0)}),
                 (6, "GLIGENTextBoxApply", ["a dog", 3 * size // 8, size // 2, size // 2,
                                            3 * q], {"conditioning_to": (5, 0), "clip": (1, 1),
                                                     "gligen_textbox_model": (4, 0)})]
        pos = 6
    rows += [(11, "StyleModelApply", [], {"conditioning": (pos, 0), "style_model": (10, 0),
                                          "clip_vision_output": (9, 0)}),
             (12, "StyleModelApply", [], {"conditioning": (3, 0), "style_model": (10, 0),
                                          "clip_vision_output": (9, 0)}),
             (13, "EmptyLatentImage", [size, size, 1], {})]
    pos = 11
    if area is not None:
        rows.append((16, "ConditioningSetAreaStrength", [area], {"conditioning": (11, 0)}))
        pos = 16
    name_, sched, steps, cfg = sampler
    return rows + [(14, "KSampler", [IMAGE_SEED, "fixed", steps, cfg, name_, sched, 1.0],
                    {"model": (1, 0), "positive": (pos, 0), "negative": (12, 0),
                     "latent_image": latent or (13, 0)}),
                   (15, "VAEDecode", [], {"samples": (14, 0), "vae": (1, 2)})]


def image_graph_run(label: str, ex, loaders, want_k1: dict, card: str, phase: int = 26,
                    timed: int = IMAGE_TIMED, timed_node: str = "CLIPVisionEncode",
                    load_node: str = None) -> dict:
    """One warm execute of ``ex`` (the loads included; ``load_node``'s calls
    in it timed), then ``timed`` executes with only the ``loaders`` nodes'
    outputs kept, each under k1_shape_tally (K1 by shape ``want_k1`` an
    execute), ``timed_node`` timed on its own; one profiled execute's
    kernel time and busy share; the peak device memory. Returns (summary,
    K1 tally of one execute, the last execute's context)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stable_renderer_tpu_torch.workflow import executor as wex

    def timing(name, into):
        fn = wex.NODE_REGISTRY[name]

        def timed_fn(ctx, node, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = fn(ctx, node, **kw)
            torch.cuda.synchronize()
            into.append((time.perf_counter() - t) * 1e3)
            return result

        return fn, timed_fn

    load_ms, node_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if load_node is not None:
        real_load, wex.NODE_REGISTRY[load_node] = timing(load_node, load_ms)
    t0 = time.perf_counter()
    try:
        ex.execute()
    finally:
        if load_node is not None:
            wex.NODE_REGISTRY[load_node] = real_load
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    def keep_loaders():
        ex._cache = {n: ex._cache[n] for n in loaders}

    times = []
    real_node, wex.NODE_REGISTRY[timed_node] = timing(timed_node, node_ms)
    try:
        for _ in range(timed):
            keep_loaders()
            zero_counts()
            with k1_shape_tally() as seen:
                torch.cuda.synchronize()
                t = time.perf_counter()
                ctx = ex.execute()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            if dict(seen) != want_k1:
                fail(f"phase {phase} {label}: an execute launched K1 by shape {dict(seen)}; "
                     f"want {want_k1}")
    finally:
        wex.NODE_REGISTRY[timed_node] = real_node
    peak = torch.cuda.max_memory_allocated()
    keep_loaders()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.execute()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not device_ms > 0:
        fail(f"phase {phase} {label}: the profiled execute recorded no device time")
    med = statistics.median(times)
    # the busy share over the unprofiled median, as phase 25 takes it (the
    # profiler slows the host)
    out = {"warm_s": warm_s, "execute_ms": times, "median_ms": med,
           f"{timed_node}_ms": node_ms, "profiled_execute_ms": prof_ms,
           "profiled_kernel_ms": device_ms, "busy_share": device_ms / med,
           "k1_by_shape": {str(k): n for k, n in seen.items()}, "k1_routes": k1_routes(seen),
           "max_memory_allocated_gib": peak / 2 ** 30}
    if load_node is not None:
        out["load_s"] = sum(load_ms) / 1e3
    print(f"[{phase} {label}] first execute (loads included"
          + (f", {load_node} {sum(load_ms) / 1e3:.1f} s" if load_node else "")
          + f") {warm_s:.2f} s; {timed} executes "
          f"{', '.join(f'{t_:.1f}' for t_ in times)} ms (median {med:.1f}); {timed_node} "
          f"{', '.join(f'{t_:.1f}' for t_ in node_ms)} ms; K1 an execute by (BH, Lq, Lk, d) "
          f"{dict(seen)} ({out['k1_routes']}); one profiled execute ({prof_ms:.1f} ms): kernels "
          f"{device_ms:.1f} ms (busy share {device_ms / med:.3f} of the median); "
          f"max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB | {card}", flush=True)
    return out, seen, ctx


@contextlib.contextmanager
def host_drawn_noise_aug():
    """noise_aug's draws made on the CPU from the generator's seed and sent
    to the tensor's device inside the block, so that a graph on the card
    and on the CPU augments with the same numbers."""
    import torch

    from stable_renderer_tpu_torch.models import noise_aug

    real_adm, real_q = noise_aug.unclip_adm, noise_aug.NoiseAugmentor.q_sample

    def adm(entries, augmentor, generator=None, noise_augment_merge=0.05, noise=None):
        if noise is None and generator is not None and entries:
            g = torch.Generator().manual_seed(generator.initial_seed())
            rows = sum(1 if e["embeds"].dim() == 1 else e["embeds"].shape[0] for e in entries)
            noise = [torch.randn((1, augmentor.timestep_dim), generator=g)
                     for _ in range(rows + (rows > 1))]
        return real_adm(entries, augmentor, generator, noise_augment_merge, noise)

    def q_sample(self, x, noise_level, generator=None, noise=None):
        if noise is None and generator is not None:
            noise = torch.randn(tuple(x.shape), generator=torch.Generator().manual_seed(
                generator.initial_seed()))
        return real_q(self, x, noise_level, generator, noise)

    noise_aug.unclip_adm, noise_aug.NoiseAugmentor.q_sample = adm, q_sample
    try:
        yield
    finally:
        noise_aug.unclip_adm, noise_aug.NoiseAugmentor.q_sample = real_adm, real_q


def image_conditioning_phase(dev, card: str, k1: dict, ckpt: str) -> dict:
    """Phase 26 (see the module docstring). ``ckpt`` is phase 20's SD1.5
    file; the phase's own files go to a temporary directory under build/,
    removed at the end."""
    import os
    from dataclasses import replace as dc_replace

    import torch

    from stable_renderer_tpu_torch.models.clip import SD2_CLIP_H_CONFIG
    from stable_renderer_tpu_torch.models.clip_vision import (
        VITH_CONFIG,
        VITL_CONFIG,
        CLIPVisionModel,
    )
    from stable_renderer_tpu_torch.models.t2i_adapter import StyleAdapterConfig
    from stable_renderer_tpu_torch.models.unet import SD15_UNET_CONFIG
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG
    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors
    from stable_renderer_tpu_torch.utils import paths
    from stable_renderer_tpu_torch.workflow import Workflow
    from stable_renderer_tpu_torch.workflow import executor as wex

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="image-", dir=root / "build"))
    out = {}
    t_phase = time.perf_counter()
    saved_output_dir = paths.OUTPUT_DIR
    paths.OUTPUT_DIR = tmp / "outputs"
    try:
        write_frame_png(tmp / "frame.png", SIZE, IMAGE_SEED)
        gen = torch.Generator(device=dev).manual_seed(IMAGE_SEED)

        # --- 26a. SD2.1-unclip-H at full width -------------------------------------------------
        ucfg = dc_replace(SD15_UNET_CONFIG, context_dim=1024, head_dim=64, adm_in_channels=2048)
        trees = family_trees("unclip", ucfg, None, SD2_CLIP_H_CONFIG, SD15_VAE_CONFIG, gen,
                             torch.bfloat16, dev, vision=VITH_CONFIG)
        flat = {p + k: v for p, t in trees.items() for k, v in flatten(t).items()}
        del trees
        t0 = time.perf_counter()
        size = write_safetensors(flat, tmp / "unclip_h.safetensors")
        write_s = time.perf_counter() - t0
        n_vision = sum(v.numel() for k, v in flat.items() if k.startswith("embedder."))
        del flat
        torch.cuda.empty_cache()
        print(f"[26 unclip] the SD2.1-unclip-H file: {size / 1e9:.2f} GB (bf16; ViT-H/14 "
              f"{n_vision / 1e6:.0f} M parameters at embedder.model.visual.) written in "
              f"{write_s:.1f} s | {card}", flush=True)
        wf_path = tmp / "unclip.json"
        wf_path.write_text(json.dumps(ui_workflow(unclip_rows("unclip_h.safetensors",
                                                              UNCLIP_SIZE))))
        ex = wex.PromptExecutor(Workflow.Load(wf_path), model_dirs=(str(tmp),), device=dev)
        out["unclip"], seen, ctx = image_graph_run("unclip", ex, (1,), UNCLIP_K1_SHAPES, card)
        model, _, vae, cv = ex._cache[1]
        img = ctx.final_output
        if (model.get("family"), model.get("noise_aug_dim"), cv["model"].config) != (
                "sd21-unclip", 1024, VITH_CONFIG) or model["params"]["time_embed"]["0"][
                "weight"].device.type != "cuda":
            fail(f"phase 26a: loaded family {model.get('family')}, noise_aug_dim "
                 f"{model.get('noise_aug_dim')}, vision {cv['model'].config}")
        if (tuple(img.shape) != (1, UNCLIP_SIZE, UNCLIP_SIZE, 3) or not torch.isfinite(img).all()
                or float(img.std()) < 1e-3):
            fail(f"phase 26a: image {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
        y = ctx.outputs[7][0]["unclip"]
        if len(y) != 2 or tuple(ctx.outputs[5][0]["image_embeds"].shape) != (1, 1024):
            fail(f"phase 26a: {len(y)} unCLIP entries, embeds "
                 f"{tuple(ctx.outputs[5][0]['image_embeds'].shape)}")
        out["unclip"].update(file_gb=size / 1e9, write_s=write_s)
        hold_new_k1_shapes(seen, 26, dev, card, k1)
        del ex, model, vae, cv, ctx
        torch.cuda.empty_cache()
        exec_out = tmp / "cli_out"
        (tmp / "color").mkdir()  # `execute` composes EngineData from one map directory at least
        shutil.copy(tmp / "frame.png", tmp / "color" / "0000.png")
        cmd = [sys.executable, "-m", "stable_renderer_tpu_torch", "execute", "--workflow",
               str(wf_path), "--color-dir", str(tmp / "color"), "--model-dir", str(tmp),
               "--out", str(exec_out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, SR_TPU_OUTPUT_DIR=str(tmp / "outputs")))
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0 or "1 frames -> " not in proc.stdout:
            fail(f"phase 26a CLI execute exited {proc.returncode}: {' '.join(cmd)}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        frames = _png_frames(exec_out)
        if len(frames) != 1 or frames[0].shape[:2] != (UNCLIP_SIZE, UNCLIP_SIZE):
            fail(f"phase 26a CLI execute wrote {[f.shape for f in frames]}")
        out["unclip"]["cli_execute_s"] = cli_s
        print(f"[26 unclip CLI] python -m stable_renderer_tpu_torch execute --workflow <unCLIP "
              f"graph> --model-dir <the file's dir>: exit 0 in {cli_s:.1f} s (process, imports "
              f"and the 3.9 GB load included); one {UNCLIP_SIZE}x{UNCLIP_SIZE} frame | {card}",
              flush=True)
        (tmp / "unclip_h.safetensors").unlink()

        # --- 26b. SD1.5 at 512x512, grounded and style-conditioned ----------------------------
        model_dirs = (str(tmp), str(Path(ckpt).parent))
        t0 = time.perf_counter()
        nbytes = write_safetensors(gligen_flat(SD15_UNET_CONFIG, 768, gen, torch.bfloat16, dev),
                                   tmp / "gligen.safetensors")
        nbytes += write_safetensors(style_flat(StyleAdapterConfig(  # ViT-L's width, 1024
            width=VITL_CONFIG.hidden_size, context_dim=768, num_head=8, n_layers=3, num_token=8),
            gen, torch.bfloat16, dev), tmp / "style.safetensors")
        nbytes += write_safetensors(flatten(CLIPVisionModel(VITL_CONFIG).init(
            gen, dtype=torch.bfloat16, device=dev)), tmp / "clip_vision_l.safetensors")
        print(f"[26 grounded files] GLIGEN (16 fusers, key width 768), the style adapter "
              f"(width 1024, 3 layers, 8 tokens, transformer_layes. keys) and ViT-L/14: "
              f"{nbytes / 1e9:.2f} GB bf16 in {time.perf_counter() - t0:.1f} s | {card}",
              flush=True)
        loaders = (1, 4, 7, 10)
        runs = {}
        for grounded in (True, False):
            wf = tmp / f"sd15_{'grounded' if grounded else 'plain'}.json"
            wf.write_text(json.dumps(ui_workflow(grounded_rows(Path(ckpt).name, grounded, SIZE))))
            ex = wex.PromptExecutor(Workflow.Load(wf), model_dirs=model_dirs, device=dev)
            if grounded:
                out["grounded"], seen, ctx = image_graph_run("grounded sd15", ex, loaders,
                                                             GLIGEN_K1_SHAPES, card)
                gl = ex._cache[4][0]
                n_fusers = len(transformer_blocks(SD15_UNET_CONFIG))
                if gl.fuser_heads != [8] * n_fusers or len(ctx.outputs[6][0]["gligen"][2]) != 2 or (
                        tuple(ctx.outputs[11][0]["context"].shape) != (1, 85, 768)):
                    fail(f"phase 26b: fuser heads {gl.fuser_heads}, context "
                         f"{tuple(ctx.outputs[11][0]['context'].shape)}")
                hold_new_k1_shapes(seen, 26, dev, card, k1)
                grounded_ex = ex
            else:
                ex._cache = {n: grounded_ex._cache[n] for n in (1, 7, 10)}  # the same loads
                ctx = ex.execute()
            runs[grounded] = ctx.outputs[15][0].float()
        for f in gl.fusers:  # tanh(0) = 0: the fusers add exact zeros
            f["alpha_attn"] = torch.zeros_like(f["alpha_attn"])
            f["alpha_dense"] = torch.zeros_like(f["alpha_dense"])
        grounded_ex._cache = {n: grounded_ex._cache[n] for n in loaders}
        zeroed = grounded_ex.execute().outputs[15][0].float()
        moved = float((runs[True] - runs[False]).abs().max())
        if not (same_bits(zeroed, runs[False]) and moved > GROUNDED_MOVED_FLOOR
                and torch.isfinite(runs[True]).all()):
            fail(f"phase 26b: zero gates equal to the ungrounded image bit for bit "
                 f"{same_bits(zeroed, runs[False])}; the file's gates moved it {moved:.3e} "
                 f"(floor {GROUNDED_MOVED_FLOOR})")
        out["grounded"].update(moved=moved, zero_gates_bit_equal=True)
        print(f"[26 grounded] the fusers' gates zeroed: the image equals the ungrounded one bit "
              f"for bit; the file's gates move it by {moved:.3e} (max abs, floor "
              f"{GROUNDED_MOVED_FLOOR}) | {card}", flush=True)
        del grounded_ex, ex, gl, ctx, runs, zeroed
        torch.cuda.empty_cache()

        # --- 26c. tiny graphs: the card against the CPU ---------------------------------------
        out["tiny_graphs"] = tiny_image_graphs(dev, card, tmp / "tiny")
    finally:
        paths.OUTPUT_DIR = saved_output_dir
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[26 image] phase 26 in {out['phase_s']:.1f} s | {card}", flush=True)
    return out


def photomaker_tree(cfg, proj2: int, generator) -> dict:
    """PhotoMaker's ID-encoder tree for a vision config (tests and phase
    26c): the tower, its second projection (``proj2`` wide) and the
    FuseModule over the two projections' width, drawn from ``generator``."""
    import torch

    from stable_renderer_tpu_torch.models.clip_vision import CLIPVisionModel

    embed = cfg.projection_dim + proj2

    def lin(i, o):
        return {"weight": torch.randn((o, i), generator=generator) * 0.02,
                "bias": torch.randn((o,), generator=generator) * 0.02}

    def norm(c):
        return {"weight": 1.0 + 0.1 * torch.randn((c,), generator=generator),
                "bias": 0.1 * torch.randn((c,), generator=generator)}

    def mlp(i, o, h):
        return {"layernorm": norm(i), "fc1": lin(i, h), "fc2": lin(h, o)}

    return {**CLIPVisionModel(cfg).init(generator),
            "visual_projection_2": {"weight": torch.randn((proj2, cfg.hidden_size),
                                                          generator=generator) * 0.02},
            "fuse_module": {"mlp1": mlp(embed * 2, embed, embed), "mlp2": mlp(embed, embed, embed),
                            "layer_norm": norm(embed)}}


def tiny_image_graphs(dev, card: str, d: Path) -> dict:
    """Phase 26c: tiny files written to ``d`` (f32) and the image-conditioned
    graphs over them on the CPU and on the card, the loaded UNets and VAEs
    widened to f32 after a first execute as loaded; the outputs within
    REF_TOL. The KSampler's noise comes from EngineData's noise maps and
    noise_aug draws on the host (host_drawn_noise_aug), so both devices take
    the same numbers. Returns {graph: max abs err}."""
    from dataclasses import replace

    import torch

    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.t2i_adapter import StyleAdapterConfig
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel
    from stable_renderer_tpu_torch.models.vae import TINY_VAE_CONFIG, VAE
    from stable_renderer_tpu_torch.models.weights import flatten, tree_to, write_safetensors
    from stable_renderer_tpu_torch.workflow import Workflow
    from stable_renderer_tpu_torch.workflow import executor as wex

    f32, s = torch.float32, IMAGE_GRAPH_SIZE
    d.mkdir()
    write_frame_png(d / "frame.png", s, IMAGE_SEED)
    for kind in ("unclip", "x4", "sd1", "sdxl"):
        write_family_file(kind, d / f"{kind}.safetensors", f32)
    g = torch.Generator().manual_seed(IMAGE_SEED)
    vitl = CLIPVisionConfig(**VITL_TINY_VISION)
    write_safetensors(gligen_flat(family_configs("sd1")[0], 768, g, f32), d / "gligen.safetensors")
    write_safetensors(style_flat(StyleAdapterConfig(width=32, context_dim=768, num_head=8,
                                                    n_layers=3, num_token=8), g, f32),
                      d / "style.safetensors")
    write_safetensors(flatten(CLIPVisionModel(vitl).init(g)), d / "clip_vision_l.safetensors")
    # projections 32 + 992 = the tiny SDXL CLIP-L's 1024: the fuse path
    write_safetensors({"id_encoder." + k: v for k, v in flatten(
        photomaker_tree(vitl, 1024 - vitl.projection_dim, g)).items()},
        d / "photomaker.safetensors")
    zcfg = replace(TINY_UNET_CONFIG, in_channels=8)
    zero123 = {"unet": UNetModel(zcfg), "params": UNetModel(zcfg).init(g),
               "sampling": ModelSampling(),
               "cc_projection": {"weight": torch.randn((zcfg.context_dim, 36), generator=g) * 0.1,
                                 "bias": torch.randn((zcfg.context_dim,), generator=g) * 0.1}}
    zvae = {"vae": VAE(TINY_VAE_CONFIG), "params": VAE(TINY_VAE_CONFIG).init(g)}
    noise3 = torch.randn((3, s // 2, s // 2, 4), generator=g)
    colors = torch.rand((3, s, s, 3), generator=g)

    def widened(outs, device):
        return tuple({**o, "params": tree_to(o["params"], device, f32)}
                     if isinstance(o, dict) and "params" in o else o for o in outs)

    latent = (20, 6)
    euler = ("euler", "normal", 2, 2.0)
    engine = [(20, "EngineData", [], {})]

    def zero123_rows(batched):
        cond = (["StableZero123_Conditioning_Batched", [s, s, 3, 10.0, 20.0, 5.0, 15.0]]
                if batched else ["StableZero123_Conditioning", [s, s, 1, 10.0, 30.0]])
        return [(1, "CheckpointLoaderSimple", ["zero123 (in the cache)"], {}),
                (7, "CLIPVisionLoader", ["clip_vision_l.safetensors"], {}),
                (8, "LoadImage", ["frame.png"], {}),
                (4, *cond, {"clip_vision": (7, 0), "init_image": (8, 0), "vae": (1, 2)}),
                *engine,
                (5, "KSampler", [IMAGE_SEED, "fixed", 2, 2.5, "euler", "normal", 1.0],
                 {"model": (1, 0), "positive": (4, 0), "negative": (4, 1),
                  "latent_image": latent}),
                (6, "VAEDecode", [], {"samples": (5, 0), "vae": (1, 2)})]

    x4_rows = [(1, "CheckpointLoaderSimple", ["x4.safetensors"], {}),
               (2, "CLIPTextEncode", ["a sharp photo"], {"clip": (1, 1)}),
               (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
               (8, "LoadImage", ["frame.png"], {}),
               (4, "SD_4XUpscale_Conditioning", [2.0, 0.2],
                {"images": (8, 0), "positive": (2, 0), "negative": (3, 0)}), *engine,
               (5, "KSampler", [IMAGE_SEED, "fixed", 2, 2.0, "euler", "normal", 1.0],
                {"model": (1, 0), "positive": (4, 0), "negative": (4, 1), "latent_image": latent}),
               (6, "VAEDecode", [], {"samples": (5, 0), "vae": (1, 2)})]
    photomaker_rows = [(1, "CheckpointLoaderSimple", ["sdxl.safetensors"], {}),
                       (2, "PhotoMakerLoader", ["photomaker.safetensors"], {}),
                       (8, "LoadImage", ["frame.png"], {}),
                       (3, "PhotoMakerEncode", ["photograph of a man photomaker, smiling"],
                        {"photomaker": (2, 0), "image": (8, 0), "clip": (1, 1)})]
    # (label, family loaders, rows, loader ids, frames, the output compared)
    graphs = [
        ("zero123", "sd1", zero123_rows(False), (1, 7), 1, (6, None)),
        ("zero123_batched", "sd1", zero123_rows(True), (1, 7), 3, (6, None)),
        ("photomaker_sdxl", "sdxl", photomaker_rows, (1, 2), 1, (3, "context")),
        ("x4_noise_aug_0.2", "x4", x4_rows, (1,), 1, (6, None)),
        ("unclip_3_entries", "unclip",
         unclip_rows("unclip.safetensors", s, 3, euler, latent, save=False) + engine, (1,), 1,
         (12, None)),
        ("style", "sd1", grounded_rows("sd1.safetensors", False, s, euler, latent) + engine,
         (1, 7, 10), 1, (15, None)),
        ("gligen_cfg", "sd1", grounded_rows("sd1.safetensors", True, s, euler, latent) + engine,
         (1, 4, 7, 10), 1, (15, None)),
        ("gligen_cond_list", "sd1",
         grounded_rows("sd1.safetensors", True, s, euler, latent, area=0.7) + engine,
         (1, 4, 7, 10), 1, (15, None)),
    ]
    errs = {}
    for label, kind, rows, loaders, frames, (nid, key) in graphs:
        wf_path = d / f"{label}.json"
        wf_path.write_text(json.dumps(ui_workflow(rows)))
        finals = []
        with tiny_family_loaders(kind), host_drawn_noise_aug():
            for device in (torch.device("cpu"), dev):
                ex = wex.PromptExecutor(Workflow.Load(wf_path), model_dirs=(str(d),),
                                        device=device)
                if label.startswith("zero123"):  # the model in the loader's cache slot
                    ex._cache[1] = (tree_to_model(zero123, device), None,
                                    tree_to_model(zvae, device))
                ed = EngineData(frame_indices=torch.arange(frames),
                                color_maps=colors[:frames].to(device),
                                noise_maps=noise3[:frames].to(device),
                                id_maps=torch.zeros((frames, s, s, 4), dtype=torch.int32,
                                                    device=device))

                def result(ctx):
                    o = ctx.outputs[nid][0]
                    return (o[key] if key else o).float()

                first = result(ex.execute(engine_data=ed))
                if not torch.isfinite(first).all():
                    fail(f"phase 26c {label} on {device}: non-finite output as loaded")
                ex._cache = {n: widened(ex._cache[n], device) for n in loaders}
                finals.append(result(ex.execute(engine_data=ed)).cpu())
        err = float((finals[1] - finals[0]).abs().max())
        if not (torch.isfinite(finals[1]).all() and err < REF_TOL
                and float(finals[1].std()) > 1e-3):
            fail(f"phase 26c {label}: card against CPU max abs err {err:.3e} (tol {REF_TOL})")
        errs[label] = err
        print(f"[26 tiny] {label}: {len(rows)} nodes at {s}x{s}, the loaded models widened to "
              f"f32: card against CPU max abs err {err:.3e} (tol {REF_TOL}) | {card}",
              flush=True)
    return errs


# phase 27: video and Stable Cascade
SVD_WIDTH, SVD_HEIGHT, SVD_FRAMES = 1024, 576, 14  # SVD img2vid's published frames
SVD_INIT_SIZE = 512   # the init image, resized by the conditioning to 576x1024
VIDEO_SEED = 27
VIDEO_TIMED = 1       # phase 27's timed executes a graph, after one warm
CASCADE_SIZE = 1024   # Stable Cascade's published resolution
# K1 launches an execute by (BH, Lq, Lk, d). SVD at 576x1024 (72x128
# latents), CFG's batch of 28 rows (two groups of 14 frames): level 0's 5
# spatial self-attentions an evaluation at 5 heads of 64 over 9216 tokens,
# level 1's 5 at 10 heads over 2304 tokens, 4 evaluations (level 2's 576
# tokens, the temporal attention over 14 frames and the 1-key
# cross-attention stay plain); the bf16 VAE's mid-block attention at 9216
# tokens in the init image's encode and the 14 frames' decode. Stable
# Cascade at 1024x1024 attends over at most 1024 + 308 keys: no K1
SVD_K1_SHAPES = {(140, 9216, 9216, 64): 20, (280, 2304, 2304, 64): 20,
                 (1, 9216, 9216, 512): 1, (14, 9216, 9216, 512): 1}
VIDEO_GRAPH_SIZE = (24, 32)  # phase 27c's tiny frames (height, width): 12x16 latents


def video_flat(kind: str, ucfg, vision, vae_cfg, generator, dtype, device=None,
               projection: bool = True) -> dict:
    """A video checkpoint's flat state dict, drawn from ``generator`` in
    ``dtype``: kind "svd" SVD's temporal UNet (VideoUNetModel(ucfg)) at
    model.diffusion_model., the VAE at first_stage_model. and the ``vision``
    tower's transformers-layout ``vision_model`` subtree at
    conditioner.embedders.0.open_clip.model.visual. (the JAX loader's
    layout), its visual_projection there too when ``projection``; kind
    "zero123" an image-conditioned stills UNet (UNetModel(ucfg)) with its
    cc_projection (context_dim x (projection_dim + 4)) and the tower at
    cond_stage_model.model.visual."""
    import torch

    from stable_renderer_tpu_torch.models.clip_vision import CLIPVisionModel
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.vae import VAE
    from stable_renderer_tpu_torch.models.video_unet import VideoUNetModel
    from stable_renderer_tpu_torch.models.weights import flatten

    kw = dict(dtype=dtype, device=device)
    unet = (VideoUNetModel if kind == "svd" else UNetModel)(ucfg).init(generator, **kw)
    flat = {"model.diffusion_model." + k: v for k, v in flatten(unet).items()}
    del unet
    flat.update({"first_stage_model." + k: v
                 for k, v in flatten(VAE(vae_cfg).init(generator, **kw)).items()})
    tower = CLIPVisionModel(vision).init(generator, **kw)
    inner = dict(tower["vision_model"])
    if projection:
        inner["visual_projection"] = tower["visual_projection"]
    prefix = ("conditioner.embedders.0.open_clip.model.visual." if kind == "svd"
              else "cond_stage_model.model.visual.")
    flat.update({prefix + k: v for k, v in flatten(inner).items()})
    if kind == "zero123":
        fan_in = vision.projection_dim + 4
        flat["cc_projection.weight"] = (torch.randn((ucfg.context_dim, fan_in), generator=generator,
                                                    device=device) / fan_in ** 0.5).to(dtype)
        flat["cc_projection.bias"] = (0.1 * torch.randn((ucfg.context_dim,), generator=generator,
                                                        device=device)).to(dtype)
    return flat


def cascade_flat(stage: str, cfg, generator, dtype, device=None) -> dict:
    """A Stable Cascade stage file's flat state dict (the bare layout),
    Stage C or B of ``cfg``, drawn from ``generator`` in ``dtype``."""
    from stable_renderer_tpu_torch.models.cascade import CascadeStageB, CascadeStageC
    from stable_renderer_tpu_torch.models.weights import flatten

    model = (CascadeStageC if stage == "c" else CascadeStageB)(cfg)
    return flatten(model.init(generator, dtype=dtype, device=device))


@contextlib.contextmanager
def tiny_video_loaders():
    """The video and Cascade loaders' configs, which they read by module
    name at call time, set to the tiny ones inside the block: SVD's UNet
    preset (detection keeps the preset's layout), ViT-H (the tiny tower,
    projection 32 = the tiny video UNet's context), SD1.5's VAE and the two
    Cascade stages."""
    from stable_renderer_tpu_torch.models import cascade
    from stable_renderer_tpu_torch.models import clip_vision as vision_mod
    from stable_renderer_tpu_torch.models import vae as vae_mod
    from stable_renderer_tpu_torch.models import video_unet

    names = [(video_unet, "SVD_UNET_CONFIG", video_unet.TINY_VIDEO_UNET_CONFIG),
             (vision_mod, "VITH_CONFIG", vision_mod.TINY_VISION_CONFIG),
             (vae_mod, "SD15_VAE_CONFIG", vae_mod.TINY_VAE_CONFIG),
             (cascade, "STAGE_C_CONFIG", cascade.TINY_CASCADE_C_CONFIG),
             (cascade, "STAGE_B_CONFIG", cascade.TINY_CASCADE_B_CONFIG)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in names]
    for mod, name, value in names:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def svd_rows(name: str, width: int, height: int, frames: int, steps: int = 4,
             cfg: float = 2.5, init="frame.png", latent=None) -> list:
    """ImageOnlyCheckpointLoader -> LoadImage of ``init`` (or a (node, slot)
    link) -> SVD_img2vid_Conditioning (``frames`` frames at width x height,
    motion 127, fps 6, augmentation 0) -> VideoLinearCFGGuidance(1.0) ->
    KSampler (euler, karras, ``steps`` steps, ``cfg``; on the conditioning's
    empty latent, or ``latent``, a (node, slot) link) -> VAEDecode ->
    InferenceOutput."""
    rows = [(1, "ImageOnlyCheckpointLoader", [name], {})]
    if isinstance(init, str):
        rows.append((2, "LoadImage", [init], {}))
        init = (2, 0)
    return rows + [
        (3, "SVD_img2vid_Conditioning", [width, height, frames, 127, 6, 0.0],
         {"clip_vision": (1, 1), "init_image": init, "vae": (1, 2)}),
        (4, "VideoLinearCFGGuidance", [1.0], {"model": (1, 0)}),
        (5, "KSampler", [VIDEO_SEED, "fixed", steps, cfg, "euler", "karras", 1.0],
         {"model": (4, 0), "positive": (3, 0), "negative": (3, 1),
          "latent_image": latent or (3, 2)}),
        (6, "VAEDecode", [], {"samples": (5, 0), "vae": (1, 2)}),
        (8, "InferenceOutput", [], {"images": (6, 0)})]


def cascade_rows(size: int, compression: int, cond, uncond, steps=(4, 2),
                 cfgs=(4.0, 1.1)) -> list:
    """CascadeStageLoader of stage_c.safetensors and stage_b.safetensors ->
    StableCascade_EmptyLatentImage(size, size, compression, 1) -> KSampler
    on Stage C (euler, simple, ``steps[0]`` steps, cfg ``cfgs[0]``) over the
    ``cond`` / ``uncond`` conditionings ((node, slot) links) ->
    StableCascade_StageB_Conditioning -> KSampler on Stage B (``steps[1]``
    steps, cfg ``cfgs[1]``) over Stage B's empty latent."""
    return [
        (11, "CascadeStageLoader", ["stage_c.safetensors"], {}),
        (12, "CascadeStageLoader", ["stage_b.safetensors"], {}),
        (13, "StableCascade_EmptyLatentImage", [size, size, compression, 1], {}),
        (14, "KSampler", [VIDEO_SEED, "fixed", steps[0], cfgs[0], "euler", "simple", 1.0],
         {"model": (11, 0), "positive": cond, "negative": uncond, "latent_image": (13, 0)}),
        (15, "StableCascade_StageB_Conditioning", [], {"conditioning": cond, "stage_c": (14, 0)}),
        (16, "KSampler", [VIDEO_SEED + 1, "fixed", steps[1], cfgs[1], "euler", "simple", 1.0],
         {"model": (12, 0), "positive": (15, 0), "negative": uncond, "latent_image": (13, 1)})]


VIDEO_DISK_BYTES = 12e9  # phase 27's largest moment on disk: both Cascade stage files
# sha256 of the float32 sigma tables that the JAX package's ModelSamplingEDM
# and ModelSamplingCascade build (tests/test_torch_video_unet.py and
# tests/test_torch_cascade.py hold these digests to the JAX tables); phase
# 27d holds the port's tables, built with the card machine's numpy, to them
SCHEDULE_DIGESTS = {
    "edm 0.002-700": "11ddde6c5c741a3b212787c973c9bee92701c3641623c80f7ed8ce157e75691c",
    "edm 0.002-120": "55ec36b149bbba4489bc331473009406d2789b702f8c48531081fe306e582eb0",
    "cascade shift 1": "417a90c3b0be1e9ea219019c05e187dd4f292c1a11a719b0fd292093c2504338",
    "cascade shift 2": "0481678a7aa6ae3140ac6979d407261898557c3569898e6785b65f3b20955766",
}


def schedule_tables(schedules) -> dict:
    """{name: the float32 sigma table} of SCHEDULE_DIGESTS' four schedules
    from the ``schedules`` module (either package's)."""
    return {"edm 0.002-700": schedules.ModelSamplingEDM(prediction="v").sigmas,
            "edm 0.002-120": schedules.ModelSamplingEDM(prediction="v",
                                                        edm_sigma_max=120.0).sigmas,
            "cascade shift 1": schedules.ModelSamplingCascade(shift=1.0).sigmas,
            "cascade shift 2": schedules.ModelSamplingCascade(shift=2.0).sigmas}


def table_digest(table) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(table, np.float32).tobytes()).hexdigest()


def video_cascade_phase(dev, card: str, k1: dict) -> dict:
    """Phase 27 (see the module docstring). Its files go to a temporary
    directory under build/, each removed once loaded, the directory at the
    end."""
    import os

    import torch

    from stable_renderer_tpu_torch.models import cascade
    from stable_renderer_tpu_torch.models.clip import (
        SD15_CLIP_CONFIG,
        SDXL_CLIP_G_CONFIG,
        CLIPTextModel,
        OpenCLIPTextModel,
        Tokenizer,
    )
    from stable_renderer_tpu_torch.models.clip_vision import VITH_CONFIG
    from stable_renderer_tpu_torch.models.sampling import schedules
    from stable_renderer_tpu_torch.models.vae import SD15_VAE_CONFIG
    from stable_renderer_tpu_torch.models.video_unet import SVD_UNET_CONFIG, VideoUNetModel
    from stable_renderer_tpu_torch.models.weights import write_safetensors
    from stable_renderer_tpu_torch.utils import paths
    from stable_renderer_tpu_torch.workflow import Workflow
    from stable_renderer_tpu_torch.workflow import executor as wex

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="video-", dir=root / "build"))
    out = {}
    t_phase = time.perf_counter()
    saved_output_dir = paths.OUTPUT_DIR
    paths.OUTPUT_DIR = tmp / "outputs"
    try:
        free = shutil.disk_usage(tmp).free
        if free < VIDEO_DISK_BYTES:
            fail(f"phase 27: {free / 1e9:.1f} GB free under build/, want "
                 f"{VIDEO_DISK_BYTES / 1e9:.0f} GB for the stage files")
        write_frame_png(tmp / "frame.png", SVD_INIT_SIZE, VIDEO_SEED)
        gen = torch.Generator(device=dev).manual_seed(VIDEO_SEED)

        # --- 27a. SVD img2vid at its published widths --------------------------------------
        flat = video_flat("svd", SVD_UNET_CONFIG, VITH_CONFIG, SD15_VAE_CONFIG, gen,
                          torch.bfloat16, dev)
        n_unet = sum(v.numel() for k, v in flat.items() if k.startswith("model."))
        t0 = time.perf_counter()
        size = write_safetensors(flat, tmp / "svd.safetensors")
        write_s = time.perf_counter() - t0
        del flat
        torch.cuda.empty_cache()
        print(f"[27 svd] the SVD file: {size / 1e9:.2f} GB (bf16: the temporal UNet "
              f"{n_unet / 1e9:.2f} B parameters, ViT-H/14 at "
              f"conditioner.embedders.0.open_clip.model.visual., the SD VAE) written in "
              f"{write_s:.1f} s; {free / 1e9:.0f} GB were free | {card}", flush=True)
        wf_path = tmp / "svd.json"
        wf_path.write_text(json.dumps(ui_workflow(svd_rows("svd.safetensors", SVD_WIDTH,
                                                           SVD_HEIGHT, SVD_FRAMES))))
        ex = wex.PromptExecutor(Workflow.Load(wf_path), model_dirs=(str(tmp),), device=dev)
        out["svd"], seen, ctx = image_graph_run(
            "svd", ex, (1,), SVD_K1_SHAPES, card, phase=27, timed=VIDEO_TIMED,
            timed_node="SVD_img2vid_Conditioning", load_node="ImageOnlyCheckpointLoader")
        model, cv, vae = ex._cache[1]
        if not (isinstance(model["unet"], VideoUNetModel)
                and model["unet"].config == SVD_UNET_CONFIG
                and type(model["sampling"]).__name__ == "ModelSamplingEDM"
                and model["sampling"].prediction == "v" and cv["model"].config == VITH_CONFIG
                and model["params"]["time_embed"]["0"]["weight"].device.type == "cuda"):
            fail(f"phase 27a: loaded {type(model['unet']).__name__} {model['unet'].config}, "
                 f"sampling {type(model['sampling']).__name__}, vision {cv['model'].config}")
        frames = ctx.final_output
        pos = ctx.outputs[3][0]
        if (tuple(frames.shape) != (SVD_FRAMES, SVD_HEIGHT, SVD_WIDTH, 3)
                or not torch.isfinite(frames).all() or float(frames.std()) < 1e-3
                or float((frames[0] - frames[-1]).abs().max()) < 1e-3):
            fail(f"phase 27a: frames {tuple(frames.shape)}, finite "
                 f"{bool(torch.isfinite(frames).all())}, std {float(frames.std()):.3e}")
        if (tuple(pos["context"].shape) != (1, 1, 1024)
                or tuple(pos["concat_latent_image"].shape) != (1, SVD_HEIGHT // 8,
                                                               SVD_WIDTH // 8, 4)
                or tuple(pos["y"].shape) != (1, 768)):
            fail(f"phase 27a: conditioning context {tuple(pos['context'].shape)}, c_concat "
                 f"{tuple(pos['concat_latent_image'].shape)}, y {tuple(pos['y'].shape)}")
        out["svd"].update(file_gb=size / 1e9, write_s=write_s,
                          frames=list(frames.shape))
        hold_new_k1_shapes(seen, 27, dev, card, k1)
        del ex, model, cv, vae, ctx, frames, pos
        torch.cuda.empty_cache()
        exec_out = tmp / "cli_out"
        (tmp / "color").mkdir()  # `execute` composes EngineData from one map directory at least
        shutil.copy(tmp / "frame.png", tmp / "color" / "0000.png")
        cmd = [sys.executable, "-m", "stable_renderer_tpu_torch", "execute", "--workflow",
               str(wf_path), "--color-dir", str(tmp / "color"), "--model-dir", str(tmp),
               "--out", str(exec_out)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, SR_TPU_OUTPUT_DIR=str(tmp / "outputs")))
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0 or f"{SVD_FRAMES} frames -> " not in proc.stdout:
            fail(f"phase 27a CLI execute exited {proc.returncode}: {' '.join(cmd)}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        pngs = _png_frames(exec_out)
        if len(pngs) != SVD_FRAMES or pngs[0].shape[:2] != (SVD_HEIGHT, SVD_WIDTH):
            fail(f"phase 27a CLI execute wrote {[f.shape for f in pngs]}")
        out["svd"]["cli_execute_s"] = cli_s
        print(f"[27 svd CLI] python -m stable_renderer_tpu_torch execute --workflow <SVD graph> "
              f"--model-dir <the file's dir>: exit 0 in {cli_s:.1f} s (process, imports and the "
              f"{size / 1e9:.1f} GB load included); {SVD_FRAMES} frames of {SVD_WIDTH}x"
              f"{SVD_HEIGHT} | {card}", flush=True)
        (tmp / "svd.safetensors").unlink()

        # --- 27b. Stable Cascade C -> B at its published widths ----------------------------
        sizes, t0 = {}, time.perf_counter()
        for stage, cfg in (("c", cascade.STAGE_C_CONFIG), ("b", cascade.STAGE_B_CONFIG)):
            flat = cascade_flat(stage, cfg, gen, torch.bfloat16, dev)
            sizes[stage] = write_safetensors(flat, tmp / f"stage_{stage}.safetensors")
            del flat
            torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        print(f"[27 cascade] Stage C {sizes['c'] / 1e9:.2f} GB and Stage B "
              f"{sizes['b'] / 1e9:.2f} GB (bf16) written in {write_s:.1f} s | {card}",
              flush=True)
        # the CLIP-G context: a G-only CLIP (as a refiner file's CheckpointLoaderSimple
        # gives it) of the full-width OpenCLIP-G, in the loader node's cache slot
        clip_g = OpenCLIPTextModel(SDXL_CLIP_G_CONFIG)
        clip = {"clip": CLIPTextModel(SD15_CLIP_CONFIG), "params": {}, "clip_g": clip_g,
                "params_g": clip_g.init(gen, device=dev), "tokenizer": Tokenizer(SD15_CLIP_CONFIG),
                "g_only": True}
        rows = [(1, "CheckpointLoaderSimple", ["clip_g (in the cache)"], {}),
                (2, "CLIPTextEncode", ["a castle on a hill at dawn, highly detailed"],
                 {"clip": (1, 1)}),
                (3, "CLIPTextEncode", ["blurry, lowres"], {"clip": (1, 1)}),
                *cascade_rows(CASCADE_SIZE, 42, (2, 0), (3, 0))]
        wf_path = tmp / "cascade.json"
        wf_path.write_text(json.dumps(ui_workflow(rows)))
        ex = wex.PromptExecutor(Workflow.Load(wf_path), model_dirs=(str(tmp),), device=dev)
        ex._cache[1] = (None, clip, None)
        out["cascade"], seen, ctx = image_graph_run(
            "cascade", ex, (1, 11, 12), {}, card, phase=27, timed=VIDEO_TIMED,
            timed_node="KSampler", load_node="CascadeStageLoader")
        for stage in ("c", "b"):  # loaded (the loaders' outputs stay in the cache)
            (tmp / f"stage_{stage}.safetensors").unlink()
        (mc,), (mb,) = ex._cache[11], ex._cache[12]
        c_lat, b_lat = ctx.outputs[14][0]["samples"], ctx.outputs[16][0]["samples"]
        if (type(mc["unet"]).__name__, mc["unet"].config, mc["sampling"].shift,
                type(mb["unet"]).__name__, mb["unet"].config, mb["sampling"].shift) != (
                "CascadeStageC", cascade.STAGE_C_CONFIG, 2.0, "CascadeStageB",
                cascade.STAGE_B_CONFIG, 1.0):
            fail(f"phase 27b: loaded {type(mc['unet']).__name__} and "
                 f"{type(mb['unet']).__name__}")
        ctx_c = ctx.outputs[2][0]["context"]
        side = CASCADE_SIZE // 42
        if (tuple(ctx_c.shape) != (1, 77, 1280) or tuple(c_lat.shape) != (1, side, side, 16)
                or tuple(b_lat.shape) != (1, CASCADE_SIZE // 4, CASCADE_SIZE // 4, 4)
                or not torch.isfinite(b_lat).all() or float(b_lat.std()) < 1e-3):
            fail(f"phase 27b: context {tuple(ctx_c.shape)}, Stage C latent "
                 f"{tuple(c_lat.shape)}, Stage B latent {tuple(b_lat.shape)}, finite "
                 f"{bool(torch.isfinite(b_lat).all())}")
        out["cascade"].update(stage_c_gb=sizes["c"] / 1e9, stage_b_gb=sizes["b"] / 1e9,
                              write_s=write_s, stage_b_latent=list(b_lat.shape))
        del ex, mc, mb, ctx, c_lat, b_lat, clip, clip_g
        torch.cuda.empty_cache()

        # --- 27c. tiny graphs: the card against the CPU ------------------------------------
        out["tiny_graphs"] = tiny_video_graphs(dev, card, tmp / "tiny")

        # --- 27d. the EDM and Cascade sigma tables against the JAX package's ---------------
        for name, table in schedule_tables(schedules).items():
            if table_digest(table) != SCHEDULE_DIGESTS[name]:
                fail(f"phase 27d: the {name} sigma table's digest {table_digest(table)} is "
                     f"not the JAX package's {SCHEDULE_DIGESTS[name]}")
        print(f"[27 schedules] {', '.join(SCHEDULE_DIGESTS)}: the port's float32 sigma tables "
              f"built here equal the JAX package's bit for bit (sha256) | {card}", flush=True)
    finally:
        paths.OUTPUT_DIR = saved_output_dir
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[27 video] phase 27 in {out['phase_s']:.1f} s | {card}", flush=True)
    return out


def tiny_video_graphs(dev, card: str, d: Path) -> dict:
    """Phase 27c: tiny SVD, Zero123 and Stable Cascade stage files (f32)
    written to ``d``, read through tiny_video_loaders, and the video graph,
    the Zero123 stills graph and Cascade C -> B on the CPU and on the card,
    the loaded models widened to f32 after a first execute as loaded; the
    outputs within REF_TOL (Cascade's Stage B latent in units of its
    schedule's largest sigma). The KSamplers' noise comes from EngineData's
    noise maps or from latents drawn on the host, and the Cascade contexts
    are host draws in the text encodes' cache slots, so both devices take
    the same numbers. Returns {graph: max abs err}."""
    from dataclasses import replace

    import torch

    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.models import cascade
    from stable_renderer_tpu_torch.models.clip_vision import TINY_VISION_CONFIG
    from stable_renderer_tpu_torch.models.sampling.schedules import ModelSamplingCascade
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG
    from stable_renderer_tpu_torch.models.vae import TINY_VAE_CONFIG
    from stable_renderer_tpu_torch.models.video_unet import TINY_VIDEO_UNET_CONFIG
    from stable_renderer_tpu_torch.models.weights import tree_to, write_safetensors
    from stable_renderer_tpu_torch.workflow import Workflow
    from stable_renderer_tpu_torch.workflow import executor as wex

    f32 = torch.float32
    h, w = VIDEO_GRAPH_SIZE
    frames = 3
    d.mkdir()
    write_frame_png(d / "frame.png", 32, VIDEO_SEED)
    g = torch.Generator().manual_seed(VIDEO_SEED)
    zcfg = replace(TINY_UNET_CONFIG, in_channels=8, num_heads=8, context_dim=768)
    for kind, ucfg in (("svd", TINY_VIDEO_UNET_CONFIG), ("zero123", zcfg)):
        write_safetensors(video_flat(kind, ucfg, TINY_VISION_CONFIG, TINY_VAE_CONFIG, g, f32),
                          d / f"{kind}.safetensors")
    for stage, cfg in (("c", cascade.TINY_CASCADE_C_CONFIG), ("b", cascade.TINY_CASCADE_B_CONFIG)):
        write_safetensors(cascade_flat(stage, cfg, g, f32), d / f"stage_{stage}.safetensors")
    noise = torch.randn((frames, h // 2, w // 2, 4), generator=g)
    colors = torch.rand((frames, h, w, 3), generator=g)
    conds = [{"context": torch.randn((1, 5, 48), generator=g), "controls": [], "prompt": p}
             for p in ("a castle", "")]
    latents = ({"samples": torch.zeros((1, 4, 4, 16)), "noise": torch.randn((1, 4, 4, 16),
                                                                            generator=g)},
               {"samples": torch.zeros((1, 64, 64, 4)), "noise": torch.randn((1, 64, 64, 4),
                                                                             generator=g)})
    engine = [(20, "EngineData", [], {})]
    zero123_rows = [(1, "ImageOnlyCheckpointLoader", ["zero123.safetensors"], {}),
                    (2, "LoadImage", ["frame.png"], {}),
                    (3, "StableZero123_Conditioning", [w, h, frames, 10.0, 30.0],
                     {"clip_vision": (1, 1), "init_image": (2, 0), "vae": (1, 2)}),
                    (5, "KSampler", [VIDEO_SEED, "fixed", 2, 2.5, "euler", "normal", 1.0],
                     {"model": (1, 0), "positive": (3, 0), "negative": (3, 1),
                      "latent_image": (20, 6)}),
                    (6, "VAEDecode", [], {"samples": (5, 0), "vae": (1, 2)}), *engine]
    cascade_graph = [(1, "CheckpointLoaderSimple", ["clip (in the cache)"], {}),
                     (2, "CLIPTextEncode", ["a castle"], {"clip": (1, 1)}),
                     (3, "CLIPTextEncode", [""], {"clip": (1, 1)}),
                     *cascade_rows(256, 64, (2, 0), (3, 0), steps=(2, 2), cfgs=(2.0, 1.1))]
    sigma_max = float(ModelSamplingCascade(shift=2.0).sigma_max)
    # (label, rows, loader ids, the output compared, its scale)
    graphs = [("svd", svd_rows("svd.safetensors", w, h, frames, steps=2, latent=(20, 6))
               + engine, (1,), (6, None), 1.0),
              ("zero123", zero123_rows, (1,), (6, None), 1.0),
              ("cascade_c_to_b", cascade_graph, (11, 12), (16, "samples"), sigma_max)]

    def widened(outs, device):
        return tuple({**o, "params": tree_to(o["params"], device, f32)}
                     if isinstance(o, dict) and "params" in o else o for o in outs)

    errs = {}
    for label, rows, loaders, (nid, key), scale in graphs:
        wf_path = d / f"{label}.json"
        wf_path.write_text(json.dumps(ui_workflow(rows)))
        finals = []
        with tiny_video_loaders():
            for device in (torch.device("cpu"), dev):
                ex = wex.PromptExecutor(Workflow.Load(wf_path), model_dirs=(str(d),),
                                        device=device)
                given = {}
                if label.startswith("cascade"):  # host draws in the cache slots
                    given = {1: (None, None, None)}
                    given.update({n: ({**c, "context": c["context"].to(device)},)
                                  for n, c in zip((2, 3), conds)})
                    given[13] = tuple(tree_to(lat, device) for lat in latents)
                ex._cache.update(given)
                ed = EngineData(frame_indices=torch.arange(frames), color_maps=colors.to(device),
                                noise_maps=noise.to(device),
                                id_maps=torch.zeros((frames, h, w, 4), dtype=torch.int32,
                                                    device=device))

                def result(ctx):
                    o = ctx.outputs[nid][0]
                    return (o[key] if key else o).float() / scale

                first = result(ex.execute(engine_data=ed))
                if not torch.isfinite(first).all():
                    fail(f"phase 27c {label} on {device}: non-finite output as loaded")
                ex._cache = {**given, **{n: widened(ex._cache[n], device) for n in loaders}}
                finals.append(result(ex.execute(engine_data=ed)).cpu())
        err = float((finals[1] - finals[0]).abs().max())
        if not (torch.isfinite(finals[1]).all() and err < REF_TOL
                and float(finals[1].std()) > 1e-3):
            fail(f"phase 27c {label}: card against CPU max abs err {err:.3e} (tol {REF_TOL})")
        errs[label] = err
        print(f"[27 tiny] {label}: {len(rows)} nodes, the loaded models widened to f32: card "
              f"against CPU max abs err {err:.3e} (tol {REF_TOL}"
              + (f", in units of sigma_max {scale:.2f}" if scale != 1.0 else "")
              + f") | {card}", flush=True)
    return errs


def tree_to_model(model: dict, device) -> dict:
    """A model dict with its tensors (params, cc_projection) on ``device``."""
    from stable_renderer_tpu_torch.models.weights import tree_to

    return {k: tree_to(v, device) if k in ("params", "cc_projection") else v
            for k, v in model.items()}


PLAIN_LOGIT_BYTES = 8e9  # hold_new_k1_shapes: the plain version's f32 logits at most a slice


def hold_new_k1_shapes(launched, phase: int, dev, card: str, k1: dict) -> list:
    """Each K1 shape of ``launched`` (k1_shape_tally's Counter) that no
    phase held yet, against flash_attention_reference at K1's bar, timed
    beside SDPA (seeded with ``phase``); its row joins ``k1["shapes"]``.
    Returns the rows."""
    import torch
    import torch.nn.functional as F

    from stable_renderer_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(phase)
    rows = []
    for key in sorted(set(launched) - HELD_K1, key=str):
        bh, lq, lk, d = key[:4]
        f32 = len(key) == 5
        dt = torch.float32 if f32 else torch.bfloat16
        q, k_, v = (torch.randn((bh, n, d), generator=gen, device=dev).to(dt)
                    for n in (lq, lk, lk))
        row = {"shape": f"bh={bh} lq={lq} lk={lk} d={d} {str(dt).replace('torch.', '')} "
                        f"(phase {phase})", "route": k1_route(d, f32),
               f"launches_in_phase_{phase}": launched[key]}
        # the plain version a BH slice at a time where its f32 logits would
        # pass PLAIN_LOGIT_BYTES (SVD's 140 heads at 9216^2: 47.6 GB, twice
        # that with the softmax)
        step = max(1, int(PLAIN_LOGIT_BYTES // (lq * lk * 4)))
        if step < bh:
            row["plain_bh_slices"] = -(-bh // step)

        def plain(step=step):
            return torch.cat([flash_attention_reference(q[i:i + step], k_[i:i + step],
                                                        v[i:i + step])
                              for i in range(0, bh, step)])

        _k1_case(row, dt, K1_F32_TOL if f32 else K1_BF16_TOL,
                 lambda: flash_attention(q, k_, v),
                 plain,
                 lambda: F.scaled_dot_product_attention(q[None], k_[None], v[None]),
                 k1_bound(bh, lq, lk, d, f32), timed=True)
        HELD_K1.add(key)
        k1["shapes"].append(row)
        rows.append(row)
        print(f"[{phase} K1] {row} | {card}", flush=True)
        del q, k_, v
    return rows


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


# --- phase 28: the restoration and upscale zoo --------------------------------------

ZOO_SEED = 28
ZOO_TIMED = 3       # phase 28's timed executes a graph, after one warm
ZOO_TOL = 2e-4      # (d): a tiny f32 file on the card against the CPU plain run (the tests' TOL)
ZOO_MARGIN = 1e-4   # (d): a code index compared where its best code leads by this much
ZOO_TINY_SIZE = 32  # (d)'s inputs, except CodeFormer's (its detected published widths: 512)


def zoo_rows(model_name: str) -> list:
    """LoadImage -> UpscaleModelLoader -> ImageUpscaleWithModel -> SaveImage."""
    return [(1, "LoadImage", ["frame.png"], {}), (2, "UpscaleModelLoader", [model_name], {}),
            (3, "ImageUpscaleWithModel", [], {"upscale_model": (2, 0), "image": (1, 0)}),
            (4, "SaveImage", ["zoo"], {"images": (3, 0)})]


def write_zoo_file(path, tree: dict, nest_key=None) -> int:
    """A zoo model's tree as a torch file (``{nest_key: state_dict}`` when
    given, as published BasicSR-style files nest it); returns its bytes."""
    import torch

    from stable_renderer_tpu_torch.models.weights import flatten

    flat = {k: v.detach().cpu().contiguous() for k, v in flatten(tree).items()}
    torch.save({nest_key: flat} if nest_key else flat, str(path))
    return Path(path).stat().st_size


def rrdb_basicsr_scaled(tree: dict) -> dict:
    """An RRDBNet init's conv weights rescaled to BasicSR's init: fan-in
    (Kaiming) normal, times 0.1 inside the RRDBs (default_init_weights)."""
    from stable_renderer_tpu_torch.models.weights import flatten, nest

    out = {}
    for k, v in flatten(tree).items():
        if v.dim() == 4:
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            v = v * ((2.0 / fan_in) ** 0.5 / 0.02 * (0.1 if k.startswith("body.") else 1.0))
        out[k] = v
    return nest(out)


@contextlib.contextmanager
def k4_shape_tally():
    """K4's launches by (N, S, C, act) inside the ``with`` block, as
    k3_shape_tally counts K3's: ``models.layers.group_norm_kernel`` wrapped,
    the notes adding up to the wrapper's own launch count."""
    from stable_renderer_tpu_torch.models import layers

    k4 = layers.group_norm_kernel
    seen = collections.Counter()

    def noted(x, w, b, groups=32, eps=1e-6, act=None):
        seen[tuple(x.shape) + (act,)] += 1
        return k4(x, w, b, groups=groups, eps=eps, act=act)

    before = k4.launches
    layers.group_norm_kernel = noted
    try:
        yield seen
    finally:
        layers.group_norm_kernel = k4
    if sum(seen.values()) != k4.launches - before:
        fail(f"K4: {sum(seen.values())} calls noted by shape, {k4.launches - before} launches")


def hold_zoo_classes(k3_seen, k4_seen, dev, card: str, k3: dict, k4: dict) -> dict:
    """Phase 28c: each bf16 K3 class (N, H, W, Cin, Cout, prologue) of
    CodeFormer's switched pass that phase 7 did not check, and each K4 class
    (N, S, C, act) that phase 8 did not, against its plain version (phase
    7's and 8's bars), timed by graph replay beside its bound and cuDNN's
    conv or F.group_norm; the rows join k3["shapes"] / k4["shapes"] with
    their launches a pass. Returns the rows by kernel."""
    import torch
    import torch.nn.functional as F

    from stable_renderer_tpu_torch.ops.conv_kernel import conv3x3_kernel, conv3x3_kernel_reference
    from stable_renderer_tpu_torch.ops.group_norm_kernel import (
        group_norm_kernel,
        group_norm_kernel_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED)
    rows = {"k3": [], "k4": []}
    for (n, h, w, cin, cout, pro), launches in sorted(k3_seen.items()):
        if (n, h, w, cin, cout, pro) in K3_SWITCHED_FRAME_SHAPES:
            continue
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
        wk = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
              / (3.0 * cin ** 0.5)).to(torch.bfloat16)
        b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        kw = {}
        if pro:
            kw.update(pre_scale=torch.rand((n, cin), generator=gen, device=dev) + 0.5,
                      pre_shift=torch.randn((n, cin), generator=gen, device=dev) * 0.5,
                      pre_act="silu")
        out = conv3x3_kernel(x, wk, b, **kw)
        torch.cuda.synchronize()
        ref = conv3x3_kernel_reference(x, wk, b, **kw)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        shape = (f"{n}x{h}x{w}x{cin}->{cout} bf16{' + prologue' if pro else ''} "
                 "(phase 28 CodeFormer)")
        if not (math.isfinite(err) and (diff <= BF16_STEP * ref.float().abs()
                                        + K3_BF16_ATOL).all()):
            fail(f"K3 {shape}: max abs err {err:.3e} (bar |d| <= 2^-7 |ref| + {K3_BF16_ATOL:g})")
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        row = {"shape": shape, "max_abs_err": err,
               "bar": f"|d| <= 2^-7 |ref| + {K3_BF16_ATOL:g}", "launches_a_pass_phase_28": launches,
               "ms": graph_ms(lambda: conv3x3_kernel(x, wk, b, **kw)),
               "plain_ms": graph_ms(lambda: conv3x3_kernel_reference(x, wk, b, **kw), 5),
               "library_ms": graph_ms(lambda: F.conv2d(x_cl, w_cl, b, padding=1)),
               "ms_with_host": cuda_ms(lambda: conv3x3_kernel(x, wk, b, **kw), 20)}
        row["bound_ms"], row["bound_by"] = bound(
            nbytes(x, wk, b, out, kw.get("pre_scale"), kw.get("pre_shift")),
            2.0 * n * h * w * cout * 9 * cin, "bf16")
        k3["shapes"].append(row)
        rows["k3"].append(row)
        print(f"[28 K3] {row} | {card}", flush=True)
        del x, wk, out, ref, diff
    for (n, s, c, act), launches in sorted(k4_seen.items(), key=str):
        if (n, s, c, act) in K4_SWITCHED_FRAME_SHAPES:
            continue
        x = (torch.randn((n, s, c), generator=gen, device=dev) * 1.5 + 0.3).to(torch.bfloat16)
        w = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((c,), generator=gen, device=dev).to(torch.bfloat16)
        call = lambda: group_norm_kernel(x, w, b, groups=32, act=act)  # noqa: E731
        out = call()
        torch.cuda.synchronize()
        ref = group_norm_kernel_reference(x, w, b, groups=32, act=act)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if not (math.isfinite(err) and (diff <= BF16_STEP * ref.float().abs() + K4_ATOL).all()):
            fail(f"K4 {(n, s, c)} {act}: max abs err {err:.3e} (bar |d| <= 2^-7 |ref| + "
                 f"{K4_ATOL:g})")
        x_nc = x.transpose(1, 2)
        lib = ((lambda: F.silu(F.group_norm(x_nc, 32, w, b, 1e-6))) if act == "silu" else
               (lambda: F.group_norm(x_nc, 32, w, b, 1e-6)))
        row = {"shape": f"{(n, s, c)} bf16 {act} (phase 28 CodeFormer)", "max_abs_err": err,
               "launches_a_pass_phase_28": launches,
               "ms": graph_ms(call, calls=SHORT_CALLS_A_GRAPH),
               "plain_ms": graph_ms(lambda: group_norm_kernel_reference(x, w, b, 32, 1e-6, act),
                                    calls=SHORT_CALLS_A_GRAPH),
               "library_ms": graph_ms(lib, calls=SHORT_CALLS_A_GRAPH),
               "ms_with_host": cuda_ms(call, 20)}
        row["bound_ms"], row["bound_by"] = bound(nbytes(x, w, b, out), 10.0 * x.numel(), "f32")
        k4["shapes"].append(row)
        rows["k4"].append(row)
        print(f"[28 K4] {row} | {card}", flush=True)
    return rows


CODEFORMER_FUSE_SCALE = 0.01  # random SFT fuse convs, tamed (see codeformer_tamed)


def codeformer_tamed(params: dict) -> dict:
    """A random CodeFormer init with each SFT fuse block's last scale and
    shift convs scaled by CODEFORMER_FUSE_SCALE: drawn at the init's 0.05
    they multiply the generator's features by ~80 at each of the four
    connect resolutions, and the published-width image overflows f32 (bf16
    too); trained fuse convs keep the scale near 1."""
    for fp in params["fuse_convs_dict"].values():
        for name in ("scale", "shift"):
            fp[name]["2"]["weight"] = fp[name]["2"]["weight"] * CODEFORMER_FUSE_SCALE
    return params


def codeformer_config():
    """Phase 28c's CodeFormer: the published widths (a CPU rehearsal sets a
    tiny one)."""
    from stable_renderer_tpu_torch.models.codeformer import CodeFormerConfig

    return CodeFormerConfig()


def zoo_tiny_models():
    """Phase 28d's files: {expected class: (model, its tree, CPU input)}, one
    of each of the twelve architectures at the tests' tiny configs (f32, a
    generator seeded ZOO_SEED on the CPU). LaMa's and CodeFormer's carry
    what detection reads (LaMa: 3 downsamplings and 18 blocks at ngf 8;
    CodeFormer: the published encoder and generator, 2 transformer layers of
    64 on a 512x512 input)."""
    import torch

    from stable_renderer_tpu_torch.models import (
        codeformer,
        dat,
        gfpgan,
        hat,
        lama,
        omnisr,
        restoreformer,
        scunet,
        spsr,
        swin2sr,
        swinir,
        upscale,
    )

    gen = torch.Generator().manual_seed(ZOO_SEED)
    s = ZOO_TINY_SIZE

    def img(size, face=False):
        x = torch.rand((1, size, size, 3), generator=gen)
        return x * 2.0 - 1.0 if face else x

    models = {
        "RRDBNet": (upscale.RRDBNet(upscale.RRDBConfig(16, 2, 8, 4)), img(s)),
        "SRVGGNetCompact": (upscale.SRVGGNetCompact(upscale.SRVGGConfig(16, 2, 2)), img(s)),
        "SwiftSRGAN": (upscale.SwiftSRGAN(upscale.SwiftSRGANConfig(8, 2, 2)), img(s)),
        "SwinIR": (swinir.SwinIR(swinir.TINY_SWINIR_CONFIG), img(s)),
        "Swin2SR": (swin2sr.Swin2SR(swin2sr.TINY_SWIN2SR_CONFIG), img(s)),
        "HAT": (hat.HAT(hat.TINY_HAT_CONFIG), img(s)),
        "DAT": (dat.DAT(dat.TINY_DAT_CONFIG), img(s)),
        "OmniSR": (omnisr.OmniSR(omnisr.TINY_OMNISR_CONFIG), img(s)),
        "SPSRNet": (spsr.SPSRNet(spsr.TINY_SPSR_CONFIG), img(s)),
        "SCUNet": (scunet.SCUNet(scunet.TINY_SCUNET_CONFIG), img(s)),
        "GFPGAN": (gfpgan.GFPGAN(gfpgan.TINY_GFPGAN_CONFIG), img(32, face=True)),
        "CodeFormer": (codeformer.CodeFormer(codeformer.CodeFormerConfig(
            codebook_size=64, dim_embd=64, n_layers=2)), img(512, face=True)),
        "RestoreFormer": (restoreformer.RestoreFormer(restoreformer.TINY_RESTOREFORMER_CONFIG),
                          img(16, face=True)),
        "LaMa": (lama.LaMa(lama.LaMaConfig(ngf=8)), img(2 * s)),
    }
    out = {}
    for name, (model, x) in models.items():
        tree = model.init(gen)
        if name == "RRDBNet":
            tree = rrdb_basicsr_scaled(tree)
        elif name == "CodeFormer":
            tree = codeformer_tamed(tree)
        extra = ((torch.rand((1, 2 * s, 2 * s, 1), generator=gen) > 0.6).float(),) \
            if name == "LaMa" else ()
        out[name] = (tree, (x,) + extra)
    return out


def zoo_compare(name: str, model, params, cpu_model, cpu_params, xs, dev) -> dict:
    """Phase 28d: a loaded tiny model on the card against the CPU plain run
    on the same tensors: outputs within ZOO_TOL; for CodeFormer and
    RestoreFormer the logits / distances within ZOO_TOL, the code indices
    equal wherever the CPU's best code leads by ZOO_MARGIN, the images
    decoded from the CPU's indices."""
    import torch

    xd = [x.to(dev) for x in xs]
    with torch.no_grad():
        if name == "CodeFormer":
            idx_c, feats_c, logit_c = cpu_model.code_indices(cpu_params, xs[0])
            idx_d, feats_d, logit_d = model.code_indices(params, xd[0])
            scores = (logit_d.cpu(), logit_c)
            ref = cpu_model.decode(cpu_params, idx_c, feats_c, 0.5, torch.float32)
            out = model.decode(params, idx_c.to(dev), feats_d, 0.5, torch.float32)
            idx = (idx_d.cpu(), idx_c, torch.sort(logit_c, -1).values)
        elif name == "RestoreFormer":
            z_c, d2_c, hs_c = cpu_model.encode(cpu_params, xs[0])
            _, d2_d, hs_d = model.encode(params, xd[0])
            scores = (d2_d.cpu(), d2_c)
            idx_c = d2_c.argmin(-1)
            ref = cpu_model.decode(cpu_params, z_c.shape, idx_c, hs_c)
            out = model.decode(params, z_c.shape, idx_c.to(dev), hs_d)
            idx = (d2_d.argmin(-1).cpu(), idx_c, torch.sort(-d2_c, -1).values)
        else:
            ref = cpu_model.apply(cpu_params, *xs)
            out = model.apply(params, *xd)
            scores = idx = None
    res = {}
    if scores is not None:
        s_err = (scores[0] - scores[1]).abs().max().item()
        i_d, i_c, ordered = idx
        led = (ordered[..., -1] - ordered[..., -2]) > ZOO_MARGIN
        flips = int((i_d != i_c)[led].sum())
        res.update(score_max_abs_err=s_err, led_share=float(led.float().mean()),
                   index_flips_where_led=flips)
        if not (s_err <= ZOO_TOL and flips == 0 and float(led.float().mean()) > 0.5):
            fail(f"phase 28d {name}: scores max abs err {s_err:.3e} (tol {ZOO_TOL}), "
                 f"{flips} index flips where led, {float(led.float().mean()):.3f} led")
    err = (out.cpu() - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1.0)
    if not (math.isfinite(err) and err <= ZOO_TOL * scale and out.shape == ref.shape):
        fail(f"phase 28d {name}: card against CPU max abs err {err:.3e} (tol {ZOO_TOL} x "
             f"{scale:.3g}), shapes {tuple(out.shape)} {tuple(ref.shape)}")
    res.update(max_abs_err=err, shape=list(out.shape))
    return res


def zoo_phase(dev, card: str, k3: dict, k4: dict, frame) -> dict:
    """Phase 28 (see the module docstring): ``frame`` is phase 11's last
    presented (512, 512, 4) uint8 frame. Files go to a temporary directory
    under build/, removed at the end."""
    import os

    import numpy as np
    import torch
    from PIL import Image

    from stable_renderer_tpu_torch.models import codeformer, layers, upscale
    from stable_renderer_tpu_torch.models.lama import load_lama
    from stable_renderer_tpu_torch.models.swinir import SWINIR_M_X4_CONFIG, SwinIR
    from stable_renderer_tpu_torch.models.weights import flatten
    from stable_renderer_tpu_torch.ops.conv_kernel import use_pallas_conv
    from stable_renderer_tpu_torch.utils import paths
    from stable_renderer_tpu_torch.workflow import Workflow
    from stable_renderer_tpu_torch.workflow import executor as wex

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="zoo-", dir=root / "build"))
    out = {}
    t_phase = time.perf_counter()
    saved_output_dir = paths.OUTPUT_DIR
    paths.OUTPUT_DIR = tmp / "outputs"
    size = frame.shape[0]  # the engine's presented frame, upscaled x4
    try:
        Image.fromarray(np.ascontiguousarray(frame[..., :3])).save(tmp / "frame.png")
        gen = torch.Generator(device=dev).manual_seed(ZOO_SEED)
        zoo_models = {"esrgan": (upscale.RRDBNet(upscale.RRDBConfig()), "params_ema"),
                      "swinir": (SwinIR(SWINIR_M_X4_CONFIG), "params_ema")}
        for label, (model, nest_key) in zoo_models.items():
            # --- 28a / 28b: ESRGAN x4, SwinIR-M x4 through the executor ----------------
            tree = model.init(gen, device=dev)
            if label == "esrgan":
                tree = rrdb_basicsr_scaled(tree)
            n_params = sum(v.numel() for v in flatten(tree).values())
            file_bytes = write_zoo_file(tmp / f"{label}.pth", tree, nest_key)
            del tree
            wf_path = tmp / f"{label}.json"
            wf_path.write_text(json.dumps(ui_workflow(zoo_rows(f"{label}.pth"))))
            ex = wex.PromptExecutor(Workflow.Load(wf_path), model_dirs=(str(tmp),), device=dev)
            zero_counts()
            out[label], seen, ctx = image_graph_run(
                label, ex, (1, 2), {}, card, phase=28, timed=ZOO_TIMED,
                timed_node="ImageUpscaleWithModel", load_node="UpscaleModelLoader")
            launched = counts()
            (loaded, params), = ex._cache[2]
            want = type(model).__name__, model.config
            img = ctx.final_output
            if (type(loaded).__name__, loaded.config) != want or launched != (0, 0, 0, 0):
                fail(f"phase 28 {label}: loaded {type(loaded).__name__} {loaded.config}, want "
                     f"{want}; kernel launches {launched} (want none: f32, switches off)")
            lo, hi = float(img.min()), float(img.max())
            if (tuple(img.shape) != (1, 4 * size, 4 * size, 3) or img.dtype != torch.float32
                    or not torch.isfinite(img).all() or float(img.std()) < 1e-3
                    or (label == "esrgan" and not (0.0 <= lo and hi <= 1.0))
                    or params["conv_first"]["weight"].device.type != "cuda"):
                fail(f"phase 28 {label}: image {tuple(img.shape)} {img.dtype}, range [{lo}, {hi}], "
                     f"std {float(img.std()):.3e}")
            out[label].update(family=type(loaded).__name__, params=n_params,
                              file_mb=file_bytes / 1e6,
                              image=list(img.shape), range=[lo, hi])
            print(f"[28 {label}] {type(loaded).__name__} {loaded.config}: {n_params / 1e6:.2f} M "
                  f"parameters, a {file_bytes / 1e6:.1f} MB .pth in the {nest_key} nesting; "
                  f"{size}x{size} -> {img.shape[2]}x{img.shape[1]} f32, range "
                  f"[{lo:.3f}, {hi:.3f}] | {card}", flush=True)
            del ex, ctx, img, params, loaded
            torch.cuda.empty_cache()

        # --- 28c. CodeFormer in bf16, unswitched and switched ------------------------------
        cf = codeformer.CodeFormer(codeformer_config())
        params = codeformer_tamed(cf.init(gen, dtype=torch.bfloat16, device=dev))
        x = (torch.from_numpy(np.ascontiguousarray(frame[..., :3])).to(dev).float() / 127.5
             - 1.0)[None].to(torch.bfloat16)
        passes, ref_idx = {}, None
        for mode in ("unswitched", "switched"):
            on = mode == "switched"
            use_pallas_conv(on)
            layers._group_norm_pallas_on = on
            try:
                with torch.no_grad():
                    zero_counts()
                    with k3_shape_tally() as s3, k4_shape_tally() as s4:
                        idx, feats, _ = cf.code_indices(params, x)
                        ref_idx = idx if ref_idx is None else ref_idx
                        img = cf.decode(params, ref_idx, feats, 0.5, torch.bfloat16)
                    launched = counts()
                    ms = cuda_ms(lambda: cf.apply(params, x), repeats=ZOO_TIMED, warmup=1)
            finally:
                use_pallas_conv(False)
                layers._group_norm_pallas_on = False
            if on != (launched[2] > 0 and launched[3] > 0) or launched[:2] != (0, 0):
                fail(f"phase 28c CodeFormer {mode}: launches K1, K2, K3, K4 = {launched}")
            passes[mode] = {"img": img.float() * 0.5 + 0.5, "idx": idx, "launches": launched,
                            "k3_by_class": dict(s3), "k4_by_class": dict(s4), "apply_ms": ms}
        flips = int((passes["switched"]["idx"] != ref_idx).sum())
        d = (passes["switched"]["img"] - passes["unswitched"]["img"]).abs()
        mean_d, max_d = float(d.mean()), float(d.max())
        if not (torch.isfinite(passes["switched"]["img"]).all() and mean_d < SWITCH_MEAN_BAR
                and max_d < SWITCH_MAX_BAR):
            fail(f"phase 28c CodeFormer: switched against unswitched mean abs {mean_d:.4f} "
                 f"(bar {SWITCH_MEAN_BAR}), max {max_d:.4f} (bar {SWITCH_MAX_BAR})")
        sw = passes["switched"]
        rows = hold_zoo_classes(sw["k3_by_class"], sw["k4_by_class"], dev, card, k3, k4)
        out["codeformer"] = {
            "unswitched_apply_ms": passes["unswitched"]["apply_ms"], "switched_apply_ms":
            sw["apply_ms"], "launches_switched": list(sw["launches"]),
            "k3_by_class": {str(k): v for k, v in sw["k3_by_class"].items()},
            "k4_by_class": {str(k): v for k, v in sw["k4_by_class"].items()},
            "mean_abs": mean_d, "max_abs": max_d, "index_flips": flips,
            "tokens": int(ref_idx.numel()), "new_k3_classes": len(rows["k3"]),
            "new_k4_classes": len(rows["k4"])}
        print(f"[28 codeformer] {cf.config} bf16 at {size}x{size}: apply "
              f"unswitched {passes['unswitched']['apply_ms']:.1f} ms, switched "
              f"{sw['apply_ms']:.1f} ms (median of {ZOO_TIMED}); switched launches K3 "
              f"{sw['launches'][2]} by class {dict(sw['k3_by_class'])}, K4 {sw['launches'][3]} by "
              f"class {dict(sw['k4_by_class'])}; switched vs unswitched (both decoded from the "
              f"unswitched indices) mean abs {mean_d:.5f}, max {max_d:.4f}; the switched argmax "
              f"moved {flips} of {ref_idx.numel()} tokens; {len(rows['k3'])} new K3 and "
              f"{len(rows['k4'])} new K4 classes held | {card}", flush=True)
        del params, x, passes, sw, d, feats, img
        torch.cuda.empty_cache()

        # --- 28d. a tiny file of each architecture on the card ------------------------------
        tiny, det = {}, {}
        for name, (tree, xs) in zoo_tiny_models().items():
            path = tmp / f"tiny-{name}.pth"
            write_zoo_file(path, tree, "params_ema" if name == "SwinIR" else None)
            if name == "LaMa":
                try:
                    upscale.load_upscale_model(path, device=dev)
                    fail("phase 28d: load_upscale_model loaded a LaMa file (JAX's raises)")
                except KeyError:
                    pass
                model, params = load_lama(path, device=dev)
                cpu_model, cpu_params = load_lama(path, device="cpu")
            else:
                model, params = upscale.load_upscale_model(path, device=dev)
                cpu_model, cpu_params = upscale.load_upscale_model(path, device="cpu")
            det[name] = type(model).__name__
            if det[name] != name:
                fail(f"phase 28d: a {name} file loaded as {det[name]}")
            tiny[name] = zoo_compare(name, model, params, cpu_model, cpu_params, xs, dev)
        out["tiny"] = tiny
        print(f"[28 tiny] twelve architectures' tiny files on the card, each detected as the "
              f"JAX package's dispatch does ({', '.join(det)}), against the CPU: max abs errors "
              + ", ".join(f"{k} {v['max_abs_err']:.2e}" for k, v in tiny.items())
              + f" | {card}", flush=True)

        # --- 28e. the CLI's upscale as its own process --------------------------------------
        cmd = [sys.executable, "-m", "stable_renderer_tpu_torch", "upscale", "--model",
               str(tmp / "esrgan.pth"), "--image", str(tmp / "frame.png"), "--out",
               str(tmp / "cli.png")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, SR_TPU_OUTPUT_DIR=str(tmp / "outputs")))
        cli_s = time.perf_counter() - t0
        want_line = f"RRDBNet: {size}x{size} -> {4 * size}x{4 * size} -> "
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines or not lines[-1].startswith(want_line):
            fail(f"phase 28e upscale exited {proc.returncode}: {' '.join(cmd)}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        png = np.asarray(Image.open(tmp / "cli.png"))
        if png.shape != (4 * size, 4 * size, 3) or png.max() == png.min():
            fail(f"phase 28e upscale wrote {png.shape}, range [{png.min()}, {png.max()}]")
        out["cli_upscale_s"] = cli_s
        print(f"[28 CLI] python -m stable_renderer_tpu_torch upscale --model <(a)'s file>: exit "
              f"0 in {cli_s:.1f} s (process, imports and load included): "
              f"{lines[-1].replace(str(tmp), '<tmp>')} | {card}", flush=True)
    finally:
        paths.OUTPUT_DIR = saved_output_dir
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[28 zoo] phase 28 in {out['phase_s']:.1f} s | {card}", flush=True)
    return out


if __name__ == "__main__":
    main()
