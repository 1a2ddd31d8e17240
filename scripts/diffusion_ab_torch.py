"""Diffusion-mode temporal A/B on the PyTorch port: OverlapCorresponder on against off.

Counterpart of scripts/diffusion_ab.py. Runs the SAME moving scene and seeds
through the real img2img render program twice, OverlapCorresponder ON and
OFF, and scores the temporal stability of the outputs. With identical
weights and noise, any flicker delta comes from the correspondence machinery
(pre-attention broadcast K/V and step_finished vertex averaging, reference
corresponder.py:157-377) working through the actual sampler. Weights are
random and tiny unless --ckpt names a checkpoint; the noise is vertex-anchored
(cfg.vertex_noise) and drawn from torch generators seeded as the JAX script
seeds its keys (render 7, latent-level noise 7, attention hooks 9).

Writes the result into <--out>/PARITY.json under "diffusion_ab" (default
--out: a new run directory under outputs/).

Usage: python scripts/diffusion_ab_torch.py [--ckpt FILE] [--size S] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch


def moving_scene(n_frames: int, size: int, device=None):
    """A textured square translating 1 px/frame with PERSISTENT vertex ids —
    the same surface point keeps its id across frames, so vertex_flicker
    measures true per-surface-point color stability. Returns (color (N, S,
    S, 3) f32, ids (N, S, S, 4) int32) on ``device``."""
    w = (size * 3) // 4  # large object: interior >> VAE-boundary halo
    vid = np.arange(w * w, dtype=np.int32).reshape(w, w) + 1
    # deterministic per-vertex texture (what a stable render should produce)
    rng = np.random.default_rng(0)
    tex = rng.uniform(0.2, 0.8, (w * w + 1, 3)).astype(np.float32)

    ids = np.zeros((n_frames, size, size, 4), np.int32)
    color = np.zeros((n_frames, size, size, 3), np.float32)
    for f in range(n_frames):
        ox = 4 + f  # slides right
        oy = 4
        ids[f, oy : oy + w, ox : ox + w, 3] = vid
        ids[f, oy : oy + w, ox : ox + w, 0] = 1
        color[f, oy : oy + w, ox : ox + w] = tex[vid]
    return torch.from_numpy(color).to(device), torch.from_numpy(ids).to(device)


def run(pipe, corresponder, color, ids, seed: int):
    from stable_renderer_tpu_torch.data.engine_data import EngineData

    ed = EngineData(
        frame_indices=torch.arange(color.shape[0], device=color.device),
        color_maps=color,
        id_maps=ids,
    )
    key = torch.Generator(device=pipe.device).manual_seed(seed)
    return pipe.render(ed, corresponder=corresponder, key=key)


def main(argv=None) -> dict:
    """Run the A/B; returns the result written to PARITY.json."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None, help="real checkpoint (optional)")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", type=str, default=None,
                    help="directory of the PARITY.json written (default: outputs/<date>)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.sampling import samplers
    from stable_renderer_tpu_torch.models.sampling.cfg import make_denoiser
    from stable_renderer_tpu_torch.ops.correspondence import (
        DefaultCorresponder,
        OverlapCorresponder,
        vertex_noise,
    )
    from stable_renderer_tpu_torch.ops.metrics import temporal_flicker_l1, vertex_flicker
    from stable_renderer_tpu_torch.utils.paths import new_run_dir
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    cfg = RenderConfig(
        prompt="a textured square", steps=args.steps, cfg_scale=2.0,
        sampler="ddim", scheduler="sgm_uniform", denoise=0.6,
        vertex_noise=True,
    )
    if args.ckpt:
        pipe = DiffusionPipeline.from_checkpoint(args.ckpt, cfg, device=args.device)
    else:
        pipe = DiffusionPipeline.from_random(cfg, tiny=True, device=args.device)
    dev = pipe.device

    color, ids = moving_scene(args.frames, args.size, dev)

    off = DefaultCorresponder(update_corrmap=False)
    # injection strength is a user knob; with random weights the model can't
    # PRESERVE early-step consistency the way trained weights do, so the A/B
    # runs the injection throughout (stop_inject_timestep=0) — the delta then
    # isolates the machinery (vertex averaging + broadcast-KV through the
    # real sampler), not the weights' denoising prior
    on = OverlapCorresponder(
        update_corrmap=False, vertex_segments=4096,
        pre_attn_frames=(0,), layer_range=None,  # inject at every layer
        step_finished_inject_ratio=0.8,
        step_finished_stop_inject_timestep=0.0,
    )

    frames_off = run(pipe, off, color, ids, seed=7).float()
    frames_on = run(pipe, on, color, ids, seed=7).float()

    result = {}
    for name, frames in (("overlap_off", frames_off), ("overlap_on", frames_on)):
        result[name] = {
            "flicker_l1": float(temporal_flicker_l1(frames)),
            "vertex_flicker": float(vertex_flicker(frames, ids, num_segments=4096)),
        }
    result["delta"] = {
        k: result["overlap_on"][k] - result["overlap_off"][k]
        for k in ("flicker_l1", "vertex_flicker")
    }
    # ---- latent-level A/B: the mechanism, isolated from the decode --------
    # With random weights the VAE decode is a position-dependent random map,
    # so image-level flicker saturates regardless of latent consistency (a
    # REAL checkpoint's local/smooth decoder preserves it — rerun with
    # --ckpt for image-level evidence). The latent-level numbers below show
    # the injection doing its job through the real sampler.
    log_sigmas = torch.as_tensor(pipe.model_sampling.log_sigmas)
    sigmas = pipe.scheduler_sigmas()
    vae_dtype = pipe.vae_params["quant_conv"]["weight"].dtype
    with torch.no_grad():
        x0 = pipe.vae.encode(pipe.vae_params, (color * 2.0 - 1.0).to(vae_dtype)).float()
    lh, lw = x0.shape[1], x0.shape[2]
    nz = vertex_noise(torch.Generator(device=dev).manual_seed(7), ids, lh, lw, x0.shape[-1])
    ctx = torch.zeros((color.shape[0], 7, pipe.unet.config.context_dim), device=dev)

    @torch.no_grad()
    def latent_run(corr):
        hooks = corr.attn_hooks(None, generator=torch.Generator(device=dev).manual_seed(9))
        cb = corr.make_step_callback(ids, log_sigmas)
        den = make_denoiser(pipe.unet, pipe.unet_params, ctx, ctx, log_sigmas,
                            cfg_scale=2.0, hooks=hooks)
        return samplers.sample(den, nz, sigmas, latent_image=x0,
                               sampler="ddim", step_callback=cb).float()

    ids_lat = ids[:, :: args.size // lh, :: args.size // lw]
    lat_result = {}
    for name, corr in (("overlap_off", off), ("overlap_on", on)):
        lat = latent_run(corr)
        lat01 = (lat - lat.min()) / (lat.max() - lat.min() + 1e-8)
        lat_result[name] = {
            "vertex_flicker_latent": float(
                vertex_flicker(lat01[..., :3], ids_lat, num_segments=4096)),
        }
    lat_result["delta"] = {
        "vertex_flicker_latent":
            lat_result["overlap_on"]["vertex_flicker_latent"]
            - lat_result["overlap_off"]["vertex_flicker_latent"],
    }
    result["latent_level"] = lat_result

    result["config"] = {
        "frames": args.frames, "size": args.size, "steps": args.steps,
        "sampler": cfg.sampler, "denoise": cfg.denoise,
        "weights": "checkpoint" if args.ckpt else "random-tiny",
        "device": str(dev),
        "note": "same scene/seeds/noise through the real img2img loop; "
                "the only difference is the corresponder injection. "
                "latent_level isolates the mechanism from the (random-weight) "
                "VAE decode.",
    }
    print(json.dumps(result, indent=2))

    out = Path(args.out) if args.out else new_run_dir("diffusion_ab")
    out.mkdir(parents=True, exist_ok=True)
    parity_path = out / "PARITY.json"
    data = json.loads(parity_path.read_text()) if parity_path.exists() else {}
    data["diffusion_ab"] = result
    parity_path.write_text(json.dumps(data, indent=2) + "\n")
    print(f"written to {parity_path}")

    improved = lat_result["delta"]["vertex_flicker_latent"] < 0
    print("overlap-on reduces latent vertex flicker:", improved,
          f"({lat_result['delta']['vertex_flicker_latent']:+.4f})")
    return result


if __name__ == "__main__":
    main()
