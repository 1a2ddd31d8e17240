"""RenderConfig — the declarative replacement for ComfyUI workflow graphs.

Counterpart of stable_renderer_tpu/workflow/config.py, field for field: one
frozen config selects one render program (sampler, scheduler, steps, cfg,
denoise, prompts, corresponder-related knobs). The port runs every knob: the
sequential path in bf16 or with the calibrated int8 convs (``int8_conv``),
the stream pipeline with lag-1 K/V, TAESD, ControlNets, scene conditioning
and every sampler and scheduler. ``workflow/loader.py`` maps the reference's
workflow JSON onto it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ControlNetSpec:
    """One ControlNet application (ControlNetApplyAdvanced semantics:
    strength + start/end percent; hint source = a G-buffer channel)."""

    source: str = "normal"  # normal | depth | canny | color | pos
    strength: float = 1.0
    start_percent: float = 0.0
    end_percent: float = 1.0
    model_path: Optional[str] = None


@dataclass(frozen=True)
class RenderConfig:
    """Static configuration of one render program."""

    prompt: str = ""
    negative_prompt: str = ""
    steps: int = 4
    cfg_scale: float = 2.0
    sampler: str = "lcm"
    scheduler: str = "sgm_uniform"
    denoise: float = 1.0
    clip_skip: int = -1
    # override the model's prediction type ('eps' | 'v' | 'lcm'); None = infer
    prediction: Optional[str] = None
    seed: int = 0
    vertex_noise: bool = True
    # swap the full VAE for TAESD in the frame loop
    realtime_taesd: bool = False
    # StreamDiffusion-style pipelining: `steps` frames in flight at different
    # denoise stages, one batched UNet eval per engine frame
    stream_pipeline: bool = False
    # lag-1 broadcast-KV correspondence inside the stream pipeline at these
    # transformer indices; None = off
    stream_kv_layers: Optional[Tuple[int, ...]] = None
    # calibrated int8 conv path: DiffusionPipeline.from_random quantizes the
    # UNet and VAE conv trees (quantize_convs); their 3x3 convs run on K3
    int8_conv: bool = False
    scene_conditioning: bool = True  # per-sprite masked conditioning (SceneTextEncode)
    keep_background: bool = False  # inpaint mode: denoise only AI-object pixels
    controlnets: Tuple[ControlNetSpec, ...] = ()
    checkpoint_path: Optional[str] = None
    lora_paths: Tuple[Tuple[str, float], ...] = ()

    # engine-level knobs mirrored from the reference manager kwargs
    baking_interval: int = 8  # frames per bake batch
