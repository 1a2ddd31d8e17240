"""Remaining builtin + comfy_extras parity nodes.

Counterpart of stable_renderer_tpu/workflow/nodes_parity.py, node for node
(reference: source/comfyUI/nodes.py:1901-1968 builtins +
comfy_extras/nodes_{latent,images,mask,model_advanced,model_downscale,
clip_sdxl,cond,canny,post_processing,stable_cascade,stable3d}.py):

  * latent batch/transform zoo — SetLatentNoiseMask, LatentFromBatch,
    RepeatLatentBatch, LatentBlend, LatentRotate, LatentFlip, LatentCrop,
    LatentInterpolate, LatentBatch, LatentBatchSeedBehavior,
    LatentCompositeMasked, Save/LoadLatent.
  * image zoo — EmptyImage, ImageCrop, RepeatImageBatch, ImageFromBatch,
    ImageCompositeMasked, ImageColorToMask, CropMask, LoadImageMask,
    ImageScaleToTotalPixels, Canny, SaveAnimatedWEBP/PNG.
  * conditioning — ConditioningAverage, ConditioningSetAreaStrength,
    CLIPTextEncodeSDXL(+Refiner), CLIPTextEncodeControlnet.
  * loaders — VAELoader, CLIPLoader, DualCLIPLoader, LoraLoader,
    CheckpointLoader, DiffusersLoader, DiffControlNetLoader,
    VAEDecode/EncodeTiled.
  * advanced model patches — ModelSamplingDiscrete, ModelSamplingContinuousEDM,
    ModelSamplingStableCascade, RescaleCFG, PatchModelAddDownscale.
  * image conditioning — unCLIPCheckpointLoader, StyleModelLoader,
    StyleModelApply, StableZero123_Conditioning_Batched.
  * StableCascade_StageC_VAEEncode.

All tensors are NHWC torch tensors on the executor's device; LATENT values
are the same {"samples": ...} dicts the rest of the executor uses. Files
(.latent, .safetensors) go through models/weights.py's reader and writer.
"""

from __future__ import annotations

import math
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.utils.log import get_logger
from stable_renderer_tpu_torch.workflow.executor import (
    InferenceContext,
    WorkflowNode,
    _find_model_file,
    _generator,
    _on,
    register_node,
    widget as _widget,
)
from stable_renderer_tpu_torch.workflow.nodes_extra import (
    _add_patch,
    _resize_image,
    zero123_camera,
    zero123_latent,
)

logger = get_logger("sr_tpu_torch.nodes_parity")


def _samples(latent):
    return latent["samples"] if isinstance(latent, dict) else latent


def _repeat_to_batch(x: torch.Tensor, n: int) -> torch.Tensor:
    """comfy.utils.repeat_to_batch_size: tile then slice to n rows."""
    if x.shape[0] == n:
        return x
    reps = -(-n // x.shape[0])
    return x.repeat((reps,) + (1,) * (x.dim() - 1))[:n]


def _tile(x: torch.Tensor, reps: tuple) -> torch.Tensor:
    """numpy's tile: ``x`` gains leading dims up to ``len(reps)`` first."""
    x = x.reshape((1,) * (len(reps) - x.dim()) + tuple(x.shape))
    return x.repeat(reps)


def _output_dir() -> Path:
    from stable_renderer_tpu_torch.utils import paths

    return Path(paths.OUTPUT_DIR)


# ---------------------------------------------------------------------------
# latent batch / transform zoo (nodes.py + comfy_extras/nodes_latent.py)


@register_node("SetLatentNoiseMask")
def set_latent_noise_mask(ctx: InferenceContext, node: WorkflowNode,
                          samples=None, mask=None):
    """Attach an inpaint noise mask to a latent (nodes.py:1380-1394
    SetLatentNoiseMask; consumed by the KSampler's inpaint wrap)."""
    m = _on(ctx, mask)
    if m.dim() == 2:
        m = m[None]
    return ({**samples, "noise_mask": m},)


@register_node("LatentFromBatch")
def latent_from_batch(ctx: InferenceContext, node: WorkflowNode, samples=None):
    """Slice [batch_index, batch_index+length) out of a latent batch,
    carrying noise_mask rows and per-sample noise batch indices
    (nodes.py:1109-1139 LatentFromBatch)."""
    s_in = _samples(samples)
    batch_index = min(s_in.shape[0] - 1, _widget(node, 0, 0, int))
    length = min(s_in.shape[0] - batch_index, _widget(node, 1, 1, int))
    out = dict(samples)
    out["samples"] = s_in[batch_index:batch_index + length]
    if "noise_mask" in samples:
        masks = samples["noise_mask"]
        if masks.shape[0] == 1:
            out["noise_mask"] = masks
        else:
            masks = _repeat_to_batch(masks, s_in.shape[0])
            out["noise_mask"] = masks[batch_index:batch_index + length]
    if "batch_index" not in samples:
        out["batch_index"] = list(range(batch_index, batch_index + length))
    else:
        out["batch_index"] = samples["batch_index"][batch_index:batch_index + length]
    return (out,)


@register_node("RepeatLatentBatch")
def repeat_latent_batch(ctx: InferenceContext, node: WorkflowNode, samples=None):
    """Tile a latent batch ``amount`` times (nodes.py:1141-1170)."""
    amount = _widget(node, 0, 1, int)
    s_in = _samples(samples)
    out = dict(samples)
    out["samples"] = _tile(s_in, (amount, 1, 1, 1))
    if "noise_mask" in samples and samples["noise_mask"].shape[0] > 1:
        masks = _repeat_to_batch(samples["noise_mask"], s_in.shape[0])
        out["noise_mask"] = _tile(masks, (amount, 1, 1, 1))
    if "batch_index" in samples:
        idx = list(samples["batch_index"])
        offset = max(idx) - min(idx) + 1
        out["batch_index"] = [i + offset * rep for rep in range(amount) for i in idx]
    return (out,)


@register_node("LatentBlend")
def latent_blend(ctx: InferenceContext, node: WorkflowNode, samples1=None, samples2=None):
    """blend_factor * s1 + (1 - blend_factor) * s2, resizing s2 to s1's
    spatial dims when needed (nodes.py:1306-1345 LatentBlend)."""
    s1, s2 = _samples(samples1), _samples(samples2)
    factor = _widget(node, 0, 0.5, float)
    if s1.shape[1:3] != s2.shape[1:3]:
        s2 = _resize_image(s2, s1.shape[1], s1.shape[2], "bicubic")
    out = dict(samples1)
    out["samples"] = s1 * factor + s2 * (1.0 - factor)
    return (out,)


@register_node("LatentRotate")
def latent_rotate(ctx: InferenceContext, node: WorkflowNode, samples=None):
    """Rotate by 0/90/180/270 degrees (nodes.py:1220-1242; the reference
    rotates dims [3,2] = (W,H) in NCHW, i.e. clockwise — NHWC dims (2,1))."""
    rotation = str(_widget(node, 0, "none"))
    k = {"9": 1, "1": 2, "2": 3}.get(rotation[:1], 0)
    out = dict(samples)
    out["samples"] = torch.rot90(_samples(samples), k=k, dims=(2, 1))
    return (out,)


@register_node("LatentFlip")
def latent_flip(ctx: InferenceContext, node: WorkflowNode, samples=None):
    """Flip vertically (x-axis) or horizontally (y-axis)
    (nodes.py:1244-1262 LatentFlip; NCHW dim 2 = NHWC dim 1)."""
    method = str(_widget(node, 0, "x-axis: vertically"))
    dim = 1 if method.startswith("x") else 2
    out = dict(samples)
    out["samples"] = torch.flip(_samples(samples), dims=(dim,))
    return (out,)


@register_node("LatentCrop")
def latent_crop(ctx: InferenceContext, node: WorkflowNode, samples=None):
    """Crop a (width, height) window at pixel (x, y), /8 to latent units
    (nodes.py:1347-1378 LatentCrop)."""
    s = _samples(samples)
    width = _widget(node, 0, 512, int)
    height = _widget(node, 1, 512, int)
    x = min(_widget(node, 2, 0, int) // 8, s.shape[2] - 8)
    y = min(_widget(node, 3, 0, int) // 8, s.shape[1] - 8)
    out = dict(samples)
    out["samples"] = s[:, y:y + height // 8, x:x + width // 8]
    return (out,)


@register_node("LatentInterpolate")
def latent_interpolate(ctx: InferenceContext, node: WorkflowNode,
                       samples1=None, samples2=None):
    """Norm-preserving channel-vector slerp-style interpolation
    (comfy_extras/nodes_latent.py:69-100 LatentInterpolate; the reference's
    vector_norm(dim=1) is the NCHW channel axis = NHWC dim -1)."""
    ratio = _widget(node, 0, 1.0, float)
    s1, s2 = _samples(samples1), _samples(samples2)
    if s1.shape[1:3] != s2.shape[1:3]:
        s2 = _resize_image(s2, s1.shape[1], s1.shape[2], "bilinear")
    s2 = _repeat_to_batch(s2, s1.shape[0])
    m1 = torch.linalg.vector_norm(s1, dim=-1, keepdim=True)
    m2 = torch.linalg.vector_norm(s2, dim=-1, keepdim=True)
    n1 = torch.nan_to_num(s1 / m1)
    n2 = torch.nan_to_num(s2 / m2)
    t = n1 * ratio + n2 * (1.0 - ratio)
    mt = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    st = torch.nan_to_num(t / mt)
    out = dict(samples1)
    out["samples"] = st * (m1 * ratio + m2 * (1.0 - ratio))
    return (out,)


@register_node("LatentBatch")
def latent_batch(ctx: InferenceContext, node: WorkflowNode, samples1=None, samples2=None):
    """Concatenate two latent batches, upscaling the second to match
    (comfy_extras/nodes_latent.py:102-123 LatentBatch)."""
    s1, s2 = _samples(samples1), _samples(samples2)
    if s1.shape[1:3] != s2.shape[1:3]:
        s2 = _resize_image(s2, s1.shape[1], s1.shape[2], "bilinear")
    out = dict(samples1)
    out["samples"] = torch.cat([s1, s2], 0)
    out["batch_index"] = (list(samples1.get("batch_index", range(s1.shape[0])))
                          + list(samples2.get("batch_index", range(s2.shape[0]))))
    return (out,)


@register_node("LatentBatchSeedBehavior")
def latent_batch_seed_behavior(ctx: InferenceContext, node: WorkflowNode, samples=None):
    """random: per-sample noise seeds; fixed: all rows share seed index
    (comfy_extras/nodes_latent.py:125-146)."""
    behavior = str(_widget(node, 0, "fixed"))
    out = dict(samples)
    if behavior == "random":
        out.pop("batch_index", None)
    else:
        first = list(samples.get("batch_index", [0]))[0]
        out["batch_index"] = [first] * _samples(samples).shape[0]
    return (out,)


def _composite_masked(destination, source, x, y, mask, multiplier, resize_source):
    """comfy_extras/nodes_mask.py:8-40 composite(), NHWC. Bounds-clamped
    masked paste of source over destination at (x, y) pixel coords."""
    if resize_source:
        source = _resize_image(source, destination.shape[1], destination.shape[2], "bilinear")
    source = _repeat_to_batch(source, destination.shape[0])
    x = max(-source.shape[2] * multiplier, min(x, destination.shape[2] * multiplier))
    y = max(-source.shape[1] * multiplier, min(y, destination.shape[1] * multiplier))
    left, top = x // multiplier, y // multiplier
    if mask is None:
        mask = torch.ones(tuple(source.shape[:3]) + (1,), dtype=source.dtype,
                          device=source.device)
    else:
        mask = mask.to(source.device)
        if mask.dim() == 2:
            mask = mask[None]
        mask = _resize_image(mask[..., None], source.shape[1], source.shape[2], "bilinear")
        mask = _repeat_to_batch(mask, source.shape[0])
    visible_w = destination.shape[2] - left + min(0, x)
    visible_h = destination.shape[1] - top + min(0, y)
    vh = min(visible_h, source.shape[1])
    vw = min(visible_w, source.shape[2])
    if vh <= 0 or vw <= 0:
        return destination
    m = mask[:, :vh, :vw]
    src = source[:, :vh, :vw]
    t0, l0 = max(top, 0), max(left, 0)
    dst_win = destination[:, t0:t0 + vh, l0:l0 + vw]
    hh, ww = dst_win.shape[1], dst_win.shape[2]
    blended = m[:, :hh, :ww] * src[:, :hh, :ww] + (1.0 - m[:, :hh, :ww]) * dst_win
    out = destination.clone()
    out[:, t0:t0 + hh, l0:l0 + ww] = blended
    return out


@register_node("LatentCompositeMasked")
def latent_composite_masked(ctx: InferenceContext, node: WorkflowNode,
                            destination=None, source=None, mask=None):
    """(comfy_extras/nodes_mask.py:42-67 LatentCompositeMasked)"""
    x = _widget(node, 0, 0, int)
    y = _widget(node, 1, 0, int)
    resize = bool(_widget(node, 2, False))
    out = dict(destination)
    out["samples"] = _composite_masked(_samples(destination), _samples(source), x, y,
                                       mask, 8, resize)
    return (out,)


@register_node("ImageCompositeMasked")
def image_composite_masked(ctx: InferenceContext, node: WorkflowNode,
                           destination=None, source=None, mask=None):
    """(comfy_extras/nodes_mask.py:69-92 ImageCompositeMasked)"""
    x = _widget(node, 0, 0, int)
    y = _widget(node, 1, 0, int)
    resize = bool(_widget(node, 2, False))
    return (_composite_masked(destination, source, x, y, mask, 1, resize),)


@register_node("SaveLatent")
def save_latent(ctx: InferenceContext, node: WorkflowNode, samples=None):
    """Write the latent as a safetensors .latent file in the reference's
    sharing format: latent_tensor + latent_format_version_0 marker
    (nodes.py:444-493 SaveLatent), through the port's writer."""
    from stable_renderer_tpu_torch.models.weights import write_safetensors

    prefix = str(_widget(node, 0, "latents/sr_tpu"))
    out_dir = (_output_dir() / prefix).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(prefix).name
    counter = len(list(out_dir.glob(f"{stem}_*.latent")))
    path = out_dir / f"{stem}_{counter:05}_.latent"
    write_safetensors({
        "latent_tensor": _samples(samples).detach().float().cpu(),
        "latent_format_version_0": torch.zeros((0,)),
    }, path)
    ctx.status_messages.append(f"saved latent {path}")
    return (str(path),)


@register_node("LoadLatent")
def load_latent(ctx: InferenceContext, node: WorkflowNode):
    """Load a .latent safetensors file; legacy files without the version
    marker are un-scaled by 1/0.18215 (nodes.py:495-540 LoadLatent); an NCHW
    latent from a torch writer is brought to NHWC."""
    from stable_renderer_tpu_torch.models.weights import read_safetensors

    name = str(_widget(node, 0, ""))
    path = _find_model_file(ctx, name)
    if path is None:
        raise FileNotFoundError(f"latent '{name}' not found")
    data = read_safetensors(path)
    mult = 1.0 if "latent_format_version_0" in data else 1.0 / 0.18215
    arr = data["latent_tensor"].float() * mult
    if arr.dim() == 4 and arr.shape[1] in (4, 16) and arr.shape[-1] not in (4, 16):
        arr = arr.permute(0, 2, 3, 1)  # NCHW latent from a torch writer
    return ({"samples": _on(ctx, arr.contiguous())},)


# ---------------------------------------------------------------------------
# image zoo (nodes.py + comfy_extras/nodes_images.py, nodes_mask.py)


@register_node("EmptyImage")
def empty_image(ctx: InferenceContext, node: WorkflowNode):
    """Solid-color RGB image from a packed 0xRRGGBB int
    (nodes.py:1813-1834 EmptyImage)."""
    width = _widget(node, 0, 512, int)
    height = _widget(node, 1, 512, int)
    batch = _widget(node, 2, 1, int)
    color = _widget(node, 3, 0, int)
    rgb = torch.tensor([(color >> 16) & 0xFF, (color >> 8) & 0xFF, color & 0xFF],
                       dtype=torch.float32, device=ctx.device) / 255.0
    return (rgb.expand(batch, height, width, 3).contiguous(),)


@register_node("ImageCrop")
def image_crop(ctx: InferenceContext, node: WorkflowNode, image=None):
    """(comfy_extras/nodes_images.py:14-34 ImageCrop)"""
    width = _widget(node, 0, 512, int)
    height = _widget(node, 1, 512, int)
    x = min(_widget(node, 2, 0, int), image.shape[2] - 1)
    y = min(_widget(node, 3, 0, int), image.shape[1] - 1)
    return (image[:, y:y + height, x:x + width, :],)


@register_node("RepeatImageBatch")
def repeat_image_batch(ctx: InferenceContext, node: WorkflowNode, image=None):
    """(comfy_extras/nodes_images.py:36-49 RepeatImageBatch)"""
    amount = _widget(node, 0, 1, int)
    return (image.repeat(amount, 1, 1, 1),)


@register_node("ImageFromBatch")
def image_from_batch(ctx: InferenceContext, node: WorkflowNode, image=None):
    """(comfy_extras/nodes_images.py:51-68 ImageFromBatch)"""
    batch_index = min(image.shape[0] - 1, _widget(node, 0, 0, int))
    length = min(image.shape[0] - batch_index, _widget(node, 1, 1, int))
    return (image[batch_index:batch_index + length],)


@register_node("ImageColorToMask")
def image_color_to_mask(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Mask = 1 where the pixel equals the packed 0xRRGGBB color
    (comfy_extras/nodes_mask.py:132-151 ImageColorToMask)."""
    color = _widget(node, 0, 0, int)
    quant = torch.round(torch.clamp(image, 0.0, 1.0) * 255.0).to(torch.int32)
    packed = (quant[..., 0] << 16) | (quant[..., 1] << 8) | quant[..., 2]
    return ((packed == color).to(torch.float32),)


@register_node("CropMask")
def crop_mask(ctx: InferenceContext, node: WorkflowNode, mask=None):
    """(comfy_extras/nodes_mask.py:193-215 CropMask)"""
    m = _on(ctx, mask)
    if m.dim() == 2:
        m = m[None]
    x = _widget(node, 0, 0, int)
    y = _widget(node, 1, 0, int)
    width = _widget(node, 2, 512, int)
    height = _widget(node, 3, 512, int)
    return (m[:, y:y + height, x:x + width],)


@register_node("LoadImageMask")
def load_image_mask(ctx: InferenceContext, node: WorkflowNode):
    """Load one channel of an image as a mask, read on the host; alpha is
    inverted (nodes.py:1682-1725 LoadImageMask)."""
    name = str(_widget(node, 0, ""))
    channel = str(_widget(node, 1, "alpha"))
    path = _find_model_file(ctx, name)
    if path is None:
        logger.warning(f"LoadImageMask: '{name}' not found; zeros(64,64)")
        return (torch.zeros((1, 64, 64), device=ctx.device),)
    from PIL import Image

    pil = Image.open(path)
    if pil.mode == "I":
        pil = pil.point(lambda v: v * (1 / 255))
    pil = pil.convert("RGBA")
    c = channel[0].upper()
    arr = np.asarray(pil.getchannel(c), np.float32) / 255.0
    if c == "A":
        arr = 1.0 - arr
    return (_on(ctx, arr)[None],)


@register_node("ImageScaleToTotalPixels")
def image_scale_to_total_pixels(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Scale preserving aspect to hit a megapixel budget
    (comfy_extras/nodes_post_processing.py ImageScaleToTotalPixels)."""
    method = str(_widget(node, 0, "bilinear"))
    megapixels = _widget(node, 1, 1.0, float)
    total = megapixels * 1024 * 1024
    scale = math.sqrt(total / (image.shape[1] * image.shape[2]))
    h = round(image.shape[1] * scale)
    w = round(image.shape[2] * scale)
    return (_resize_image(image, h, w, method),)


@register_node("Canny")
def canny_node(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Canny edge preprocessor (comfy_extras/nodes_canny.py Canny; the
    pipeline lives in ops/canny.py)."""
    from stable_renderer_tpu_torch.ops.canny import canny

    low = _widget(node, 0, 0.4, float)
    high = _widget(node, 1, 0.8, float)
    return (canny(image, low, high),)


def _save_animated(images, fps: float, suffix: str, **pil_kwargs) -> str:
    from PIL import Image

    out_dir = _output_dir() / "workflow"
    out_dir.mkdir(parents=True, exist_ok=True)
    host = images.detach().float().cpu().numpy()
    frames = [Image.fromarray(np.clip(f * 255.0, 0, 255).astype(np.uint8)) for f in host]
    counter = len(list(out_dir.glob(f"anim_*{suffix}")))
    path = out_dir / f"anim_{counter:05}{suffix}"
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=round(1000.0 / max(fps, 0.01)), **pil_kwargs)
    return str(path)


@register_node("SaveAnimatedWEBP")
def save_animated_webp(ctx: InferenceContext, node: WorkflowNode, images=None):
    """(comfy_extras/nodes_images.py SaveAnimatedWEBP)"""
    fps = _widget(node, 1, 6.0, float)
    lossless = bool(_widget(node, 2, True))
    quality = _widget(node, 3, 80, int)
    method = str(_widget(node, 4, "default"))
    methods = {"default": 4, "fastest": 0, "slowest": 6}
    path = _save_animated(images, fps, ".webp", lossless=lossless, quality=quality,
                          method=methods.get(method, 4))
    ctx.status_messages.append(f"saved {path}")
    return (images,)


@register_node("SaveAnimatedPNG")
def save_animated_png(ctx: InferenceContext, node: WorkflowNode, images=None):
    """(comfy_extras/nodes_images.py SaveAnimatedPNG — APNG writer)"""
    fps = _widget(node, 1, 6.0, float)
    compress_level = _widget(node, 2, 4, int)
    path = _save_animated(images, fps, ".png", compress_level=compress_level)
    ctx.status_messages.append(f"saved {path}")
    return (images,)


# ---------------------------------------------------------------------------
# conditioning (nodes.py + nodes_clip_sdxl.py + nodes_cond.py)


@register_node("ConditioningAverage")
def conditioning_average(ctx: InferenceContext, node: WorkflowNode,
                         conditioning_to=None, conditioning_from=None):
    """Weighted average of two conditionings; the shorter context is
    zero-padded on the token axis (nodes.py:79-120 ConditioningAverage)."""
    strength = _widget(node, 0, 1.0, float)
    t1 = conditioning_to["context"]
    t0 = conditioning_from["context"][:, :t1.shape[1]]
    if t0.shape[1] < t1.shape[1]:
        pad = torch.zeros((t0.shape[0], t1.shape[1] - t0.shape[1], t1.shape[2]),
                          dtype=t0.dtype, device=t0.device)
        t0 = torch.cat([t0, pad], 1)
    out = dict(conditioning_to)
    out["context"] = t1 * strength + t0 * (1.0 - strength)
    p1 = conditioning_to.get("pooled")
    p0 = conditioning_from.get("pooled")
    if p1 is not None and p0 is not None:
        out["pooled"] = p1 * strength + p0 * (1.0 - strength)
    elif p0 is not None:
        out["pooled"] = p0
    return (out,)


@register_node("ConditioningSetAreaStrength")
def conditioning_set_area_strength(ctx: InferenceContext, node: WorkflowNode,
                                   conditioning=None):
    """(nodes.py ConditioningSetAreaStrength — strength only)"""
    strength = _widget(node, 0, 1.0, float)
    return ({**conditioning, "strength": strength},)


def _encode_tower(ctx: InferenceContext, clip: dict, text_l: str, text_g: Optional[str] = None):
    """(context, pooled) of one prompt, as the JAX package's node helper:
    CLIP-G alone for a refiner's ``g_only`` CLIP (``text_g`` drives it), the
    dual-tower SDXL encode when the CLIP carries a G tower, else the weighted
    single tower (sd1_clip.py SD1ClipModel, sdxl_clip.py SDXLClipModel).

    Split prompts (``text_g`` != ``text_l``) run the dual encode once a text
    and take the L columns of the one and the G columns of the other; the
    shorter chunk stream is padded with zeros, and pooled is ``text_g``'s."""
    from stable_renderer_tpu_torch.models.clip import (
        encode_token_weights_batch,
        encode_token_weights_batch_g,
        encode_token_weights_batch_xl,
    )

    dev = ctx.device

    def tokens(text):
        ids, w, custom = clip["tokenizer"].tokenize_weighted_batch([text])
        return (torch.as_tensor(ids, device=dev), torch.as_tensor(w, device=dev),
                None if custom is None else torch.as_tensor(custom, device=dev))

    if clip.get("g_only"):
        ids, w, _ = tokens(text_g if text_g is not None else text_l)
        return encode_token_weights_batch_g(clip["clip_g"], clip["params_g"], ids, w,
                                            clip_skip=int(clip.get("clip_skip", -2)))
    if clip.get("clip_g") is not None:
        def enc(text):
            return encode_token_weights_batch_xl(clip["clip"], clip["clip_g"], clip["params"],
                                                 clip["params_g"], *tokens(text),
                                                 clip_skip=int(clip.get("clip_skip", -2)))

        if text_g is None or text_g == text_l:
            return enc(text_l)
        z_l, _ = enc(text_l)
        z_g, pooled = enc(text_g)
        length = max(z_l.shape[1], z_g.shape[1])
        z_l, z_g = (F.pad(z, (0, 0, 0, length - z.shape[1])) for z in (z_l, z_g))
        d_l = clip["clip"].config.hidden_size
        return torch.cat([z_l[..., :d_l], z_g[..., d_l:]], dim=-1), pooled
    ids, w, custom = tokens(text_l)
    return encode_token_weights_batch(clip["clip"], clip["params"], ids, w, custom,
                                      clip_skip=int(clip.get("clip_skip", -1)))


@register_node("CLIPTextEncodeSDXL")
def clip_text_encode_sdxl(ctx: InferenceContext, node: WorkflowNode, clip=None):
    """SDXL's dual-prompt encode with the size and crop ADM vector
    (comfy_extras/nodes_clip_sdxl.py CLIPTextEncodeSDXL, model_base.py
    SDXL.encode_adm): widgets width, height, crop_w, crop_h, target_width,
    target_height, text_g, text_l."""
    from stable_renderer_tpu_torch.models.sdxl import sdxl_adm_vector

    width = _widget(node, 0, 1024, int)
    height = _widget(node, 1, 1024, int)
    crop_w = _widget(node, 2, 0, int)
    crop_h = _widget(node, 3, 0, int)
    target_width = _widget(node, 4, 1024, int)
    target_height = _widget(node, 5, 1024, int)
    text_g = str(_widget(node, 6, ""))
    text_l = str(_widget(node, 7, text_g))
    context, pooled = _encode_tower(ctx, clip, text_l, text_g)
    cond = {"context": context, "pooled": pooled, "controls": [], "prompt": text_g}
    if pooled is not None:
        cond["y"] = sdxl_adm_vector(pooled, original_size=(height, width),
                                    crop=(crop_h, crop_w),
                                    target_size=(target_height, target_width))
    return (cond,)


@register_node("CLIPTextEncodeSDXLRefiner")
def clip_text_encode_sdxl_refiner(ctx: InferenceContext, node: WorkflowNode, clip=None):
    """The refiner's encode with the aesthetic-score ADM vector
    (nodes_clip_sdxl.py CLIPTextEncodeSDXLRefiner, model_base.py
    SDXLRefiner.encode_adm): widgets ascore, width, height, text."""
    from stable_renderer_tpu_torch.models.sdxl import sdxl_refiner_adm_vector

    ascore = _widget(node, 0, 6.0, float)
    width = _widget(node, 1, 1024, int)
    height = _widget(node, 2, 1024, int)
    text = str(_widget(node, 3, ""))
    context, pooled = _encode_tower(ctx, clip, text, text)
    cond = {"context": context, "pooled": pooled, "controls": [], "prompt": text}
    if pooled is not None:
        cond["y"] = sdxl_refiner_adm_vector(pooled, original_size=(height, width),
                                            aesthetic_score=ascore)
    return (cond,)


@register_node("CLIPTextEncodeControlnet")
def clip_text_encode_controlnet(ctx: InferenceContext, node: WorkflowNode,
                                clip=None, conditioning=None):
    """Attach a separate text encoding for controlnets that take their own
    prompt (comfy_extras/nodes_cond.py CLIPTextEncodeControlnet —
    cross_attn_controlnet)."""
    text = str(_widget(node, 0, ""))
    context, pooled = _encode_tower(ctx, clip, text)
    return ({**conditioning, "controlnet_context": context,
             "controlnet_pooled": pooled},)


# ---------------------------------------------------------------------------
# loaders (nodes.py advanced/loaders)


@register_node("VAELoader")
def vae_loader(ctx: InferenceContext, node: WorkflowNode):
    """Standalone VAE checkpoint loader (nodes.py VAELoader; accepts bare
    VAE state dicts or full checkpoints' first_stage_model.* subtree), in
    bf16; a tiny random VAE when the file is absent."""
    from stable_renderer_tpu_torch.models import vae as vae_mod
    from stable_renderer_tpu_torch.models.weights import load_state_dict, nest, tree_to

    name = str(_widget(node, 0, ""))
    path = _find_model_file(ctx, name)
    if path is None:
        logger.warning(f"VAE '{name}' not found; tiny random VAE")
        vae = vae_mod.VAE(vae_mod.TINY_VAE_CONFIG)
        return ({"vae": vae, "params": vae.init(_generator(ctx, 1), device=ctx.device)},)
    flat = load_state_dict(path)
    if any(k.startswith("first_stage_model.") for k in flat):
        flat = {k[len("first_stage_model."):]: v for k, v in flat.items()
                if k.startswith("first_stage_model.")}
    return ({"vae": vae_mod.VAE(vae_mod.SD15_VAE_CONFIG),
             "params": tree_to(nest(flat, ""), ctx.device, torch.bfloat16)},)


@register_node("CLIPLoader")
def clip_loader(ctx: InferenceContext, node: WorkflowNode):
    """Standalone text-encoder loader (nodes.py CLIPLoader): the file's
    tree, its ``cond_stage_model.transformer.``, ``text_model.`` or
    ``transformer.`` prefix stripped, in f32 behind the SD1.x CLIP-L model,
    as the JAX package's node loads every file (an OpenCLIP file's leaves
    too, which that model cannot encode: queue 3 of ROADMAP.md); a tiny
    random CLIP when the file is absent."""
    from stable_renderer_tpu_torch.models import clip as clip_mod
    from stable_renderer_tpu_torch.models.weights import load_state_dict, nest, tree_to

    name = str(_widget(node, 0, ""))
    path = _find_model_file(ctx, name)
    if path is None:
        logger.warning(f"CLIP '{name}' not found; tiny random CLIP")
        clip = clip_mod.CLIPTextModel(clip_mod.TINY_CLIP_CONFIG)
        return ({"clip": clip, "params": clip.init(_generator(ctx, 2), device=ctx.device),
                 "tokenizer": clip_mod.Tokenizer(clip_mod.TINY_CLIP_CONFIG)},)
    flat = load_state_dict(path)
    for prefix in ("cond_stage_model.transformer.", "text_model.", "transformer."):
        if any(k.startswith(prefix) for k in flat):
            flat = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
            break
    cfg = clip_mod.SD15_CLIP_CONFIG
    return ({"clip": clip_mod.CLIPTextModel(cfg),
             "params": tree_to(nest(flat, ""), ctx.device, torch.float32),
             "tokenizer": clip_mod.Tokenizer(cfg)},)


@register_node("DualCLIPLoader")
def dual_clip_loader(ctx: InferenceContext, node: WorkflowNode):
    """SDXL's two text encoders in one CLIP (nodes.py DualCLIPLoader): a
    CLIP-L file (SD1.x's config) and a CLIP-G file (SDXL's), each tree as the
    file holds it, in f32. Without both files, tiny random towers: CLIP-L at
    the tiny UNet's context width and a 2-layer CLIP-G of the same width,
    drawn from generators seeded with 3 and 4."""
    from stable_renderer_tpu_torch.models import clip as clip_mod
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG
    from stable_renderer_tpu_torch.models.weights import load_state_dict, nest, tree_to

    path_l = _find_model_file(ctx, str(_widget(node, 0, "")))
    path_g = _find_model_file(ctx, str(_widget(node, 1, "")))
    if path_l is None or path_g is None:
        logger.warning("DualCLIPLoader: checkpoints not found; tiny random towers")
        ccfg = replace(clip_mod.TINY_CLIP_CONFIG, hidden_size=TINY_UNET_CONFIG.context_dim)
        gcfg = clip_mod.OpenCLIPConfig(vocab_size=ccfg.vocab_size, width=ccfg.hidden_size,
                                       num_layers=2, num_heads=2, max_length=ccfg.max_length,
                                       projection_dim=ccfg.hidden_size)
        clip_l, clip_g = clip_mod.CLIPTextModel(ccfg), clip_mod.OpenCLIPTextModel(gcfg)
        return ({"clip": clip_l, "params": clip_l.init(_generator(ctx, 3), device=ctx.device),
                 "clip_g": clip_g,
                 "params_g": clip_g.init(_generator(ctx, 4), device=ctx.device),
                 "tokenizer": clip_mod.Tokenizer(ccfg)},)
    cfg = clip_mod.SD15_CLIP_CONFIG
    return ({"clip": clip_mod.CLIPTextModel(cfg),
             "params": tree_to(nest(load_state_dict(path_l), ""), ctx.device, torch.float32),
             "clip_g": clip_mod.OpenCLIPTextModel(clip_mod.SDXL_CLIP_G_CONFIG),
             "params_g": {"model": tree_to(nest(load_state_dict(path_g), ""), ctx.device,
                                           torch.float32)},
             "tokenizer": clip_mod.Tokenizer(cfg)},)


@register_node("LoraLoader")
def lora_loader(ctx: InferenceContext, node: WorkflowNode, model=None, clip=None):
    """LoRA merge into BOTH the UNet and the text encoder
    (nodes.py LoraLoader; the model-only variant is LoraLoaderModelOnly)."""
    name = str(_widget(node, 0, ""))
    strength_model = _widget(node, 1, 1.0, float)
    strength_clip = _widget(node, 2, 1.0, float)
    path = _find_model_file(ctx, name)
    if path is None:
        logger.warning(f"lora '{name}' not found; passing through")
        return model, clip
    from stable_renderer_tpu_torch.models.lora import merge_lora
    from stable_renderer_tpu_torch.models.weights import load_state_dict

    flat = load_state_dict(path)
    out_model = model
    if strength_model != 0.0 and model is not None:
        out_model = {**model, "params": merge_lora(model["params"], flat, strength_model,
                                                   prefix="lora_unet_")[0]}
    out_clip = clip
    if strength_clip != 0.0 and clip is not None:
        out_clip = {**clip, "params": merge_lora(clip["params"], flat, strength_clip,
                                                 prefix="lora_te_")[0]}
    return out_model, out_clip


@register_node("CheckpointLoader")
def checkpoint_loader_config(ctx: InferenceContext, node: WorkflowNode):
    """Config-file checkpoint loader (nodes.py CheckpointLoader). The config
    widget is accepted for workflow compatibility; the architecture is
    detected from the state dict (models/weights.py), as
    CheckpointLoaderSimple loads it."""
    from stable_renderer_tpu_torch.workflow.executor import checkpoint_loader

    inner = WorkflowNode(id=node.id, type="CheckpointLoaderSimple",
                         widgets=list(node.widgets[1:2]), inputs=node.inputs)
    return checkpoint_loader(ctx, inner)


@register_node("unCLIPCheckpointLoader")
def unclip_checkpoint_loader(ctx: InferenceContext, node: WorkflowNode):
    """An unCLIP checkpoint -> (MODEL, CLIP, VAE, CLIP_VISION) (nodes.py
    unCLIPCheckpointLoader). The embedded CLIP vision tower is read from
    ``embedder.model.visual.*`` in the transformers layout only, as the JAX
    package reads it: any other layout (open_clip's ``transformer.resblocks``)
    warns and, like a missing file, falls back to the tiny random tower."""
    from stable_renderer_tpu_torch.models.clip_vision import (
        TINY_VISION_CONFIG,
        CLIPVisionModel,
        detect_vision_config,
    )
    from stable_renderer_tpu_torch.models.weights import load_state_dict, nest, tree_to
    from stable_renderer_tpu_torch.workflow.executor import checkpoint_loader

    model, clip, vae = checkpoint_loader(ctx, node)
    path = _find_model_file(ctx, str(_widget(node, 0, "")))
    clip_vision = None
    if path is not None:
        prefix = "embedder.model.visual."
        sub = {k[len(prefix):]: v for k, v in load_state_dict(path).items()
               if k.startswith(prefix)}
        cfg = detect_vision_config(sub.keys()) if sub else None
        if cfg is not None:
            clip_vision = {"model": CLIPVisionModel(cfg),
                           "params": tree_to(nest(sub, ""), ctx.device)}
        elif sub:
            logger.warning("unCLIP embedder layout unrecognized; "
                           "load a CLIP vision checkpoint separately")
    if clip_vision is None:
        m = CLIPVisionModel(TINY_VISION_CONFIG)
        clip_vision = {"model": m, "params": m.init(_generator(ctx, 5), device=ctx.device)}
    return model, clip, vae, clip_vision


@register_node("DiffusersLoader")
def diffusers_loader(ctx: InferenceContext, node: WorkflowNode):
    """Diffusers-layout model directory -> (MODEL, CLIP, VAE)
    (nodes.py DiffusersLoader; models/diffusers_convert.py remaps the key
    layout into the comfy flat layout the normal loader consumes): the UNet
    and VAE in bf16, the CLIP in f32."""
    name = str(_widget(node, 0, ""))
    base = None
    for d in ctx.model_dirs:
        cand = Path(d) / name
        if (cand / "model_index.json").exists() or (cand / "unet").exists():
            base = cand
            break
    if base is None and (Path(name) / "unet").exists():
        base = Path(name)
    if base is None:
        raise FileNotFoundError(f"diffusers model dir '{name}' not found")
    from stable_renderer_tpu_torch.models import clip as clip_mod, vae as vae_mod
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.weights import load_checkpoint, tree_to

    unet_p, vae_p, clip_p, ucfg, _ = load_checkpoint(str(base))  # other families raise
    model = {"unet": UNetModel(ucfg),
             "params": tree_to(unet_p, ctx.device, torch.bfloat16),
             "sampling": ModelSampling()}
    vae = {"vae": vae_mod.VAE(vae_mod.SD15_VAE_CONFIG),
           "params": tree_to(vae_p, ctx.device, torch.bfloat16)}
    clip = {"clip": clip_mod.CLIPTextModel(clip_mod.SD15_CLIP_CONFIG),
            "params": tree_to(clip_p, ctx.device, torch.float32),
            "tokenizer": clip_mod.Tokenizer(clip_mod.SD15_CLIP_CONFIG)}
    return model, clip, vae


@register_node("StyleModelLoader")
def style_model_loader(ctx: InferenceContext, node: WorkflowNode):
    """A T2I style adapter (nodes.py StyleModelLoader; sd.py:383
    StyleModel), the file's dtypes kept; without the file, a tiny random
    one (width 64, context 32)."""
    from stable_renderer_tpu_torch.models.t2i_adapter import (
        StyleAdapter,
        StyleAdapterConfig,
        load_style_model,
    )
    from stable_renderer_tpu_torch.models.weights import load_state_dict, tree_to

    name = str(_widget(node, 0, ""))
    path = _find_model_file(ctx, name)
    if path is None:
        logger.warning(f"style model '{name}' not found; tiny random")
        sa = StyleAdapter(StyleAdapterConfig(width=64, context_dim=32, num_head=4, n_layers=2,
                                             num_token=4))
        return ({"model": sa, "params": sa.init(_generator(ctx, 6), device=ctx.device)},)
    sa, params = load_style_model(load_state_dict(path))
    return ({"model": sa, "params": tree_to(params, ctx.device)},)


def _vision_tokens(clip_vision_output) -> torch.Tensor:
    """The vision tower's last hidden state: CLIPVisionEncode's dict entry,
    or the attribute of a VisionOutput (the JAX node reads the attribute
    only, and so fails on CLIPVisionEncode's dict: ROADMAP queue 3)."""
    if isinstance(clip_vision_output, dict):
        return clip_vision_output["last_hidden_state"]
    return clip_vision_output.last_hidden_state


@register_node("StyleModelApply")
def style_model_apply(ctx: InferenceContext, node: WorkflowNode, conditioning=None,
                      style_model=None, clip_vision_output=None):
    """Append the style tokens to the text context on the token axis
    (nodes.py StyleModelApply: torch.cat((t, style_cond), dim=1)), computed
    in f32 from the vision tokens."""
    tokens = style_model["model"].apply(style_model["params"],
                                        _on(ctx, _vision_tokens(clip_vision_output)).float())
    ctx_t = conditioning["context"]
    tokens = tokens[:1].expand((ctx_t.shape[0],) + tuple(tokens.shape[1:]))
    return ({**conditioning, "context": torch.cat([ctx_t, tokens.to(ctx_t.dtype)], dim=1)},)


@register_node("DiffControlNetLoader")
def diff_controlnet_loader(ctx: InferenceContext, node: WorkflowNode, model=None):
    """Difference-format controlnet loader (nodes.py DiffControlNetLoader):
    diff checkpoints store controlnet-minus-base weights; the base model's
    matching tensors are added back when the KSampler reads the control
    (executor.load_control). The value stays lazy like ControlNetLoader's."""
    name = str(_widget(node, 0, ""))
    path = _find_model_file(ctx, name)
    return ({"name": name, "path": path, "diff_base": model},)


@register_node("VAEDecodeTiled")
def vae_decode_tiled(ctx: InferenceContext, node: WorkflowNode, samples=None, vae=None):
    """Tiled VAE decode (nodes.py VAEDecodeTiled; models/vae.py decode_tiled
    host loop over overlapping latent tiles), in the VAE's dtype."""
    tile = _widget(node, 0, 512, int)
    dtype = vae["params"]["quant_conv"]["weight"].dtype
    z = _on(ctx, _samples(samples))
    img = vae["vae"].decode_tiled(vae["params"], z.to(dtype), tile=max(tile // 8, 8))
    return (torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0),)


@register_node("VAEEncodeTiled")
def vae_encode_tiled(ctx: InferenceContext, node: WorkflowNode, pixels=None, vae=None):
    """Tiled VAE encode (nodes.py VAEEncodeTiled)."""
    tile = _widget(node, 0, 512, int)
    dtype = vae["params"]["quant_conv"]["weight"].dtype
    z = vae["vae"].encode_tiled(vae["params"], (_on(ctx, pixels)[..., :3] * 2.0 - 1.0).to(dtype),
                                tile=tile)
    return ({"samples": z.float()},)


# ---------------------------------------------------------------------------
# advanced model patches (nodes_model_advanced.py + nodes_model_downscale.py)


@register_node("ModelSamplingDiscrete")
def model_sampling_discrete(ctx: InferenceContext, node: WorkflowNode, model=None):
    """Swap the model's sampling schedule/prediction (nodes_model_advanced.py
    ModelSamplingDiscrete: eps | v_prediction | lcm | x0, optional
    zero-terminal-SNR sigma rescale)."""
    from stable_renderer_tpu_torch.models.sampling.schedules import (
        ModelSampling,
        rescale_zero_terminal_snr_sigmas,
    )

    sampling = str(_widget(node, 0, "eps"))
    zsnr = bool(_widget(node, 1, False))
    pred = {"eps": "eps", "v_prediction": "v", "lcm": "lcm", "x0": "x0"}[sampling]
    ms = ModelSampling(prediction=pred)
    if zsnr:
        ms.set_sigmas(rescale_zero_terminal_snr_sigmas(ms.sigmas))
    return ({**model, "sampling": ms},)


@register_node("ModelSamplingContinuousEDM")
def model_sampling_continuous_edm(ctx: InferenceContext, node: WorkflowNode, model=None):
    """EDM sampling between the node's sigma bounds (nodes_model_advanced.py
    ModelSamplingContinuousEDM): v_prediction or eps."""
    from stable_renderer_tpu_torch.models.sampling.schedules import ModelSamplingEDM

    sampling = str(_widget(node, 0, "v_prediction"))
    sigma_max = _widget(node, 1, 120.0, float)
    sigma_min = _widget(node, 2, 0.002, float)
    ms = ModelSamplingEDM(prediction="v" if sampling == "v_prediction" else "eps",
                          edm_sigma_min=sigma_min, edm_sigma_max=sigma_max)
    return ({**model, "sampling": ms},)


@register_node("ModelSamplingStableCascade")
def model_sampling_stable_cascade(ctx: InferenceContext, node: WorkflowNode, model=None):
    """Stable Cascade's cosine sampling at the node's shift
    (nodes_model_advanced.py ModelSamplingStableCascade)."""
    from stable_renderer_tpu_torch.models.sampling.schedules import ModelSamplingCascade

    return ({**model, "sampling": ModelSamplingCascade(shift=_widget(node, 0, 2.0, float))},)


@register_node("RescaleCFG")
def rescale_cfg(ctx: InferenceContext, node: WorkflowNode, model=None):
    """v-space CFG rescale patch (nodes_model_advanced.py:173-210 RescaleCFG;
    the math runs inside the denoiser's CFG combine)."""
    multiplier = _widget(node, 0, 0.7, float)
    return (_add_patch(model, {"kind": "rescale_cfg", "sig": ("rescale_cfg", multiplier),
                               "multiplier": multiplier}),)


@register_node("PatchModelAddDownscale")
def patch_model_add_downscale(ctx: InferenceContext, node: WorkflowNode, model=None):
    """Kohya Deep Shrink (nodes_model_downscale.py PatchModelAddDownscale),
    as the JAX package applies it: a sigma-gated low-pass (down + up) at the
    patched input block, shapes unchanged (nodes_extra._make_downscale_in_block)."""
    block_number = _widget(node, 0, 3, int)
    factor = _widget(node, 1, 2.0, float)
    start_percent = _widget(node, 2, 0.0, float)
    end_percent = _widget(node, 3, 0.35, float)
    after_skip = bool(_widget(node, 4, True))
    down_m = str(_widget(node, 5, "bicubic"))
    up_m = str(_widget(node, 6, "bicubic"))
    return (_add_patch(model, {
        "kind": "downscale",
        "sig": ("downscale", block_number, factor, start_percent, end_percent,
                after_skip, down_m, up_m),
        "block_number": block_number, "downscale_factor": factor,
        "start_percent": start_percent, "end_percent": end_percent,
        "after_skip": after_skip, "downscale_method": down_m,
        "upscale_method": up_m}),)


# ---------------------------------------------------------------------------
# stragglers (nodes_stable_cascade.py / nodes_stable3d.py)

@register_node("StableCascade_StageC_VAEEncode")
def stable_cascade_stage_c_vae_encode(ctx: InferenceContext, node: WorkflowNode, image=None,
                                      vae=None):
    """Pixels -> a Stage C latent at the requested compression and an empty
    Stage B latent (nodes_stable_cascade.py:51-83). It encodes with the VAE
    it is given, as the JAX package does: the image is resized (bicubic) to
    (size // compression) times the VAE's downscale ratio (2^(levels-1);
    32, the effnet encoder's, for a VAE without a config)."""
    from stable_renderer_tpu_torch.models.sampling.cfg import _params_dtype

    compression = _widget(node, 0, 42, int)
    image = _on(ctx, image)
    height, width = image.shape[1], image.shape[2]
    cfg = getattr(vae["vae"], "config", None)
    ratio = 2 ** (len(cfg.ch_mult) - 1) if cfg is not None else 32
    out_w = max(ratio, (width // compression) * ratio)
    out_h = max(ratio, (height // compression) * ratio)
    s = _resize_image(image[..., :3], out_h, out_w, "bicubic")
    c_latent = vae["vae"].encode(vae["params"], (s * 2.0 - 1.0).to(_params_dtype(vae["params"])))
    b_latent = torch.zeros((c_latent.shape[0], height // 4, width // 4, 4), device=ctx.device)
    return {"samples": c_latent.float()}, {"samples": b_latent}


@register_node("StableZero123_Conditioning_Batched")
def stable_zero123_conditioning_batched(ctx: InferenceContext, node: WorkflowNode,
                                        clip_vision=None, init_image=None, vae=None):
    """Batched Zero123 conditioning (nodes_stable3d.py:56-99): one camera
    row a batch entry, stepped by the elevation and azimuth increments;
    batch_index pinned to 0 so every view shares the noise seed."""
    width = _widget(node, 0, 256, int)
    height = _widget(node, 1, 256, int)
    batch_size = _widget(node, 2, 1, int)
    elevation = _widget(node, 3, 0.0, float)
    azimuth = _widget(node, 4, 0.0, float)
    elev_inc = _widget(node, 5, 0.0, float)
    azim_inc = _widget(node, 6, 0.0, float)
    pooled, t = zero123_latent(clip_vision, _on(ctx, init_image), vae, width, height)
    cam = torch.tensor([zero123_camera(elevation + elev_inc * i, azimuth + azim_inc * i)
                        for i in range(batch_size)], dtype=torch.float32,
                       device=pooled.device)[:, None, :]
    cond_ctx = torch.cat([pooled.expand(batch_size, 1, pooled.shape[-1]), cam], dim=-1)
    t_b = _repeat_to_batch(t, batch_size)
    positive = {"context": cond_ctx, "controls": [], "concat_latent_image": t_b,
                "prompt": "zero123"}
    negative = {"context": torch.zeros_like(cond_ctx), "controls": [],
                "concat_latent_image": torch.zeros_like(t_b), "prompt": ""}
    latent = {"samples": torch.zeros((batch_size, height // 8, width // 8, 4), device=ctx.device),
              "batch_index": [0] * batch_size}
    return positive, negative, latent
