"""Stable-rendering workflow nodes: sequence loaders and processing utilities.

Counterpart of stable_renderer_tpu/workflow/nodes_sr.py (reference
source/comfyUI/stable_rendering/_nodes/{loaders,data,processing}):

  * sequence loaders — ImageSequenceLoader, NoiseSequenceLoader,
    CreateNoiseSequenceFromIdMap, CreateIdenticalNoiseSequence,
    IDSequenceLoader (loaders.py:19-340) and their legacy forms.
  * VirtualEngineDataNode — compose an EngineData from explicit map inputs
    when running without the engine (data.py:71-105).
  * processing — RemoveBGNode, RGBAToRGB, RGBAThreshold (processing/img.py),
    TextConcat, TextReplace (processing/text.py), SimpleVideoCombine
    (processing/video.py).

Files are read on the host; the tensors go to the context's device. LATENT
values are {"samples", "noise"} dicts: the KSampler takes the "noise" slot,
as the reference's LATENT(noise=...). The noise nodes split into a function
of their draws (``noise_from_id_map``, ``identical_noise``) and a node that
draws them from a generator seeded with the seed widget.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.utils.log import get_logger
from stable_renderer_tpu_torch.workflow.executor import (
    InferenceContext,
    WorkflowNode,
    _generator,
    _on,
    register_node,
    widget as _widget,
)

logger = get_logger("sr_tpu_torch.nodes_sr")


_SD_SIZES = {"SD15": 512, "SDXL": 1024}


def _sd_size(sd_version: str) -> int:
    if sd_version not in _SD_SIZES:
        raise ValueError("sd_version should be either SD15 or SDXL")
    return _SD_SIZES[sd_version]


# ---------------------------------------------------------------------------
# sequence loaders (_nodes/loaders.py)


@register_node("ImageSequenceLoader")
def image_sequence_loader(ctx: InferenceContext, node: WorkflowNode, directory=None):
    """Numbered image dir -> (N, size, size, 3) float32, resized (nearest) to
    the SD version's canvas (loaders.py:19-77 ImageSequenceLoader)."""
    from stable_renderer_tpu_torch.data.loaders import load_image_sequence
    from stable_renderer_tpu_torch.workflow.nodes_extra import _resize_image

    # directory is forceInput in the reference; accept it as a widget too,
    # shifting the remaining widget offsets
    off = 0
    if directory is None:
        directory = str(_widget(node, 0, ""))
        off = 1
    frame_start = _widget(node, off + 0, 0, int)
    num_frames = _widget(node, off + 1, 16, int)
    size = _sd_size(str(_widget(node, off + 2, "SD15")))
    x = _on(ctx, load_image_sequence(directory, frame_start, num_frames))
    if tuple(x.shape[1:3]) != (size, size):
        x = _resize_image(x, size, size, "nearest")
    return (x,)


@register_node("NoiseSequenceLoader")
def noise_sequence_loader(ctx: InferenceContext, node: WorkflowNode, directory=None):
    """Dumped noise .npy dir -> LATENT with the reference's block-mean
    downsample to latent resolution + AdaIN renormalization against the
    full-res noise (loaders.py:79-152). samples is zeros: only the noise
    slot carries data, as LATENT(samples=zeros_like(noise), noise=noise)."""
    from stable_renderer_tpu_torch.data.loaders import load_noise_sequence

    off = 0
    if directory is None:
        directory = str(_widget(node, 0, ""))
        off = 1
    frame_start = _widget(node, off + 0, 0, int)
    num_frames = _widget(node, off + 1, 16, int)
    sd_version = str(_widget(node, off + 2, "SD15"))
    block = _sd_size(sd_version) // 8  # 64 for SD15, 128 for SDXL
    height = load_noise_sequence(directory, frame_start, 1, pool=1).shape[1]
    if height % block != 0:
        raise ValueError(f"noise height {height} not divisible by {block} for {sd_version}")
    noise = _on(ctx, load_noise_sequence(directory, frame_start, num_frames,
                                         pool=height // block))
    return ({"samples": torch.zeros_like(noise), "noise": noise},)


@register_node("IDSequenceLoader")
def id_sequence_loader(ctx: InferenceContext, node: WorkflowNode, directory=None):
    """ID .npy dir -> IDMap (loaders.py:312-340 IDSequenceLoader)."""
    from stable_renderer_tpu_torch.data.idmap import IDMap
    from stable_renderer_tpu_torch.data.loaders import load_id_sequence

    off = 0
    if directory is None:
        directory = str(_widget(node, 0, ""))
        off = 1
    frame_start = _widget(node, off + 0, 0, int)
    num_frames = _widget(node, off + 1, 16, int)
    idm = load_id_sequence(directory, frame_start, num_frames)
    return (IDMap(tensor=_on(ctx, idm.tensor), frame_indices=idm.frame_indices),)


def _legacy_paths(node, paths):
    """Explicit file list for the legacy loaders: a list/tuple of paths
    (linked input) or a newline/comma-separated widget string, sorted by the
    filename's frame index (position as fallback), then filtered to existing
    files (stable_rendering/_nodes/legacy/loaders.py:34-48)."""
    from stable_renderer_tpu_torch.utils.paths import extract_index

    if paths is None:
        raw = str(_widget(node, 0, ""))
        paths = [p.strip() for p in raw.replace(",", "\n").splitlines() if p.strip()]
    paths = [str(p) for p in paths]
    order = {p: i for i, p in enumerate(paths)}
    paths.sort(key=lambda p: extract_index(Path(p).name, order[p]))
    return [p for p in paths if Path(p).exists()]


@register_node("LegacyImageSequenceLoader")
def legacy_image_sequence_loader(ctx: InferenceContext, node: WorkflowNode, imgs=None):
    """Explicit image-file list -> (IMAGE rgb, MASK = 1 - alpha)
    (legacy/loaders.py:13-57)."""
    from PIL import Image

    files = _legacy_paths(node, imgs)
    if not files:
        raise ValueError("LegacyImageSequenceLoader: no existing image files")
    rgbs, masks = [], []
    for f in files:
        arr = np.asarray(Image.open(f).convert("RGBA"), np.float32) / 255.0
        rgbs.append(arr[..., :3])
        masks.append(1.0 - arr[..., 3])
    return _on(ctx, np.stack(rgbs)), _on(ctx, np.stack(masks))


def _legacy_load_map(path: str) -> np.ndarray:
    """One legacy npy/image map -> (H, W, 4) float32; CHW npy dumps are
    transposed to NHWC (legacy/loaders.py:87-98)."""
    from PIL import Image

    if path.endswith(".npy"):
        t = np.squeeze(np.load(path)).astype(np.float32)
        if t.ndim != 3:
            raise ValueError(f"Invalid shape of legacy map tensor: {t.shape}.")
        if t.shape[-1] != 4:
            if t.shape[0] == 4:
                t = np.transpose(t, (1, 2, 0))
            else:
                raise ValueError(f"Invalid legacy map tensor shape: {t.shape}.")
        return t
    return np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0


def _legacy_maps(files) -> np.ndarray:
    maps = [_legacy_load_map(f) for f in files]
    for t in maps:
        if t.shape != maps[0].shape:
            raise ValueError(
                f"Tensor data has inconsistent shapes: {t.shape} and {maps[0].shape}.")
    return np.stack(maps)


@register_node("LegacyNoiseSequenceLoader")
def legacy_noise_sequence_loader(ctx: InferenceContext, node: WorkflowNode, data_paths=None):
    """Explicit noise npy/image file list -> LATENT(samples=zeros, noise=t) at
    full resolution (legacy/loaders.py:60-102)."""
    files = _legacy_paths(node, data_paths)
    if not files:
        raise ValueError("LegacyNoiseSequenceLoader: no existing noise files")
    noise = _on(ctx, _legacy_maps(files))
    return ({"samples": torch.zeros_like(noise), "noise": noise},)


@register_node("LegacyIDSequenceLoader")
def legacy_id_sequence_loader(ctx: InferenceContext, node: WorkflowNode, data_paths=None):
    """Explicit id npy/image file list -> IDMap with filename-derived frame
    indices (legacy/loaders.py:105-147)."""
    from stable_renderer_tpu_torch.data.idmap import IDMap
    from stable_renderer_tpu_torch.utils.paths import extract_index

    files = _legacy_paths(node, data_paths)
    if not files:
        raise ValueError("LegacyIDSequenceLoader: no existing id files")
    frame_indices = [extract_index(Path(f).name, i) for i, f in enumerate(files)]
    return (IDMap(tensor=_on(ctx, _legacy_maps(files).astype(np.int32)),
                  frame_indices=frame_indices),)


def _pool_latent(full: torch.Tensor, block: int, how: str) -> torch.Tensor:
    """(N, H, W, 4) -> (N, H/block, W/block, 4) by block reduce."""
    from stable_renderer_tpu_torch.ops.math import resize_nearest

    n, h, w, c = full.shape
    if how == "nearest":
        return resize_nearest(full, h // block, w // block)
    tiles = full.reshape(n, h // block, block, w // block, block, c)
    if how == "mean":
        return tiles.mean(dim=(2, 4))
    return tiles.amax(dim=(2, 4)) if how == "max" else tiles.amin(dim=(2, 4))


def noise_from_id_map(id_map, size: int, how: str, draws) -> dict:
    """Vertex-consistent latent noise from an IDMap (loaders.py:154-271
    CreateNoiseSequenceFromIdMap): one shared full-res noise field per
    sequence, every screen pixel that maps to the same 3D vertex re-seeded to
    the same normal draw across frames (tensor_group_by_then_randn_init),
    then block-reduced to latent resolution. ``draws`` is two (base (1, size,
    size, 4), per-vertex table (segments, 4), fallback (pixels, 4)) triples,
    the samples' and the noise's. 'nearest' fills both samples and noise;
    mean/max/min give samples zeros and the pooled noise."""
    from stable_renderer_tpu_torch.ops.math import group_randn_by_id

    n = id_map.frame_count
    info, valid = id_map.create_vertex_screen_info()
    vertex_ids = info[:, 3].to(torch.int32)
    # info[:, 6] carries the filename-derived frame index: mapped back to the
    # batch row through the (sorted) frame_indices table
    fi_table = torch.as_tensor(id_map.frame_indices, dtype=torch.int32, device=info.device)
    fs = torch.clamp(torch.searchsorted(fi_table, info[:, 6].to(torch.int32)), 0, n - 1)
    xs = torch.clamp((info[:, 4] * size).to(torch.int64), 0, size - 1)
    ys = torch.clamp((info[:, 5] * size).to(torch.int64), 0, size - 1)

    def vertex_noise(base, table, fallback):
        field = base.to(info.device, torch.float32).repeat(n, 1, 1, 1)
        per_vertex = group_randn_by_id(None, vertex_ids, table.shape[0], 4,
                                       table=table, fallback=fallback)
        field[fs, ys, xs] = torch.where(valid[:, None], per_vertex, field[fs, ys, xs])
        return field

    latent = _pool_latent(vertex_noise(*draws[0]), 8, how)
    noise = _pool_latent(vertex_noise(*draws[1]), 8, how)
    if how == "nearest":
        return {"samples": latent, "noise": noise}
    return {"samples": torch.zeros_like(noise), "noise": noise}


@register_node("CreateNoiseSequenceFromIdMap")
def create_noise_sequence_from_id_map(ctx: InferenceContext, node: WorkflowNode, id_map=None):
    """``noise_from_id_map`` with its draws from a generator seeded with the
    seed widget on the context's device."""
    seed = _widget(node, 0, 0, int)
    sd_version = str(_widget(node, 1, "SD15"))
    how = str(_widget(node, 2, "nearest"))
    size = _sd_size(sd_version)
    if how not in ("mean", "max", "min", "nearest"):
        raise ValueError("downsample_option should be either mean, max, min, or nearest")
    if id_map is None or id_map.frame_count == 0:
        raise ValueError("ID map is empty.")
    info, valid = id_map.create_vertex_screen_info()
    vertex_ids = info[:, 3].to(torch.int32)
    # the segment count from the concrete table (a host loader node)
    num_segments = int(torch.where(valid, vertex_ids, 0).max()) + 1
    gen = _generator(ctx, seed)
    dev = ctx.device

    def draw():
        return (torch.randn((1, size, size, 4), generator=gen, device=dev),
                torch.randn((num_segments, 4), generator=gen, device=dev),
                torch.randn((vertex_ids.shape[0], 4), generator=gen, device=dev))

    return (noise_from_id_map(id_map, size, how, (draw(), draw())),)


def identical_noise(num_frames: int, latent: torch.Tensor, noise: torch.Tensor) -> dict:
    """One latent-resolution draw each for samples and noise, tiled over
    ``num_frames`` (loaders.py:273-310 CreateIdenticalNoiseSequence)."""
    return {"samples": latent.repeat(num_frames, 1, 1, 1),
            "noise": noise.repeat(num_frames, 1, 1, 1)}


@register_node("CreateIdenticalNoiseSequence")
def create_identical_noise_sequence(ctx: InferenceContext, node: WorkflowNode):
    seed = _widget(node, 0, 0, int)
    num_frames = _widget(node, 1, 1, int)
    hw = _sd_size(str(_widget(node, 2, "SD15"))) // 8
    if num_frames <= 0:
        raise ValueError("num_frames should be larger than 0.")
    gen = _generator(ctx, seed)
    latent = torch.randn((1, hw, hw, 4), generator=gen, device=ctx.device)
    noise = torch.randn((1, hw, hw, 4), generator=gen, device=ctx.device)
    return (identical_noise(num_frames, latent, noise),)


# ---------------------------------------------------------------------------
# VirtualEngineDataNode (_nodes/data.py:71-105)


@register_node("VirtualEngineDataNode")
def virtual_engine_data_node(ctx: InferenceContext, node: WorkflowNode,
                             color_maps=None, id_maps=None, pos_maps=None,
                             normal_maps=None, depth_maps=None,
                             canny_maps=None, noise_maps=None, masks=None,
                             correspond_maps=None, sprites=None, env_prompt=None):
    """Compose an EngineData from explicit inputs when running without the
    engine, and install it as the context's engine_data so downstream
    hidden-value consumers (CorrespondSampler) see it (data.py:92-104)."""
    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.data.idmap import IDMap, id_masks

    def on(t):
        return None if t is None else _on(ctx, t)

    id_tensor = frame_indices = None
    if id_maps is not None:
        if isinstance(id_maps, IDMap):
            id_tensor = on(id_maps.tensor)
            frame_indices = torch.as_tensor(id_maps.frame_indices, dtype=torch.int32)
        else:
            id_tensor = on(id_maps)
    noise = None
    if noise_maps is not None:
        noise = on(noise_maps["noise"] if isinstance(noise_maps, dict) else noise_maps)
    n = next((c.shape[0] for c in (color_maps, id_tensor, noise) if c is not None), None)
    if n is None:
        raise ValueError("VirtualEngineDataNode needs at least one map input")
    if frame_indices is None:
        frame_indices = torch.arange(n, dtype=torch.int32)
    if masks is None and id_tensor is not None:
        masks = id_masks(id_tensor)
    ed = EngineData(
        frame_indices=frame_indices,
        color_maps=on(color_maps),
        id_maps=id_tensor,
        pos_maps=on(pos_maps),
        noise_maps=noise,
        normal_maps=on(normal_maps),
        depth_maps=on(depth_maps),
        canny_maps=on(canny_maps),
        masks=on(masks),
        sprite_infos=sprites or {},
        env_prompts=tuple(env_prompt or ()),
        correspond_maps=correspond_maps or {},
    )
    ctx.engine_data = ed
    return (ed,)


# ---------------------------------------------------------------------------
# processing (_nodes/processing/{img,text,video}.py)


@register_node("RGBAToRGB")
def rgba_to_rgb(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Alpha-composite an RGBA image over a hex background colour
    (processing/img.py:101-130 RGBAToRGB)."""
    color = str(_widget(node, 0, "ffffff")).lstrip("#")
    if len(color) != 6:
        raise ValueError("Color must be a hex string")
    try:
        rgb_bg = [int(color[i:i + 2], 16) for i in (0, 2, 4)]
    except ValueError:
        raise ValueError(f"Invalid color format {color}, color must be a hex string")
    bg = torch.tensor(rgb_bg, dtype=torch.float32, device=image.device) / 255.0
    if image.shape[-1] != 4:
        raise ValueError("Input image must be in RGBA format")
    rgb, alpha = image[..., :3], image[..., 3:4]
    return ((1.0 - alpha) * bg + alpha * rgb,)


@register_node("RGBAThreshold")
def rgba_threshold(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Binarize the alpha channel at a threshold (processing/img.py:132-160)."""
    threshold = _widget(node, 0, 0.5, float)
    if image.shape[-1] != 4:
        raise ValueError("Input image must be in RGBA format")
    alpha = (image[..., 3:4] > threshold).to(image.dtype)
    return (torch.cat([image[..., :3], alpha], -1),)


@register_node("RemoveBGNode")
def remove_bg(ctx: InferenceContext, node: WorkflowNode, image=None):
    """Background removal (processing/img.py:80-98 RemoveBGNode), as the
    JAX package does it without the reference's ONNX matting weights: the
    background colour is the median of the frame's borders, pixels within an
    adaptive colour distance of it fade out, the matte is box-blurred 3x3.
    Output RGBA, background alpha -> 0."""
    x = _on(ctx, image)[..., :3]
    b = x.shape[0]
    border = torch.cat([x[:, :2].reshape(b, -1, 3), x[:, -2:].reshape(b, -1, 3),
                        x[:, :, :2].reshape(b, -1, 3), x[:, :, -2:].reshape(b, -1, 3)], 1)
    # jnp.median: the mean of the two middle values of an even count
    srt = torch.sort(border, dim=1).values
    m = srt.shape[1]
    med = srt[:, (m - 1) // 2] if m % 2 else (srt[:, m // 2 - 1] + srt[:, m // 2]) * 0.5
    bg = med[:, None, None, :]
    dist = torch.linalg.vector_norm(x - bg, dim=-1, keepdim=True)
    spread = torch.std(border, dim=(1, 2), correction=0)[:, None, None, None]
    lo = 2.0 * spread + 0.02
    hi = 4.0 * spread + 0.08
    alpha = torch.clamp((dist - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)
    alpha = F.conv2d(alpha.permute(0, 3, 1, 2),
                     torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=x.dtype, device=x.device),
                     padding=1).permute(0, 2, 3, 1)
    return (torch.cat([x * alpha, alpha], -1),)


@register_node("TextConcat")
def text_concat(ctx: InferenceContext, node: WorkflowNode, text_a=None, text_b=None):
    """(processing/text.py TextConcat)"""
    # widgets shift left when text_a arrives as a link instead of a widget
    off = 0
    if text_a is None:
        text_a = str(_widget(node, 0, ""))
        off = 1
    if text_b is None:
        text_b = str(_widget(node, off, ""))
    return (str(text_a) + str(text_b),)


@register_node("TextReplace")
def text_replace(ctx: InferenceContext, node: WorkflowNode, text=None, pattern=None,
                 replace=None):
    """(processing/text.py TextReplace)"""
    text = text if text is not None else str(_widget(node, 0, ""))
    pattern = pattern if pattern is not None else str(_widget(node, 1, ""))
    replace = replace if replace is not None else str(_widget(node, 2, ""))
    return (str(text).replace(str(pattern), str(replace)),)


@register_node("SimpleVideoCombine")
def simple_video_combine(ctx: InferenceContext, node: WorkflowNode, images=None):
    """Frames -> an animated webp or gif with optional alpha threshold and
    pingpong (processing/video.py:30-100 SimpleVideoCombine), written to the
    output directory."""
    from PIL import Image

    from stable_renderer_tpu_torch.utils.paths import OUTPUT_DIR

    alpha_threshold = _widget(node, 0, 0.5, float)
    enable_alpha = bool(_widget(node, 1, True))
    frame_rate = max(1, _widget(node, 2, 8, int))
    loop_count = _widget(node, 3, 0, int)
    prefix = str(_widget(node, 4, "video"))
    pingpong = bool(_widget(node, 5, False))
    fmt = str(_widget(node, 6, "webp")).lower()
    if fmt not in ("webp", "gif"):
        fmt = "webp"

    arr = images.detach().float().cpu().numpy() if hasattr(images, "detach") else images
    arr = np.clip(np.asarray(arr, np.float32), 0.0, 1.0)
    if enable_alpha:
        if arr.shape[-1] == 4:
            arr = np.concatenate(
                [arr[..., :3], (arr[..., 3:] > alpha_threshold).astype(np.float32)], -1)
        else:
            arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
    frames = [Image.fromarray((f * 255.0).astype(np.uint8)) for f in arr]
    if pingpong and len(frames) > 2:
        frames = frames + frames[-2:0:-1]
    out_dir = Path(OUTPUT_DIR) / "workflow"
    out_dir.mkdir(parents=True, exist_ok=True)
    counter = len(list(out_dir.glob(f"{prefix}_*.{fmt}")))
    path = out_dir / f"{prefix}_{counter:05}.{fmt}"
    save_kwargs = {"lossless": True} if fmt == "webp" else {}
    if fmt == "gif" and frames[0].mode == "RGBA":
        save_kwargs["disposal"] = 2  # GIF's 1-bit alpha via palette transparency
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=round(1000.0 / frame_rate), loop=loop_count, **save_kwargs)
    ctx.status_messages.append(f"saved {path}")
    return (str(path),)
