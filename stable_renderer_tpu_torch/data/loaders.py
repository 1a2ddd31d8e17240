"""Sequence loaders — rebuild EngineData from dumped map directories.

Counterpart of stable_renderer_tpu/data/loaders.py, the capability match for
the reference's loader nodes (reference: comfyUI/stable_rendering/_nodes/
loaders.py — ImageSequenceLoader :19-60, NoiseSequenceLoader (8x8-mean
downsample + AdaIN renorm) :62-150, IDSequenceLoader :273-329) and the
VirtualEngineDataNode (offline EngineData composition, _nodes/data.py:71-105):
what lets a bake run offline from the reference's map-output directories
(color/*.png, id/*.npy, noise/*.npy ...). The tensors go to ``device``
(default: the card).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from stable_renderer_tpu_torch.data.engine_data import EngineData
from stable_renderer_tpu_torch.data.idmap import IDMap
from stable_renderer_tpu_torch.device import resolve_device
from stable_renderer_tpu_torch.utils.paths import extract_index


def _sorted_files(directory: Path, suffixes: Tuple[str, ...]) -> List[Path]:
    names = [f for f in os.listdir(directory) if f.lower().endswith(suffixes)]
    fallback = {f: i for i, f in enumerate(names)}
    names.sort(key=lambda f: extract_index(f, fallback[f]))
    return [directory / f for f in names]


def load_image_sequence(directory: str | Path, frame_start: int = 0,
                        num_frames: Optional[int] = None) -> np.ndarray:
    """(N, H, W, 3) float32 in [0,1] from a directory of numbered images
    (ImageSequenceLoader)."""
    from PIL import Image

    files = _sorted_files(Path(directory), (".png", ".jpg", ".jpeg", ".bmp"))
    files = files[frame_start: frame_start + num_frames if num_frames else None]
    if not files:
        raise ValueError(f"no images in {directory}")
    frames = []
    for f in files:
        img = Image.open(f)
        if img.mode != "RGB":
            img = img.convert("RGB")
        frames.append(np.asarray(img, np.float32) / 255.0)
    return np.stack(frames)


def load_noise_sequence(directory: str | Path, frame_start: int = 0,
                        num_frames: Optional[int] = None, pool: int = 8) -> np.ndarray:
    """(N, H/pool, W/pool, 4) latent noise from dumped noise .npy maps with
    the reference's 8x8-mean downsample + AdaIN renormalization
    (NoiseSequenceLoader, loaders.py:62-150), through ops/math.py on the CPU."""
    from stable_renderer_tpu_torch.ops.math import adain, downsample_mean

    files = _sorted_files(Path(directory), (".npy",))
    files = files[frame_start: frame_start + num_frames if num_frames else None]
    if not files:
        raise ValueError(f"no noise maps in {directory}")
    frames = np.stack([np.load(f).astype(np.float32) for f in files])
    if frames.ndim == 3:
        frames = frames[..., None].repeat(4, -1)
    full = torch.from_numpy(np.ascontiguousarray(frames[..., :4]))
    return adain(downsample_mean(full, pool), full).numpy()


def load_id_sequence(directory: str | Path, frame_start: int = 0,
                     num_frames: Optional[int] = None) -> IDMap:
    """IDMap from dumped id .npy maps (IDSequenceLoader)."""
    return IDMap.from_directory(directory, frame_start=frame_start, num_frames=num_frames)


def virtual_engine_data(
    color_dir: Optional[str | Path] = None,
    id_dir: Optional[str | Path] = None,
    noise_dir: Optional[str | Path] = None,
    normal_dir: Optional[str | Path] = None,
    depth_dir: Optional[str | Path] = None,
    canny_dir: Optional[str | Path] = None,
    frame_start: int = 0,
    num_frames: Optional[int] = None,
    prompt: str = "",
    device=None,
) -> EngineData:
    """Compose an EngineData offline from map directories
    (VirtualEngineDataNode), its tensors on ``device`` (default: the card)."""
    from stable_renderer_tpu_torch.data.idmap import id_masks
    from stable_renderer_tpu_torch.data.sprite import EnvPrompt

    dev = resolve_device(device)

    def on_dev(a) -> torch.Tensor:
        return torch.as_tensor(a).to(dev)

    kwargs = {}
    n = None
    if color_dir:
        kwargs["color_maps"] = on_dev(load_image_sequence(color_dir, frame_start, num_frames))
        n = kwargs["color_maps"].shape[0]
    if id_dir:
        idmap = load_id_sequence(id_dir, frame_start, num_frames)
        kwargs["id_maps"] = on_dev(idmap.tensor)
        kwargs["masks"] = id_masks(kwargs["id_maps"])
        n = idmap.frame_count
    if noise_dir:
        kwargs["noise_maps"] = on_dev(load_noise_sequence(noise_dir, frame_start, num_frames))
        n = kwargs["noise_maps"].shape[0]
    for name, d in (("normal_maps", normal_dir), ("depth_maps", depth_dir),
                    ("canny_maps", canny_dir)):
        if d:
            kwargs[name] = on_dev(load_image_sequence(d, frame_start, num_frames))
            n = kwargs[name].shape[0]
    if n is None:
        raise ValueError("at least one map directory is required")
    return EngineData(
        frame_indices=torch.arange(n),
        env_prompts=(EnvPrompt(prompt=prompt),) if prompt else (),
        **kwargs,
    )
