"""Image/video output utilities (host-only numpy and PIL).

Counterpart of stable_renderer_tpu/utils/media.py, copied: the capability
match for the reference's processing nodes (reference:
comfyUI/stable_rendering/_nodes/processing/video.py:30-77 SimpleVideoCombine
(GIF writer), processing/img.py RGBAToRGB/RGBAThreshold, processing/text.py
TextConcat/TextReplace). RemoveBG (rembg) is gated on the
optional dependency like the reference.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def to_uint8(frame: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(frame) * 255.0, 0, 255).astype(np.uint8)


def rgba_to_rgb(img: np.ndarray, background: Sequence[float] = (0.0, 0.0, 0.0)) -> np.ndarray:
    """Composite RGBA onto a solid background (RGBAToRGB node)."""
    if img.shape[-1] == 3:
        return img
    a = img[..., 3:4]
    bg = np.asarray(background, img.dtype)
    return img[..., :3] * a + bg * (1.0 - a)


def rgba_threshold(img: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Binarize the alpha channel (RGBAThreshold node)."""
    out = np.array(img, copy=True)
    out[..., 3] = (out[..., 3] >= threshold).astype(out.dtype)
    return out


def text_concat(*texts: str, sep: str = ", ") -> str:
    """TextConcat node: join non-empty prompt fragments."""
    return sep.join(t for t in texts if t)


def text_replace(text: str, old: str, new: str) -> str:
    return text.replace(old, new)


def write_gif(
    frames: Sequence[np.ndarray],
    path: str | Path,
    fps: float = 8.0,
    loop: int = 0,
) -> str:
    """Combine float [0,1] frames into an animated GIF (SimpleVideoCombine)."""
    from PIL import Image

    if not len(frames):
        raise ValueError("no frames")
    imgs = [Image.fromarray(to_uint8(f)[..., :3]) for f in frames]
    path = str(path)
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=loop,
    )
    return path


def write_png_sequence(frames: Sequence[np.ndarray], directory: str | Path, stem: str = "frame") -> list:
    from PIL import Image

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = directory / f"{stem}_{i}.png"
        Image.fromarray(to_uint8(f)[..., :3]).save(p)
        paths.append(str(p))
    return paths


def remove_bg(img: np.ndarray) -> np.ndarray:
    """Foreground extraction (RemoveBG node). Requires the optional ``rembg``
    package like the reference; raises a clear error when absent."""
    try:
        from rembg import remove  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "RemoveBG requires the optional 'rembg' package (same as the reference)"
        ) from e
    from PIL import Image

    out = remove(Image.fromarray(to_uint8(img)))
    return np.asarray(out, np.float32) / 255.0
