"""Texture — an image resource as a tensor on the engine's device.

Counterpart of stable_renderer_tpu/engine/texture.py, the capability match for
the reference's Texture resource with its GL upload + CUDA-GL zero-copy interop
(reference: engine/static/texture/texture.py:44-569). A texture IS the tensor
the rasterizer samples, so this class is a thin host wrapper (load from file,
noise generation, dtype and flip conventions). The DDS variant of the
reference (texture_DDS.py) is subsumed: PIL handles the example formats.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from stable_renderer_tpu_torch.utils.log import EngineLogger


class Texture:
    def __init__(self, data: np.ndarray, name: str = "texture", device=None):
        """data: (H, W, C) float32 in [0, 1] (or gaussian for noise textures),
        stored as a float32 tensor on ``device`` (default: the engine's)."""
        if data.ndim == 2:
            data = data[..., None]
        self.name = name
        from stable_renderer_tpu_torch.engine.engine import engine_device

        self.array = torch.as_tensor(np.asarray(data, np.float32)).to(engine_device(device))

    @property
    def height(self) -> int:
        return self.array.shape[0]

    @property
    def width(self) -> int:
        return self.array.shape[1]

    @property
    def channels(self) -> int:
        return self.array.shape[2]

    def numpy_data(self) -> np.ndarray:
        return self.array.cpu().numpy()

    @classmethod
    def Load(cls, path: str | Path, name: Optional[str] = None, device=None) -> "Texture":
        """Load an image file (png/jpg/bmp/tga/dds via PIL). v-axis kept in image
        row order; the sampler handles the GL v-flip (ops/texture.py)."""
        from PIL import Image

        path = Path(path)
        img = Image.open(path)
        if img.mode not in ("RGB", "RGBA", "L"):
            img = img.convert("RGBA")
        data = np.asarray(img, np.float32) / 255.0
        EngineLogger.debug(f"Loaded texture {path} {data.shape}")
        return cls(data, name=name or path.stem, device=device)

    @classmethod
    def CreateNoiseTex(
        cls, width: int = 512, height: int = 512, channels: int = 4, seed: int = 0, device=None
    ) -> "Texture":
        """Gaussian noise texture (texture.py:506-569 CreateNoiseTex) — the
        per-object latent noise source rendered into the G-buffer."""
        rng = np.random.default_rng(seed)
        return cls(
            rng.standard_normal((height, width, channels)).astype(np.float32),
            name=f"noise_{width}x{height}",
            device=device,
        )

    @classmethod
    def CreateVirtualTex(
        cls, width: int = 512, height: int = 512, channels: int = 4, fill: float = 0.0,
        device=None,
    ) -> "Texture":
        return cls(np.full((height, width, channels), fill, np.float32), name="virtual",
                   device=device)
