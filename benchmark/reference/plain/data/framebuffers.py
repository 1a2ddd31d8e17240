"""GBuffer — the 6-attachment frame-buffer contract as a NamedTuple of tensors.

Counterpart of stable_renderer_tpu/data/framebuffers.py:

    0 color         (H, W, 4) float  rgba, [0,1]
    1 id            (H, W, 4) int32  (spriteID, materialID, map_index, vertexID)
    2 pos           (H, W, 3) float  view-space position
    3 normal_depth  (H, W, 4) float  view-space normal*0.5+0.5  +  inverted depth
    4 noise         (H, W, 4) float  per-object latent noise, pre-downsample
    5 canny         (H, W, 3) float  normal-angle edge mask
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NON_AI_MAP_INDEX = 2048
"""map_index sentinel for non-AI objects (reference: default_Gbuffer.frag.glsl:8)."""


class GBuffer(NamedTuple):
    color: torch.Tensor         # (H, W, 4) float32
    id: torch.Tensor            # (H, W, 4) int32
    pos: torch.Tensor           # (H, W, 3) float32
    normal_depth: torch.Tensor  # (H, W, 4) float32
    noise: torch.Tensor         # (H, W, 4) float32
    canny: torch.Tensor         # (H, W, 3) float32

    @property
    def height(self) -> int:
        return self.color.shape[-3]

    @property
    def width(self) -> int:
        return self.color.shape[-2]

    @property
    def depth(self) -> torch.Tensor:
        """Inverted depth (closer = larger), alpha channel of normal_depth."""
        return self.normal_depth[..., 3]

    @property
    def normal(self) -> torch.Tensor:
        """Encoded view-space normal in [0,1]."""
        return self.normal_depth[..., :3]

    @staticmethod
    def empty(height: int, width: int, dtype=torch.float32, device=None) -> "GBuffer":
        """A cleared G-buffer: every attachment zero."""
        def z(c, dt=dtype):
            return torch.zeros((height, width, c), dtype=dt, device=device)

        return GBuffer(color=z(4), id=z(4, torch.int32), pos=z(3),
                       normal_depth=z(4), noise=z(4), canny=z(3))
