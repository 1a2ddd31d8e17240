"""EngineData — the frame pack handed from the render stage to the diffusion stage.

Counterpart of stable_renderer_tpu/data/engine_data.py. One EngineData may
hold N frames. Tensor fields (NHWC, float32 in [0,1] unless noted):

    color_maps   (N, H, W, 3)
    id_maps      (N, H, W, 4) int32   (spriteID, materialID, map_index, vertexID)
    pos_maps     (N, H, W, 3)
    noise_maps   (N, H/8, W/8, 4)     8x8-pooled + AdaIN-renormalized noise
    normal_maps  (N, H, W, 3)
    depth_maps   (N, H, W, 3)         inverted depth replicated to 3 channels
    canny_maps   (N, H, W, 3)
    masks        (N, H, W)            1 - color alpha (background mask)
    frame_indices (N,) int

Host metadata: sprite_infos, env_prompts, correspond_maps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from stable_renderer_tpu_torch.data.sprite import EnvPrompt, SpriteInfos


@dataclass
class EngineData:
    frame_indices: torch.Tensor  # (N,)
    color_maps: Optional[torch.Tensor] = None
    id_maps: Optional[torch.Tensor] = None
    pos_maps: Optional[torch.Tensor] = None
    noise_maps: Optional[torch.Tensor] = None
    normal_maps: Optional[torch.Tensor] = None
    depth_maps: Optional[torch.Tensor] = None
    canny_maps: Optional[torch.Tensor] = None
    masks: Optional[torch.Tensor] = None
    sprite_infos: SpriteInfos = field(default_factory=dict)
    env_prompts: Tuple[EnvPrompt, ...] = ()
    correspond_maps: Dict[Any, Any] = field(default_factory=dict)

    @property
    def frame_count(self) -> int:
        return self.frame_indices.shape[0]

    @property
    def height(self) -> int:
        return self.color_maps.shape[-3]

    @property
    def width(self) -> int:
        return self.color_maps.shape[-2]
