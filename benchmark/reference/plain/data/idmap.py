"""IDMap — the per-frame correspondence data structure.

Counterpart of stable_renderer_tpu/data/idmap.py (reference:
engine/static/corrmap.py:49-280). Shape (N, H, W, 4) int32, cell =
(spriteID, materialID, map_index, vertexID). The derived products are plain
functions on tensors:

  * ``id_masks`` — background mask (map_index == 2048 OR all-zero cell) as
    float (IDMap.__attrs_post_init__, corrmap.py:119-130).
  * ``vertex_screen_info`` — the flattened (N*H*W, 7) table (spriteID,
    materialID, map_index, vertexID, x_ratio, y_ratio, frame_index) with a
    validity mask in place of the reference's boolean filter
    (corrmap.py:220-280).
  * ``flat_correspondence`` — flat vertex ids + validity for segment
    reductions keyed by vertexID.

The host-side ``IDMap`` wraps the tensor with frame indices and the loader of
the reference's .npy map dumps (corrmap.py:138-198).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from benchmark.reference.plain.data.framebuffers import NON_AI_MAP_INDEX
from benchmark.reference.plain.utils.paths import extract_index


def _ai_pixels(ids: torch.Tensor) -> torch.Tensor:
    """(...) bool: the cell carries an AI id (map_index != 2048, not all zero)."""
    return (ids[..., 2] != NON_AI_MAP_INDEX) & (ids != 0).any(-1)


def id_masks(id_tensor: torch.Tensor) -> torch.Tensor:
    """Background mask from an (..., 4) int32 id map: (...) float32, 1.0 where
    there is NO AI id (corrmap.py:119-127)."""
    return (~_ai_pixels(id_tensor)).to(torch.float32)


def vertex_screen_info(id_tensor: torch.Tensor,
                       frame_indices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened per-pixel correspondence table with its validity mask.

    Args:
      id_tensor: (N, H, W, 4) int32.
      frame_indices: (N,) frame index of each batch row.

    Returns:
      info: (N*H*W, 7) float32 (spriteID, materialID, map_index, vertexID,
            x_ratio, y_ratio, frame_idx). As in the reference,
            x_ratio = x / height and y_ratio = y / width: each divides by the
            other axis (corrmap.py:237-250); equal for square maps.
      valid: (N*H*W,) bool, False where the cell is background.
    """
    n, h, w, _ = id_tensor.shape
    dev = id_tensor.device
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :].expand(n, h, w)
    y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None].expand(n, h, w)
    f = frame_indices.to(device=dev, dtype=torch.float32)[:, None, None].expand(n, h, w)
    info = torch.cat([id_tensor.to(torch.float32), (x / h)[..., None], (y / w)[..., None],
                      f[..., None]], dim=-1).reshape(-1, 7)
    return info, _ai_pixels(id_tensor.reshape(-1, 4))


def flat_correspondence(id_tensor: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vertexID (N*H*W,) int32, valid (N*H*W,) bool) over all frames and
    pixels, for segment reductions."""
    ids = id_tensor.reshape(-1, 4)
    return ids[:, 3], _ai_pixels(ids)


@dataclass
class IDMap:
    """Host wrapper: (N, H, W, 4) int32 tensor + frame indices
    (the reference IDMap's surface, corrmap.py:49-280)."""

    tensor: torch.Tensor
    frame_indices: List[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        t = torch.as_tensor(self.tensor)
        if t.dim() == 3:
            t = t[None]
        if t.dim() != 4 or t.shape[-1] != 4:
            raise ValueError(f"IDMap tensor must be (N, H, W, 4), got {tuple(t.shape)}")
        self.tensor = t.to(torch.int32)
        if not self.frame_indices:
            self.frame_indices = list(range(t.shape[0]))
        if len(self.frame_indices) != t.shape[0]:
            raise ValueError("frame_indices length must equal batch size")

    @property
    def frame_count(self) -> int:
        return len(self.frame_indices)

    @property
    def height(self) -> int:
        return self.tensor.shape[-3]

    @property
    def width(self) -> int:
        return self.tensor.shape[-2]

    @property
    def masks(self) -> torch.Tensor:
        """(N, H, W) float32: 1.0 = background (no AI id)."""
        return id_masks(self.tensor)

    def __getitem__(self, index: int) -> torch.Tensor:
        return self.tensor[index]

    def __len__(self) -> int:
        return self.frame_count

    def create_vertex_screen_info(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return vertex_screen_info(self.tensor, torch.as_tensor(self.frame_indices))

    @classmethod
    def from_directory(
        cls,
        directory: str | Path,
        frame_start: int | None = None,
        num_frames: int | None = None,
        use_frame_indices_from_filename: bool = True,
    ) -> "IDMap":
        """Load per-frame ``*.npy`` id dumps (the reference's map-output
        format, corrmap.py:138-198), ordered by the integer index parsed from
        each filename. The tensor stays on the CPU."""
        directory = Path(directory)
        if not directory.exists():
            raise FileNotFoundError(directory)
        names = [f for f in os.listdir(directory) if f.endswith(".npy")]
        fallback = {f: i for i, f in enumerate(names)}
        names.sort(key=lambda f: extract_index(f, fallback[f]))
        frame_start = frame_start or 0
        if use_frame_indices_from_filename:
            indices = [extract_index(f) for f in names]
        else:
            indices = list(range(len(names)))
        num_frames = num_frames or len(names)
        names = names[frame_start: frame_start + num_frames]
        indices = indices[frame_start: frame_start + num_frames]
        if not names:
            raise ValueError(f"No .npy id maps found in {directory}")
        arrays = []
        for name in names:
            arr = np.squeeze(np.load(directory / name))
            if arr.ndim != 3:
                raise ValueError(f"Invalid id tensor shape {arr.shape} in {name}")
            if arr.shape[0] == 4 and arr.shape[-1] != 4:  # CHW -> HWC
                arr = np.moveaxis(arr, 0, -1)
            arrays.append(arr.astype(np.int32))
        if any(a.shape != arrays[0].shape for a in arrays):
            raise ValueError("Inconsistent id map shapes")
        return cls(tensor=torch.from_numpy(np.stack(arrays)), frame_indices=indices)

    @classmethod
    def from_tensor(cls, frame_indices: List[int], tensor: torch.Tensor) -> "IDMap":
        return cls(tensor=tensor, frame_indices=list(frame_indices))
