"""SDXL's ADM vectors.

Counterpart of stable_renderer_tpu/models/sdxl.py (reference:
comfy/model_base.py SDXL.encode_adm and SDXLRefiner.encode_adm). The ADM
vector is the pooled CLIP-G embedding followed by one 256-wide Fourier row
(``timestep_embedding``) per size value: 1280 + 6 * 256 = 2816 channels for
SDXL base, 1280 + 5 * 256 = 2560 for the refiner.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from benchmark.reference.plain.models.layers import timestep_embedding


def _adm(pooled: torch.Tensor, values: Sequence[float]) -> torch.Tensor:
    """(B, P + 256 * len(values)) f32: ``pooled`` then the values' Fourier
    rows, the same for every row of the batch."""
    vals = torch.tensor([float(v) for v in values], dtype=torch.float32, device=pooled.device)
    emb = timestep_embedding(vals, 256).reshape(1, -1)
    return torch.cat([pooled.float(), emb.expand(pooled.shape[0], -1)], dim=-1)


def sdxl_adm_vector(
    pooled: torch.Tensor,  # (B, 1280) CLIP-G pooled embedding
    original_size: Tuple[int, int] = (1024, 1024),
    crop: Tuple[int, int] = (0, 0),
    target_size: Tuple[int, int] = (1024, 1024),
) -> torch.Tensor:
    """(B, 2816) ADM conditioning: Fourier rows of [h, w, crop_h, crop_w,
    target_h, target_w] after the pooled embedding (SDXL.encode_adm)."""
    return _adm(pooled, (*original_size, *crop, *target_size))


def sdxl_refiner_adm_vector(
    pooled: torch.Tensor,  # (B, 1280) CLIP-G pooled embedding
    original_size: Tuple[int, int] = (1024, 1024),
    crop: Tuple[int, int] = (0, 0),
    aesthetic_score: float = 6.0,
) -> torch.Tensor:
    """(B, 2560) refiner ADM: Fourier rows of [h, w, crop_h, crop_w,
    aesthetic_score] after the pooled embedding (SDXLRefiner.encode_adm;
    the reference scores positive conds 6.0 and negative ones 2.5)."""
    return _adm(pooled, (*original_size, *crop, aesthetic_score))
