"""Numeric core: AdaIN + grouped (segment) reductions keyed by integer IDs.

Counterpart of stable_renderer_tpu/ops/math.py (the reference's
math_utils.py:27-278). Group ops are fixed-size segment reductions over
``num_segments`` (static shapes, as in the JAX package): ids outside
``[0, num_segments)`` — and rows masked invalid — scatter into one extra dump
segment and keep their own values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def map_mean_std(feat: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) spatial mean / std of an NHWC map, with the
    unbiased variance (ddof=1) of the reference's calc_map_mean_std.
    Returns (N, 1, 1, C) tensors in feat's dtype."""
    n, h, w, c = feat.shape
    flat = feat.reshape(n, h * w, c).float()
    mean = flat.mean(1)
    var = ((flat - mean[:, None, :]) ** 2).sum(1) / max(h * w - 1, 1)
    std = torch.sqrt(var + eps)
    return mean[:, None, None, :].to(feat.dtype), std[:, None, None, :].to(feat.dtype)


def adain(content: torch.Tensor, style: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Adaptive instance normalization, NHWC:
    ``(content - mu_c) / sigma_c * sigma_s + mu_s`` per (batch, channel)."""
    c_mean, c_std = map_mean_std(content, eps)
    s_mean, s_std = map_mean_std(style, eps)
    return (content - c_mean) / c_std * s_std + s_mean


def _valid_segments(ids: torch.Tensor, num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamp ids into range; return (segment_ids_for_scatter, valid_mask).
    Invalid rows scatter into segment ``num_segments`` (the dump segment)."""
    valid = (ids >= 0) & (ids < num_segments)
    seg = torch.where(valid, ids, torch.full_like(ids, num_segments))
    return seg, valid


def group_average_by_id(
    values: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``values`` (N, C) rows sharing the same id, broadcast back to
    each row. Returns (per_row (N, C) — invalid rows keep their value,
    per_segment (num_segments, C) — zero where a segment is empty)."""
    seg, in_range = _valid_segments(ids, num_segments)
    if valid is not None:
        in_range = in_range & valid
        seg = torch.where(in_range, seg, torch.full_like(seg, num_segments))
    seg = seg.long()
    v32 = values.float()
    sums = torch.zeros((num_segments + 1, v32.shape[1]), dtype=torch.float32, device=v32.device)
    sums.index_add_(0, seg, torch.where(in_range[:, None], v32, torch.zeros_like(v32)))
    counts = torch.zeros(num_segments + 1, dtype=torch.float32, device=v32.device)
    counts.index_add_(0, seg, in_range.float())
    seg_mean = (sums / torch.clamp(counts, min=1.0)[:, None])[:-1]
    per_row = seg_mean[torch.clamp(ids, 0, num_segments - 1).long()]
    per_row = torch.where(in_range[:, None], per_row, v32)
    return per_row.to(values.dtype), seg_mean.to(values.dtype)


def downsample_mean(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Mean-pool an (N, H, W, C) map by ``factor`` in both spatial dims (the
    reference merges each 8x8 pixel block into one latent cell)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest-neighbour resize of (N, H, W, C) to (N, height, width, C)."""
    n, h, w, c = x.shape
    rows = torch.arange(height, device=x.device) * h // height
    cols = torch.arange(width, device=x.device) * w // width
    return x[:, rows][:, :, cols]
