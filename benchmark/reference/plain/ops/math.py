"""Numeric core: AdaIN + grouped (segment) reductions keyed by integer IDs.

Counterpart of stable_renderer_tpu/ops/math.py (the reference's
math_utils.py:27-278). Group ops are fixed-size segment reductions over
``num_segments`` (static shapes, as in the JAX package): ids outside
``[0, num_segments)`` — and rows masked invalid — scatter into one extra dump
segment and keep their own values. Segment sums go through ``segment_add_``,
whose order of additions is fixed, so a frame is the same from run to run.
The group means take a ``reduce``: a
callable that sums a tensor in place over the ranks holding the rest of the
rows (``parallel.mesh.FrameShard.all_reduce_``), applied to the segment sums
and counts before the division. Randomness comes from a
``torch.Generator``; ``group_randn_by_id`` also takes its draws passed in,
since ``jax.random`` and torch never draw the same numbers.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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


def segment_add_(out: torch.Tensor, seg: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[seg[i]] += values[i]`` for every row i, in place, in an order
    fixed by the input. On CUDA ``index_put_(accumulate=True)`` sorts the
    indices and adds each segment's rows in turn, where ``index_add_`` adds
    with atomics in an order that changes from run to run (and so the last
    bits of a segment mean, which four sampler steps grow to ~0.02 of a
    pixel). On the CPU ``index_add_`` adds the rows in order, where
    ``index_put_`` splits them over threads."""
    if out.device.type == "cuda":
        return out.index_put_((seg,), values, accumulate=True)
    return out.index_add_(0, seg, values)


def _masked_segments(ids, num_segments, valid):
    """``_valid_segments`` with an extra validity mask; segment ids as int64."""
    seg, in_range = _valid_segments(ids, num_segments)
    if valid is not None:
        in_range = in_range & valid
        seg = torch.where(in_range, seg, torch.full_like(seg, num_segments))
    return seg.long(), in_range


def group_average_by_id(
    values: torch.Tensor,
    ids: torch.Tensor,
    num_segments: int,
    valid: Optional[torch.Tensor] = None,
    reduce: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``values`` (N, C) rows sharing the same id, broadcast back to
    each row. Returns (per_row (N, C) — invalid rows keep their value,
    per_segment (num_segments, C) — zero where a segment is empty)."""
    seg, in_range = _masked_segments(ids, num_segments, valid)
    v32 = values.float()
    sums = torch.zeros((num_segments + 1, v32.shape[1]), dtype=torch.float32, device=v32.device)
    segment_add_(sums, seg, torch.where(in_range[:, None], v32, torch.zeros_like(v32)))
    counts = torch.zeros(num_segments + 1, dtype=torch.float32, device=v32.device)
    segment_add_(counts, seg, in_range.float())
    if reduce is not None:
        reduce(sums)
        reduce(counts)
    seg_mean = (sums / torch.clamp(counts, min=1.0)[:, None])[:-1]
    per_row = seg_mean[torch.clamp(ids, 0, num_segments - 1).long()]
    per_row = torch.where(in_range[:, None], per_row, v32)
    return per_row.to(values.dtype), seg_mean.to(values.dtype)


def group_weighted_average_by_id(
    values: torch.Tensor,
    ids: torch.Tensor,
    weights: torch.Tensor,
    num_segments: int,
    valid: Optional[torch.Tensor] = None,
    reduce: Optional[Callable] = None,
) -> torch.Tensor:
    """Per-row trust-weighted group mean: every member of an id group gets
    sum_j(w_j x_j) / sum_j(w_j) over the group; invalid rows keep their value
    (the legacy PerpendicularViewNormal and PixelDistance overlap schemes)."""
    seg, in_range = _masked_segments(ids, num_segments, valid)
    v32 = values.float()
    w32 = torch.where(in_range, weights.float(), torch.zeros_like(weights, dtype=torch.float32))
    sums = torch.zeros((num_segments + 1, v32.shape[1]), dtype=torch.float32, device=v32.device)
    segment_add_(sums, seg, v32 * w32[:, None])
    wsum = torch.zeros(num_segments + 1, dtype=torch.float32, device=v32.device)
    segment_add_(wsum, seg, w32)
    if reduce is not None:
        reduce(sums)
        reduce(wsum)
    seg_mean = (sums / torch.clamp(wsum, min=1e-8)[:, None])[:-1]
    per_row = seg_mean[torch.clamp(ids, 0, num_segments - 1).long()]
    return torch.where(in_range[:, None], per_row, v32).to(values.dtype)


def group_frame_distance_average(
    values: torch.Tensor,   # (N, C) rows = pixels across a frame batch
    ids: torch.Tensor,      # (N,) vertex ids
    frames: torch.Tensor,   # (N,) frame index of each row
    num_segments: int,
    n_frames: int,
    valid: Optional[torch.Tensor] = None,
    reduce: Optional[Callable] = None,
) -> torch.Tensor:
    """Pairwise frame-distance mixing (the legacy FrameDistance scheme): row
    i of group g becomes sum_j x_j / (|f_i - f_j| + 1), normalized, over the
    group's rows j. Per-(segment, frame) sums and counts with one
    ``segment_add_`` over seg * n_frames + frame, then the static (F, F)
    reciprocal-distance kernel combines them."""
    seg, in_range = _valid_segments(ids, num_segments)
    if valid is not None:
        in_range = in_range & valid
    f = torch.clamp(frames, 0, n_frames - 1).long()
    dump = num_segments * n_frames
    seg2 = torch.where(in_range, seg.long() * n_frames + f, torch.full_like(f, dump))
    v32 = values.float()
    c = v32.shape[1]
    sums = torch.zeros((dump + 1, c), dtype=torch.float32, device=v32.device)
    segment_add_(sums, seg2, torch.where(in_range[:, None], v32, torch.zeros_like(v32)))
    counts = torch.zeros(dump + 1, dtype=torch.float32, device=v32.device)
    segment_add_(counts, seg2, in_range.float())
    if reduce is not None:
        reduce(sums)
        reduce(counts)
    sums = sums[:-1].reshape(num_segments, n_frames, c)
    counts = counts[:-1].reshape(num_segments, n_frames)
    fgrid = torch.arange(n_frames, dtype=torch.float32, device=v32.device)
    kern = 1.0 / ((fgrid[:, None] - fgrid[None, :]).abs() + 1.0)  # (F, F)
    mixed = torch.einsum("tf,sfc->stc", kern, sums)  # (S, F, C)
    norm = torch.einsum("tf,sf->st", kern, counts)   # (S, F)
    out_sf = mixed / torch.clamp(norm, min=1e-8)[..., None]
    per_row = out_sf[torch.clamp(ids, 0, num_segments - 1).long(), f]
    return torch.where(in_range[:, None], per_row, v32).to(values.dtype)


def group_randn_by_id(
    generator: Optional[torch.Generator],
    ids: torch.Tensor,
    num_segments: int,
    channels: int,
    dtype=torch.float32,
    table: Optional[torch.Tensor] = None,
    fallback: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A standard-normal value per id, the same for every row sharing it
    (the reference's tensor_group_by_then_randn_init): (N, channels). Rows
    with out-of-range ids take independent draws. ``table``
    (num_segments, channels) and ``fallback`` (N, channels) replace the
    generator's draws, in that order, when given."""
    dev = ids.device
    if table is None:
        table = torch.randn((num_segments, channels), generator=generator, device=dev)
    if fallback is None:
        fallback = torch.randn((ids.shape[0], channels), generator=generator, device=dev)
    in_range = (ids >= 0) & (ids < num_segments)
    gathered = table.to(dev, torch.float32)[torch.clamp(ids, 0, num_segments - 1).long()]
    return torch.where(in_range[:, None], gathered, fallback.to(dev, torch.float32)).to(dtype)


def group_first_by_id(
    values: torch.Tensor,
    ids: torch.Tensor,
    order: torch.Tensor,
    num_segments: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast, within each id group, the value of the row with the
    smallest ``order`` to every row of the group (the reference's
    tensor_group_by_then_set_first_occurance, deterministic). Ties in
    ``order`` go to the lowest row index. Both minima are
    ``scatter_reduce(..., "amin")``: no host sync.

    Returns (per_row (N, C), winner row per segment (num_segments,) int32,
    -1 where a segment is empty)."""
    n = values.shape[0]
    dev = values.device
    seg, in_range = _masked_segments(ids, num_segments, valid)
    big = torch.iinfo(torch.int32).max
    order32 = order.to(torch.int32)
    keyed = torch.where(in_range, order32, torch.full_like(order32, big))
    seg_min = torch.full((num_segments + 1,), big, dtype=torch.int32, device=dev)
    seg_min = seg_min.scatter_reduce(0, seg, keyed, "amin")[:-1]
    safe_ids = torch.clamp(ids, 0, num_segments - 1).long()
    row_idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_winner = in_range & (order32 == seg_min[safe_ids])
    winner = torch.full((num_segments + 1,), big, dtype=torch.int32, device=dev)
    winner = winner.scatter_reduce(
        0, seg, torch.where(is_winner, row_idx, torch.full_like(row_idx, big)), "amin")[:-1]
    empty = winner == big
    winner_safe = torch.where(empty, torch.zeros_like(winner), winner).long()
    seg_first = torch.where(empty[:, None], torch.zeros((), device=dev),
                            values[winner_safe].float())
    per_row = torch.where(in_range[:, None], seg_first[safe_ids], values.float())
    return per_row.to(values.dtype), torch.where(empty, torch.full_like(winner, -1), winner)


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
