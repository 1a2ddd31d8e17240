"""Temporal-consistency and image-quality metrics.

Counterpart of stable_renderer_tpu/ops/metrics.py (BASELINE.md metric #2,
temporal flicker between consecutive frames; the reference ships no metric
harness):

  * ``temporal_flicker_l1`` / ``temporal_flicker_ssim`` — consecutive-frame
    distance, weight-free.
  * ``vertex_flicker`` — correspondence-aware flicker: the RMS deviation of
    each AI pixel's colour from its 3D vertex's mean colour across all frames,
    from the id maps; independent of camera motion.
  * ``ssim`` — standard SSIM (11x11 Gaussian window, sigma 1.5).
  * ``lpips`` / ``lpips_flicker`` — LPIPS (VGG16 backbone + linear heads) over
    a merged flat dict of torchvision VGG16 ``features.N.*`` and lpips
    ``linK.model.1.weight`` keys, as the JAX package lays it out. No weights
    ship with the repository.

Frames are (N, H, W, C) in [0, 1]; every metric returns a 0-d f32 tensor on
the frames' device (``lpips`` one value a pair).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.ops.correspondence import latent_vertex_ids
from stable_renderer_tpu_torch.ops.math import group_average_by_id


def temporal_flicker_l1(frames: torch.Tensor) -> torch.Tensor:
    """Mean |frame_t - frame_{t-1}| over the sequence."""
    return (frames[1:] - frames[:-1]).abs().mean()


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-0.5 * (ax / sigma) ** 2)
    w = torch.outer(g, g)
    return w / w.sum()


def _ssim_map(a: torch.Tensor, b: torch.Tensor, max_val: float) -> torch.Tensor:
    """(N, H, W, C) pairs -> (N, C, H - 10, W - 10) SSIM map (valid window)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    win = _gaussian_window(device=a.device)[None, None]

    def filt(x):
        n, h, w, c = x.shape
        return F.conv2d(x.permute(0, 3, 1, 2).reshape(n * c, 1, h, w), win).reshape(
            n, c, h - 10, w - 10)

    a, b = a.float(), b.float()
    mu_a, mu_b = filt(a), filt(b)
    sa = filt(a * a) - mu_a ** 2
    sb = filt(b * b) - mu_b ** 2
    sab = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2)
    return num / den


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM between (H, W, C) or (N, H, W, C) images."""
    if a.dim() == 3:
        a, b = a[None], b[None]
    return _ssim_map(a, b, max_val).mean()


def temporal_flicker_ssim(frames: torch.Tensor) -> torch.Tensor:
    """1 - mean SSIM of consecutive frame pairs (0 = perfectly stable)."""
    per_pair = _ssim_map(frames[:-1], frames[1:], 1.0).flatten(1).mean(1)
    return 1.0 - per_pair.mean()


def vertex_flicker(frames: torch.Tensor, id_maps: torch.Tensor,
                   num_segments: int = 262144) -> torch.Tensor:
    """RMS deviation of each AI pixel's colour from its 3D vertex's mean
    colour across all frames (0 = every vertex keeps one colour)."""
    n, h, w, c = frames.shape
    vids, valid = latent_vertex_ids(id_maps, h, w)
    flat = frames.reshape(-1, c).float()
    per_row_mean, _ = group_average_by_id(flat, vids.reshape(-1), num_segments,
                                          valid=valid.reshape(-1))
    sq = ((flat - per_row_mean) ** 2).sum(-1)
    mask = valid.reshape(-1).float()
    return torch.sqrt((sq * mask).sum() / torch.clamp(mask.sum(), min=1.0))


# ---------------------------------------------------------------------------
# LPIPS (Zhang et al.): VGG16 convs at torch indices 0, 2, 5, ..., 28, a 2x2
# max pool after 2, 7, 14 and 21, and the relu outputs after 2, 7, 14, 21 and
# 28 feeding the five linear heads.

_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG16_POOL_AFTER = (2, 7, 14, 21)
_VGG16_TAPS = (2, 7, 14, 21, 28)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _leaf(flat: dict, key: str, device) -> torch.Tensor:
    return torch.as_tensor(flat[key], dtype=torch.float32, device=device)


def _vgg16_tap_features(flat: dict, x: torch.Tensor) -> list:
    """x (B, H, W, 3) in [0, 1] -> the five tap activations, (B, C, h, w)."""
    dev = x.device
    shift = torch.tensor(_LPIPS_SHIFT, device=dev)[None, :, None, None]
    scale = torch.tensor(_LPIPS_SCALE, device=dev)[None, :, None, None]
    h = (x.float().permute(0, 3, 1, 2) * 2.0 - 1.0 - shift) / scale
    taps = []
    for i in _VGG16_CONV_IDX:
        h = torch.relu(F.conv2d(h, _leaf(flat, f"features.{i}.weight", dev),
                                _leaf(flat, f"features.{i}.bias", dev), padding=1))
        if i in _VGG16_TAPS:
            taps.append(h)
        if i in _VGG16_POOL_AFTER:
            h = F.max_pool2d(h, 2)
    return taps


def lpips(flat: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per pair (N,): unit-normalized VGG features, squared
    difference, 1x1 linear head, spatial mean, summed over the five taps."""
    n = a.shape[0]
    taps = _vgg16_tap_features(flat, torch.cat([a, b], 0))
    total = torch.zeros(n, dtype=torch.float32, device=a.device)
    for k, t in enumerate(taps):
        t = t / torch.clamp(t.norm(dim=1, keepdim=True), min=1e-10)
        diff = (t[:n] - t[n:]) ** 2
        lin = _leaf(flat, f"lin{k}.model.1.weight", a.device).reshape(1, -1, 1, 1)
        total = total + (diff * lin).sum(1).mean(dim=(1, 2))
    return total


def lpips_flicker(frames: torch.Tensor, flat: dict) -> torch.Tensor:
    """Mean LPIPS between consecutive frames (BASELINE metric #2 proper)."""
    return lpips(flat, frames[:-1], frames[1:]).mean()
