"""Image-space edge detection for ControlNet conditioning and map dumps.

Counterpart of stable_renderer_tpu/ops/canny.py (the reference's Kornia canny
node, comfy_extras/nodes_canny.py, used by OutputAICannyMap): a Gaussian blur,
Sobel gradients, non-maximum suppression over four quantized directions, a
double threshold and one-hop hysteresis (a weak pixel survives when one of its
8 neighbours is strong). Plain PyTorch on any device.

Where the normalized gradient sits on a threshold or ties a neighbour in the
suppression, the last bits of the blur and Sobel sums decide the pixel, so
two devices (or two packages) may differ there: ``unstable_pixels`` marks
those pixels, for comparisons.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int = 5, sigma: float = 1.0, device=None) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (ax / sigma) ** 2)
    k = torch.outer(g, g)
    return k / k.sum()


def _conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(N, H, W) map correlated with the (kh, kw) kernel, zero-padded to the
    same size."""
    kh, kw = k.shape
    return F.conv2d(x[:, None], k[None, None], padding=(kh // 2, kw // 2))[:, 0]


def canny(images: torch.Tensor, low_threshold: float = 0.4,
          high_threshold: float = 0.8) -> torch.Tensor:
    """(N, H, W, 3) images in [0, 1] -> (N, H, W, 3) edge map in {0, 1},
    replicated to three channels like the reference's canny buffer."""
    images = images.float()
    dev = images.device
    gray = 0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
    blurred = _conv(gray, _gaussian_kernel(device=dev))
    sobel_x = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float32,
                           device=dev)
    gx = _conv(blurred, sobel_x)
    gy = _conv(blurred, sobel_x.T.contiguous())
    mag = torch.sqrt(gx ** 2 + gy ** 2)
    mag = mag / torch.clamp(mag.amax(dim=(1, 2), keepdim=True), min=1e-8)

    # quantized-direction non-maximum suppression
    q = torch.round(torch.atan2(gy, gx) / (math.pi / 4)).to(torch.int32) % 4

    def sh(a, dy, dx):
        return torch.roll(a, (dy, dx), dims=(1, 2))

    na = torch.where(q == 0, sh(mag, 0, 1), torch.where(
        q == 1, sh(mag, 1, 1), torch.where(q == 2, sh(mag, 1, 0), sh(mag, 1, -1))))
    nb = torch.where(q == 0, sh(mag, 0, -1), torch.where(
        q == 1, sh(mag, -1, -1), torch.where(q == 2, sh(mag, -1, 0), sh(mag, -1, 1))))
    mag = torch.where((mag >= na) & (mag >= nb), mag, torch.zeros_like(mag))

    strong = mag >= high_threshold
    weak = mag >= low_threshold
    strong_f = strong.float()
    neighbor = sum(sh(strong_f, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    edges = strong | (weak & (neighbor > 0))
    return edges[..., None].float().expand(*edges.shape, 3)


def unstable_pixels(images: torch.Tensor, low_threshold: float = 0.4,
                    high_threshold: float = 0.8, tol: float = 1e-5) -> torch.Tensor:
    """(N, H, W) bool on the CPU: the pixels whose ``canny`` decision f32
    rounding may flip. The normalized gradient magnitude, in float64, lies
    within ``tol`` of a threshold or of one of its 8 neighbours (the
    suppression compares them); their 8 neighbours are marked too (one-hop
    hysteresis)."""
    x = images.detach().to("cpu", torch.float64)
    gray = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    b = _conv(gray, _gaussian_kernel().double())
    sobel_x = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float64)
    mag = torch.sqrt(_conv(b, sobel_x) ** 2 + _conv(b, sobel_x.T.contiguous()) ** 2)
    mag = mag / torch.clamp(mag.amax(dim=(1, 2), keepdim=True), min=1e-8)
    shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    near = ((mag - low_threshold).abs() < tol) | ((mag - high_threshold).abs() < tol)
    for dy, dx in shifts:
        near |= (mag - torch.roll(mag, (dy, dx), dims=(1, 2))).abs() < tol
    grown = near.clone()
    for dy, dx in shifts:
        grown |= torch.roll(near, (dy, dx), dims=(1, 2))
    return grown
