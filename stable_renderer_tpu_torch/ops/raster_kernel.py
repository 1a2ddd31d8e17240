"""Tile rasterizer: the K2 kernel's wrapper and its per-triangle setup.

Counterpart of stable_renderer_tpu/ops/raster_pallas.py. ``triangle_setup``
stays in PyTorch (batched elementwise work over triangles) and packs the
(T, 20) constants the kernel reads; ``rasterize_kernel`` launches
``csrc/raster_tile.cu`` for CUDA tensors and runs the plain
``ops/raster.py:rasterize`` for CPU tensors. Same ``VisibilityBuffer``
contract as the plain version.
"""

from __future__ import annotations

import torch

from stable_renderer_tpu_torch.ops.raster import VisibilityBuffer, rasterize, window_coords

# packed triangle-constant columns (see triangle_setup)
# 0:A0 1:B0 2:C0 3:A1 4:B1 5:C1 6:A2 7:B2 8:C2  (normalized edge eqs: b_i = A_i x + B_i y + C_i)
# 9:z0 10:z1 11:z2  12:iw0 13:iw1 14:iw2
# 15:minx 16:maxx 17:miny 18:maxy  19:valid
N_COLS = 20


def triangle_setup(
    clip_pos: torch.Tensor,  # (V, 4)
    tris: torch.Tensor,      # (T, 3)
    height: int,
    width: int,
    cull_backface: bool = False,
) -> torch.Tensor:
    """Per-triangle constants for the tile kernel: (T, 20) float32.

    Edge equations are pre-divided by the signed area so that inside-ness is
    simply b0, b1, b2 >= 0."""
    tris = tris.long()
    w_clip = clip_pos[:, 3]
    sx, sy, sz, inv_w = window_coords(clip_pos, height, width)
    i0, i1, i2 = tris[:, 0], tris[:, 1], tris[:, 2]
    x0, y0 = sx[i0], sy[i0]
    x1, y1 = sx[i1], sy[i1]
    x2, y2 = sx[i2], sy[i2]
    w_ok = (w_clip[i0] > 1e-6) & (w_clip[i1] > 1e-6) & (w_clip[i2] > 1e-6)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    # GL front face = CCW in GL window coords -> negative area in y-down space
    face_ok = area < -1e-12 if cull_backface else area.abs() > 1e-12
    inv_area = 1.0 / torch.where(area.abs() < 1e-12, torch.ones_like(area), area)

    def edge(ax, ay, bx, by):
        # e(x, y) = (bx-ax)(y-ay) - (by-ay)(x-ax)  ->  A x + B y + C
        return -(by - ay), bx - ax, (by - ay) * ax - (bx - ax) * ay

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    cols = [
        a0 * inv_area, b0 * inv_area, c0 * inv_area,
        a1 * inv_area, b1 * inv_area, c1 * inv_area,
        a2 * inv_area, b2 * inv_area, c2 * inv_area,
        sz[i0], sz[i1], sz[i2],
        inv_w[i0], inv_w[i1], inv_w[i2],
        torch.minimum(torch.minimum(x0, x1), x2),
        torch.maximum(torch.maximum(x0, x1), x2),
        torch.minimum(torch.minimum(y0, y1), y2),
        torch.maximum(torch.maximum(y0, y1), y2),
        (w_ok & face_ok).float(),
    ]
    return torch.stack(cols, dim=-1)


def rasterize_kernel(
    clip_pos: torch.Tensor,
    tris: torch.Tensor,
    height: int,
    width: int,
    cull_backface: bool = False,
) -> VisibilityBuffer:
    """Rasterize with the tile kernel (CUDA tensors); CPU tensors take the
    plain ``rasterize``."""
    if clip_pos.device.type == "cpu":
        return rasterize(clip_pos, tris, height, width, cull_backface=cull_backface)
    if clip_pos.device.type != "cuda" or tris.device != clip_pos.device:
        raise ValueError(f"rasterize_kernel: clip_pos on {clip_pos.device}, tris on "
                         f"{tris.device}; both must be on one CUDA device")
    if clip_pos.dim() != 2 or clip_pos.shape[1] != 4 or tris.dim() != 2 or tris.shape[1] != 3:
        raise ValueError(f"rasterize_kernel: want clip_pos (V, 4) and tris (T, 3), got "
                         f"{tuple(clip_pos.shape)} and {tuple(tris.shape)}")
    if height <= 0 or width <= 0:
        raise ValueError(f"rasterize_kernel: frame {height}x{width}")
    tri_data = triangle_setup(clip_pos.float(), tris, height, width, cull_backface).contiguous()
    from stable_renderer_tpu_torch.kernels import _build

    lib = _build.load_library()
    dev = clip_pos.device
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sr_raster_tile(tri_data.data_ptr(), tri_data.shape[0], z.data_ptr(),
                                tri_id.data_ptr(), bary.data_ptr(), height, width,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "rasterize_kernel")
    rasterize_kernel.launches += 1
    return VisibilityBuffer(z=z, tri_id=tri_id, bary=bary)


rasterize_kernel.launches = 0
