"""Tile rasterizer: the K2 kernels' wrapper and their plain versions.

Counterpart of stable_renderer_tpu/ops/raster_pallas.py. ``rasterize_kernel``
launches ``csrc/raster_tile.cu`` for CUDA tensors: a setup kernel that writes
the (T, 20) triangle constants and each triangle's tile range, then a binned
tile kernel (see the file's header). CPU tensors take the plain
``ops/raster.py:rasterize``. Same ``VisibilityBuffer`` contract as the plain
version.

The kernels' plain versions, which they equal bit for bit on the card:
``triangle_setup`` (the constants), ``tile_ranges`` (the tile ranges) and
``rasterize_tiles_reference`` (the visibility buffer from the constants).
"""

from __future__ import annotations

import torch

from stable_renderer_tpu_torch.device import on_device
from stable_renderer_tpu_torch.ops.raster import VisibilityBuffer, rasterize, window_coords

# packed triangle-constant columns (see triangle_setup)
# 0:A0 1:B0 2:C0 3:A1 4:B1 5:C1 6:A2 7:B2 8:C2  (normalized edge eqs: b_i = A_i x + B_i y + C_i)
# 9:z0 10:z1 11:z2  12:iw0 13:iw1 14:iw2
# 15:minx 16:maxx 17:miny 18:maxy  19:valid
N_COLS = 20
TILE = 16  # pixels a side of the kernel's tiles


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


def tile_ranges(tri_data: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The setup kernel's tile ranges, (T, 4) int16: the first and last tile
    column and row of each triangle's bbox, (1, 0, 1, 0) for none. Tile
    (tx, ty) is in the range exactly when the tile kernel's inclusive test
    admits it: valid, maxx >= 16 tx, minx <= 16 tx + 16, and the same in y."""
    def axis(lo, hi, tiles):
        a = torch.clamp(torch.ceil(lo * 0.0625) - 1.0, min=0.0)
        b = torch.clamp(torch.floor(hi * 0.0625), max=float(tiles - 1))
        return a, b, torch.isnan(lo) | torch.isnan(hi) | (a > b)

    x0, x1, ex = axis(tri_data[:, 15], tri_data[:, 16], -(-width // TILE))
    y0, y1, ey = axis(tri_data[:, 17], tri_data[:, 18], -(-height // TILE))
    none = (ex | ey | ~(tri_data[:, 19] > 0.5))[:, None]
    empty = torch.tensor([1.0, 0.0, 1.0, 0.0], device=tri_data.device)
    return torch.where(none, empty, torch.stack([x0, x1, y0, y1], dim=-1)).to(torch.int16)


def rasterize_tiles_reference(tri_data: torch.Tensor, height: int, width: int,
                              chunk: int = 32) -> VisibilityBuffer:
    """The tile kernel's plain version over the (T, 20) constants: the same
    arithmetic per pixel and triangle, each product, sum and quotient one
    rounding in the kernel's order (edge values, z renormalized by the
    barycentric sum and clipped to [0, 1], perspective-correct barycentrics),
    the tile's bbox test, and in each chunk of triangles the first minimum
    merged with a strict ``<``: on the card the kernel equals it bit for bit."""
    dev = tri_data.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]
    x0 = (torch.arange(width, device=dev) // TILE * TILE).float()[None, :]  # the pixel's tile
    y0 = (torch.arange(height, device=dev) // TILE * TILE).float()[:, None]
    z_buf, tri_id, bary = VisibilityBuffer.empty(height, width, device=dev)
    for base in range(0, tri_data.shape[0], chunk):
        r = tri_data[base: base + chunk]

        def col(k):
            return r[:, k, None, None]  # (G, 1, 1)

        b0 = col(0) * px + col(1) * py + col(2)
        b1 = col(3) * px + col(4) * py + col(5)
        b2 = col(6) * px + col(7) * py + col(8)
        overlap = ((col(16) >= x0) & (col(15) <= x0 + TILE) & (col(18) >= y0)
                   & (col(17) <= y0 + TILE) & (col(19) > 0.5))
        inside = overlap & (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        bsum = b0 + b1 + b2
        z = (b0 * col(9) + b1 * col(10) + b2 * col(11)) / torch.where(bsum > 0, bsum, 1.0)
        z = torch.where(z < 0, 0.0, torch.where(z > 1, 1.0, z))  # keeps NaN, as the kernel
        # a NaN z fails the kernel's z < zbuf, but argmin would pick it
        z = torch.where(inside & ~torch.isnan(z), z, float("inf"))
        pb0, pb1, pb2 = b0 * col(12), b1 * col(13), b2 * col(14)
        denom = pb0 + pb1 + pb2
        denom = torch.where(denom.abs() < 1e-12, 1.0, denom)
        pbary = torch.stack([pb0 / denom, pb1 / denom, pb2 / denom], dim=-1)
        best = torch.argmin(z, dim=0)  # the first (lowest index) minimum
        best_z = torch.gather(z, 0, best[None])[0]
        best_bary = torch.gather(pbary, 0, best[None, ..., None].expand(1, -1, -1, 3))[0]
        closer = best_z < z_buf
        z_buf = torch.where(closer, best_z, z_buf)
        tri_id = torch.where(closer, base + best.to(torch.int32), tri_id)
        bary = torch.where(closer[..., None], best_bary, bary)
    return VisibilityBuffer(z_buf, tri_id, bary)


def _check_inputs(clip_pos: torch.Tensor, tris: torch.Tensor, height: int, width: int) -> None:
    if clip_pos.device.type != "cuda" or tris.device != clip_pos.device:
        raise ValueError(f"rasterize_kernel: clip_pos on {clip_pos.device}, tris on "
                         f"{tris.device}; both must be on one CUDA device")
    if clip_pos.dim() != 2 or clip_pos.shape[1] != 4 or tris.dim() != 2 or tris.shape[1] != 3:
        raise ValueError(f"rasterize_kernel: want clip_pos (V, 4) and tris (T, 3), got "
                         f"{tuple(clip_pos.shape)} and {tuple(tris.shape)}")
    if height <= 0 or width <= 0 or max(height, width) > TILE * 32767:
        raise ValueError(f"rasterize_kernel: frame {height}x{width}")
    if tris.shape[0] and not clip_pos.shape[0]:
        raise ValueError("rasterize_kernel: triangles but no vertices")
    if tris.shape[0] >= 2 ** 31 or clip_pos.shape[0] >= 2 ** 31:
        raise ValueError("rasterize_kernel: more than 2^31 - 1 triangles or vertices")


def _kernel_inputs(clip_pos: torch.Tensor, tris: torch.Tensor):
    """clip_pos as contiguous, 16-byte aligned f32 and tris as contiguous
    int32 or int64, copied only when they are not (the frame's are)."""
    if clip_pos.dtype != torch.float32 or not clip_pos.is_contiguous() or clip_pos.data_ptr() % 16:
        clip_pos = clip_pos.to(torch.float32, memory_format=torch.contiguous_format).clone()
    if tris.dtype not in (torch.int32, torch.int64):
        tris = tris.long()
    return clip_pos, tris.contiguous()


def _launch_setup(lib, clip_pos, tris, height, width, cull_backface, tri_ptr, ranges_ptr,
                  stream) -> None:
    from stable_renderer_tpu_torch.kernels import _build

    rc = lib.sr_raster_setup(clip_pos.data_ptr(), clip_pos.shape[0], tris.data_ptr(),
                             int(tris.dtype == torch.int64), tris.shape[0], height, width,
                             int(cull_backface), tri_ptr, ranges_ptr, stream)
    _build.check(rc, "rasterize_kernel (setup)")


_scratch: dict = {}  # (device index, stream) -> f32 buffer for the setup kernel's outputs


def _scratch_for(dev: torch.device, stream: int, t_count: int):
    """Device pointers to the setup kernel's (T, 20) f32 constants and (T, 4)
    int16 ranges for a launch on ``stream``: one buffer per device and
    stream, grown to a power of two, so that a call allocates nothing but its
    outputs (and a CUDA graph may capture it). Work on one stream runs in
    order, so reusing the buffer there is safe."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    need = 22 * t_count  # 20 f32 + 4 int16 a triangle
    if buf is None or buf.numel() < need:
        buf = torch.empty((1 << max(need - 1, 0).bit_length(),), dtype=torch.float32, device=dev)
        _scratch[key] = buf
    return buf.data_ptr(), buf.data_ptr() + 4 * N_COLS * t_count  # 16-byte aligned


def _current_stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def triangle_setup_kernel(clip_pos: torch.Tensor, tris: torch.Tensor, height: int, width: int,
                          cull_backface: bool = False):
    """The setup kernel alone, into new tensors: ((T, 20) f32 constants,
    (T, 4) int16 tile ranges). On the card these equal ``triangle_setup`` and
    ``tile_ranges`` bit for bit."""
    _check_inputs(clip_pos, tris, height, width)
    from stable_renderer_tpu_torch.kernels import _build

    clip_pos, tris = _kernel_inputs(clip_pos, tris)
    t_count, dev = tris.shape[0], clip_pos.device
    tri_data = torch.empty((t_count, N_COLS), dtype=torch.float32, device=dev)
    ranges = torch.empty((t_count, 4), dtype=torch.int16, device=dev)
    with on_device(dev):
        _launch_setup(_build.load_library(), clip_pos, tris, height, width, cull_backface,
                      tri_data.data_ptr(), ranges.data_ptr(), _current_stream(dev))
    return tri_data, ranges


def rasterize_kernel(
    clip_pos: torch.Tensor,
    tris: torch.Tensor,
    height: int,
    width: int,
    cull_backface: bool = False,
) -> VisibilityBuffer:
    """Rasterize with the K2 kernels (CUDA tensors): the setup kernel, then the
    binned tile kernel, and nothing else but the three outputs' allocations.
    CPU tensors take the plain ``rasterize``."""
    if clip_pos.device.type == "cpu":
        return rasterize(clip_pos, tris, height, width, cull_backface=cull_backface)
    _check_inputs(clip_pos, tris, height, width)
    from stable_renderer_tpu_torch.kernels import _build

    clip_pos, tris = _kernel_inputs(clip_pos, tris)
    lib = _build.load_library()
    dev, t_count = clip_pos.device, tris.shape[0]
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    tri_id = torch.empty((height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    with on_device(dev):
        stream = _current_stream(dev)
        tri_ptr, ranges_ptr = _scratch_for(dev, stream, t_count)
        _launch_setup(lib, clip_pos, tris, height, width, cull_backface, tri_ptr, ranges_ptr,
                      stream)
        rc = lib.sr_raster_tiles(tri_ptr, ranges_ptr, t_count, z.data_ptr(), tri_id.data_ptr(),
                                 bary.data_ptr(), height, width, stream)
    _build.check(rc, "rasterize_kernel")
    rasterize_kernel.launches += 1
    return VisibilityBuffer(z=z, tri_id=tri_id, bary=bary)


rasterize_kernel.launches = 0
