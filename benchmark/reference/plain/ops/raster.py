"""Triangle rasterizer: the plain version, the device dispatch and interpolation.

Counterpart of stable_renderer_tpu/ops/raster.py. The raster pass writes a
visibility buffer — (window z, triangle id, perspective-correct
barycentrics) per pixel — and ops/gbuffer.py shades from it.

``rasterize`` is the plain PyTorch version (chunks of triangles tested
against every pixel, nearest hit per chunk merged into the buffer). It is
the CPU path and the reference that the tile kernel (K2,
``ops/raster_kernel.py``) is held to. ``rasterize_auto`` is the frame's
entry point: CUDA tensors go to the kernel, CPU tensors to the plain version.

Conventions: GL clip space (z in [-1,1]), window z in [0,1] (less = closer),
y-down image rows with pixel centres at +0.5. Triangles with a vertex behind
the camera (w <= 1e-6) are culled, not clipped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class VisibilityBuffer(NamedTuple):
    """Per-pixel raster output. tri_id == -1 where nothing was drawn."""

    z: torch.Tensor       # (H, W) float32 window depth in [0,1]; 1.0 = empty
    tri_id: torch.Tensor  # (H, W) int32 triangle index, -1 = none
    bary: torch.Tensor    # (H, W, 3) float32 perspective-correct barycentrics

    @staticmethod
    def empty(height: int, width: int, device=None) -> "VisibilityBuffer":
        return VisibilityBuffer(
            z=torch.ones((height, width), dtype=torch.float32, device=device),
            tri_id=torch.full((height, width), -1, dtype=torch.int32, device=device),
            bary=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        )


def vertex_stage(
    positions: torch.Tensor,  # (V, 3) model space
    normals: torch.Tensor,    # (V, 3)
    mv: torch.Tensor,         # (4, 4) model-view
    proj: torch.Tensor,       # (4, 4) projection
    mv_it: Optional[torch.Tensor] = None,
) -> tuple:
    """The default_Gbuffer.vert.glsl equivalent: returns
    (clip_pos (V,4), view_pos (V,3), view_normal (V,3) normalized)."""
    v4 = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=-1)
    view4 = v4 @ mv.T
    view_pos = view4[:, :3]
    clip = view4 @ proj.T
    if mv_it is None:
        mv_it = torch.linalg.inv(mv).T
    vn = normals @ mv_it[:3, :3].T
    vn = vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True), min=1e-8)
    return clip, view_pos, vn


def window_coords(clip_pos: torch.Tensor, height: int, width: int):
    """GL viewport transform with the y flip to image rows: (sx, sy, sz, inv_w)."""
    w_clip = clip_pos[:, 3]
    safe_w = torch.where(w_clip.abs() < 1e-8, torch.full_like(w_clip, 1e-8), w_clip)
    ndc = clip_pos[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] + 1.0) * 0.5 * width
    sy = (1.0 - ndc[:, 1]) * 0.5 * height
    sz = (ndc[:, 2] + 1.0) * 0.5
    return sx, sy, sz, 1.0 / safe_w


def rasterize(
    clip_pos: torch.Tensor,  # (V, 4)
    tris: torch.Tensor,      # (T, 3) int
    height: int,
    width: int,
    chunk: int = 32,
    cull_backface: bool = False,
) -> VisibilityBuffer:
    """Rasterize triangles into a visibility buffer (plain version).

    Per chunk of ``chunk`` triangles, coverage of every pixel is one
    vectorized edge-function test; the chunk's nearest hit per pixel (lowest
    index on ties) is depth-merged into the buffer with a strict ``<``."""
    dev = clip_pos.device
    t_count = tris.shape[0]
    n_chunks = max(1, -(-t_count // chunk))
    tris = tris.long()
    w_clip = clip_pos[:, 3]
    sx, sy, sz, inv_w = window_coords(clip_pos, height, width)
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]   # (1, W)
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]  # (H, 1)
    out = VisibilityBuffer.empty(height, width, device=dev)
    z_buf, tri_id, bary = out

    for ci in range(n_chunks):
        base = ci * chunk
        idx = tris[base: base + chunk]
        if idx.shape[0] == 0:
            break
        i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]

        def col(a):
            return a[:, None, None]  # (G, 1, 1)

        x0, y0 = col(sx[i0]), col(sy[i0])
        x1, y1 = col(sx[i1]), col(sy[i1])
        x2, y2 = col(sx[i2]), col(sy[i2])
        w_ok = col((w_clip[i0] > 1e-6) & (w_clip[i1] > 1e-6) & (w_clip[i2] > 1e-6))
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        # GL front face = CCW in GL window coords (y up): negative area here
        face_ok = area < -1e-12 if cull_backface else area.abs() > 1e-12
        inv_area = 1.0 / torch.where(area.abs() < 1e-12, torch.ones_like(area), area)

        e0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)  # opposite v0
        e1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)  # opposite v1
        e2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)  # opposite v2
        b0, b1, b2 = e0 * inv_area, e1 * inv_area, e2 * inv_area
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & w_ok & face_ok

        z = torch.clamp(b0 * col(sz[i0]) + b1 * col(sz[i1]) + b2 * col(sz[i2]), 0.0, 1.0)
        z = torch.where(inside, z, torch.ones_like(z))
        pb0, pb1, pb2 = b0 * col(inv_w[i0]), b1 * col(inv_w[i1]), b2 * col(inv_w[i2])
        denom = pb0 + pb1 + pb2
        denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
        pbary = torch.stack([pb0, pb1, pb2], dim=-1) / denom[..., None]

        best = torch.argmin(z, dim=0)  # first (lowest index) minimum
        best_z = torch.gather(z, 0, best[None])[0]
        best_bary = torch.gather(pbary, 0, best[None, ..., None].expand(1, -1, -1, 3))[0]
        closer = (best_z < 1.0) & (best_z < z_buf)
        z_buf = torch.where(closer, best_z, z_buf)
        tri_id = torch.where(closer, base + best.to(torch.int32), tri_id)
        bary = torch.where(closer[..., None], best_bary, bary)
    return VisibilityBuffer(z_buf, tri_id, bary)


def rasterize_auto(
    clip_pos: torch.Tensor,
    tris: torch.Tensor,
    height: int,
    width: int,
    cull_backface: bool = False,
) -> VisibilityBuffer:
    """The frame's rasterizer: the plain version on every device."""
    return rasterize(clip_pos, tris, height, width, cull_backface=cull_backface)


def interpolate(vis: VisibilityBuffer, tris: torch.Tensor,
                vertex_attr: torch.Tensor) -> torch.Tensor:
    """Perspective-correct interpolation of a vertex attribute (V, C) over the
    frame -> (H, W, C); pixels with no triangle get zeros."""
    tri = torch.clamp(vis.tri_id, 0, tris.shape[0] - 1).long()
    idx = tris.long()[tri]                 # (H, W, 3)
    attrs = vertex_attr[idx]               # (H, W, 3, C)
    out = torch.einsum("hwk,hwkc->hwc", vis.bary, attrs)
    return torch.where((vis.tri_id >= 0)[..., None], out, torch.zeros_like(out))


def flat_vertex(vis: VisibilityBuffer, tris: torch.Tensor, vertex_attr: torch.Tensor,
                mode: str = "nearest") -> torch.Tensor:
    """Non-interpolated per-pixel vertex attribute (GLSL ``flat``):
    ``nearest`` picks the vertex with the largest barycentric weight,
    ``provoking`` the triangle's last vertex (GL's rule)."""
    tri = torch.clamp(vis.tri_id, 0, tris.shape[0] - 1).long()
    idx = tris.long()[tri]  # (H, W, 3)
    if mode == "provoking":
        chosen = idx[..., 2]
    else:
        chosen = torch.gather(idx, -1, torch.argmax(vis.bary, dim=-1, keepdim=True))[..., 0]
    vals = vertex_attr[chosen]
    none = vis.tri_id < 0
    if vals.dim() == 3:
        return torch.where(none[..., None], torch.zeros_like(vals), vals)
    return torch.where(none, torch.zeros_like(vals), vals)
