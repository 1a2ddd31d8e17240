"""Camera / transform math over torch tensors.

Counterpart of stable_renderer_tpu/ops/transforms.py. Matrices are (4, 4)
float32 acting on column vectors (M @ v); conventions match OpenGL
(right-handed view space, camera looks down -Z, clip z in [-1, 1]).
Functions that take no tensor build their result on the CPU; the others
follow their inputs' device.
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def perspective(fov_y_deg: float, aspect: float, near: float, far: float) -> torch.Tensor:
    """GL-style perspective projection matrix (column-action: proj @ v)."""
    f = 1.0 / math.tan(math.radians(fov_y_deg) / 2.0)
    return _f32([
        [f / aspect, 0.0, 0.0, 0.0],
        [0.0, f, 0.0, 0.0],
        [0.0, 0.0, (far + near) / (near - far), 2.0 * far * near / (near - far)],
        [0.0, 0.0, -1.0, 0.0],
    ])


def orthographic(size: float, aspect: float, near: float, far: float) -> torch.Tensor:
    """GL orthographic projection; ``size`` = half vertical extent."""
    t, b = size, -size
    r, l = size * aspect, -size * aspect
    return _f32([
        [2.0 / (r - l), 0, 0, -(r + l) / (r - l)],
        [0, 2.0 / (t - b), 0, -(t + b) / (t - b)],
        [0, 0, -2.0 / (far - near), -(far + near) / (far - near)],
        [0, 0, 0, 1.0],
    ])


def look_at(eye, center, up) -> torch.Tensor:
    """GL lookAt view matrix."""
    eye, center, up = _f32(eye), _f32(center), _f32(up)
    f = center - eye
    f = f / torch.linalg.norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.norm(s)
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -torch.dot(s, eye), -torch.dot(u, eye), torch.dot(f, eye)
    return m


def translate(t) -> torch.Tensor:
    t = _f32(t)
    m = torch.eye(4, dtype=torch.float32, device=t.device)
    m[:3, 3] = t
    return m


def scale(s) -> torch.Tensor:
    s = torch.broadcast_to(_f32(s), (3,))
    return torch.diag(torch.cat([s, torch.ones(1, dtype=torch.float32, device=s.device)]))


def quat_from_euler(euler_xyz_deg) -> torch.Tensor:
    """(x, y, z) intrinsic Tait-Bryan angles in degrees -> quaternion (w, x, y, z)."""
    rx, ry, rz = torch.deg2rad(_f32(euler_xyz_deg)) / 2.0
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    return torch.stack([
        cx * cy * cz + sx * sy * sz,
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
    ])


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion q (w, x, y, z)."""
    w, xyz = q[0], torch.broadcast_to(q[1:], v.shape)
    t = 2.0 * torch.linalg.cross(xyz, v)
    return v + w * t + torch.linalg.cross(xyz, t)


def quat_to_matrix(q) -> torch.Tensor:
    q = _f32(q)
    w, x, y, z = q / torch.linalg.norm(q)
    zero, one = torch.zeros_like(w), torch.ones_like(w)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), zero]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), zero]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), zero]),
        torch.stack([zero, zero, zero, one]),
    ])


def trs(translation, rotation_quat, scaling) -> torch.Tensor:
    """Compose a model matrix = T @ R @ S."""
    return translate(translation) @ quat_to_matrix(rotation_quat) @ scale(scaling)


def normal_matrix(model_view: torch.Tensor) -> torch.Tensor:
    """Inverse-transpose of the upper-left 3x3 (transforms normals to view space)."""
    return torch.linalg.inv(model_view[:3, :3]).T


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4,4) matrix to (..., 3) points, returning (..., 3) (w-divide)."""
    p4 = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = p4 @ m.T
    return out[..., :3] / out[..., 3:4]


def transform_dirs(m: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Apply the rotation part of a (4,4) matrix to (..., 3) directions."""
    return dirs @ m[:3, :3].T
