"""Transform component: TRS hierarchy with quaternion rotation.

Counterpart of stable_renderer_tpu/engine/transform.py, the capability match
for the reference's Transform
(reference: engine/runtime/components/transform.py:9-393 — position/rotation/
scale, forward/up/right, lookAt, rotateAround, local/global matrices) built on
host numpy (float32, as the JAX package) instead of PyGLM.

Conventions match the reference/GL: right-handed, camera forward = -Z, matrices
act on column vectors (M @ v).
"""

from __future__ import annotations

import numpy as np

from stable_renderer_tpu_torch.engine.gameobj import Component


def _quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _quat_matrix_np(q: np.ndarray) -> np.ndarray:
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), 0],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), 0],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )


def _axis_angle_quat(axis: np.ndarray, angle_deg: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    half = np.deg2rad(angle_deg) / 2
    return np.concatenate([[np.cos(half)], np.sin(half) * axis]).astype(np.float32)


class Transform(Component):
    def __init__(self, game_object):
        super().__init__(game_object)
        self._local_pos = np.zeros(3, np.float32)
        self._local_quat = np.array([1.0, 0, 0, 0], np.float32)  # (w, x, y, z)
        self._local_scale = np.ones(3, np.float32)

    # --- local TRS ---
    @property
    def localPosition(self) -> np.ndarray:
        return self._local_pos.copy()

    @localPosition.setter
    def localPosition(self, v) -> None:
        self._local_pos = np.asarray(v, np.float32).copy()

    @property
    def localRotation(self) -> np.ndarray:
        """Quaternion (w, x, y, z)."""
        return self._local_quat.copy()

    @localRotation.setter
    def localRotation(self, q) -> None:
        q = np.asarray(q, np.float32)
        self._local_quat = (q / np.linalg.norm(q)).copy()

    @property
    def localScale(self) -> np.ndarray:
        return self._local_scale.copy()

    @localScale.setter
    def localScale(self, v) -> None:
        v = np.asarray(v, np.float32)
        self._local_scale = (np.full(3, v, np.float32) if v.ndim == 0 else v).copy()

    @property
    def localEulerAngles(self) -> np.ndarray:
        """Tait-Bryan XYZ in degrees (reference uses glm euler)."""
        w, x, y, z = self._local_quat
        sinr = 2 * (w * x + y * z)
        cosr = 1 - 2 * (x * x + y * y)
        sinp = np.clip(2 * (w * y - z * x), -1, 1)
        siny = 2 * (w * z + x * y)
        cosy = 1 - 2 * (y * y + z * z)
        return np.rad2deg(
            np.array([np.arctan2(sinr, cosr), np.arcsin(sinp), np.arctan2(siny, cosy)])
        ).astype(np.float32)

    @localEulerAngles.setter
    def localEulerAngles(self, euler_deg) -> None:
        # Host numpy (same formula as ops.transforms.quat_from_euler): a tiny
        # 3-vector has no business on the device, where reading it back would
        # block the host on every set.
        rx, ry, rz = np.deg2rad(np.asarray(euler_deg, np.float64)) / 2.0
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        self._local_quat = np.array(
            [
                cx * cy * cz + sx * sy * sz,
                sx * cy * cz - cx * sy * sz,
                cx * sy * cz + sx * cy * sz,
                cx * cy * sz - sx * sy * cz,
            ],
            np.float32,
        )

    # --- matrices ---
    @property
    def localMatrix(self) -> np.ndarray:
        m = _quat_matrix_np(self._local_quat)
        m[:3, :3] = m[:3, :3] * self._local_scale[None, :]
        m[:3, 3] = self._local_pos
        return m

    @property
    def globalTransformMatrix(self) -> np.ndarray:
        parent = self.gameObj.parent
        if parent is not None:
            return parent.transform.globalTransformMatrix @ self.localMatrix
        return self.localMatrix

    # --- global accessors ---
    @property
    def position(self) -> np.ndarray:
        return self.globalTransformMatrix[:3, 3].copy()

    @position.setter
    def position(self, v) -> None:
        v = np.asarray(v, np.float32)
        parent = self.gameObj.parent
        if parent is not None:
            inv = np.linalg.inv(parent.transform.globalTransformMatrix)
            v = (inv @ np.append(v, 1.0))[:3]
        self._local_pos = v.astype(np.float32)

    @property
    def rotation(self) -> np.ndarray:
        parent = self.gameObj.parent
        if parent is not None:
            return _quat_mul_np(parent.transform.rotation, self._local_quat)
        return self._local_quat.copy()

    @property
    def scale(self) -> np.ndarray:
        parent = self.gameObj.parent
        if parent is not None:
            return parent.transform.scale * self._local_scale
        return self._local_scale.copy()

    # --- directions (GL: forward = -Z) ---
    @property
    def forward(self) -> np.ndarray:
        return (_quat_matrix_np(self.rotation)[:3, :3] @ np.array([0, 0, -1.0])).astype(np.float32)

    @property
    def up(self) -> np.ndarray:
        return (_quat_matrix_np(self.rotation)[:3, :3] @ np.array([0, 1.0, 0])).astype(np.float32)

    @property
    def right(self) -> np.ndarray:
        return (_quat_matrix_np(self.rotation)[:3, :3] @ np.array([1.0, 0, 0])).astype(np.float32)

    # --- operations ---
    def translate(self, delta) -> None:
        self._local_pos = self._local_pos + np.asarray(delta, np.float32)

    def rotate(self, axis, angle_deg: float) -> None:
        q = _axis_angle_quat(np.asarray(axis, np.float32), angle_deg)
        self._local_quat = _quat_mul_np(self._local_quat, q)

    def lookAt(self, target, up=(0.0, 1.0, 0.0)) -> None:
        """Orient -Z toward target (reference Transform.lookAt)."""
        pos = self.position
        f = np.asarray(target, np.float64) - pos
        f = f / max(np.linalg.norm(f), 1e-12)
        upv = np.asarray(up, np.float64)
        s = np.cross(f, upv)
        s = s / max(np.linalg.norm(s), 1e-12)
        u = np.cross(s, f)
        m = np.stack([s, u, -f], axis=1)  # columns: right, up, -forward(-z)
        # matrix -> quaternion
        tr = m[0, 0] + m[1, 1] + m[2, 2]
        if tr > 0:
            s4 = np.sqrt(tr + 1.0) * 2
            q = np.array(
                [0.25 * s4, (m[2, 1] - m[1, 2]) / s4, (m[0, 2] - m[2, 0]) / s4, (m[1, 0] - m[0, 1]) / s4]
            )
        else:
            i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
            j, k = (i + 1) % 3, (i + 2) % 3
            s4 = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
            q = np.zeros(4)
            q[0] = (m[k, j] - m[j, k]) / s4
            q[1 + i] = 0.25 * s4
            q[1 + j] = (m[j, i] + m[i, j]) / s4
            q[1 + k] = (m[k, i] + m[i, k]) / s4
        world_q = (q / np.linalg.norm(q)).astype(np.float32)
        parent = self.gameObj.parent
        if parent is not None:
            pq = parent.transform.rotation
            pq_inv = np.array([pq[0], -pq[1], -pq[2], -pq[3]]) / np.dot(pq, pq)
            world_q = _quat_mul_np(pq_inv, world_q)
        self._local_quat = world_q

    def rotateAround(self, center, axis, angle_deg: float) -> None:
        """Orbit the object's position around a world-space point+axis
        (reference Transform.rotateAround)."""
        center = np.asarray(center, np.float64)
        q = _axis_angle_quat(np.asarray(axis, np.float32), angle_deg)
        rot = _quat_matrix_np(q)[:3, :3]
        rel = self.position - center
        self.position = (center + rot @ rel).astype(np.float32)
        self._local_quat = _quat_mul_np(q, self._local_quat)

    def inverseTransformPoint(self, world_point) -> np.ndarray:
        inv = np.linalg.inv(self.globalTransformMatrix)
        return (inv @ np.append(np.asarray(world_point, np.float64), 1.0))[:3].astype(np.float32)
