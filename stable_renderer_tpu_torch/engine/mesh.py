"""Procedural meshes as host numpy vertex/index buffers.

Counterpart of stable_renderer_tpu/engine/mesh.py: the ``Mesh`` dataclass with
the procedural ``Plane``, ``Sphere`` and ``Cube`` (reference mesh.py:448-470).
Vertex IDs are the vertex's index in the mesh (vertexID 0 is valid). OBJ and
glTF loading are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


@dataclass
class Mesh:
    positions: np.ndarray          # (V, 3) float32
    normals: np.ndarray            # (V, 3) float32
    uvs: np.ndarray                # (V, 2) float32
    colors: np.ndarray             # (V, 3) float32
    tris: np.ndarray               # (T, 3) int32
    vertex_ids: np.ndarray = None  # (V,) int32
    tangents: np.ndarray = None    # (V, 3) float32
    bitangents: np.ndarray = None  # (V, 3) float32
    name: str = "mesh"
    # material id per triangle for multi-material OBJ/MTL meshes (reference
    # mesh.py materials list + per-material draw); -1 = default material.
    tri_material: np.ndarray = None  # (T,) int32

    def __post_init__(self) -> None:
        v = self.positions.shape[0]
        if self.vertex_ids is None:
            self.vertex_ids = np.arange(v, dtype=np.int32)
        if self.tri_material is None:
            self.tri_material = np.full((self.tris.shape[0],), -1, np.int32)
        if self.tangents is None or self.bitangents is None:
            self.tangents, self.bitangents = _tangent_space(
                self.positions, self.uvs, self.tris
            )

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @cached_property
    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Object-space AABB (min, max) corners, computed once per mesh."""
        if self.positions.shape[0]:
            return self.positions.min(0), self.positions.max(0)
        return np.zeros(3, np.float32), np.zeros(3, np.float32)

    @property
    def triangle_count(self) -> int:
        return self.tris.shape[0]

    # --- procedural geometry (reference mesh.py:448-470 Plane/Sphere) ---

    @classmethod
    def Plane(cls, size: float = 1.0, segments: int = 1) -> "Mesh":
        """XZ plane centered at origin, +Y normal, uv spanning [0,1]^2."""
        s = segments
        xs = np.linspace(-size / 2, size / 2, s + 1, dtype=np.float32)
        zs = np.linspace(-size / 2, size / 2, s + 1, dtype=np.float32)
        gx, gz = np.meshgrid(xs, zs, indexing="xy")
        pos = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
        nrm = np.tile(np.array([[0, 1, 0]], np.float32), (pos.shape[0], 1))
        u, v = np.meshgrid(
            np.linspace(0, 1, s + 1, dtype=np.float32),
            np.linspace(0, 1, s + 1, dtype=np.float32),
            indexing="xy",
        )
        uv = np.stack([u, v], axis=-1).reshape(-1, 2)
        tris = []
        for j in range(s):
            for i in range(s):
                a = j * (s + 1) + i
                b = a + 1
                c = a + (s + 1)
                d = c + 1
                tris += [[a, c, b], [b, c, d]]
        col = np.ones_like(pos)
        return cls(pos, nrm, uv, col, np.asarray(tris, np.int32), name="plane")

    @classmethod
    def Sphere(cls, radius: float = 1.0, segments: int = 32) -> "Mesh":
        """UV sphere (latitude/longitude), matching the reference's _SphereMesh."""
        lat = segments
        lon = segments
        phis = np.linspace(0, np.pi, lat + 1, dtype=np.float32)
        thetas = np.linspace(0, 2 * np.pi, lon + 1, dtype=np.float32)
        pos, nrm, uv = [], [], []
        for j, phi in enumerate(phis):
            for i, theta in enumerate(thetas):
                x = np.sin(phi) * np.cos(theta)
                y = np.cos(phi)
                z = np.sin(phi) * np.sin(theta)
                pos.append([radius * x, radius * y, radius * z])
                nrm.append([x, y, z])
                uv.append([i / lon, 1.0 - j / lat])
        tris = []
        for j in range(lat):
            for i in range(lon):
                a = j * (lon + 1) + i
                b = a + 1
                c = a + (lon + 1)
                d = c + 1
                if j > 0:
                    tris.append([a, b, c])
                if j < lat - 1:
                    tris.append([b, d, c])
        pos = np.asarray(pos, np.float32)
        return cls(
            pos,
            np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32),
            np.ones_like(pos),
            np.asarray(tris, np.int32),
            name="sphere",
        )

    @classmethod
    def Cube(cls, size: float = 1.0) -> "Mesh":
        s = size / 2
        faces = [
            ([0, 0, 1], [[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]]),
            ([0, 0, -1], [[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]]),
            ([1, 0, 0], [[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]]),
            ([-1, 0, 0], [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]]),
            ([0, 1, 0], [[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]]),
            ([0, -1, 0], [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]]),
        ]
        pos, nrm, uv, tris = [], [], [], []
        for n, corners in faces:
            base = len(pos)
            pos.extend(corners)
            nrm.extend([n] * 4)
            uv.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
            tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        pos = np.asarray(pos, np.float32)
        return cls(
            pos,
            np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32),
            np.ones_like(pos),
            np.asarray(tris, np.int32),
            name="cube",
        )


def _tangent_space(
    positions: np.ndarray, uvs: np.ndarray, tris: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex tangent/bitangent from uv gradients (assimp CalcTangentSpace
    equivalent, averaged over incident triangles)."""
    v = positions.shape[0]
    tan = np.zeros((v, 3), np.float64)
    bit = np.zeros((v, 3), np.float64)
    if tris.shape[0]:
        p0, p1, p2 = (positions[tris[:, k]] for k in range(3))
        t0, t1, t2 = (uvs[tris[:, k]] for k in range(3))
        e1, e2 = p1 - p0, p2 - p0
        d1, d2 = t1 - t0, t2 - t0
        det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
        r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1, det))
        t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
        b = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r[:, None]
        for k in range(3):
            np.add.at(tan, tris[:, k], t)
            np.add.at(bit, tris[:, k], b)
    norm = np.linalg.norm(tan, axis=-1, keepdims=True)
    tan = np.where(norm > 1e-12, tan / np.maximum(norm, 1e-12), [1.0, 0, 0])
    norm = np.linalg.norm(bit, axis=-1, keepdims=True)
    bit = np.where(norm > 1e-12, bit / np.maximum(norm, 1e-12), [0, 1.0, 0])
    return tan.astype(np.float32), bit.astype(np.float32)
