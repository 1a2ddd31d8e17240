"""Camera component.

Counterpart of stable_renderer_tpu/engine/camera.py, the capability match for
the reference's Camera
(reference: engine/runtime/components/camera/camera.py:14-130): fov/near/far/
ortho, main-camera registry, per-camera background EnvPrompt; instead of pushing
matrices into a GL UBO each lateUpdate, view/projection are produced as arrays on
demand for the compiled frame step.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from stable_renderer_tpu_torch.data.sprite import EnvPrompt
from stable_renderer_tpu_torch.engine.gameobj import Component


class Camera(Component):
    _cameras: List["Camera"] = []

    def __init__(
        self,
        game_object,
        fov: float = 45.0,
        near: float = 0.1,
        far: float = 100.0,
        ortho: bool = False,
        ortho_size: float = 1.0,
        main: bool = True,
        env_prompt: Optional[EnvPrompt] = None,
    ):
        super().__init__(game_object)
        self.fov = fov
        self.near = near
        self.far = far
        self.ortho = ortho
        self.ortho_size = ortho_size
        self.env_prompt = env_prompt or EnvPrompt()
        self._is_main = main
        Camera._cameras.append(self)

    def onDestroy(self):
        if self in Camera._cameras:
            Camera._cameras.remove(self)

    @classmethod
    def MainCamera(cls) -> Optional["Camera"]:
        for cam in cls._cameras:
            if cam._is_main and cam.gameObj.is_active:
                return cam
        return cls._cameras[0] if cls._cameras else None

    @classmethod
    def _clear(cls) -> None:
        cls._cameras.clear()

    @property
    def viewMatrix(self) -> np.ndarray:
        """World -> view (inverse of the camera's global transform)."""
        return np.linalg.inv(self.transform.globalTransformMatrix).astype(np.float32)

    def projectionMatrix(self, aspect: float) -> np.ndarray:
        """Projection matrix computed on HOST numpy with a parameter-keyed
        cache: a tiny static 4x4 that belongs on the host (the frame step
        uploads it with the frame's other inputs)."""
        key = (self.ortho, self.ortho_size, self.fov, aspect, self.near, self.far)
        cached = getattr(self, "_proj_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        if self.ortho:
            t = self.ortho_size  # half vertical extent (ops/transforms.py)
            r = t * aspect
            n, f = self.near, self.far
            m = np.array([
                [1.0 / r, 0, 0, 0],
                [0, 1.0 / t, 0, 0],
                [0, 0, -2.0 / (f - n), -(f + n) / (f - n)],
                [0, 0, 0, 1.0],
            ], np.float32)
        else:
            n, f = self.near, self.far
            ttan = float(np.tan(np.radians(self.fov) / 2.0))
            m = np.array([
                [1.0 / (aspect * ttan), 0, 0, 0],
                [0, 1.0 / ttan, 0, 0],
                [0, 0, -(f + n) / (f - n), -2.0 * f * n / (f - n)],
                [0, 0, -1.0, 0],
            ], np.float32)
        self._proj_cache = (key, m)
        return m
