"""Camera/object control components.

Counterpart of stable_renderer_tpu/engine/controls.py, the capability match for
the reference's controls
(reference: engine/runtime/components/control/cameraController.py:12,
camera_orbit.py:7,55, rotations.py:4,35, rigidController.py:4): scripted orbits
and rotations used by every example scene. The interactive WASD controller is
exposed with the same API, driven by the headless InputManager (key states can be
fed programmatically or from a remote viewer).
"""

from __future__ import annotations

import numpy as np

from stable_renderer_tpu_torch.engine.gameobj import Component


class AutoRotation(Component):
    """Spin the object around an axis every frame (rotations.py:35)."""

    def __init__(self, game_object, axis=(0.0, 1.0, 0.0), speed_deg: float = 1.0):
        super().__init__(game_object)
        self.axis = np.asarray(axis, np.float32)
        self.speed = speed_deg

    def update(self):
        self.transform.rotate(self.axis, self.speed)


class EqualIntervalRotation(Component):
    """Rotate by a fixed angle every N frames (rotations.py:4) — the bake
    examples use this to sample evenly spaced views."""

    def __init__(self, game_object, axis=(0.0, 1.0, 0.0), angle_deg: float = 45.0, interval: int = 1):
        super().__init__(game_object)
        self.axis = np.asarray(axis, np.float32)
        self.angle = angle_deg
        self.interval = max(int(interval), 1)
        self._count = 0

    def update(self):
        self._count += 1
        if self._count % self.interval == 0:
            self.transform.rotate(self.axis, self.angle)


class CircularOrbit(Component):
    """Orbit around a world-space center at fixed height (camera_orbit.py:7)."""

    def __init__(self, game_object, center=(0.0, 0.0, 0.0), speed_deg: float = 1.0,
                 look_at_center: bool = True):
        super().__init__(game_object)
        self.center = np.asarray(center, np.float32)
        self.speed = speed_deg
        self.look_at_center = look_at_center

    def update(self):
        self.transform.rotateAround(self.center, (0.0, 1.0, 0.0), self.speed)
        if self.look_at_center:
            self.transform.lookAt(self.center)


class HelicalOrbit(CircularOrbit):
    """Circular orbit plus vertical oscillation (camera_orbit.py:55)."""

    def __init__(self, game_object, center=(0.0, 0.0, 0.0), speed_deg: float = 1.0,
                 vertical_speed: float = 0.02, vertical_range: float = 1.0,
                 look_at_center: bool = True):
        super().__init__(game_object, center, speed_deg, look_at_center)
        self.vertical_speed = vertical_speed
        self.vertical_range = vertical_range
        self._phase = 0.0

    def update(self):
        self._phase += self.vertical_speed
        offset = np.sin(self._phase) * self.vertical_range
        pos = self.transform.position
        base_y = self.center[1]
        self.transform.position = np.array([pos[0], base_y + offset, pos[2]], np.float32)
        super().update()


class CameraController(Component):
    """WASD + mouse-drag orbit controller (cameraController.py:12), reading the
    headless InputManager's key/mouse state."""

    def __init__(self, game_object, move_speed: float = 0.1, rotate_speed: float = 0.25):
        super().__init__(game_object)
        self.move_speed = move_speed
        self.rotate_speed = rotate_speed

    def update(self):
        inp = self.engine.InputManager
        t = self.transform
        if inp.GetKey("w"):
            t.translate(t.forward * self.move_speed)
        if inp.GetKey("s"):
            t.translate(-t.forward * self.move_speed)
        if inp.GetKey("a"):
            t.translate(-t.right * self.move_speed)
        if inp.GetKey("d"):
            t.translate(t.right * self.move_speed)
        dx, dy = inp.MouseDelta
        if inp.GetMouseBtn(0) and (dx or dy):
            t.rotate((0.0, 1.0, 0.0), -dx * self.rotate_speed)
            t.rotate(t.right, -dy * self.rotate_speed)


class RigidController(Component):
    """Simple kinematic mover (rigidController.py:4): constant velocity +
    angular velocity applied per frame."""

    def __init__(self, game_object, velocity=(0.0, 0.0, 0.0), angular_axis=(0.0, 1.0, 0.0),
                 angular_speed_deg: float = 0.0):
        super().__init__(game_object)
        self.velocity = np.asarray(velocity, np.float32)
        self.angular_axis = np.asarray(angular_axis, np.float32)
        self.angular_speed = angular_speed_deg

    def update(self):
        self.transform.translate(self.velocity)
        if self.angular_speed:
            self.transform.rotate(self.angular_axis, self.angular_speed)


class RigidBody(Component):
    """Physics placeholder matching the reference stub
    (components/physics/rigidbody.py:11): gravity integration only."""

    def __init__(self, game_object, mass: float = 1.0, use_gravity: bool = True):
        super().__init__(game_object)
        self.mass = mass
        self.use_gravity = use_gravity
        self.velocity = np.zeros(3, np.float32)

    def fixedUpdate(self):
        if self.use_gravity:
            dt = self.engine.RuntimeManager.FixedDeltaTime
            self.velocity = self.velocity + np.asarray([0.0, -9.8, 0.0]) * dt
            self.transform.translate(self.velocity * dt)
