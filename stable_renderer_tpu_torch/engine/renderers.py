"""Renderer components: MeshRenderer, CorrMapRenderer, SpriteInfo, Light.

Counterpart of stable_renderer_tpu/engine/renderers.py, the capability match
for the reference's renderer components
(reference: engine/runtime/components/renderer/mesh_renderer.py:15-128,
corrmap_renderer.py:43-192, components/ai/sprite.py:11-45,
components/light/light.py:13-80). Each frame they submit DrawCalls (arrays +
uniforms) into the RenderManager's sorted queue — draw order encodes opaque
near-to-far / transparent far-to-near exactly like the reference's
order = render_order -/+ 1/cam_z.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
from stable_renderer_tpu_torch.data.sprite import Sprite
from stable_renderer_tpu_torch.engine.gameobj import Component
from stable_renderer_tpu_torch.engine.material import DefaultTextureType, Material, RenderOrder
from stable_renderer_tpu_torch.engine.mesh import Mesh
from stable_renderer_tpu_torch.engine.texture import Texture
from stable_renderer_tpu_torch.ops.gbuffer import (
    RENDER_MODE_BAKED,
    RENDER_MODE_BAKING,
    RENDER_MODE_NORMAL,
    DrawUniforms,
)


@dataclass
class DrawCall:
    """One draw submitted to the render queue: everything the draw pass needs
    (host-side mesh + matrices + uniforms + texture tensors)."""

    mesh: Mesh
    model_matrix: np.ndarray
    uniforms: DrawUniforms
    order: float = 0.0
    diffuse: Optional[Texture] = None
    noise: Optional[Texture] = None
    corrmap: Optional[CorrespondMap] = None
    shader: Optional[object] = None  # engine/shader.py Shader (None = fixed)


class MeshRenderer(Component):
    """Non-AI mesh drawing (mesh_renderer.py): one DrawCall per material with
    camera-distance draw order; supports multi-material meshes via tri_material."""

    def __init__(self, game_object, mesh: Mesh | None = None,
                 materials: List[Material] | None = None):
        super().__init__(game_object)
        self.mesh = mesh
        self.materials = materials or [Material.DefaultOpaqueMaterial()]
        if mesh is not None:
            # deferred device upload: ResourcesManager.prepare batches all
            # mesh uploads before the frame loop (resources_obj.py semantics)
            from stable_renderer_tpu_torch.engine.resources import MeshResource

            self._mesh_resource = MeshResource(mesh, name=mesh.name)

    def load_MTL_Materials(self, path) -> None:
        mats = Material.Load_MTL(path)
        names = getattr(self.mesh, "material_names", [])
        self.materials = [mats[n] for n in names if n in mats] or list(mats.values())

    def _order_factor(self):
        from stable_renderer_tpu_torch.engine.camera import Camera

        cam = Camera.MainCamera()
        if cam is None:
            return True, 1.0
        z = -cam.transform.inverseTransformPoint(self.transform.position)[2]
        return z > 0, z + 1.0

    def update(self):
        if self.mesh is None:
            return
        visible, cam_z = self._order_factor()
        if not visible:
            return
        model = self.transform.globalTransformMatrix
        for mat in self.materials:
            if RenderOrder.OPAQUE.value <= mat.render_order < RenderOrder.TRANSPARENT.value:
                order = mat.render_order - 1.0 / cam_z  # opaque: near -> far
            else:
                order = mat.render_order + 1.0 / cam_z  # transparent: far -> near
            self.engine.RenderManager.AddGBufferTask(
                DrawCall(
                    mesh=self.mesh,
                    model_matrix=model,
                    uniforms=DrawUniforms(
                        sprite_id=self._sprite_id(),
                        material_id=mat.materialID,
                        render_mode=RENDER_MODE_NORMAL,
                        has_vertex_color=True,
                    ),
                    order=order,
                    diffuse=mat.diffuse,
                    noise=mat.noise,
                    shader=getattr(mat, "shader", None),
                )
            )

    def _sprite_id(self) -> int:
        info = self.gameObj.getComponent(SpriteInfo)
        return info.sprite.spriteID if info else 0


class SpriteInfo(Component):
    """Attaches a Sprite (id + prompts) and submits it every frame
    (components/ai/sprite.py:11-45)."""

    def __init__(self, game_object, sprite: Sprite | None = None,
                 prompt: str = "", negative_prompt: str = ""):
        super().__init__(game_object)
        self.sprite = sprite or Sprite(prompt=prompt, negative_prompt=negative_prompt)

    def update(self):
        self.engine.RenderManager.SubmitSprite(self.sprite)


class CorrMapRenderer(Component):
    """AI-object renderer (corrmap_renderer.py:43-192): draws with renderMode
    BAKING (bake mode) or BAKED (replay from the corrmap), auto-attaches a noise
    texture, and submits its CorrespondMap into the frame's EngineData. Each
    map moves to the engine's device with the resources' prepare pass."""

    def __init__(self, game_object, mesh: Mesh | None = None,
                 corrmaps: List[CorrespondMap] | None = None,
                 materials: List[Material] | None = None,
                 use_texcoord_id: bool = True,
                 auto_noise_map_if_not_exist: bool = True):
        super().__init__(game_object)
        self.mesh = mesh
        self.corrmaps = corrmaps or []
        self.materials = materials or [Material.DefaultOpaqueMaterial()]
        self.use_texcoord_id = use_texcoord_id
        self.auto_noise_map_if_not_exist = auto_noise_map_if_not_exist
        from stable_renderer_tpu_torch.engine.resources import CorrMapResource

        self._corrmap_resources = [CorrMapResource(c) for c in self.corrmaps]

    def start(self):
        for i, mat in enumerate(self.materials):
            if i >= len(self.corrmaps):
                break
            if not mat.hasDefaultTexture(DefaultTextureType.CorrespondMap):
                mat.addDefaultTexture(self.corrmaps[i], DefaultTextureType.CorrespondMap)
            if (
                not mat.hasDefaultTexture(DefaultTextureType.Noise)
                and self.auto_noise_map_if_not_exist
            ):
                mat.addDefaultTexture(Texture.CreateNoiseTex(), DefaultTextureType.Noise)

    @property
    def spriteID(self) -> Optional[int]:
        info = self.gameObj.getComponent(SpriteInfo)
        return info.sprite.spriteID if info else None

    def update(self):
        from stable_renderer_tpu_torch.engine.camera import Camera
        from stable_renderer_tpu_torch.engine.engine import EngineMode

        if self.mesh is None or not self.corrmaps or self.spriteID is None:
            return
        cam = Camera.MainCamera()
        cam_z = 1.0
        if cam is not None:
            cam_z = -cam.transform.inverseTransformPoint(self.transform.position)[2]
            if not cam_z > 0:
                return
            cam_z += 1.0
        mode = RENDER_MODE_BAKING if self.engine.Mode == EngineMode.BAKE else RENDER_MODE_BAKED
        model = self.transform.globalTransformMatrix
        for i, mat in enumerate(self.materials):
            if i >= len(self.corrmaps):
                break
            cmap = self.corrmaps[i]
            self.engine.RenderManager.AddGBufferTask(
                DrawCall(
                    mesh=self.mesh,
                    model_matrix=model,
                    uniforms=DrawUniforms(
                        sprite_id=self.spriteID,
                        material_id=mat.materialID,
                        render_mode=mode,
                        corrmap_k=cmap.k,
                        use_texcoord_as_id=self.use_texcoord_id and bool(np.any(self.mesh.uvs)),
                    ),
                    order=mat.render_order - 1.0 / cam_z,
                    diffuse=mat.diffuse,
                    noise=mat.noise,
                    corrmap=cmap,
                )
            )
            self.engine.RenderManager.SubmitCorrmap(self.spriteID, mat.materialID, cmap)


class Light(Component):
    """Light component hierarchy (light.py:13-80: position/color/intensity +
    const/linear/quadratic attenuation shader structs). ``pack_lights`` maps
    the live components into the (L, 16) array the defer stage's Lambert term
    consumes (ops/postprocess.py apply_lights) — the counterpart of the
    reference's Light UBO block. Shadow maps are TODO in the reference too
    (renderManager.py:452-461)."""

    def __init__(self, game_object, color=(1.0, 1.0, 1.0), intensity: float = 1.0,
                 att_const: float = 1.0, att_linear: float = 0.0,
                 att_quadratic: float = 0.0, ambient: float = 0.1):
        super().__init__(game_object)
        self.color = np.asarray(color, np.float32)
        self.intensity = intensity
        self.att_const = att_const
        self.att_linear = att_linear
        self.att_quadratic = att_quadratic
        self.ambient = ambient
        Light._lights.append(self)

    _lights: List["Light"] = []
    LIGHT_TYPE = 0  # directional; see ops/postprocess LIGHT_*

    def onDestroy(self):
        if self in Light._lights:
            Light._lights.remove(self)

    @classmethod
    def all_lights(cls) -> List["Light"]:
        return [l for l in cls._lights if l.enable]

    @classmethod
    def _clear(cls) -> None:
        cls._lights.clear()

    def _row(self, view: np.ndarray) -> np.ndarray:
        """One packed (16,) row in VIEW space (the G-buffer's space)."""
        row = np.zeros(16, np.float32)
        row[0] = float(self.LIGHT_TYPE)
        row[1:4] = self.color[:3]
        row[4] = self.intensity
        wpos = np.asarray(self.transform.position, np.float32)
        row[5:8] = (view @ np.append(wpos, 1.0))[:3]
        wdir = np.asarray(self.transform.forward, np.float32)
        row[8:11] = (view @ np.append(wdir, 0.0))[:3]
        row[11:14] = (self.att_const, self.att_linear, self.att_quadratic)
        row[14] = np.cos(np.radians(getattr(self, "angle", 180.0)))
        row[15] = self.ambient
        return row

    @classmethod
    def pack_lights(cls, view) -> Optional[np.ndarray]:
        """(L, 16) array for apply_lights, or None when the scene is unlit."""
        lights = cls.all_lights()
        if not lights:
            return None
        view = np.asarray(view, np.float32)
        return np.stack([l._row(view) for l in lights])


class DirectionalLight(Light):
    LIGHT_TYPE = 0

    @property
    def direction(self) -> np.ndarray:
        return self.transform.forward


class PointLight(Light):
    LIGHT_TYPE = 1

    def __init__(self, game_object, color=(1.0, 1.0, 1.0), intensity: float = 1.0,
                 radius: float = 10.0, **kw):
        # radius maps onto quadratic attenuation (intensity falls to ~1% at r)
        kw.setdefault("att_quadratic", 100.0 / max(radius * radius, 1e-6))
        super().__init__(game_object, color, intensity, **kw)
        self.radius = radius


class SpotLight(PointLight):
    LIGHT_TYPE = 2

    def __init__(self, game_object, color=(1.0, 1.0, 1.0), intensity: float = 1.0,
                 radius: float = 10.0, angle_deg: float = 30.0, **kw):
        super().__init__(game_object, color, intensity, radius, **kw)
        self.angle = angle_deg
