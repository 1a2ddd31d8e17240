"""The engine: the host runtime (scene graph, components, managers, Engine.Run),
the frame program, draw execution, meshes and the diffusion pipeline.

Counterpart of stable_renderer_tpu/engine/__init__.py, with the same names.
"""

from stable_renderer_tpu_torch.engine.mesh import Mesh
from stable_renderer_tpu_torch.engine.gameobj import GameObject, Component
from stable_renderer_tpu_torch.engine.transform import Transform
from stable_renderer_tpu_torch.engine.camera import Camera
from stable_renderer_tpu_torch.engine.texture import Texture
from stable_renderer_tpu_torch.engine.material import Material, DefaultTextureType, RenderOrder
from stable_renderer_tpu_torch.engine.renderers import (
    MeshRenderer,
    CorrMapRenderer,
    SpriteInfo,
    Light,
    DirectionalLight,
    PointLight,
    SpotLight,
    DrawCall,
)
from stable_renderer_tpu_torch.engine.controls import (
    AutoRotation,
    CameraController,
    CircularOrbit,
    EqualIntervalRotation,
    HelicalOrbit,
    RigidBody,
    RigidController,
)
from stable_renderer_tpu_torch.engine.scene import Scene
from stable_renderer_tpu_torch.engine.engine import Engine, EngineMode
from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline

__all__ = [
    "Mesh",
    "GameObject",
    "Component",
    "Transform",
    "Camera",
    "Texture",
    "Material",
    "DefaultTextureType",
    "RenderOrder",
    "MeshRenderer",
    "CorrMapRenderer",
    "SpriteInfo",
    "Light",
    "DirectionalLight",
    "PointLight",
    "SpotLight",
    "DrawCall",
    "AutoRotation",
    "CameraController",
    "CircularOrbit",
    "EqualIntervalRotation",
    "HelicalOrbit",
    "RigidBody",
    "RigidController",
    "Scene",
    "Engine",
    "EngineMode",
    "DiffusionPipeline",
]
