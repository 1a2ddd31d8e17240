"""Scene container with save/load.

Counterpart of stable_renderer_tpu/engine/scene.py. The reference's Scene is a
stub with save/load marked TODO
(reference: engine/static/scene.py:10-33, sceneManager.py:3-26). Here the
container works and serialization is implemented (JSON of the object/component
hierarchy: names, transforms, tags) — meshes/materials are referenced by name.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np

from stable_renderer_tpu_torch.engine.gameobj import GameObject


class Scene:
    def __init__(self, name: str = "scene"):
        self.name = name

    @property
    def root_objects(self) -> List[GameObject]:
        return GameObject.roots()

    def save(self, path: str | Path) -> None:
        def encode(obj: GameObject) -> dict:
            t = obj.transform
            return {
                "name": obj.name,
                "tags": sorted(obj.tags),
                "active": obj.active,
                "position": t.localPosition.tolist(),
                "rotation": t.localRotation.tolist(),
                "scale": t.localScale.tolist(),
                "components": [type(c).__name__ for c in obj.components],
                "children": [encode(c) for c in obj.children],
            }

        data = {"name": self.name, "objects": [encode(o) for o in self.root_objects]}
        Path(path).write_text(json.dumps(data, indent=1))

    @classmethod
    def load(cls, path: str | Path) -> "Scene":
        data = json.loads(Path(path).read_text())
        scene = cls(data.get("name", "scene"))

        def decode(node: dict, parent) -> GameObject:
            obj = GameObject(node["name"], parent=parent, tags=node.get("tags", ()))
            obj.active = node.get("active", True)
            obj.transform.localPosition = np.asarray(node["position"], np.float32)
            obj.transform.localRotation = np.asarray(node["rotation"], np.float32)
            obj.transform.localScale = np.asarray(node["scale"], np.float32)
            for child in node.get("children", ()):
                decode(child, obj)
            return obj

        for node in data.get("objects", ()):
            decode(node, None)
        return scene
