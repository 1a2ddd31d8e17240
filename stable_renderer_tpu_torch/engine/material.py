"""Material — texture slots + render order + per-draw uniforms.

Counterpart of stable_renderer_tpu/engine/material.py, the capability match for
the reference's Material
(reference: engine/static/material/material.py:36-215 + enums.py:95-131
DefaultTextureType, material_MTL.py .mtl loading): named texture slots
(Diffuse/Normal/Specular/.../Noise/CorrespondMap), render_order for draw sorting,
and the default opaque/transparent materials.
"""

from __future__ import annotations

import itertools
from enum import Enum
from pathlib import Path
from typing import Dict, Optional

from stable_renderer_tpu_torch.engine.texture import Texture


class DefaultTextureType(Enum):
    Diffuse = "diffuseTex"
    Normal = "normalTex"
    Specular = "specularTex"
    Emission = "emissionTex"
    Occlusion = "occlusionTex"
    Metallic = "metallicTex"
    Roughness = "roughnessTex"
    Displacement = "displacementTex"
    Alpha = "alphaTex"
    Noise = "noiseTex"
    CorrespondMap = "correspond_map"


class RenderOrder(Enum):
    OPAQUE = 1000
    TRANSPARENT = 2000
    OVERLAY = 3000


_mat_counter = itertools.count(1)


class Material:
    def __init__(self, name: str = "material", render_order: int = RenderOrder.OPAQUE.value):
        self.name = name
        self.materialID = next(_mat_counter)
        self.render_order = render_order
        self.textures: Dict[DefaultTextureType, object] = {}
        self.variables: Dict[str, object] = {}
        # user-programmable shading (engine/shader.py, not ported yet: a draw
        # with a shader raises); None = fixed pipeline
        # (the reference Material holds a Shader program, material.py)
        self.shader = None

    def addDefaultTexture(self, texture, ttype: DefaultTextureType) -> None:
        self.textures[ttype] = texture

    def hasDefaultTexture(self, ttype: DefaultTextureType) -> bool:
        return ttype in self.textures

    def getTexture(self, ttype: DefaultTextureType):
        return self.textures.get(ttype)

    def setVariable(self, name: str, value) -> None:
        self.variables[name] = value

    @property
    def diffuse(self) -> Optional[Texture]:
        return self.textures.get(DefaultTextureType.Diffuse)

    @property
    def noise(self) -> Optional[Texture]:
        return self.textures.get(DefaultTextureType.Noise)

    @property
    def corrmap(self):
        return self.textures.get(DefaultTextureType.CorrespondMap)

    @classmethod
    def DefaultOpaqueMaterial(cls, name: str = "opaque") -> "Material":
        return cls(name, RenderOrder.OPAQUE.value)

    @classmethod
    def DefaultTransparentMaterial(cls, name: str = "transparent") -> "Material":
        return cls(name, RenderOrder.TRANSPARENT.value)

    @classmethod
    def DefaultDebugMaterial(cls, name: str = "debug") -> "Material":
        return cls(name, RenderOrder.OVERLAY.value)

    @classmethod
    def Load_MTL(cls, path: str | Path) -> Dict[str, "Material"]:
        """Minimal .mtl parser (material_MTL.py capability): newmtl blocks with
        map_Kd diffuse textures resolved relative to the mtl file."""
        path = Path(path)
        mats: Dict[str, Material] = {}
        cur: Optional[Material] = None
        for line in path.read_text().splitlines():
            tok = line.strip().split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = cls(name=tok[1] if len(tok) > 1 else "mtl")
                mats[cur.name] = cur
            elif tok[0] == "map_Kd" and cur is not None:
                tex_path = path.parent / " ".join(tok[1:])
                if tex_path.exists():
                    cur.addDefaultTexture(Texture.Load(tex_path), DefaultTextureType.Diffuse)
            elif tok[0] == "d" and cur is not None:
                if float(tok[1]) < 1.0:
                    cur.render_order = RenderOrder.TRANSPARENT.value
        return mats
