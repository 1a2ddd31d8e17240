"""Programmable shaders: user shading functions run inside the draw.

Counterpart of stable_renderer_tpu/engine/shader.py (reference
engine/static/shader.py: Shader program objects :391-570 with a named
registry and default shaders, ShaderStruct UBO reflection :247-389). A
shader is a pair of Python functions over torch tensors on the draw's device
instead of GLSL source:

  * ``vertex_fn(positions, normals, mv, proj) -> (clip, view_pos,
    view_normal)`` replaces the vertex stage (optional); the rasterizer
    (K2 on the card) takes its clip coordinates;
  * ``fragment_fn(frag: FragmentInputs, uniforms: dict) -> (H, W, 4)`` (or
    (H, W, 3), alpha 1) replaces the fixed color stage on the pixels the draw
    covers (optional).

``ShaderStruct`` replaces the UBO reflection: a bundle of uniform values
handed to ``fragment_fn`` as tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch


class FragmentInputs(NamedTuple):
    """What the GLSL fragment stage would see (gbuffer.frag in-attributes)."""

    view_pos: torch.Tensor      # (H, W, 3) view-space position
    normal: torch.Tensor        # (H, W, 3) unit view-space normal
    uv: torch.Tensor            # (H, W, 2)
    vertex_color: torch.Tensor  # (H, W, 3)
    color: torch.Tensor         # (H, W, 4) the fixed pipeline's color (texture / vertex color)
    covered: torch.Tensor       # (H, W) bool: the draw covers the pixel


class ShaderStruct:
    """Uniform bundle (reference ShaderStruct, shader.py:247-389): subclass
    with class-level defaults or pass kwargs; ``uniforms()`` returns them as
    a dict of CPU tensors for ``fragment_fn``."""

    def __init__(self, **kwargs):
        fields = {k: v for k, v in vars(type(self)).items()
                  if not k.startswith("_") and not callable(v)}
        fields.update(kwargs)
        self._fields = fields
        for k, v in fields.items():
            setattr(self, k, v)

    def uniforms(self) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v) for k, v in self._fields.items()}


_SHADERS: Dict[str, "Shader"] = {}


class Shader:
    """Named shader program (reference Shader, shader.py:391-570); made
    shaders join the registry under their name."""

    def __init__(self, name: str, fragment_fn: Optional[Callable] = None,
                 vertex_fn: Optional[Callable] = None,
                 uniforms: Optional[ShaderStruct] = None):
        self.name = name
        self.fragment_fn = fragment_fn
        self.vertex_fn = vertex_fn
        self.uniform_struct = uniforms
        self._bound: Optional[Callable] = None
        _SHADERS[name] = self

    @classmethod
    def Find(cls, name: str) -> Optional["Shader"]:
        return _SHADERS.get(name)

    @classmethod
    def AllShaders(cls) -> Dict[str, "Shader"]:
        return dict(_SHADERS)

    @classmethod
    def Default(cls) -> "Shader":
        """The fixed pipeline: no user stage."""
        return _SHADERS.get("default") or cls("default")

    @classmethod
    def DefaultDebug(cls) -> "Shader":
        """Shows the view-space normals (the reference's debug shader)."""
        if "debug_normals" in _SHADERS:
            return _SHADERS["debug_normals"]

        def frag(f: FragmentInputs, uniforms: dict) -> torch.Tensor:
            rgb = f.normal * 0.5 + 0.5
            return torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)

        return cls("debug_normals", fragment_fn=frag)

    def bound_fragment(self) -> Optional[Callable]:
        """``fragment_fn`` with the uniform struct closed over, the
        (FragmentInputs) -> color hook ``shade_draw`` takes; made once, so a
        draw sees the same hook every frame. The uniforms move to the
        fragment's device on each call (a no-op once they are there)."""
        if self.fragment_fn is None:
            return None
        if self._bound is None:
            fn = self.fragment_fn
            uni = {} if self.uniform_struct is None else self.uniform_struct.uniforms()

            def bound(frag: FragmentInputs) -> torch.Tensor:
                dev = frag.color.device
                if any(v.device != dev for v in uni.values()):
                    uni.update({k: v.to(dev) for k, v in uni.items()})
                return fn(frag, uni)

            self._bound = bound
        return self._bound

    def __repr__(self) -> str:
        stages = [s for s, f in (("vert", self.vertex_fn), ("frag", self.fragment_fn)) if f]
        return f"<Shader {self.name} [{'+'.join(stages) or 'fixed'}]>"
