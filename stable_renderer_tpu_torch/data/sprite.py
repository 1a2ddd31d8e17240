"""Sprite / EnvPrompt — per-object and background prompt metadata.

Same contract as the reference (reference:
source/common_utils/stable_render_utils/sprite.py:5-41 and prompts.py:3-19):
a Sprite carries (spriteID, prompt, negative prompt, weights); spriteID 0 is
reserved for "no sprite"; EnvPrompt is the background prompt attached to a camera.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict

_sprite_counter = itertools.count(1)  # 0 is reserved = "no sprite"


def get_new_spriteID() -> int:
    return next(_sprite_counter)


@dataclass
class Sprite:
    spriteID: int = field(default_factory=get_new_spriteID)
    prompt: str = ""
    negative_prompt: str = ""
    weight: float = 1.0

    def __post_init__(self) -> None:
        if self.spriteID == 0:
            raise ValueError("spriteID 0 is reserved for 'no sprite'")


SpriteInfos = Dict[int, Sprite]
"""{spriteID: Sprite} — the per-frame sprite table packed into EngineData."""


@dataclass
class EnvPrompt:
    prompt: str = ""
    negative_prompt: str = ""
    weight: float = 1.0
