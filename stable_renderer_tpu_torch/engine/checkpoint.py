"""Engine-state checkpoint / resume.

Counterpart of stable_renderer_tpu/engine/checkpoint.py, in the same on-disk
layout, so a state saved by either package loads in the other:

    <dir>/scene.json            object hierarchy + transforms (engine/scene.py)
    <dir>/corrmaps/<name>/      every submitted CorrespondMap (dump format)
    <dir>/state.json            frame count, sprite table, config echo

Model weights are not duplicated: they reload from their own source.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import TYPE_CHECKING

from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
from stable_renderer_tpu_torch.engine.scene import Scene
from stable_renderer_tpu_torch.utils.log import EngineLogger

if TYPE_CHECKING:
    from stable_renderer_tpu_torch.engine.engine import Engine


def save_engine_state(engine: "Engine", directory: str | Path) -> str:
    """Write the scene, every submitted CorrespondMap and the frame count and
    sprite table under ``directory``; returns its path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    Scene("checkpoint").save(directory / "scene.json")

    corr_dir = directory / "corrmaps"
    corr_index = {}
    for (sprite_id, material_id), cmap in engine.RenderManager._corrmaps.items():
        name = f"s{sprite_id}_m{material_id}"
        cmap.dump(corr_dir, name=name, force=True)
        corr_index[name] = [sprite_id, material_id]

    state = {
        "frame_count": engine.RuntimeManager.FrameCount,
        "mode": engine.Mode.name,
        "window_size": list(engine.WindowManager.WindowSize),
        "sprites": {
            str(sid): {"prompt": s.prompt, "negative_prompt": s.negative_prompt,
                       "weight": s.weight}
            for sid, s in engine.RenderManager._sprites.items()
        },
        "corrmaps": corr_index,
    }
    (directory / "state.json").write_text(json.dumps(state, indent=1))
    EngineLogger.info(f"engine state checkpointed to {directory}")
    return str(directory)


def load_engine_state(engine: "Engine", directory: str | Path) -> dict:
    """Restore frame count, sprites and corrmaps (onto the engine's device)
    into a prepared engine; rebuilds the scene from scene.json if the current
    scene is empty. Returns the state dict."""
    from stable_renderer_tpu_torch.data.sprite import Sprite
    from stable_renderer_tpu_torch.engine.gameobj import GameObject

    directory = Path(directory)
    state = json.loads((directory / "state.json").read_text())
    engine.RuntimeManager.FrameCount = int(state["frame_count"])
    for sid, info in state.get("sprites", {}).items():
        engine.RenderManager._sprites[int(sid)] = Sprite(
            spriteID=int(sid),
            prompt=info.get("prompt", ""),
            negative_prompt=info.get("negative_prompt", ""),
            weight=info.get("weight", 1.0),
        )
    for name, (sprite_id, material_id) in state.get("corrmaps", {}).items():
        cmap = CorrespondMap.Load(directory / "corrmaps" / name, device=engine.device)
        engine.RenderManager._corrmaps[(sprite_id, material_id)] = cmap
    if not GameObject.roots() and (directory / "scene.json").exists():
        Scene.load(directory / "scene.json")
    EngineLogger.info(f"engine state restored from {directory} (frame {state['frame_count']})")
    return state
