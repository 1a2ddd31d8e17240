"""extra_model_paths.yaml support — the reference's model-search-path config.

Counterpart of stable_renderer_tpu/utils/model_paths.py.

The reference loads an ``extra_model_paths.yaml`` next to its entry point and
registers per-type model folders (checkpoints/loras/vae/controlnet/...) into
folder_paths (reference comfyUI/main.py:202-236 load_extra_path_config,
utils/extra_config.py). Example of the schema (the a111 stanza ships with
the reference):

    a111:
      base_path: ~/stable-diffusion-webui/
      checkpoints: models/Stable-diffusion
      vae: models/VAE
      loras: |
        models/Lora
        models/LyCORIS

This build resolves model files by NAME over a flat search list
(workflow.executor._find_model_file), so the adaptation is: expand every
(base_path, per-type subpaths) pair into absolute directories and append
them to the executor's ``model_dirs``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Tuple

from stable_renderer_tpu_torch.utils.log import get_logger

logger = get_logger("sr_tpu_torch.paths")

DEFAULT_CONFIG_NAME = "extra_model_paths.yaml"


def load_extra_model_paths(yaml_path: str) -> Tuple[str, ...]:
    """Parse a reference-format extra_model_paths.yaml into a flat tuple of
    existing model directories (order: file order; missing dirs skipped with
    a log line, matching the reference's warn-and-continue)."""
    import yaml

    with open(yaml_path) as f:
        data = yaml.safe_load(f) or {}
    dirs: List[str] = []
    for stanza, conf in data.items():
        if not isinstance(conf, dict):
            continue
        base = os.path.expanduser(str(conf.get("base_path", "") or ""))
        for key, value in conf.items():
            if key in ("base_path", "is_default"):
                continue
            if not isinstance(value, str):
                continue
            for sub in value.splitlines():
                sub = sub.strip()
                if not sub:
                    continue
                full = Path(base) / os.path.expanduser(sub) if base else Path(
                    os.path.expanduser(sub))
                if full.is_dir():
                    dirs.append(str(full))
                else:
                    logger.info(
                        f"extra_model_paths[{stanza}].{key}: skipping missing "
                        f"dir {full}")
    return tuple(dict.fromkeys(dirs))  # dedupe, keep order


def auto_extra_model_paths(cwd: str | None = None) -> Tuple[str, ...]:
    """Load ./extra_model_paths.yaml if present (the reference auto-loads the
    file next to its entry point)."""
    p = Path(cwd or os.getcwd()) / DEFAULT_CONFIG_NAME
    if p.is_file():
        try:
            return load_extra_model_paths(str(p))
        except Exception as ex:  # malformed yaml: warn, don't crash startup
            logger.warning(f"failed to parse {p}: {ex}")
    return ()
