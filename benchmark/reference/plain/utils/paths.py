"""Output-path allocation and frame-index filename parsing.

Counterpart of stable_renderer_tpu/utils/paths.py.

Same contract as the reference's path utilities
(reference: source/common_utils/path_utils.py:20-180 — dated output dirs
``runtime_map/YYYY-MM-DD_idx`` and the ``extract_index`` filename parser used by
IDMap.from_directory / the sequence loaders).
"""

from __future__ import annotations

import datetime
import os
import re
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
OUTPUT_DIR = Path(os.environ.get("SR_TPU_OUTPUT_DIR", REPO_ROOT / "outputs"))
TEMP_DIR = Path(os.environ.get("SR_TPU_TEMP_DIR", REPO_ROOT / ".tmp"))

_INDEX_RE = re.compile(r"(\d+)")


def extract_index(filename: str, default: int = -1) -> int:
    """Parse the trailing integer frame index out of a map filename.

    ``'12.npy' -> 12``, ``'frame_007.png' -> 7``, no digits -> ``default``.
    Uses the LAST run of digits in the stem so names like 'v2_frame_13' parse as 13.
    """
    stem = Path(filename).stem
    matches = _INDEX_RE.findall(stem)
    if not matches:
        return default
    return int(matches[-1])


def new_run_dir(tag: str = "run", root: Path | None = None) -> Path:
    """Allocate a fresh dated output directory ``<root>/<YYYY-MM-DD>_<idx>_<tag>``."""
    root = Path(root) if root is not None else OUTPUT_DIR
    root.mkdir(parents=True, exist_ok=True)
    date = datetime.date.today().isoformat()
    idx = 0
    while True:
        cand = root / f"{date}_{idx}_{tag}"
        if not cand.exists():
            cand.mkdir(parents=True)
            return cand
        idx += 1
