"""The comparison that decides ``correct`` for frame cells.

Each checked frame's presented uint8 RGB is held against the reference's:
the mean absolute difference in uint8 levels (``mad``). The start frames
(replayed by the reference from frame 0) and the window frames (drawn from
the seed) are judged apart, each group by its largest value of each
statistic: ``mad``; ``rel``, the difference over the reference frame's own
contrast (its mean absolute deviation from its mean); ``share8`` and
``share16``, the shares of values off by more than 8 and 16 levels. A frame
that never came reads infinity. A cell's limits file names the ones it
compares (``<group>_<statistic>``).
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional

import numpy as np


STATS = ("mad", "rel", "share8", "share16")


def frame_stat(i: int, got: Optional[np.ndarray], want: np.ndarray) -> dict:
    if got is None:
        return {"frame": i, "mad": float("inf"), "rel": float("inf"), "share8": float("inf"),
                "share16": float("inf")}
    a = got[..., :3].astype(np.float64)
    b = want[..., :3].astype(np.float64)
    d = np.abs(a - b)
    contrast = float(np.abs(b - b.mean(axis=(0, 1))).mean())
    return {"frame": i, "mad": float(d.mean()), "rel": float(d.mean()) / max(contrast, 1e-9),
            "share8": float((d > 8).mean()), "share16": float((d > 16).mean()),
            "p99": float(np.percentile(d, 99)),
            "max": float(d.max())}


def frame_stats(got: Dict[int, np.ndarray], want: Dict[int, np.ndarray],
                idx: Iterable[int]) -> List[dict]:
    return [frame_stat(i, got.get(i), want[i]) for i in sorted(idx)]


def frame_checks(got: Dict[int, np.ndarray], want: Dict[int, np.ndarray],
                 start: Iterable[int], window: Iterable[int], log=sys.stderr) -> dict:
    """{"<group>_<statistic>"}: the largest of each statistic over each
    group (None for an empty group) and, under "stats", every frame's
    statistics."""
    out: dict = {"stats": {}}
    for group, idx in (("start", start), ("window", window)):
        stats = frame_stats(got, want, idx)
        out["stats"][group] = stats
        for s in stats:
            if log is not None:
                print("frame {frame}: mean |diff| {mad:.4f}, over contrast {rel:.5f}, share over "
                      "8 levels {share8:.5f}, over 16 {share16:.5f}".format(**s), file=log)
        for k in STATS:
            out[f"{group}_{k}"] = max((s[k] for s in stats), default=None)
    return out
