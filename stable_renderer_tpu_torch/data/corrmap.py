"""CorrespondMap — view-binned UV-space color cache for baking.

Counterpart of stable_renderer_tpu/data/corrmap.py (reference:
engine/static/corrmap.py:373-886). State:

    values:  (k*k, map_h * map_w, C) float32 — per view-bin flattened UV colors
    written: (k*k, map_h * map_w) bool       — which cells hold real data

``corrmap_update`` is one frame's masked segment reduction over
(map_index, vertexID) cells, in plain tensor ops on the tensors' device (no
Pallas kernel in the JAX package either). Update modes (corrmap.py:344-357):

    replace      overwrite the cell with the first new contribution
    replace_avg  overwrite the cell with the mean of this update's contributions
    first        write only unwritten cells, first contribution wins
    first_avg    write only unwritten cells, mean of this update's contributions

"First" is the pixel with the smallest flat screen index: a ``scatter_reduce``
``amin`` over int32 pixel indices, exact on every device, so ``first`` and
``replace`` agree with the JAX package bit for bit. The ``_avg`` modes sum
with ``ops.math.segment_add_``, in an order fixed by the input (the same map
from run to run), but not the JAX package's order: they agree with it to
rounding, not bit for bit.

``dump`` / ``Load`` use the JAX package's (and the reference's) on-disk format
byte for byte: k*k PNGs, ``{i}_written.png`` masks and ``meta.json``,
optionally zipped (corrmap.py:738-872), so a map baked by either package
replays in the other. Values are quantized as ``np.clip(255 * v, 0, 255)``
cast to uint8, which truncates.

The multi-device forms (``corrmap_update_sharded``, ``update_batch``) wait for
ROADMAP 1.14 and raise.
"""

from __future__ import annotations

import json
import math
import os
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple
from uuid import uuid4

import numpy as np
import torch

from stable_renderer_tpu_torch.device import resolve_device
from stable_renderer_tpu_torch.ops.math import segment_add_
from stable_renderer_tpu_torch.utils.log import EngineLogger
from stable_renderer_tpu_torch.utils.paths import TEMP_DIR

UpdateMode = str  # 'replace' | 'replace_avg' | 'first' | 'first_avg'
_MODES = ("replace", "replace_avg", "first", "first_avg")
_INT32_MAX = 2**31 - 1


def corrmap_update(
    values: torch.Tensor,       # (K2, M, C) float
    written: torch.Tensor,      # (K2, M) bool
    color_frame: torch.Tensor,  # (H, W, C') float
    id_map: torch.Tensor,       # (H, W, 4) int32
    mode: str = "first_avg",
    mask: Optional[torch.Tensor] = None,  # (H, W): > 0 keeps the pixel
    sprite_id: Optional[int] = None,
    material_id: Optional[int] = None,
    ignore_obj_mat_id: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's scatter into the map. Returns new (values, written).

    Cell key = map_index * M + vertexID. Pixels with out-of-range keys, that
    fail the mask, or whose sprite / material id differs from the given one
    (unless ``ignore_obj_mat_id``) contribute nothing. An RGB frame into an
    RGBA map gets alpha 1 (corrmap.py:699-701). Runs without a host sync."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}")
    k2, m, c = values.shape
    n_seg = k2 * m
    dev = values.device

    cf = color_frame.reshape(-1, color_frame.shape[-1]).to(torch.float32)
    if cf.shape[-1] > c:
        cf = cf[:, :c]
    elif c == 4 and cf.shape[-1] == 3:
        cf = torch.cat([cf, torch.ones_like(cf[:, :1])], dim=-1)
    n_pix = cf.shape[0]

    ids = id_map.reshape(-1, 4)
    map_index, vertex_id = ids[:, 2], ids[:, 3]
    valid = (map_index >= 0) & (map_index < k2) & (vertex_id >= 0) & (vertex_id < m)
    if mask is not None:
        valid &= mask.reshape(-1) > 0
    if not ignore_obj_mat_id:
        if sprite_id is not None:
            valid &= ids[:, 0] == sprite_id
        if material_id is not None:
            valid &= ids[:, 1] == material_id

    dump = torch.full_like(map_index, n_seg, dtype=torch.int64)
    seg = torch.where(valid, map_index.long() * m + vertex_id.long(), dump)
    if mode.startswith("first"):
        valid &= ~written.reshape(-1)[seg.clamp(max=n_seg - 1)]
        seg = torch.where(valid, seg, dump)

    if mode.endswith("_avg"):
        sums = torch.zeros((n_seg + 1, c), dtype=torch.float32, device=dev)
        segment_add_(sums, seg, torch.where(valid[:, None], cf, torch.zeros_like(cf)))
        counts = torch.zeros(n_seg + 1, dtype=torch.float32, device=dev)
        segment_add_(counts, seg, valid.to(torch.float32))
        counts = counts[:-1]
        touched = counts > 0
        new_cell = sums[:-1] / counts.clamp(min=1.0)[:, None]
    else:
        pix = torch.arange(n_pix, dtype=torch.int32, device=dev)
        big = torch.full_like(pix, _INT32_MAX)
        win = torch.full((n_seg + 1,), _INT32_MAX, dtype=torch.int32, device=dev)
        win.scatter_reduce_(0, seg, torch.where(valid, pix, big), "amin")
        win = win[:-1]
        touched = win != _INT32_MAX
        new_cell = cf[win.clamp(max=n_pix - 1).long()]
        new_cell = torch.where(touched[:, None], new_cell, torch.zeros_like(new_cell))

    out_vals = torch.where(touched[:, None], new_cell, values.reshape(n_seg, c).to(torch.float32))
    out_written = written.reshape(n_seg) | touched
    return out_vals.reshape(values.shape).to(values.dtype), out_written.reshape(written.shape)


def corrmap_update_sharded(*args, **kwargs):
    """The collective form of the update over frames sharded across devices
    (stable_renderer_tpu/data/corrmap.py:130): waits for the multi-device
    slice."""
    raise NotImplementedError("corrmap_update_sharded waits for the multi-device slice "
                              "(ROADMAP 1.14)")


@dataclass
class CorrespondMap:
    """Host wrapper around the (values, written) tensors, on ``device``
    (default: the card). The rasterizer samples ``values`` directly in BAKED
    mode (ops/gbuffer.py)."""

    name: str = "corrmap"
    k: int = 3
    height: int = 512
    width: int = 512
    channel_count: int = 4
    values: Optional[torch.Tensor] = field(default=None)
    written: Optional[torch.Tensor] = field(default=None)
    device: Optional[torch.device] = field(default=None)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.values is None:
            self.values = torch.zeros(
                (self.k * self.k, self.height * self.width, self.channel_count),
                dtype=torch.float32, device=self.device)
        if self.written is None:
            self.written = torch.zeros((self.k * self.k, self.height * self.width),
                                       dtype=torch.bool, device=self.device)

    @classmethod
    def from_numpy(cls, values, written, k: Optional[int] = None,
                   height: Optional[int] = None, width: Optional[int] = None,
                   name: str = "corrmap", device=None) -> "CorrespondMap":
        """A map from host arrays, as another package holds them:
        ``values`` (k*k, H*W, C), ``written`` (k*k, H*W). ``k`` defaults to
        the square root of the bin count and the map to a square."""
        values = np.asarray(values, np.float32)
        written = np.asarray(written, bool)
        k = k or math.isqrt(values.shape[0])
        if height is None or width is None:
            height = width = math.isqrt(values.shape[1])
        if values.shape[:2] != (k * k, height * width) or written.shape != values.shape[:2]:
            raise ValueError(f"values {values.shape} / written {written.shape} do not fit "
                             f"k={k}, {height}x{width}")
        dev = resolve_device(device)
        return cls(name=name, k=k, height=height, width=width, channel_count=values.shape[2],
                   values=torch.from_numpy(values.copy()).to(dev),
                   written=torch.from_numpy(written.copy()).to(dev), device=dev)

    # --- reference-parity accessors (corrmap.py:540-576) ---

    def __getitem__(self, index: int) -> torch.Tensor:
        return self.values[index]

    def get_map(self, index: int) -> torch.Tensor:
        return self.values[index].reshape(self.height, self.width, self.channel_count)

    def get_maps(self) -> torch.Tensor:
        return self.values.reshape(self.k * self.k, self.height, self.width, self.channel_count)

    def get_written_flag_map(self, index: int) -> torch.Tensor:
        return self.written[index].reshape(self.height, self.width)

    def clear(self) -> None:
        self.values = torch.zeros_like(self.values)
        self.written = torch.zeros_like(self.written)

    def to(self, device) -> "CorrespondMap":
        """Move ``values`` and ``written`` to ``device`` together."""
        self.device = torch.device(device)
        self.values = self.values.to(self.device)
        self.written = self.written.to(self.device)
        return self

    def update(
        self,
        color_frames: torch.Tensor,  # (N, H, W, C) or (H, W, C)
        id_maps: torch.Tensor,       # (N, H, W, 4) or (H, W, 4)
        spriteID: int | None = None,
        materialID: int | None = None,
        mode: UpdateMode = "first_avg",
        masks: torch.Tensor | None = None,
        inverse_masks: bool = False,
        ignore_obj_mat_id: bool = False,
    ) -> None:
        """Scatter N frames into the map, one after another
        (corrmap.py:578-736). The frames go to the map's device."""
        dev = self.values.device
        color_frames = torch.as_tensor(color_frames).to(dev)
        id_maps = torch.as_tensor(id_maps).to(dev)
        if color_frames.dim() == 3:
            color_frames = color_frames[None]
        if id_maps.dim() == 3:
            id_maps = id_maps[None]
        if masks is not None:
            masks = torch.as_tensor(masks).to(dev)
            if masks.dim() == 2:
                masks = masks[None]
            if masks.dim() == 4:
                masks = masks[..., 0]
            if inverse_masks:
                masks = 1.0 - masks
        vals, writ = self.values, self.written
        for i in range(color_frames.shape[0]):
            vals, writ = corrmap_update(
                vals, writ, color_frames[i], id_maps[i], mode=mode,
                mask=None if masks is None else masks[i], sprite_id=spriteID,
                material_id=materialID, ignore_obj_mat_id=ignore_obj_mat_id)
        self.values, self.written = vals, writ
        EngineLogger.debug(
            f"Updated CorrespondMap {self.name}: mode={mode} sprite={spriteID} mat={materialID}")

    def update_batch(self, *args, **kwargs) -> None:
        """The sharded batch scatter (stable_renderer_tpu/data/corrmap.py:335):
        waits for the multi-device slice."""
        raise NotImplementedError("CorrespondMap.update_batch waits for the multi-device slice "
                                  "(ROADMAP 1.14)")

    # --- on-disk interchange (reference format, corrmap.py:738-872) ---

    def dump(self, path: str | Path, name: str | None = None, zip: bool = False,
             force: bool = False) -> str:
        """Write the map as k*k PNGs + written masks + meta.json (a zip when
        ``zip``) under ``path``; returns the target's path."""
        from PIL import Image

        name = name or self.name
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        suffix = ".zip" if zip else ""
        real_name = name
        if not force:
            count = 1
            while (path / (real_name + suffix)).exists():
                real_name = f"{name}_{count}"
                count += 1
        target = path / (real_name + suffix)
        work = Path(TEMP_DIR) / uuid4().hex if zip else target
        work.mkdir(parents=True, exist_ok=True)

        values = self.get_maps().to(torch.float32).cpu().numpy()
        written = self.written.reshape(-1, self.height, self.width).cpu().numpy()
        for i in range(self.k * self.k):
            # uint8 (H, W, 4 | 3) and (H, W) arrays are RGBA | RGB and L images
            img = np.clip(255.0 * values[i], 0, 255).astype(np.uint8)
            if self.channel_count == 1:
                img = img[..., 0]
            Image.fromarray(img).save(work / f"{i}.png")
            wr = np.clip(255.0 * written[i], 0, 255).astype(np.uint8)
            Image.fromarray(wr).save(work / f"{i}_written.png")

        meta = {"k": self.k, "height": self.height, "width": self.width,
                "channel_count": self.channel_count, "name": name}
        with open(work / "meta.json", "w") as f:
            json.dump(meta, f)

        if zip:
            with zipfile.ZipFile(target, "w") as z:
                for f_ in os.listdir(work):
                    z.write(work / f_, f_)
                    os.remove(work / f_)
            os.rmdir(work)
        EngineLogger.debug(f"CorrespondMap {name} dumped to {target}")
        return str(target)

    @classmethod
    def Load(cls, path: str | Path, name: str | None = None, device=None) -> "CorrespondMap":
        """Read a map written by ``dump`` (a directory or a zip) onto
        ``device`` (default: the card)."""
        from PIL import Image

        path = Path(path)
        is_zip = path.is_file()
        if is_zip:
            work = Path(TEMP_DIR) / uuid4().hex
            work.mkdir(parents=True, exist_ok=True)
            with zipfile.ZipFile(path, "r") as z:
                z.extractall(work)
        else:
            work = path
        with open(work / "meta.json") as f:
            meta = json.load(f)
        k, h, w, c = meta["k"], meta["height"], meta["width"], meta["channel_count"]
        values, writtens = [], []
        for i in range(k * k):
            img = np.asarray(Image.open(work / f"{i}.png"), dtype=np.float32) / 255.0
            values.append(img.reshape(-1, c))
            wr = np.asarray(Image.open(work / f"{i}_written.png"), dtype=np.float32) / 255.0
            writtens.append(wr.reshape(-1) > 0.5)
        if is_zip:
            for f_ in os.listdir(work):
                os.remove(work / f_)
            os.rmdir(work)
        return cls.from_numpy(np.stack(values), np.stack(writtens), k=k, height=h, width=w,
                              name=name or meta["name"], device=device)
