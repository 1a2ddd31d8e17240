"""Checkpoint loading: reference-format safetensors / ckpt files -> param trees.

Counterpart of stable_renderer_tpu/models/weights.py (reference:
comfy/sd.py:592-712 load_checkpoint_guess_config, comfy/utils.py
load_torch_file, comfy/model_detection.py). The param trees of ``models/*``
use the torch module names verbatim, so loading is re-nesting:

    model.diffusion_model.*   -> UNet params
    first_stage_model.*       -> VAE params
    cond_stage_model.transformer.* (or .clip_l.transformer.*) -> CLIP params

A flat state dict holds CPU torch tensors (numpy has no bf16), in the file's
dtype; ``tree_to`` casts and moves a nested tree. ``.safetensors`` files go
through the port's own reader (``read_safetensors``), which maps the file
instead of copying it; ``.ckpt`` / ``.pt`` files through
``torch.load(weights_only=True)``.

Detection keeps the JAX package's whole walk (``detect_unet_layout``, which
fills a ``UNetLayout`` with every field the JAX ``UNetConfig`` gets) and its
family rule (``detect_model_family``). The port's UNet is the SD1.x one, so
``detect_unet_config`` maps an SD1.x layout, 9-channel inpaint UNets
included, to ``UNetConfig`` and raises for the other families (ROADMAP 1.11).
"""

from __future__ import annotations

import json
import mmap
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from stable_renderer_tpu_torch.models.unet import UNetConfig
from stable_renderer_tpu_torch.utils.log import get_logger

logger = get_logger("sr_tpu.weights")

# --- safetensors ----------------------------------------------------------------
# The format: 8 bytes (little-endian u64) giving the header's length N; N bytes
# of JSON, {name: {"dtype", "shape", "data_offsets": [begin, end]}, ...} plus an
# optional "__metadata__" of strings; then the buffer, offsets relative to its
# start.

# file dtype -> (torch dtype, the little-endian numpy dtype the bytes are read as)
_ST_DTYPES = {
    "F64": (torch.float64, "<f8"), "F32": (torch.float32, "<f4"),
    "F16": (torch.float16, "<f2"), "BF16": (torch.bfloat16, "<i2"),
    "I64": (torch.int64, "<i8"), "I32": (torch.int32, "<i4"), "I16": (torch.int16, "<i2"),
    "I8": (torch.int8, "i1"), "U8": (torch.uint8, "u1"), "BOOL": (torch.bool, "?"),
}
_ST_NAMES = {t: name for name, (t, _) in _ST_DTYPES.items()}
_NP_NAMES = {"float64": "F64", "float32": "F32", "float16": "F16", "bfloat16": "BF16",
             "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8", "uint8": "U8",
             "bool": "BOOL"}
_ITEMSIZE = {name: np.dtype(nd).itemsize for name, (_, nd) in _ST_DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024  # as the safetensors library


def _read_header(path: Path, size: int) -> Tuple[int, dict]:
    """(buffer start, parsed header) with every entry checked: a known dtype,
    offsets that hold exactly the shape's bytes, inside the buffer, and no
    two entries sharing a byte."""
    if size < 8:
        raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if n > min(_MAX_HEADER, size - 8):
            raise ValueError(f"{path}: header length {n} runs past the file ({size} bytes)")
        raw = f.read(n)
    try:
        header = json.loads(raw)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    start, buf_len = 8 + n, size - 8 - n
    spans = []
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype, shape, (begin, end) = entry["dtype"], entry["shape"], entry["data_offsets"]
        except (TypeError, KeyError, ValueError):
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {entry!r}") from None
        if dtype not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}, which the reader "
                             f"does not take ({sorted(_ST_DTYPES)})")
        if not all(isinstance(d, int) and d >= 0 for d in shape):
            raise ValueError(f"{path}: tensor {name!r} has shape {shape!r}")
        want = int(np.prod(shape, dtype=np.int64)) * _ITEMSIZE[dtype]
        if not (isinstance(begin, int) and isinstance(end, int) and 0 <= begin <= end):
            raise ValueError(f"{path}: tensor {name!r} has offsets {[begin, end]}")
        if end - begin != want:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, its shape "
                             f"{shape} {dtype} needs {want}")
        if end > buf_len:
            raise ValueError(f"{path}: tensor {name!r} runs past the buffer "
                             f"({end} > {buf_len} bytes)")
        spans.append((begin, end, name))
    spans.sort()
    for (b0, e0, n0), (b1, _, n1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensors {n0!r} and {n1!r} overlap")
    return start, header


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}, each a view of one
    copy-on-write map of the file (nothing is read until a tensor is used;
    writing to a tensor does not touch the file). BF16 is read as int16
    words and viewed as bfloat16; the header's ``__metadata__`` is skipped.
    Raises ValueError on a corrupt header or offsets that overlap or run
    past the buffer."""
    path = Path(path)
    size = path.stat().st_size
    start, header = _read_header(path, size)
    tensors: Dict[str, torch.Tensor] = {}
    names = [k for k in header if k != "__metadata__"]
    if names and size > start:
        with open(path, "rb") as f:
            mapped = np.frombuffer(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY), np.uint8)
    for name in names:
        entry = header[name]
        tdtype, ndtype = _ST_DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        nd = np.dtype(ndtype)
        if begin == end:
            t = torch.empty(entry["shape"], dtype=tdtype)
        else:
            raw = mapped[start + begin:start + end]
            if (start + begin) % nd.itemsize:
                raw = raw.copy()  # an unaligned tensor: copied, not viewed
            t = torch.from_numpy(raw.view(nd)).reshape(entry["shape"])
            if tdtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
        tensors[name] = t
    return tensors


def _spec(value) -> Tuple[str, list, int]:
    """(file dtype, shape, byte length) of a tensor or array."""
    name = (_ST_NAMES.get(value.dtype) if isinstance(value, torch.Tensor)
            else _NP_NAMES.get(np.asarray(value).dtype.name))
    if name is None:
        raise ValueError(f"write_safetensors: dtype {value.dtype} is not writable")
    shape = list(value.shape)
    return name, shape, int(np.prod(shape, dtype=np.int64)) * _ITEMSIZE[name]


def _as_bytes(value) -> np.ndarray:
    """The little-endian bytes of a tensor (copied to the host) or array."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    else:
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":  # an ml_dtypes array: its words as they are
            arr = arr.view(np.int16)
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def write_safetensors(tensors: Mapping[str, Any], path: Union[str, Path]) -> int:
    """Write {name: tensor or array} as a ``.safetensors`` file, the port's
    counterpart of ``safetensors.numpy.save_file``: tensors laid out by
    element size (largest first), then name, so every offset is aligned;
    the header padded with spaces to 8 bytes. CUDA tensors are copied to the
    host one at a time. Returns the file's size in bytes."""
    if "__metadata__" in tensors:
        raise ValueError("write_safetensors: '__metadata__' is not a tensor name")
    specs = {name: _spec(value) for name, value in tensors.items()}
    order = sorted(specs, key=lambda n: (-_ITEMSIZE[specs[n][0]], n))
    header: Dict[str, Any] = {}
    offset = 0
    for name in order:
        dtype, shape, nb = specs[name]
        header[name] = {"dtype": dtype, "shape": shape, "data_offsets": [offset, offset + nb]}
        offset += nb
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for name in order:
            f.write(_as_bytes(tensors[name]))
    return 8 + len(raw) + offset


def load_state_dict(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file (mapped, see ``read_safetensors``) or a torch
    ``.ckpt`` / ``.pt`` file (``torch.load(weights_only=True)``, a
    ``state_dict`` entry unwrapped, non-tensor entries dropped) -> flat
    {name: CPU tensor}."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def nest(flat: Mapping[str, Any], prefix: str = "") -> dict:
    """Re-nest a flat dotted-key dict under ``prefix`` into nested dicts."""
    tree: dict = {}
    plen = len(prefix)
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[plen:].split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def tree_to(tree, device, dtype: Optional[torch.dtype] = None):
    """A nested tree of tensors on ``device``, floating leaves cast to
    ``dtype`` when given (integer leaves keep their type). A leaf already
    there in that dtype is the same tensor."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    if dtype is not None and t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device)


# --- detection --------------------------------------------------------------------

_UNET = "model.diffusion_model."


@dataclass(frozen=True)
class UNetLayout:
    """What the JAX package's ``detect_unet_config`` reads from a state dict,
    field for field (its ``UNetConfig`` of the same names); ``temporal`` marks
    the SVD UNet, for which it returns its SVD preset instead."""

    in_channels: int
    model_channels: int
    channel_mult: Tuple[int, ...] = ()
    num_res_blocks: int = 2
    num_res_blocks_per_level: Tuple[int, ...] = ()
    transformer_depth_blocks: Tuple[int, ...] = ()
    transformer_depth_blocks_out: Tuple[int, ...] = ()
    transformer_depth_middle: int = 1
    disable_self_attn_levels: Optional[Tuple[bool, ...]] = None
    context_dim: int = 768
    head_dim: Optional[int] = None
    adm_in_channels: Optional[int] = None
    num_classes: Optional[int] = None
    temporal: bool = False


def _st_depth(flat: Mapping[str, Any], prefix: str, block: str) -> int:
    """Transformer depth of a SpatialTransformer param subtree (0 = absent)."""
    if prefix + block + ".proj_in.weight" not in flat:
        return 0
    d = 0
    while f"{prefix}{block}.transformer_blocks.{d}.attn1.to_q.weight" in flat:
        d += 1
    return d


def detect_unet_layout(flat: Mapping[str, Any]) -> UNetLayout:
    """The JAX package's architecture walk (comfy/model_detection.py
    detect_unet_config): input blocks up to each downsample make a level
    (channel_mult, res blocks per level, per-block transformer depths,
    disable_self_attn), the middle block's layout, the output blocks'
    depths, the context and ADM widths, the class table, and the head rule
    (8 fixed heads at context 768, 64-wide heads otherwise). Reads shapes
    only, so zero-stride arrays will do."""
    prefix = _UNET
    w = flat.get(prefix + "input_blocks.0.0.weight")
    if w is None:
        raise ValueError("state dict has no diffusion model")
    model_channels, in_channels = int(w.shape[0]), int(w.shape[1])
    label_w = flat.get(prefix + "label_emb.0.0.weight")
    adm = None if label_w is None else int(label_w.shape[1])
    class_w = flat.get(prefix + "label_emb.weight")
    num_classes = None if class_w is None else int(class_w.shape[0])
    if any(".time_stack." in k for k in flat if k.startswith(prefix)):
        return UNetLayout(in_channels=in_channels, model_channels=model_channels,
                          adm_in_channels=adm, temporal=True)
    context_dim = 768
    for k, v in flat.items():
        if k.startswith(prefix) and k.endswith("attn2.to_k.weight"):
            context_dim = int(v.shape[1])
            break
    channel_mult, num_res_blocks, depth_in, disable_self = [], [], [], []
    cur_res, cur_dis, last_ch, i = 0, False, model_channels, 1
    while True:
        b = f"input_blocks.{i}"
        if prefix + b + ".0.op.weight" in flat:  # a downsample closes a level
            channel_mult.append(last_ch // model_channels)
            num_res_blocks.append(cur_res)
            disable_self.append(cur_dis)
            cur_res, cur_dis = 0, False
            i += 1
            continue
        rw = flat.get(prefix + b + ".0.out_layers.3.weight")
        if rw is None:
            break
        last_ch = int(rw.shape[0])
        cur_res += 1
        depth_in.append(_st_depth(flat, prefix, b + ".1"))
        k1 = flat.get(prefix + b + ".1.transformer_blocks.0.attn1.to_k.weight")
        if k1 is not None and k1.shape[1] != last_ch:
            cur_dis = True
        i += 1
    channel_mult.append(last_ch // model_channels)
    num_res_blocks.append(cur_res)
    disable_self.append(cur_dis)
    if prefix + "middle_block.1.proj_in.weight" in flat:
        depth_middle = _st_depth(flat, prefix, "middle_block.1")
    elif prefix + "middle_block.0.in_layers.0.weight" in flat:
        depth_middle = -1
    else:
        depth_middle = -2
    n_out = sum(r + 1 for r in num_res_blocks)
    depth_out = [_st_depth(flat, prefix, f"output_blocks.{i}.1") for i in range(n_out)]
    return UNetLayout(
        in_channels=in_channels,
        model_channels=model_channels,
        channel_mult=tuple(channel_mult),
        num_res_blocks=max(num_res_blocks) if num_res_blocks else 2,
        num_res_blocks_per_level=tuple(num_res_blocks),
        transformer_depth_blocks=tuple(depth_in),
        transformer_depth_blocks_out=tuple(depth_out),
        transformer_depth_middle=depth_middle,
        disable_self_attn_levels=tuple(disable_self) if any(disable_self) else None,
        context_dim=context_dim,
        head_dim=None if context_dim == 768 else 64,
        adm_in_channels=adm,
        num_classes=num_classes,
    )


def detect_model_family(flat: Mapping[str, Any], layout: UNetLayout) -> dict:
    """The reference's model families (comfy/supported_models.py), as the
    JAX package classifies them: {"family", "prediction", "noise_aug_dim"};
    family is "sd1", "sd2", "sdxl", "sdxl-refiner", "svd", "sd21-unclip" or
    "sd-x4-upscaler", prediction "eps" or "v"."""
    family, prediction, noise_aug_dim = "sd1", "eps", None
    if any(".time_stack." in k for k in flat):
        return {"family": "svd", "prediction": "v", "noise_aug_dim": None}
    if layout.context_dim == 1024:
        if layout.adm_in_channels in (1536, 2048):
            return {"family": "sd21-unclip", "prediction": "v",
                    "noise_aug_dim": layout.adm_in_channels // 2}
        if layout.in_channels == 7:
            return {"family": "sd-x4-upscaler", "prediction": "v", "noise_aug_dim": None}
        family = "sd2"
        # the 768-v checkpoints' out-layer statistics have std > 0.09; SD2
        # inpaint UNets (9 channels) stay eps
        if layout.in_channels == 4:
            t = flat.get(_UNET + "output_blocks.11.1.transformer_blocks.0.norm1.bias")
            if t is not None and float(torch.as_tensor(t).double().std(correction=0)) > 0.09:
                prediction = "v"
    elif layout.context_dim == 1280:
        family = "sdxl-refiner"
    elif layout.context_dim == 2048:
        family = "sdxl"
    return {"family": family, "prediction": prediction, "noise_aug_dim": noise_aug_dim}


def sd1_unet_config(layout: UNetLayout, family: dict) -> UNetConfig:
    """The port's ``UNetConfig`` for an SD1.x layout: the same res-block
    count at every level, transformers of depth 1 at ``attention_levels``
    (every block of such a level, in and out) and in the middle, context
    768, 8 heads, no ADM or classes; 4 input channels, or 9 for an inpaint
    UNet (the latent, then the mask and the masked image's latent). Other
    families raise naming ROADMAP 1.11."""
    if family["family"] != "sd1" or layout.temporal:
        raise NotImplementedError(
            f"{family['family']} checkpoints are not ported yet (ROADMAP 1.11); the port loads "
            "the SD1.x family, from files and diffusers folders alike")
    res = layout.num_res_blocks_per_level
    levels = len(layout.channel_mult)
    attention_levels = tuple(lvl for lvl in range(levels)
                             if layout.transformer_depth_blocks[lvl * res[0]] > 0)
    want_in = tuple(1 if lvl in attention_levels else 0 for lvl in range(levels)
                    for _ in range(res[0]))
    want_out = tuple(1 if lvl in attention_levels else 0 for lvl in reversed(range(levels))
                     for _ in range(res[0] + 1))
    sd1 = (layout.in_channels in (4, 9) and layout.adm_in_channels is None
           and layout.num_classes is None and layout.disable_self_attn_levels is None
           and layout.head_dim is None and len(set(res)) == 1
           and layout.transformer_depth_blocks == want_in
           and layout.transformer_depth_blocks_out == want_out
           and layout.transformer_depth_middle == 1)
    if not sd1:
        raise NotImplementedError(
            f"a UNet layout the port's SD1.x UNet does not take ({layout}); other layouts wait "
            "for ROADMAP 1.11")
    return UNetConfig(in_channels=layout.in_channels, model_channels=layout.model_channels,
                      num_res_blocks=res[0], channel_mult=layout.channel_mult,
                      attention_levels=attention_levels, transformer_depth=1, num_heads=8,
                      context_dim=layout.context_dim)


def detect_unet_config(flat: Mapping[str, Any]) -> UNetConfig:
    """The port's ``UNetConfig`` from the state dict alone (SD1.x only; see
    ``sd1_unet_config``)."""
    layout = detect_unet_layout(flat)
    return sd1_unet_config(layout, detect_model_family(flat, layout))


def split_checkpoint(flat: Mapping[str, Any]) -> Tuple[dict, dict, dict]:
    """flat checkpoint -> (unet_params, vae_params, clip_params) nested trees."""
    unet = nest(flat, _UNET)
    vae = nest(flat, "first_stage_model.")
    clip = nest(flat, "cond_stage_model.transformer.")
    if not clip:
        clip = nest(flat, "cond_stage_model.clip_l.transformer.")
    return unet, vae, clip


def load_checkpoint_flat(flat: Mapping[str, Any], label: str = "<flat>"):
    """Detect + split an in-memory flat state dict (an ldm file's, or a
    diffusers folder's after conversion): (unet, vae, clip, UNetConfig,
    family), the family as ``detect_model_family`` gives it. Raises as
    ``sd1_unet_config`` does for what the port does not load."""
    layout = detect_unet_layout(flat)
    family = detect_model_family(flat, layout)
    cfg = sd1_unet_config(layout, family)
    unet, vae, clip = split_checkpoint(flat)
    logger.info(f"Loaded checkpoint {label}: unet ch={cfg.model_channels} "
                f"ctx={cfg.context_dim}, {len(flat)} tensors")
    return unet, vae, clip, cfg, family


def load_checkpoint(path: Union[str, Path]):
    """A full SD1.x checkpoint file, or a diffusers model folder ->
    (unet_params, vae_params, clip_params, UNetConfig, family), CPU tensors
    in the file's dtypes (load_checkpoint_guess_config)."""
    if os.path.isdir(path):
        from stable_renderer_tpu_torch.models.diffusers_convert import load_diffusers_folder

        return load_checkpoint_flat(load_diffusers_folder(str(path)), str(path))
    return load_checkpoint_flat(load_state_dict(path), str(path))
