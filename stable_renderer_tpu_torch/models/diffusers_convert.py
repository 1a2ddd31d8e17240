"""Diffusers-layout checkpoint conversion (HF folder -> ldm state dict).

Counterpart of stable_renderer_tpu/models/diffusers_convert.py (reference:
comfy/diffusers_convert.py:10-265, the UNet/VAE key tables of huggingface's
convert_diffusers_to_original script, and comfy/diffusers_load.py:1-36
load_diffusers). The tables are a data contract between the two
ecosystems' key names, copied here over flat dicts of CPU tensors; like the
reference, the layer maps assume the SD1.x UNet topology (4 levels x 2
resnets) and the SD VAE."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

# --- UNet tables (diffusers_convert.py:10-84) -------------------------------

UNET_MAP = [
    ("time_embed.0.weight", "time_embedding.linear_1.weight"),
    ("time_embed.0.bias", "time_embedding.linear_1.bias"),
    ("time_embed.2.weight", "time_embedding.linear_2.weight"),
    ("time_embed.2.bias", "time_embedding.linear_2.bias"),
    ("input_blocks.0.0.weight", "conv_in.weight"),
    ("input_blocks.0.0.bias", "conv_in.bias"),
    ("out.0.weight", "conv_norm_out.weight"),
    ("out.0.bias", "conv_norm_out.bias"),
    ("out.2.weight", "conv_out.weight"),
    ("out.2.bias", "conv_out.bias"),
]

UNET_MAP_RESNET = [
    ("in_layers.0", "norm1"),
    ("in_layers.2", "conv1"),
    ("out_layers.0", "norm2"),
    ("out_layers.3", "conv2"),
    ("emb_layers.1", "time_emb_proj"),
    ("skip_connection", "conv_shortcut"),
]


def _unet_layer_map():
    m = []
    for i in range(4):
        for j in range(2):
            m.append((f"input_blocks.{3 * i + j + 1}.0.",
                      f"down_blocks.{i}.resnets.{j}."))
            if i < 3:
                m.append((f"input_blocks.{3 * i + j + 1}.1.",
                          f"down_blocks.{i}.attentions.{j}."))
        for j in range(3):
            m.append((f"output_blocks.{3 * i + j}.0.",
                      f"up_blocks.{i}.resnets.{j}."))
            if i > 0:
                m.append((f"output_blocks.{3 * i + j}.1.",
                          f"up_blocks.{i}.attentions.{j}."))
        if i < 3:
            m.append((f"input_blocks.{3 * (i + 1)}.0.op.",
                      f"down_blocks.{i}.downsamplers.0.conv."))
            m.append((f"output_blocks.{3 * i + 2}.{1 if i == 0 else 2}.",
                      f"up_blocks.{i}.upsamplers.0."))
    m.append(("middle_block.1.", "mid_block.attentions.0."))
    for j in range(2):
        m.append((f"middle_block.{2 * j}.", f"mid_block.resnets.{j}."))
    return m


UNET_MAP_LAYER = _unet_layer_map()


def convert_unet_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers UNet keys -> ldm keys (convert_unet_state_dict :85-103)."""
    mapping = {k: k for k in sd}
    for sd_name, hf_name in UNET_MAP:
        if hf_name in mapping:
            mapping[hf_name] = sd_name
    for k, v in mapping.items():
        if "resnets" in k:
            for sd_part, hf_part in UNET_MAP_RESNET:
                v = v.replace(hf_part, sd_part)
            mapping[k] = v
    for k, v in mapping.items():
        for sd_part, hf_part in UNET_MAP_LAYER:
            v = v.replace(hf_part, sd_part)
        mapping[k] = v
    return {v: sd[k] for k, v in mapping.items()}


# --- VAE tables (diffusers_convert.py:107-183) ------------------------------

def _vae_map():
    m = [
        ("nin_shortcut", "conv_shortcut"),
        ("norm_out", "conv_norm_out"),
        ("mid.attn_1.", "mid_block.attentions.0."),
    ]
    for i in range(4):
        for j in range(2):
            m.append((f"encoder.down.{i}.block.{j}.",
                      f"encoder.down_blocks.{i}.resnets.{j}."))
        if i < 3:
            m.append((f"down.{i}.downsample.", f"down_blocks.{i}.downsamplers.0."))
            m.append((f"up.{3 - i}.upsample.", f"up_blocks.{i}.upsamplers.0."))
        for j in range(3):
            m.append((f"decoder.up.{3 - i}.block.{j}.",
                      f"decoder.up_blocks.{i}.resnets.{j}."))
    for i in range(2):
        m.append((f"mid.block_{i + 1}.", f"mid_block.resnets.{i}."))
    return m


VAE_MAP = _vae_map()
VAE_MAP_ATTN = [
    ("norm.", "group_norm."),
    ("q.", "query."),
    ("k.", "key."),
    ("v.", "value."),
    ("q.", "to_q."),
    ("k.", "to_k."),
    ("v.", "to_v."),
    ("proj_out.", "to_out.0."),
    ("proj_out.", "proj_attn."),
]


def convert_vae_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers VAE keys -> ldm keys, reshaping the mid-attention linears to
    1x1 convs (convert_vae_state_dict :166-188)."""
    mapping = {k: k for k in sd}
    for k, v in mapping.items():
        for sd_part, hf_part in VAE_MAP:
            v = v.replace(hf_part, sd_part)
        mapping[k] = v
    for k, v in mapping.items():
        if "attentions" in k:
            for sd_part, hf_part in VAE_MAP_ATTN:
                v = v.replace(hf_part, sd_part)
            mapping[k] = v
    out = {v: sd[k] for k, v in mapping.items()}
    for name in ("q", "k", "v", "proj_out"):
        for k, v in list(out.items()):
            if f"mid.attn_1.{name}.weight" in k and v.ndim == 2:
                out[k] = v.reshape(*v.shape, 1, 1)
    return out


def load_diffusers_folder(path: str) -> Dict[str, torch.Tensor]:
    """Load a diffusers model folder (unet/ vae/ text_encoder/ safetensors)
    into ONE ldm-layout flat dict (comfy diffusers_load.py load_diffusers):
    model.diffusion_model.* + first_stage_model.* +
    cond_stage_model.transformer.*."""
    from stable_renderer_tpu_torch.models.weights import load_state_dict

    root = Path(path)

    def find_weights(sub: str) -> Optional[Path]:
        d = root / sub
        if not d.is_dir():
            return None
        cands = sorted(list(d.glob("*.safetensors")) + list(d.glob("*.bin"))
                       + list(d.glob("*.pth")))
        return cands[0] if cands else None

    unet_f = find_weights("unet")
    vae_f = find_weights("vae")
    te_f = find_weights("text_encoder")
    if unet_f is None:
        raise FileNotFoundError(f"{path}: no unet/ weights found")
    flat: Dict[str, torch.Tensor] = {}
    for k, v in convert_unet_state_dict(load_state_dict(unet_f)).items():
        flat[f"model.diffusion_model.{k}"] = v
    if vae_f is not None:
        for k, v in convert_vae_state_dict(load_state_dict(vae_f)).items():
            flat[f"first_stage_model.{k}"] = v
    if te_f is not None:
        # diffusers text encoders are already transformers-layout — exactly
        # the ldm cond_stage_model.transformer.* contract (SD1.x); no v2
        # re-pack needed on the load path
        for k, v in load_state_dict(te_f).items():
            flat[f"cond_stage_model.transformer.{k}"] = v
    return flat
