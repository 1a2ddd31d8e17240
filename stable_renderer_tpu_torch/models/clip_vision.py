"""CLIP vision tower: image embeddings for unCLIP, the style adapter,
Zero123 and PhotoMaker.

Counterpart of stable_renderer_tpu/models/clip_vision.py (reference
comfy/clip_vision.py clip_preprocess / ClipVisionModel.encode_image /
load_clipvision_from_sd, comfy/clip_model.py CLIPVisionModelProjection).
Functional PyTorch over a transformers-layout param dict, as the text towers
of models/clip.py. The patch embedding is a strided ``F.conv2d``; attention
goes through ``layers.attention`` (257 tokens at 224x224: the plain path, as
the JAX routing has it). The tower computes in the input's dtype, weights
cast to it.

Outputs mirror the reference's Output triple: last_hidden_state,
penultimate_hidden_states (intermediate_output=-2) and image_embeds (the
projected class token).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import attention, gelu_quick, layer_norm, linear

# clip_vision.py:26-27 normalization constants (data contract)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768


# size detection by deepest layer present (clip_vision.py:109-117)
VITL_CONFIG = CLIPVisionConfig()  # ViT-L/14 (SD1.5 unCLIP / IP-Adapter)
VITH_CONFIG = CLIPVisionConfig(hidden_size=1280, num_layers=32, num_heads=16,
                               intermediate_size=5120, projection_dim=1024)
VITG_CONFIG = CLIPVisionConfig(hidden_size=1664, num_layers=48, num_heads=16,
                               intermediate_size=8192, patch_size=14, projection_dim=1280)
TINY_VISION_CONFIG = CLIPVisionConfig(hidden_size=64, num_layers=2, num_heads=2,
                                      intermediate_size=128, image_size=28, patch_size=14,
                                      projection_dim=32)


class VisionOutput(NamedTuple):
    last_hidden_state: torch.Tensor          # (B, 1+P, H)
    penultimate_hidden_states: torch.Tensor  # (B, 1+P, H)
    image_embeds: torch.Tensor               # (B, projection_dim)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5."""
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """The linear (tent) resampling kernel."""
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _resize_weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """(n_in, n_out) f32 resampling weights along one axis, antialiased when
    shrinking: jax.image.scale_and_translate's weight matrix, op for op."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)  # a Python float, as JAX's static scale
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32)
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(image: torch.Tensor, h: int, w: int, kernel) -> torch.Tensor:
    out = image
    if image.shape[1] != h:
        wh = _resize_weights(image.shape[1], h, kernel, image.device).to(image.dtype)
        out = torch.einsum("bhwc,hy->bywc", out, wh)
    if image.shape[2] != w:
        ww = _resize_weights(image.shape[2], w, kernel, image.device).to(image.dtype)
        out = torch.einsum("bhwc,wx->bhxc", out, ww)
    return out


def resize_cubic(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C): ``jax.image.resize(..., "cubic")``, a
    separable Keys cubic antialiased when shrinking, in the image's dtype."""
    return _resize(image, h, w, _keys_cubic)


def resize_linear(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C): ``jax.image.resize(..., "bilinear")``,
    half-pixel centres, antialiased (a widened tent) when shrinking, which
    ``F.interpolate(..., antialias=False)`` is not."""
    return _resize(image, h, w, _triangle)


def clip_preprocess(image: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, size, size, 3) normalized
    (clip_vision.py:25-36): cubic resize of the short side to ``size``,
    centre crop, 8-bit quantize, CLIP mean/std normalize."""
    b, h, w, _ = image.shape
    if (h, w) != (size, size):
        scale = size / min(h, w)
        nh, nw = round(scale * h), round(scale * w)
        image = resize_cubic(image, nh, nw)
        top, left = (nh - size) // 2, (nw - size) // 2
        image = image[:, top: top + size, left: left + size, :]
    image = torch.round(torch.clamp(image * 255.0, 0, 255)) / 255.0
    mean = torch.tensor(_CLIP_MEAN, dtype=image.dtype, device=image.device)
    std = torch.tensor(_CLIP_STD, dtype=image.dtype, device=image.device)
    return (image - mean) / std


class CLIPVisionModel:
    """Functional ViT (clip_model.py CLIPVisionModelProjection)."""

    def __init__(self, config: CLIPVisionConfig = VITL_CONFIG):
        self.config = config

    def apply(self, params: dict, pixel_values: torch.Tensor) -> VisionOutput:
        """pixel_values: (B, S, S, 3), already clip_preprocess-ed."""
        cfg = self.config
        vm = params["vision_model"]
        emb = vm["embeddings"]
        dt = pixel_values.dtype
        x = F.conv2d(pixel_values.permute(0, 3, 1, 2),
                     emb["patch_embedding"]["weight"].to(dt), stride=cfg.patch_size)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, P, H), patches row-major
        cls = emb["class_embedding"].to(dt)[None, None].expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
        x = x + emb["position_embedding"]["weight"][: x.shape[1]].to(dt)[None]
        x = layer_norm(vm["pre_layrnorm"], x)  # transformers' (sic) key name

        penultimate = x
        for i in range(cfg.num_layers):
            lp = vm["encoder"]["layers"][str(i)]
            h = layer_norm(lp["layer_norm1"], x)
            q = linear(lp["self_attn"]["q_proj"], h)
            k = linear(lp["self_attn"]["k_proj"], h)
            v = linear(lp["self_attn"]["v_proj"], h)
            h = attention(q, k, v, cfg.num_heads)  # not causal
            x = x + linear(lp["self_attn"]["out_proj"], h)
            h = gelu_quick(linear(lp["mlp"]["fc1"], layer_norm(lp["layer_norm2"], x)))
            x = x + linear(lp["mlp"]["fc2"], h)
            if i == cfg.num_layers - 2:  # intermediate_output=-2
                penultimate = x

        last = layer_norm(vm["post_layernorm"], x)
        pooled = last[:, 0]  # the class token
        image_embeds = pooled @ params["visual_projection"]["weight"].to(pooled.dtype).T
        return VisionOutput(last, penultimate, image_embeds)

    def encode_image(self, params: dict, image: torch.Tensor) -> VisionOutput:
        """Raw (B, H, W, 3) [0, 1] image -> embeddings (encode_image,
        clip_vision.py:71-80)."""
        return self.apply(params, clip_preprocess(image, self.config.image_size))

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the checkpoint tree: N(0, 0.02^2) weights, zero
        biases, unit norms, as the JAX package's ``init``."""
        cfg = self.config

        def randn(*shape):
            return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

        def lin(i, o):
            return {"weight": randn(o, i), "bias": torch.zeros(o, dtype=dtype, device=device)}

        def norm(c):
            return {"weight": torch.ones(c, dtype=dtype, device=device),
                    "bias": torch.zeros(c, dtype=dtype, device=device)}

        h = cfg.hidden_size
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        layers = {
            str(i): {
                "layer_norm1": norm(h), "layer_norm2": norm(h),
                "self_attn": {"q_proj": lin(h, h), "k_proj": lin(h, h),
                              "v_proj": lin(h, h), "out_proj": lin(h, h)},
                "mlp": {"fc1": lin(h, cfg.intermediate_size),
                        "fc2": lin(cfg.intermediate_size, h)},
            }
            for i in range(cfg.num_layers)
        }
        return {
            "vision_model": {
                "embeddings": {
                    "class_embedding": randn(h),
                    "patch_embedding": {"weight": randn(h, 3, cfg.patch_size, cfg.patch_size)},
                    "position_embedding": {"weight": randn(n_pos, h)},
                },
                "pre_layrnorm": norm(h),
                "encoder": {"layers": layers},
                "post_layernorm": norm(h),
            },
            "visual_projection": {"weight": randn(cfg.projection_dim, h)},
        }


def detect_vision_config(sd_keys) -> Optional[CLIPVisionConfig]:
    """The config from the deepest encoder layer present
    (load_clipvision_from_sd, clip_vision.py:109-117)."""
    def has(i: int) -> bool:
        return any(f"layers.{i}." in k for k in sd_keys)

    if has(47):
        return VITG_CONFIG
    if has(30):
        return VITH_CONFIG
    if has(22):
        return VITL_CONFIG
    return None


def load_clip_vision(path: str, device=None):
    """A transformers-layout CLIP vision checkpoint -> (CLIPVisionModel,
    params) on ``device`` (default: the card), the file's dtypes kept.
    Reference load(), clip_vision.py:133-140."""
    from stable_renderer_tpu_torch.device import resolve_device
    from stable_renderer_tpu_torch.models.weights import load_state_dict, nest, tree_to

    dev = resolve_device(device)
    sd = load_state_dict(path)
    cfg = detect_vision_config(sd.keys())
    if cfg is None:
        raise ValueError(f"{path} is not a recognized CLIP vision checkpoint")
    return CLIPVisionModel(cfg), tree_to(nest(sd), dev)
