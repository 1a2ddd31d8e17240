"""GLIGEN: grounded (bounding-box) text-to-image conditioning.

Counterpart of stable_renderer_tpu/models/gligen.py (reference
comfy/gligen.py GatedSelfAttentionDense :87-124, FourierEmbedder :181-196,
PositionNet :199-240, Gligen.set_position :243-310, load_gligen :320-343).
The fusers hook the UNet at the ``mid`` attention hook (models/unet.py
AttnHooks.mid), which fires after the attn1 residual add of every
transformer block; fuser i serves the UNet's transformer i.

A fuser's self-attention runs over the block's visual tokens plus
``MAX_OBJS`` grounding tokens through ``layers.attention``: at SD1.5's level
0 at 512x512 that is 4096 + 30 = 4126 tokens, past the 2048 threshold, so K1
takes it on the card. The feed-forward's GELU is the tanh form
(``jax.nn.gelu``'s default, which the JAX package takes).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import attention, layer_norm, linear

MAX_OBJS = 30  # gligen.py:248


def fourier_embed(x: torch.Tensor, num_freqs: int = 8, temperature: float = 100.0
                  ) -> torch.Tensor:
    """FourierEmbedder (gligen.py:181-196): sin/cos bands by frequency,
    concatenated on the last axis. x: (..., 4) -> (..., num_freqs*2*4)."""
    freqs = temperature ** (torch.arange(num_freqs, dtype=torch.float32) / num_freqs)
    out = []
    for f in freqs.tolist():
        f = torch.tensor(f, dtype=x.dtype, device=x.device)
        out += [torch.sin(f * x), torch.cos(f * x)]
    return torch.cat(out, dim=-1)


def position_net_apply(params: dict, boxes: torch.Tensor, masks: torch.Tensor,
                       positive_embeddings: torch.Tensor) -> torch.Tensor:
    """PositionNet (gligen.py:199-240): (B,N,4) boxes + (B,N) masks +
    (B,N,in_dim) text embeds -> (B,N,out_dim) grounding tokens; padded slots
    take the learned null features."""
    m = masks[..., None]
    xyxy = fourier_embed(boxes)
    pos_null = params["null_positive_feature"][None, None]
    xyxy_null = params["null_position_feature"][None, None]
    pe = positive_embeddings * m + (1 - m) * pos_null
    xe = xyxy * m + (1 - m) * xyxy_null
    h = torch.cat([pe, xe], dim=-1)
    h = F.silu(linear(params["linears"]["0"], h))
    h = F.silu(linear(params["linears"]["2"], h))
    return linear(params["linears"]["4"], h)


def _geglu_ff(p: dict, x: torch.Tensor) -> torch.Tensor:
    """FeedForward(glu=True) (gligen.py:23-50): GEGLU proj -> linear."""
    a, gate = linear(p["net"]["0"]["proj"], x).chunk(2, dim=-1)
    return linear(p["net"]["2"], a * F.gelu(gate, approximate="tanh"))


def gated_self_attention(p: dict, x: torch.Tensor, objs: torch.Tensor,
                         n_heads: int) -> torch.Tensor:
    """GatedSelfAttentionDense (gligen.py:87-124): self-attention over
    [visual tokens ++ projected grounding tokens], the visual part kept,
    gated by tanh(alpha)."""
    n_visual = x.shape[1]
    objs_p = linear(p["linear"], objs)
    h = layer_norm(p["norm1"], torch.cat([x, objs_p], dim=1))
    q = linear(p["attn"]["to_q"], h)
    k = linear(p["attn"]["to_k"], h)
    v = linear(p["attn"]["to_v"], h)
    att = attention(q, k, v, n_heads)
    att = linear(p["attn"]["to_out"]["0"], att)[:, :n_visual]
    # the gates promote as JAX's arrays do: a gate wider than the activations
    # (an f32 or f16 file under a bf16 UNet) widens the block's output
    dt = torch.promote_types(x.dtype, p["alpha_attn"].dtype)
    x = x.to(dt) + torch.tanh(p["alpha_attn"]).to(dt) * att.to(dt)
    dt = torch.promote_types(x.dtype, p["alpha_dense"].dtype)
    ff = _geglu_ff(p["ff"], layer_norm(p["norm2"], x))
    return x.to(dt) + torch.tanh(p["alpha_dense"]).to(dt) * ff.to(dt)


class Gligen:
    """A loaded GLIGEN patch: fuser params by transformer index + the
    PositionNet (gligen.py:243-316)."""

    def __init__(self, fusers: List[dict], fuser_heads: List[int], position_net: dict,
                 key_dim: int):
        self.fusers = fusers          # ordered by transformer_index
        self.fuser_heads = fuser_heads
        self.position_net = position_net
        self.key_dim = key_dim
        self.max_objs = MAX_OBJS

    def grounding_tokens(self, batch: int, position_params: Optional[List[Tuple]] = None,
                         latent_hw: Tuple[int, int] = (64, 64)) -> torch.Tensor:
        """The (B, max_objs, out_dim) grounding tokens. ``position_params``
        entries are the node's tuples (cond_pooled, h, w, y, x) in latent
        cells (gligen.py:262-276); none -> set_empty (gligen.py:297-310)."""
        dev = self.position_net["null_positive_feature"].device
        h_lat, w_lat = latent_hw
        boxes = torch.zeros((self.max_objs, 4), device=dev)
        masks = torch.zeros((self.max_objs,), device=dev)
        conds = torch.zeros((self.max_objs, self.key_dim), device=dev)
        for i, p in enumerate(position_params or []):
            if i >= self.max_objs:
                break
            emb, bh, bw, by, bx = p
            boxes[i] = torch.tensor([bx / w_lat, by / h_lat, (bx + bw) / w_lat,
                                     (by + bh) / h_lat], dtype=torch.float32)
            masks[i] = 1.0
            conds[i] = torch.as_tensor(emb).reshape(-1)[: self.key_dim].to(dev, torch.float32)

        def rep(a):
            return a[None].expand((batch,) + tuple(a.shape))

        return position_net_apply(self.position_net, rep(boxes), rep(masks), rep(conds))

    def make_mid_hook(self, objs: torch.Tensor):
        """An AttnHooks.mid function applying fuser[transformer_index]
        (Gligen._set_position, gligen.py:251-257)."""

        def mid(x: torch.Tensor, layer: int) -> torch.Tensor:
            if layer >= len(self.fusers):
                return x
            p = self.fusers[layer]
            # a fuser applies only at its own width (real checkpoints always
            # match; partial fixtures skip)
            if p["norm1"]["weight"].shape[0] != x.shape[-1]:
                return x
            return gated_self_attention(p, x, objs.to(x.dtype), self.fuser_heads[layer])

        return mid


def load_gligen(sd: dict, device=None) -> Gligen:
    """A GLIGEN checkpoint state dict (load_gligen, gligen.py:320-343) on
    ``device`` (default: the card), the file's dtypes kept: fusers keyed
    input_blocks / middle_block / output_blocks.<n>.fuser.*, ordered by scan
    order = transformer_index; 8 heads when the key width is 768 (SD1.x),
    else query_dim // 64."""
    from stable_renderer_tpu_torch.device import resolve_device
    from stable_renderer_tpu_torch.models.weights import nest, tree_to

    dev = resolve_device(device)
    fusers: List[dict] = []
    heads: List[int] = []
    key_dim = 768
    for a in ("input_blocks", "middle_block", "output_blocks"):
        for b in range(20):
            prefix = f"{a}.{b}."
            n_sd = {k.split(".fuser.")[-1]: v for k, v in sd.items()
                    if k.startswith(prefix) and ".fuser." in k}
            if not n_sd:
                continue
            query_dim, key_dim = n_sd["linear.weight"].shape
            heads.append(8 if key_dim == 768 else query_dim // 64)
            fusers.append(tree_to(nest(n_sd), dev))
    position_net = tree_to(nest({k[len("position_net."):]: v for k, v in sd.items()
                                 if k.startswith("position_net.")}), dev)
    return Gligen(fusers, heads, position_net, key_dim)


def init_random_gligen(generator: Optional[torch.Generator] = None, n_fusers: int = 16,
                       query_dim: int = 64, key_dim: int = 64, n_heads: int = 2,
                       device=None) -> Gligen:
    """A random-weights Gligen for tests, in the JAX package's shapes: each
    fuser's linear projects key_dim -> query_dim; the PositionNet emits
    key_dim-wide tokens (gligen.py:91-93, 320-335)."""
    def lin(i, o, bias=True):
        p = {"weight": torch.randn((o, i), generator=generator, device=device) * 0.02}
        if bias:
            p["bias"] = torch.zeros((o,), device=device)
        return p

    def norm(c):
        return {"weight": torch.ones((c,), device=device), "bias": torch.zeros((c,), device=device)}

    def fuser():
        inner = query_dim * 4
        return {
            "linear": lin(key_dim, query_dim),
            "attn": {"to_q": lin(query_dim, query_dim, False),
                     "to_k": lin(query_dim, query_dim, False),
                     "to_v": lin(query_dim, query_dim, False),
                     "to_out": {"0": lin(query_dim, query_dim)}},
            "ff": {"net": {"0": {"proj": lin(query_dim, inner * 2)}, "2": lin(inner, query_dim)}},
            "norm1": norm(query_dim), "norm2": norm(query_dim),
            "alpha_attn": torch.tensor(0.5, device=device),
            "alpha_dense": torch.tensor(0.5, device=device),
        }

    pos_dim = 8 * 2 * 4
    position_net = {
        "linears": {"0": lin(key_dim + pos_dim, 512), "2": lin(512, 512), "4": lin(512, key_dim)},
        "null_positive_feature": torch.zeros((key_dim,), device=device),
        "null_position_feature": torch.zeros((pos_dim,), device=device),
    }
    return Gligen([fuser() for _ in range(n_fusers)], [n_heads] * n_fusers, position_net,
                  key_dim)
