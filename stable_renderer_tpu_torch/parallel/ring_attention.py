"""All-frames (cross-frame) attention.

Counterpart of stable_renderer_tpu/parallel/ring_attention.py. SURVEY.md
section 2.6: every frame attends to the K/V of ALL frames (sequence = frames x
tokens), the all-frames generalization of the reference OverlapCorresponder's
broadcast K/V.

  * ``cross_frame_attention_reference`` — the plain version, the JAX package's
    dense ``_mha`` over every query row's broadcast copy of the concatenated
    K/V. The CPU path, and what the kernel route is held to.
  * ``cross_frame_attention`` — on the card, the same function through K1:
    every query row attends to the same K/V, so the batch folds into the
    query sequence, q (1, N*L, C) against K/V (1, N*L, C), one
    ``attention_pallas`` call that reads the UNet's fused-QKV chunks in
    place (no broadcast copy, no stride-0 view). K/V of 2048 tokens or more
    launch the kernel; shorter ones take the plain path, as every attention
    does. The dense form's logits at 512x512 (N=16, L=4096) would take ~137
    GB in f32; the folded route never forms them.
  * ``ring_cross_frame_attention`` — the multi-device ring form waits for
    ROADMAP 1.14 and raises.
"""

from __future__ import annotations

import math

import torch

from stable_renderer_tpu_torch.ops.flash_attention import attention_pallas


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Dense multi-head attention over packed heads (B, L, H*D): f32 logits and
    softmax, weights cast to v's dtype before the value product."""
    b, lq, hd = q.shape
    d = hd // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, -1, heads, d).transpose(1, 2)
    vh = v.reshape(b, -1, heads, d).transpose(1, 2)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, vh).transpose(1, 2).reshape(b, lq, hd)


def cross_frame_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    heads: int) -> torch.Tensor:
    """Every frame of q (N, L, C) attends to the concatenated K/V of all N
    frames of k, v (N, L, C): the dense plain version."""
    n, l, c = k.shape
    k_all = k.reshape(1, n * l, c).expand(q.shape[0], n * l, c)
    v_all = v.reshape(1, n * l, c).expand(q.shape[0], n * l, c)
    return _mha(q, k_all, v_all, heads)


def cross_frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """Every frame attends to the concatenated K/V of ALL frames. CPU
    tensors take the plain version; CUDA tensors the folded route through
    ``attention_pallas`` (K1 where the K/V length is >= 2048), which raises
    rather than falling back."""
    if q.device.type == "cpu":
        return cross_frame_attention_reference(q, k, v, heads)
    n, l, c = q.shape
    out = attention_pallas(q.reshape(1, n * l, c), k.reshape(1, -1, c), v.reshape(1, -1, c),
                           heads)
    return out.reshape(n, l, c)


def ring_cross_frame_attention(q, k, v, heads: int, mesh, axis: str = "dp"):
    """cross_frame_attention with frames sharded over a device mesh
    (stable_renderer_tpu/parallel/ring_attention.py:62): waits for the
    multi-device slice."""
    raise NotImplementedError("ring_cross_frame_attention waits for the multi-device slice "
                              "(ROADMAP 1.14)")
