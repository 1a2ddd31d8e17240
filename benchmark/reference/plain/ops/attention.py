"""Plain multi-head attention: f32 logits, f32 softmax, weights cast to the
value type before the value product (the port's plain version of K1)."""

from __future__ import annotations

import math

import torch

# the logits of one block of the batch-head axis at most, so that the SDXL
# VAE's 16384-token attention and the bake's batch of 16 fit beside the model
LOGIT_BLOCK_BYTES = 2 << 30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Packed multi-head attention (B, L, H*D) -> (B, Lq, H*D)."""
    b, lq, hd = q.shape
    d = hd // heads
    qh, kh, vh = (t.reshape(b, t.shape[1], heads, d).transpose(1, 2).reshape(b * heads, -1, d)
                  for t in (q, k, v))
    lk = kh.shape[1]
    step = max(1, LOGIT_BLOCK_BYTES // (lq * lk * 4))
    out = torch.empty((b * heads, lq, d), dtype=v.dtype, device=v.device)
    for i in range(0, b * heads, step):
        logits = torch.matmul(qh[i:i + step].float(), kh[i:i + step].float().transpose(-1, -2))
        w = torch.softmax(logits * (1.0 / math.sqrt(d)), dim=-1).to(v.dtype)
        out[i:i + step] = torch.matmul(w, vh[i:i + step])
    return out.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, hd)
