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
  * ``ring_cross_frame_attention`` — the same function with the frames
    split over the ranks of a mesh axis (each rank holds its frames' q, k
    and v): K/V blocks rotate around the axis's ranks, one block a hop by
    ``batch_isend_irecv``, while each rank's queries keep an f32 online
    softmax (running max, sum and accumulator), as the JAX package's
    ``hop``. No rank holds more than one block of K/V besides its own. The
    hop is plain tensor math, as in the JAX package, blocked over query
    rows so that one block's f32 logits stay under ``RING_LOGITS_BYTES``
    (8 frames of 4096 tokens and 8 heads on one rank would otherwise form
    34 GB of them).
"""

from __future__ import annotations

import math

import torch

from stable_renderer_tpu_torch.ops.flash_attention import attention_pallas
from stable_renderer_tpu_torch.parallel.mesh import FrameShard, frame_sharding

RING_LOGITS_BYTES = 1 << 30  # one query block's f32 logits in a hop


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


def ring_cross_frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                               mesh, axis: str = "dp") -> torch.Tensor:
    """cross_frame_attention with the frames split over ``axis`` of
    ``mesh``: q, k, v (n_local, L, C) are this rank's frames, the result its
    frames' outputs (stable_renderer_tpu/parallel/ring_attention.py:62)."""
    return ring_attention_shard(q, k, v, heads, frame_sharding(mesh, axis))


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                         shard: FrameShard) -> torch.Tensor:
    """The ring over ``shard``'s ranks: ``shard.size`` hops, each attending
    this rank's queries to the K/V block in hand (an online-softmax update in
    f32), then handing the block on. The products run in the inputs' type
    with f32 logits; the weights are cast to v's type for the value product,
    as the dense version does."""
    b, l, c = q.shape
    d = c // heads
    scale = 1.0 / math.sqrt(d)
    rows = b * l
    qh = q.reshape(rows, heads, d).transpose(0, 1)  # (H, rows, d): every local query row
    acc = torch.zeros((heads, rows, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((heads, rows, 1), -1e30, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((heads, rows, 1), dtype=torch.float32, device=q.device)
    kv = [k, v]
    for hop in range(shard.size):
        kh = kv[0].reshape(-1, heads, d).transpose(0, 1)  # (H, keys, d)
        vh = kv[1].reshape(-1, heads, d).transpose(0, 1)
        step = max(1, RING_LOGITS_BYTES // (4 * heads * kh.shape[1]))
        for r0 in range(0, rows, step):
            r = slice(r0, min(r0 + step, rows))
            logits = torch.matmul(qh[:, r], kh.transpose(-1, -2)).float().mul_(scale)
            m_new = torch.maximum(m_run[:, r], logits.amax(-1, keepdim=True))
            p = logits.sub_(m_new).exp_()
            corr = torch.exp(m_run[:, r] - m_new)
            l_run[:, r] = l_run[:, r] * corr + p.sum(-1, keepdim=True)
            acc[:, r] = acc[:, r] * corr + torch.matmul(p.to(vh.dtype), vh).float()
            m_run[:, r] = m_new
        if hop + 1 < shard.size:
            kv = shard.rotate(kv)
    out = (acc / l_run.clamp(min=1e-30)).to(q.dtype)
    return out.transpose(0, 1).reshape(b, l, c)
