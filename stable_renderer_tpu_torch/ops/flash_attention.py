"""Flash attention: the K1 kernel's wrapper, its plain version and its routing.

Counterpart of stable_renderer_tpu/ops/flash_attention.py. The kernel is
``csrc/flash_attention.cu`` (CUDA C++ for sm_90a); see its header for the
design. ``flash_attention`` launches it for CUDA tensors and uses the plain
einsum-softmax ``flash_attention_reference`` only for CPU tensors.

``attention_pallas`` keeps the JAX package's routing rule: attention whose
K/V sequence is shorter than 2048 goes to the plain path (short
self-attention and cross-attention against 77 text tokens), longer K/V to
the kernel.
"""

from __future__ import annotations

import math

import torch

FLASH_MIN_KV_LEN = 2048  # ops/flash_attention.py:165 routing threshold
MAX_HEAD_DIM = 512


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain non-causal attention over (BH, L, D): f32 logits, f32 softmax,
    weights cast to v's dtype before the value product."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, not CUDA")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"flash_attention: {name} dtype {t.dtype} (bf16 or f32 only)")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous (BH, L, D) tensor")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v differ in dtype or device")
    bh, _, d = q.shape
    if k.shape[0] != bh or v.shape != k.shape or k.shape[2] != d:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside 1..{MAX_HEAD_DIM}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over a merged batch-head axis: (BH, Lq, D) x
    (BH, Lk, D) -> (BH, Lq, D). CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    _check(q, k, v)
    from stable_renderer_tpu_torch.kernels import _build

    lib = _build.load_library()
    out = torch.empty_like(q)
    bh, lq, d = q.shape
    fn = lib.sr_flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.sr_flash_attention_f32
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, lq,
                k.shape[1], d, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, hd = x.shape
    return x.reshape(b, l, heads, hd // heads).transpose(1, 2)


def attention_pallas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Packed multi-head attention (B, L, H*D) with the kernel routing rule:
    K/V length >= 2048 goes to ``flash_attention``; shorter to the plain
    einsum-softmax (where the logits tensor is small)."""
    b, lq, hd = q.shape
    d = hd // heads
    lk = k.shape[1]
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    if lk < FLASH_MIN_KV_LEN:
        out = flash_attention_reference(qh, kh, vh)
    else:
        out = flash_attention(*(t.reshape(b * heads, -1, d).contiguous() for t in (qh, kh, vh)))
        out = out.reshape(b, heads, lq, d)
    return out.transpose(1, 2).reshape(b, lq, hd)
