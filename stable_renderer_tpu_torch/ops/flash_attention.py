"""Flash attention: the K1 kernel's wrapper, its plain version and its routing.

Counterpart of stable_renderer_tpu/ops/flash_attention.py. The kernels are in
``csrc/flash_attention.cu`` (CUDA C++ for sm_90a); see its header for the
design. Routes, by dtype, for CUDA tensors:

* bf16: the tensor-core kernels (d <= 256: wgmma with K and V by TMA;
  256 < d <= 512: mma.sync with cp.async). They read q, k and v as strided
  (B, L, H, D) views and write (B, L, H*D), so ``attention_pallas`` hands
  them the UNet's fused-QKV chunks without a layout copy. A view whose rows
  the kernels cannot read with 16-byte copies is made contiguous first
  (``needs_copy``).
* f32: the f32 FMA pipes over contiguous (BH, L, D) (d <= 64: a SIMT
  kernel; above: register tiles with a K/V split), never TF32.

CPU tensors take the plain einsum-softmax ``flash_attention_reference``.
Nothing on the card falls back: an input the kernels do not take raises.

The gradient: the JAX package has no backward Pallas kernel, and its
training step differentiates the plain einsum-softmax. Here, with grad mode
on and an input that requires grad, both wrappers go through
``FlashAttentionFn``: its forward is K1, launched as without grad, and its
backward the plain softmax gradient (``attention_grad_reference``),
recomputed from the saved q, k and v. A raw launch under grad raises, so
no path drops the gradient through K1 (whose output has no ``grad_fn``).

``attention_pallas`` keeps the JAX package's routing rule: attention whose
K/V sequence is shorter than 2048 goes to the plain path (short
self-attention and cross-attention against 77 text tokens), longer K/V to
the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

FLASH_MIN_KV_LEN = 2048  # ops/flash_attention.py:165 routing threshold
MAX_HEAD_DIM = 512
ALIGN_ELEMS = 8  # 16 bytes of bf16: the granule of the kernels' row copies (cp.async, TMA)
# the plain backward's f32 logits a block of the batch-head axis at most: at
# SD1.5's level 0, (16, 4096^2) is one block of 1 GiB; SDXL's (20, 4096^2) two
GRAD_LOGIT_BYTES = 1 << 30


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain non-causal attention over (BH, L, D): f32 logits, f32 softmax,
    weights cast to v's dtype before the value product."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w, v)


def attention_grad_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             dout: torch.Tensor) -> tuple:
    """The gradient of ``flash_attention_reference`` over (BH, L, D): dq,
    dk, dv for the output gradient ``dout`` (BH, Lq, D), in q's, k's and
    v's types. The softmax is recomputed in f32 a block of the batch-head
    axis at a time, so that no block's logits pass GRAD_LOGIT_BYTES; the
    row term sum(dP * P) is sum(dO * O) with O recomputed in f32."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    step = max(1, GRAD_LOGIT_BYTES // (lq * lk * 4))
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    for i in range(0, bh, step):
        qs, ks, vs, gs = (t[i:i + step].float() for t in (q, k, v, dout))
        p = torch.softmax(torch.matmul(qs, ks.transpose(-1, -2)) * scale, dim=-1)
        dv[i:i + step] = torch.matmul(p.transpose(-1, -2), gs)
        delta = (gs * torch.matmul(p, vs)).sum(-1, keepdim=True)
        ds = torch.matmul(gs, vs.transpose(-1, -2)).sub_(delta).mul_(p)
        del p
        dq[i:i + step] = torch.matmul(ds, ks) * scale
        dk[i:i + step] = torch.matmul(ds.transpose(-1, -2), qs) * scale
    return dq, dk, dv


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_grad_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """A raw K1 launch writes an output with no ``grad_fn``: under grad it
    would drop the gradient through attention, so it raises."""
    if _wants_grad(q, k, v):
        raise RuntimeError("flash_attention: a raw K1 launch under grad mode would drop the "
                           "gradient; differentiate through FlashAttentionFn")


class FlashAttentionFn(torch.autograd.Function):
    """K1 with the plain softmax gradient. ``apply(q, k, v, layout)``:

    * ``"bhld"``: (BH, L, D) in, (BH, Lq, D) out (``flash_attention``);
    * ``"blhd"``: (B, L, H, D) views in, (B, Lq, H*D) out (``attention_pallas``'s
      bf16 route on the fused-QKV chunks, read in place).

    The forward launches K1 on CUDA tensors and runs the plain version on
    CPU tensors; the backward is ``attention_grad_reference`` on the saved
    inputs (no log-sum-exp is saved)."""

    @staticmethod
    def forward(ctx, q, k, v, layout: str):
        ctx.layout = layout
        ctx.save_for_backward(q, k, v)
        if layout == "blhd":
            if q.device.type == "cpu":
                out = flash_attention_reference(*(t.transpose(1, 2) for t in (q, k, v)))
                return out.transpose(1, 2).flatten(2)
            return _launch_bf16(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        if ctx.layout == "blhd":
            b, lq, h, d = q.shape
            heads = [t.transpose(1, 2).reshape(b * h, -1, d)
                     for t in (q, k, v, dout.reshape(b, lq, h, d))]
            grads = attention_grad_reference(*heads)
            dq, dk, dv = (g.view(b, h, -1, d).transpose(1, 2) for g in grads)
        else:
            dq, dk, dv = attention_grad_reference(q, k, v, dout)
        return dq, dk, dv, None


def needs_copy(shape, strides, data_ptr: int, elem_bytes: int = 2) -> bool:
    """Whether a (B, L, H, D) view must be made contiguous before the bf16
    kernel reads it. The kernel needs a unit d stride. When d is a multiple
    of 8 it moves rows in 16-byte pieces (cp.async, TMA), so every stride of
    a dimension longer than 1 must be a multiple of 8 elements and the base
    16-byte aligned; otherwise (d not a multiple of 8) it reads element by
    element and any unit-stride view will do."""
    d = shape[-1]
    if d > 1 and strides[-1] != 1:
        return True
    if d % ALIGN_ELEMS:
        return False
    return (data_ptr % (ALIGN_ELEMS * elem_bytes) != 0
            or any(s % ALIGN_ELEMS for n, s in zip(shape[:-1], strides[:-1]) if n > 1))


def _kernel_strides(t: torch.Tensor) -> list:
    """Element strides of batch, sequence and head of a (B, L, H, D) view, 0
    for a dimension of size 1 (never indexed past 0)."""
    return [s if n > 1 else 0 for n, s in zip(t.shape[:3], t.stride()[:3])]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B, Lq, H, D), k and v (B, Lk, H, D) on one CUDA device, one dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, not CUDA")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"flash_attention: {name} dtype {t.dtype} (bf16 or f32 only)")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v differ in dtype or device")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside 1..{MAX_HEAD_DIM}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")


def _launch_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 variant: int = -1) -> torch.Tensor:
    """The bf16 tensor-core kernel on (B, L, H, D) views -> (B, Lq, H*D)."""
    _no_grad_launch(q, k, v)
    from stable_renderer_tpu_torch.kernels import _build

    q, k, v = (t.contiguous() if needs_copy(t.shape, t.stride(), t.data_ptr()) else t
               for t in (q, k, v))
    b, lq, h, d = q.shape
    lk = k.shape[1]
    lib = _build.load_library()
    scratch_bytes = lib.sr_flash_attention_bf16_scratch(b * h, lq, lk, d, variant)
    if scratch_bytes < 0:
        raise ValueError(f"flash_attention: tile variant {variant} does not take head dim {d}")
    out = torch.empty((b, lq, h * d), dtype=q.dtype, device=q.device)
    scratch: Optional[torch.Tensor] = None
    if scratch_bytes:
        scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=q.device)
    strides = (ctypes.c_longlong * 12)(*_kernel_strides(q), *_kernel_strides(k),
                                       *_kernel_strides(v),
                                       *_kernel_strides(out.view(b, lq, h, d)))
    with torch.cuda.device(q.device):
        rc = lib.sr_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), strides, b, h, lq, lk, d,
            1.0 / math.sqrt(d), variant, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


def _launch_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The f32 FMA-pipe kernels on (BH, L, D) -> (BH, Lq, D), on contiguous
    copies."""
    _no_grad_launch(q, k, v)
    from stable_renderer_tpu_torch.kernels import _build

    q, k, v = (t.contiguous() for t in (q, k, v))
    bh, lq, d = q.shape
    lk = k.shape[1]
    lib = _build.load_library()
    out = torch.empty_like(q)
    scratch_bytes = lib.sr_flash_attention_f32_scratch(bh, lq, lk, d)
    scratch: Optional[torch.Tensor] = None
    if scratch_bytes:
        scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.sr_flash_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        None if scratch is None else scratch.data_ptr(),
                                        bh, lq, lk, d, 1.0 / math.sqrt(d),
                                        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over a merged batch-head axis: (BH, Lq, D) x
    (BH, Lk, D) -> (BH, Lq, D). CUDA tensors launch a kernel (bf16: the
    tensor-core kernels, which take strided views; f32: the FMA-pipe
    kernels, on contiguous copies); CPU tensors take the plain version.
    Under grad (grad mode on, an input requiring grad) both go through
    ``FlashAttentionFn``, whose backward is the plain gradient."""
    if _wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, "bhld")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be a (BH, L, D) tensor")
    _check(q[:, :, None], k[:, :, None], v[:, :, None])
    if q.dtype == torch.bfloat16:
        return _launch_bf16(q[:, :, None], k[:, :, None], v[:, :, None])
    return _launch_f32(q, k, v)


flash_attention.launches = 0


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, hd = x.shape
    return x.reshape(b, l, heads, hd // heads).transpose(1, 2)


def attention_pallas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Packed multi-head attention (B, L, H*D) with the kernel routing rule:
    K/V length >= 2048 goes to the kernel; shorter to the plain einsum-softmax
    (where the logits tensor is small). On the card, bf16 reads q, k and v as
    they lie (the UNet's are column chunks of one fused QKV product) and
    writes (B, L, H*D) without a layout copy. Under grad the kernel routes
    (on the CPU too, with the plain forward) go through ``FlashAttentionFn``
    (K1 forward, plain backward)."""
    b, lq, hd = q.shape
    d = hd // heads
    lk = k.shape[1]
    if lk >= FLASH_MIN_KV_LEN and q.device.type == "cuda" and q.dtype == torch.bfloat16:
        qh, kh, vh = (t.unflatten(-1, (heads, d)) for t in (q, k, v))
        _check(qh, kh, vh)
        if _wants_grad(qh, kh, vh):
            return FlashAttentionFn.apply(qh, kh, vh, "blhd")
        return _launch_bf16(qh, kh, vh)
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    if lk < FLASH_MIN_KV_LEN:
        out = flash_attention_reference(qh, kh, vh)
    else:
        out = flash_attention(*(t.reshape(b * heads, -1, d).contiguous() for t in (qh, kh, vh)))
        out = out.reshape(b, heads, lq, d)
    return out.transpose(1, 2).reshape(b, lq, hd)
