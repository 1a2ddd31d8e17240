"""K1, flash attention: the port's module (ops/flash_attention.py) against the
JAX package's Pallas kernel in interpret mode and its routing, plus the
wrapper's device contract. The CUDA kernel itself is compared with the plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_renderer_tpu.ops.flash_attention as jfa
from stable_renderer_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the JAX Pallas kernel in interpreter mode on the CPU (as
    tests/test_flash_attention.py does)."""
    orig = jfa.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)


def _qkv(rng, bh, lq, lk, d):
    return (rng.standard_normal((bh, lq, d)).astype(np.float32),
            rng.standard_normal((bh, lk, d)).astype(np.float32),
            rng.standard_normal((bh, lk, d)).astype(np.float32))


# d = 80 and 160: the all-frames levels 1 and 2 (the mid wgmma route on the
# card); d = 512: the VAE's (the f32 route at the loaded VAE's attention)
@pytest.mark.parametrize("lq,lk,d", [(256, 256, 64), (256, 77, 64), (130, 333, 40),
                                     (130, 333, 80), (130, 333, 160), (130, 333, 512)])
def test_plain_matches_jax_flash(interpret_mode, rng, lq, lk, d):
    q, k, v = _qkv(rng, 2, lq, lk, d)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=128, block_k=128)
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tfa.flash_attention.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("lk", [64, 2048])
def test_routing_matches_attention_pallas(interpret_mode, rng, lk):
    """Both sides of the lk >= 2048 routing rule, one small head."""
    b, lq, heads, d = 1, 16, 1, 8
    q = rng.standard_normal((b, lq, heads * d)).astype(np.float32)
    k = rng.standard_normal((b, lk, heads * d)).astype(np.float32)
    v = rng.standard_normal((b, lk, heads * d)).astype(np.float32)
    ref = jfa.attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    out = tfa.attention_pallas(*(torch.from_numpy(a) for a in (q, k, v)), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tfa.FLASH_MIN_KV_LEN == 2048


@pytest.mark.parametrize("n,l,d", [(2, 1024, 80), (4, 256, 80), (8, 256, 160), (2, 256, 160)])
def test_folded_cross_frame_routing_matches_jax(interpret_mode, monkeypatch, rng, n, l, d):
    """cross_frame_attention's folded all-frames shapes at 8 heads, level 1
    (d = 80) and level 2 (d = 160): the frames fold into one (1, n l, 8 d)
    sequence for attention_pallas, which sends n l >= 2048 keys to the
    kernel's wrapper (here its plain version) and shorter ones to the plain
    path, as the JAX package routes them; both sides against JAX's
    attention_pallas (its Pallas kernel in interpret mode) and the port's
    dense cross_frame_attention_reference."""
    from stable_renderer_tpu_torch.parallel.ring_attention import (
        cross_frame_attention_reference,
    )

    heads = 8
    calls = []
    wrapper = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, k, v: calls.append(tuple(q.shape)) or wrapper(q, k, v))
    qkv = rng.standard_normal((n, l, 3 * heads * d)).astype(np.float32)
    q, k, v = (a.reshape(1, n * l, heads * d) for a in np.split(qkv, 3, axis=-1))
    ref = jfa.attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    out = tfa.attention_pallas(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v)),
                               heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert calls == ([(heads, n * l, d)] if n * l >= tfa.FLASH_MIN_KV_LEN else [])
    tq, tk, tv = (torch.from_numpy(a) for a in np.split(qkv, 3, axis=-1))
    dense = cross_frame_attention_reference(tq, tk, tv, heads)
    np.testing.assert_allclose(out.reshape(n, l, heads * d).numpy(), dense.numpy(), **TOL)


def test_routing_sends_long_kv_to_the_wrapper(monkeypatch, rng):
    calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or tfa.flash_attention_reference(q, k, v))
    q = torch.from_numpy(rng.standard_normal((2, 8, 3 * 4)).astype(np.float32))
    for lk, want in ((2047, 0), (2048, 1)):
        kv = torch.from_numpy(rng.standard_normal((2, lk, 3 * 4)).astype(np.float32))
        tfa.attention_pallas(q, kv, kv, heads=3)
        assert len(calls) == want
    assert calls[0] == (6, 8, 4)  # merged (batch * heads, L, D)


def test_wrapper_rejects_non_cuda_devices():
    q = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        tfa.flash_attention(q, q, q)


def test_plain_matches_jax_einsum_bf16_inputs(rng):
    """bf16 inputs: f32 logits and softmax, weights rounded to v's dtype —
    the JAX plain path's numerics (layers.attention)."""
    from stable_renderer_tpu.models.layers import attention as jattn

    b, l, heads, d = 1, 32, 2, 16
    q, k, v = (rng.standard_normal((b, l, heads * d)).astype(np.float32) for _ in range(3))
    ref = jattn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), heads)
    out = tfa.attention_pallas(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), heads)
    # both round the softmax weights and the output to bf16 (2^-8 relative)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("lk", [64, 2048])
def test_attention_pallas_on_fused_qkv_chunks(interpret_mode, rng, lk):
    """The UNet's self-attention operands: column chunks of one fused QKV
    product (row stride 3 H D), as the port's layers.attention receives
    them, against the JAX package's attention_pallas on the same values."""
    b, heads, d = 2, 2, 8
    qkv = rng.standard_normal((b, lk, 3 * heads * d)).astype(np.float32)
    q, k, v = torch.from_numpy(qkv).chunk(3, dim=-1)
    assert q.stride() == (lk * 3 * heads * d, 3 * heads * d, 1)
    jq, jk, jv = (jnp.asarray(a) for a in np.split(qkv, 3, axis=-1))
    ref = jfa.attention_pallas(jq, jk, jv, heads)
    out = tfa.attention_pallas(q, k, v, heads)
    assert out.shape == (b, lk, heads * d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape,strides,offset,copy", [
    # the UNet's fused-QKV chunk at 512x512: (2, 4096, 8, 40) rows 960 apart
    ((2, 4096, 8, 40), (4096 * 960, 960, 40, 1), 320, False),
    ((1, 4096, 1, 512), (4096 * 512, 512, 512, 1), 0, False),  # the VAE's q
    ((2, 77, 8, 40), (77 * 321, 321, 40, 1), 1, True),    # rows 321 apart
    ((2, 77, 8, 40), (77 * 320, 320, 40, 1), 1, True),    # base 2 bytes off 16
    ((2, 77, 8, 40), (77 * 640, 1, 77, 640), 0, True),    # d not the unit stride
    ((2, 77, 1, 40), (77 * 40, 40, 3, 1), 0, False),      # a head stride of size 1 is never used
    ((1, 1, 8, 40), (8 * 44, 7, 44, 1), 0, True),         # head stride 44
    ((3, 50, 2, 20), (50 * 41, 41, 20, 1), 1, False),     # d = 20: element loads take any view
    ((2, 9, 1, 1), (9, 1, 9, 5), 0, False),               # d = 1: its stride is never used
])
def test_needs_copy(shape, strides, offset, copy):
    """The bf16 kernel reads a (B, L, H, D) view in place when its rows can
    move by 16-byte copies (d, every stride of a dimension longer than 1
    and the base a multiple of 8 elements), or when d is not a multiple of
    8 (it then reads element by element); otherwise the wrapper copies."""
    assert tfa.needs_copy(shape, strides, 0x1000 + 2 * offset) == copy


def test_needs_copy_matches_views_the_wrapper_builds():
    """attention_pallas splits (B, L, H*D) into (B, L, H, D) with unflatten:
    a chunk of a fused product stays a view, with the chunk's strides."""
    qkv = torch.zeros((2, 64, 3 * 8 * 40), dtype=torch.bfloat16)
    for i, t in enumerate(qkv.chunk(3, dim=-1)):
        v = t.unflatten(-1, (8, 40))
        assert v.data_ptr() == qkv.data_ptr() + i * 320 * 2
        assert v.stride() == (64 * 960, 960, 40, 1)
        assert not tfa.needs_copy(v.shape, v.stride(), v.data_ptr())
    odd = torch.zeros((2, 64, 8 * 40 + 1), dtype=torch.bfloat16)[..., 1:].unflatten(-1, (8, 40))
    assert tfa.needs_copy(odd.shape, odd.stride(), odd.data_ptr())
    assert not tfa.needs_copy(odd.contiguous().shape, odd.contiguous().stride(),
                              odd.contiguous().data_ptr())
