"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports only the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

from stable_renderer_tpu_torch.engine.mesh import Mesh
from stable_renderer_tpu_torch.ops import flash_attention as tfa
from stable_renderer_tpu_torch.ops import raster as tr
from stable_renderer_tpu_torch.ops import raster_kernel as trk
from stable_renderer_tpu_torch.ops.transforms import look_at, perspective

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see the module docstring for the command)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype,tol", [
    ((16, 4096, 4096, 40), torch.bfloat16, 1e-2),   # UNet level-0 self-attention
    ((1, 4096, 4096, 512), torch.bfloat16, 1e-2),   # VAE mid-block attention
    ((4, 300, 2100, 40), torch.bfloat16, 1e-2),     # ragged q and K/V tiles
    ((3, 77, 2049, 80), torch.float32, 1e-4),
    ((2, 130, 333, 512), torch.float32, 1e-4),
])
def test_flash_attention_kernel_matches_plain(cuda_device, shape, dtype, tol):
    """bf16 bound: output rounding (2^-8 relative) plus the plain path's bf16
    softmax weights; f32 bound: summation order."""
    bh, lq, lk, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((bh, lq, d), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((bh, lk, d), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((bh, lk, d), generator=g, device=cuda_device).to(dtype)
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() < tol


def test_flash_attention_rejects_unsupported_inputs(cuda_device):
    q = torch.zeros((2, 8, 16), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros((2, 8, 520), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("size", [(512, 512), (200, 136)])
def test_raster_kernel_matches_plain(cuda_device, size):
    """The bars of tests/test_raster_pallas.py:38-50."""
    h, w = size
    mesh = Mesh.Sphere(1.0, 48)
    pos = torch.from_numpy(mesh.positions).to(cuda_device)
    ones = torch.ones_like(pos[:, :1])
    mvp = (perspective(45.0, w / h, 0.1, 100.0) @ look_at([0.0, 0.5, 3.0], [0.0, 0.0, 0.0],
                                                           [0.0, 1.0, 0.0])).to(cuda_device)
    clip = torch.cat([pos, ones], -1) @ mvp.T
    tris = torch.from_numpy(mesh.tris).to(cuda_device)
    before = trk.rasterize_kernel.launches
    out = trk.rasterize_kernel(clip, tris, h, w, cull_backface=True)
    torch.cuda.synchronize()
    assert trk.rasterize_kernel.launches == before + 1
    ref = tr.rasterize(clip, tris, h, w, cull_backface=True)
    cov, ref_cov = out.tri_id >= 0, ref.tri_id >= 0
    assert (cov != ref_cov).float().mean().item() < 0.005
    both = cov & ref_cov
    assert both.any()
    assert (out.z[both] - ref.z[both]).abs().max().item() < 1e-4
    same = (out.tri_id == ref.tri_id)[both]
    assert same.float().mean().item() > 0.98
    bary = torch.isclose(out.bary[both], ref.bary[both], atol=1e-3).all(-1)[same]
    assert bary.float().mean().item() > 0.98
