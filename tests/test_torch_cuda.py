"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports only the port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from stable_renderer_tpu_torch.engine.mesh import Mesh
from stable_renderer_tpu_torch.models.sampling.samplers import SAMPLER_NAMES
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


K1_BF16_TOL = 1e-2  # output rounding (2^-8 relative) + the bf16 softmax weights of both sides
# all-frames attention's outputs shrink like sqrt(e / keys): its error is also
# held to this share of the largest |plain output| (a few bf16 steps)
K1_FOLD_REL_TOL = 2e-2


@pytest.mark.parametrize("shape,dtype,tol", [
    ((16, 4096, 4096, 40), torch.bfloat16, 1e-2),   # UNet level-0 self-attention
    ((1, 4096, 4096, 512), torch.bfloat16, 1e-2),   # VAE mid-block attention
    ((4, 300, 2100, 40), torch.bfloat16, 1e-2),     # ragged q and K/V tiles
    ((2, 2049, 2049, 64), torch.bfloat16, 1e-2),
    ((3, 77, 2049, 80), torch.bfloat16, 1e-2),      # the mid wgmma route at d = 80
    ((8, 8192, 8192, 80), torch.bfloat16, 1e-2),    # all-frames level 1 (mid route)
    ((8, 2048, 2048, 160), torch.bfloat16, 1e-2),   # all-frames level 2 (mid route)
    ((2, 300, 2100, 256), torch.bfloat16, 1e-2),    # the mid route's widest, 32-row K/V tiles
    ((1, 300, 2100, 512), torch.bfloat16, 1e-2),    # ragged, split K/V
    ((4, 1, 2100, 40), torch.bfloat16, 1e-2),       # lq = 1
    ((2, 1, 2049, 512), torch.bfloat16, 1e-2),
    ((3, 200, 300, 20), torch.bfloat16, 1e-2),      # d not a multiple of 8: element loads
    ((2, 65, 129, 1), torch.bfloat16, 1e-2),
    ((2, 100, 150, 100), torch.bfloat16, 1e-2),
    ((3, 77, 2049, 80), torch.float32, 1e-4),
    ((2, 130, 333, 512), torch.float32, 1e-4),
    ((1, 4096, 4096, 512), torch.float32, 1e-4),    # the loaded f32 VAE's attention, split K/V
    ((1, 300, 2100, 160), torch.float32, 1e-4),     # ragged, d below the tiles' 512
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
    assert out.shape == q.shape and out.dtype == dtype
    ref = tfa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("shape", [(2, 130, 20, 40), (1, 70, 33, 512)])
def test_flash_attention_short_kv_matches_plain(cuda_device, shape):
    """K/V shorter than one 64-row tile. With 20-33 keys an output is the
    mean of a few values of v and reaches |out| ~ 2, where one bf16 step is
    0.0156; v is scaled by 1/4 so that the outputs stay below 1, where the
    1e-2 bar of the other cases (one or two bf16 steps) applies."""
    bh, lq, lk, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((bh, lq, d), generator=g, device=cuda_device).bfloat16()
    k = torch.randn((bh, lk, d), generator=g, device=cuda_device).bfloat16()
    v = (0.25 * torch.randn((bh, lk, d), generator=g, device=cuda_device)).bfloat16()
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_reference(q, k, v)
    assert ref.float().abs().max().item() < 1.0
    assert (out.float() - ref.float()).abs().max().item() < K1_BF16_TOL


def _plain_packed(q, k, v, heads):
    b, lq, hd = q.shape
    d = hd // heads
    qh, kh, vh = (t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
    return tfa.flash_attention_reference(qh, kh, vh).transpose(1, 2).reshape(b, lq, hd)


@pytest.mark.parametrize("b,l,heads,d", [(2, 4096, 8, 40), (1, 2100, 2, 64), (2, 2049, 3, 80),
                                         (1, 8192, 8, 80), (1, 2048, 8, 160)])
def test_attention_pallas_reads_fused_qkv_views(cuda_device, b, l, heads, d):
    """The UNet's q, k and v: column chunks of one (B, L, 3*H*D) product,
    read in place (no copy) and written as (B, L, H*D)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((b, l, 3 * heads * d), generator=g, device=cuda_device).bfloat16()
    q, k, v = qkv.chunk(3, dim=-1)
    assert not any(tfa.needs_copy(t.unflatten(-1, (heads, d)).shape,
                                  t.unflatten(-1, (heads, d)).stride(), t.data_ptr())
                   for t in (q, k, v))
    before = tfa.flash_attention.launches
    out = tfa.attention_pallas(q, k, v, heads)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert out.shape == (b, l, heads * d) and out.is_contiguous()
    err = (out.float() - _plain_packed(q, k, v, heads).float()).abs().max().item()
    assert err < K1_BF16_TOL


def test_attention_pallas_copies_an_unaligned_view(cuda_device):
    """Rows 321 elements apart cannot move by 16-byte copies: the wrapper
    makes the view contiguous and the kernel still runs."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    base = torch.randn((3, 2, 2100, 321), generator=g, device=cuda_device).bfloat16()
    q, k, v = base[..., 1:]
    qh = q.unflatten(-1, (8, 40))
    assert tfa.needs_copy(qh.shape, qh.stride(), qh.data_ptr())
    before = tfa.flash_attention.launches
    out = tfa.attention_pallas(q, k, v, 8)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert (out.float() - _plain_packed(q, k, v, 8).float()).abs().max().item() < K1_BF16_TOL


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, chip_smoke.K1_GRAD_BF16_TOL),
                                       (torch.float32, chip_smoke.K1_GRAD_F32_TOL)])
@pytest.mark.parametrize("b,l,heads,d", [(2, 4096, 8, 40), (1, 2100, 2, 64)])
def test_k1_gradient_on_the_card(cuda_device, dtype, tol, b, l, heads, d):
    """Under grad, attention_pallas on the fused-QKV views goes through
    FlashAttentionFn: one K1 launch (flash_wg in bf16, an f32 route in
    f32), and the q/k/v gradients within chip_smoke's phase 30 bar of
    autograd through the plain version in f32."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    qkv = torch.randn((b, l, 3 * heads * d), generator=g, device=cuda_device).to(dtype)
    qkv.requires_grad_(True)
    dout = torch.randn((b, l, heads * d), generator=g, device=cuda_device).to(dtype)
    before = tfa.flash_attention.launches
    (got,) = torch.autograd.grad(tfa.attention_pallas(*qkv.chunk(3, dim=-1), heads), qkv, dout)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    ref_in = qkv.detach().float().requires_grad_(True)
    q, k, v = (t.unflatten(-1, (heads, d)).transpose(1, 2) for t in ref_in.chunk(3, dim=-1))
    ref = tfa.flash_attention_reference(q, k, v).transpose(1, 2).reshape(b, l, heads * d)
    (want,) = torch.autograd.grad(ref, ref_in, dout.float())
    top = want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol * top
    with pytest.raises(RuntimeError, match="drop the gradient"):
        tfa._launch_bf16(*(t.unflatten(-1, (heads, d)) for t in qkv.chunk(3, dim=-1)))


# head dims for the tile variants: each runs at every one it takes (the
# small route's, the mid route's 80 and 160 and padded ones, the wide route's)
VARIANT_HEAD_DIMS = (40, 80, 100, 160, 200, 256, 512)


def test_flash_attention_tile_variants_match_plain(cuda_device):
    """Every compiled tile variant (scripts/sweep_torch_attention.py times
    them) at every head dim of VARIANT_HEAD_DIMS it takes, on ragged
    lengths."""
    from stable_renderer_tpu_torch.kernels import _build

    lib = _build.load_library()
    g = torch.Generator(device=cuda_device).manual_seed(4)
    i, runs = 0, 0
    while lib.sr_flash_attention_bf16_variant(i) is not None:
        name = lib.sr_flash_attention_bf16_variant(i).decode()
        dims = [d for d in VARIANT_HEAD_DIMS
                if lib.sr_flash_attention_bf16_scratch(2, 1100, 2100, d, i) >= 0]
        assert dims, name
        for d in dims:
            q = torch.randn((2, 1100, 1, d), generator=g, device=cuda_device).bfloat16()
            k = torch.randn((2, 2100, 1, d), generator=g, device=cuda_device).bfloat16()
            v = torch.randn((2, 2100, 1, d), generator=g, device=cuda_device).bfloat16()
            out = tfa._launch_bf16(q, k, v, variant=i).view(2, 1100, d)
            ref = tfa.flash_attention_reference(q[:, :, 0], k[:, :, 0], v[:, :, 0])
            err = (out.float() - ref.float()).abs().max().item()
            assert err < K1_BF16_TOL, (name, d, err)
            runs += 1
        i += 1
    assert i >= 12 and runs >= i


def test_entry_points_keep_f32_convs_f32(cuda_device):
    """Queue 3.1: with both TF32 switches at torch's card defaults (this
    file turns one off), a pipeline built by ``from_random`` in f32 decodes
    through its full-width VAE (3x3 convs of 128-512 channels in cuDNN) as
    f32: the decode against the same VAE on the CPU within 2e-4 of the
    largest |output|. The same decode with TF32 turned back on misses that
    bar, so the check can tell the two apart."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's default
    torch.backends.cudnn.allow_tf32 = True         # torch's default
    pipe = DiffusionPipeline.from_random(tiny=False, dtype=torch.float32, device=cuda_device)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert pipe.vae_params["decoder"]["conv_in"]["weight"].dtype == torch.float32
    g = torch.Generator(device=cuda_device).manual_seed(7)
    z = torch.randn((1, 16, 16, 4), generator=g, device=cuda_device)
    ref = pipe.vae.decode(chip_smoke._to_cpu(pipe.vae_params), z.cpu())
    bar = 2e-4 * ref.abs().max().item()
    err = (pipe.vae.decode(pipe.vae_params, z).cpu() - ref).abs().max().item()
    assert err <= bar, err
    torch.backends.cudnn.allow_tf32 = True
    try:
        err_tf32 = (pipe.vae.decode(pipe.vae_params, z).cpu() - ref).abs().max().item()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert err_tf32 > bar, err_tf32


def test_flash_attention_rejects_unsupported_inputs(cuda_device):
    q = torch.zeros((2, 8, 16), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros((2, 8, 520), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros((2, 8, 520), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 1, 40), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="variant"):
        tfa._launch_bf16(q, q, q, variant=99)


def _sphere(dev, h, w):
    mesh = Mesh.Sphere(1.0, 48)
    pos = torch.from_numpy(mesh.positions).to(dev)
    ones = torch.ones_like(pos[:, :1])
    mvp = (perspective(45.0, w / h, 0.1, 100.0) @ look_at([0.0, 0.5, 3.0], [0.0, 0.0, 0.0],
                                                           [0.0, 1.0, 0.0])).to(dev)
    return torch.cat([pos, ones], -1) @ mvp.T, torch.from_numpy(mesh.tris).to(dev)


@pytest.mark.parametrize("size", [(512, 512), (200, 136)])
def test_raster_kernel_matches_plain(cuda_device, size):
    """The bars of tests/test_raster_pallas.py:38-50."""
    h, w = size
    clip, tris = _sphere(cuda_device, h, w)
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


def _exact_against_references(clip, tris, h, w, cull):
    """The setup kernel equals triangle_setup and tile_ranges, and the whole
    call equals rasterize_tiles_reference over those constants: bit for bit.
    Returns the kernel's buffer."""
    tri_data = trk.triangle_setup(clip, tris, h, w, cull)
    k_data, k_ranges = trk.triangle_setup_kernel(clip, tris, h, w, cull)
    out = trk.rasterize_kernel(clip, tris, h, w, cull_backface=cull)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(k_data, tri_data)
    assert torch.equal(k_ranges, trk.tile_ranges(tri_data, h, w))
    ref = trk.rasterize_tiles_reference(tri_data, h, w)
    for name, a, b in zip(out._fields, out, ref):
        assert chip_smoke.same_bits(a, b), name
    return out


@pytest.mark.parametrize("size", [(512, 512), (200, 136)])
def test_raster_kernel_equals_tiles_reference(cuda_device, size):
    h, w = size
    clip, tris = _sphere(cuda_device, h, w)
    out = _exact_against_references(clip, tris, h, w, True)
    assert (out.tri_id >= 0).any()


@pytest.mark.parametrize("size", [(512, 512), (200, 136)])
@pytest.mark.parametrize("cull,tris_dtype", [(False, torch.int32), (True, torch.int64)])
def test_raster_kernel_soup_equals_tiles_reference(cuda_device, size, cull, tris_dtype):
    """chip_smoke.raster_soup: full-screen triangles, 10,000 tiny triangles
    inside one tile, coplanar ties (the lowest index wins), all sizes and
    windings, triangles behind the camera and degenerate ones."""
    h, w = size
    clip, tris = chip_smoke.raster_soup(h, w)
    clip = torch.from_numpy(clip).to(cuda_device)
    tris = torch.from_numpy(tris).to(cuda_device, tris_dtype)
    out = _exact_against_references(clip, tris, h, w, cull)
    ids = set(out.tri_id.unique().tolist())
    assert 2 in ids and 3 not in ids  # the coplanar pair: its first copy wins every tie
    assert any(5 <= i < 10_005 for i in ids)  # tiny triangles drawn


@pytest.mark.parametrize("case", ["no triangles", "all culled"])
def test_raster_kernel_draws_nothing(cuda_device, case):
    """T = 0, and a mesh whose every triangle faces away with culling on."""
    import numpy as np

    h, w = 200, 136
    clip, tris = chip_smoke.raster_soup(h, w, tiny=100)
    if case == "no triangles":
        tris = tris[:0]
    else:  # keep the clearly non-degenerate triangles in front, wound to face away
        xy = clip[:, :2] / clip[:, 3:]
        p = xy[tris]  # (T, 3, 2), NDC (y up): CCW, positive area, faces the camera
        area = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
                - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
        keep = (np.abs(area) * h * w / 4 > 1.0) & (clip[tris, 3] > 0.1).all(1)
        tris = np.where((area > 0)[:, None], tris[:, ::-1], tris)[keep]
        assert len(tris) > 200
    clip = torch.from_numpy(clip).to(cuda_device)
    tris = torch.from_numpy(np.ascontiguousarray(tris)).to(cuda_device)
    out = _exact_against_references(clip, tris, h, w, True)
    empty = tr.VisibilityBuffer.empty(h, w, device=cuda_device)
    for a, b in zip(out, empty):
        assert chip_smoke.same_bits(a, b)


def test_raster_kernel_launches_two_kernels_and_replays_in_a_graph(cuda_device):
    """One call is the setup kernel and the binned tile kernel, nothing else;
    captured in a CUDA graph, it replays on new vertex positions."""
    h = w = 512
    clip, tris = _sphere(cuda_device, h, w)
    names = chip_smoke.device_kernels(lambda: trk.rasterize_kernel(clip, tris, h, w, True))
    assert len(names) == 2 and "raster_setup" in names[0] and "raster_binned" in names[1], names
    static_clip = clip.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trk.rasterize_kernel(static_clip, tris, h, w, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trk.rasterize_kernel(static_clip, tris, h, w, True)
    turned = clip * torch.tensor([0.8, 1.1, 1.0, 1.0], device=cuda_device)  # squeezed in x
    static_clip.copy_(turned)
    graph.replay()
    torch.cuda.synchronize()
    ref = trk.rasterize_kernel(turned, tris, h, w, True)
    for a, b in zip(out, ref):
        assert chip_smoke.same_bits(a, b)


# --- K3: the fused 3x3 conv ---------------------------------------------------

BF16_RTOL = 2.0 ** -7  # one bf16 step of the output: both round the same f32 sum once


def _conv_case(dev, n, h, w, cin, cout, *, int8=False, pre=False, x_dtype=torch.bfloat16,
               seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=g, device=dev).to(x_dtype)
    wf = torch.randn((3, 3, cin, cout), generator=g, device=dev) / (3.0 * cin ** 0.5)
    b = torch.randn((cout,), generator=g, device=dev).to(torch.bfloat16)
    kw = {}
    if pre:
        kw.update(pre_scale=torch.rand((n, cin), generator=g, device=dev) + 0.5,
                  pre_shift=torch.randn((n, cin), generator=g, device=dev) * 0.5, pre_act="silu")
    if int8:
        ws = wf.abs().amax((0, 1, 2)) / 127.0
        w_k = torch.clamp(torch.round(wf / ws), -127, 127).to(torch.int8)
        kw.update(a_scale=(x.float().abs().amax() / 127.0).reshape(()), w_scale=ws)
    else:
        w_k = wf.to(torch.bfloat16)
    return x, w_k, b, kw


def _check_conv(x, w_k, b, kw, act=None, out_dtype=None):
    from stable_renderer_tpu_torch.ops import conv_kernel as tck

    before = tck.conv3x3_kernel.launches
    out = tck.conv3x3_kernel(x, w_k, b, act=act, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert tck.conv3x3_kernel.launches == before + 1
    ref = tck.conv3x3_kernel_reference(x, w_k, b, act=act, out_dtype=out_dtype, **kw)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    return (out.float() - ref.float()).abs(), ref.float().abs()


# the shape classes of the frame (chip_smoke.py), and ragged edges: H and W
# not multiples of the tile, Cout not a multiple of the N tile, Cin not a
# multiple of a 128-byte K chunk
K3_BF16_SHAPES = sorted({k[:5] for k in chip_smoke.K3_SWITCHED_FRAME_SHAPES}) + [
    (1, 16, 24, 136, 72), (1, 10, 13, 128, 128), (2, 32, 32, 1920, 640), (1, 10, 13, 128, 136)]
# int8 with f32 input or output too (the f32 epilogue is a path of its own)
K3_INT8_TYPE_SHAPES = [(2, 64, 64, 960, 320), (2, 32, 32, 640, 640), (1, 96, 80, 128, 128),
                       (1, 9, 11, 200, 56)]
K3_INT8_SHAPES = [s for s in sorted(chip_smoke.K3_INT8_FRAME_SHAPES)
                  if s not in K3_INT8_TYPE_SHAPES] + [
    (1, 33, 47, 8, 8), (1, 10, 13, 128, 136), (1, 16, 24, 136, 72)]


@pytest.mark.parametrize("shape", K3_BF16_SHAPES)
@pytest.mark.parametrize("pre,act", [(False, None), (False, "silu"), (True, None)])
def test_conv3x3_bf16_matches_plain(cuda_device, shape, pre, act):
    """Float mode: f32 sums of bf16 products in another order, one bf16
    rounding of the output: within one bf16 step (+1e-3 near zero)."""
    torch.backends.cudnn.allow_tf32 = False
    x, w_k, b, kw = _conv_case(cuda_device, *shape, pre=pre)
    err, mag = _check_conv(x, w_k, b, kw, act=act)
    assert (err <= BF16_RTOL * mag + 1e-3).all(), err.max().item()


@pytest.mark.parametrize("shape", K3_INT8_TYPE_SHAPES)
@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, None),
                                               (torch.float32, None),
                                               (torch.bfloat16, torch.float32)])
def test_conv3x3_int8_matches_plain_exactly(cuda_device, shape, x_dtype, out_dtype):
    """Int8 mode without the prologue: the same quantized values, exact int32
    sums and the same f32 dequantization: bit for bit."""
    x, w_k, b, kw = _conv_case(cuda_device, *shape, int8=True, x_dtype=x_dtype)
    err, _ = _check_conv(x, w_k, b, kw, out_dtype=out_dtype)
    assert err.max().item() == 0.0


@pytest.mark.parametrize("shape", K3_INT8_SHAPES)
def test_conv3x3_int8_frame_shapes_match_plain_exactly(cuda_device, shape):
    """Int8 mode at the frame's other int8 shape classes and at ragged ones:
    bit for bit."""
    x, w_k, b, kw = _conv_case(cuda_device, *shape, int8=True)
    err, _ = _check_conv(x, w_k, b, kw)
    assert err.max().item() == 0.0


@pytest.mark.parametrize("shape,int8,out_dtype", [
    ((1, 33, 47, 136, 72), True, None), ((1, 33, 47, 136, 72), True, torch.float32),
    ((1, 33, 47, 136, 72), False, None), ((1, 33, 47, 136, 72), False, torch.float32),
    ((2, 20, 36, 64, 320), True, None), ((2, 20, 36, 64, 320), True, torch.float32),
    ((2, 20, 36, 64, 320), False, None), ((2, 20, 36, 64, 320), False, torch.float32),
    ((1, 512, 512, 128, 128), True, None)])
def test_conv3x3_every_tile_shape_matches_plain(cuda_device, shape, int8, out_dtype):
    """Every launch the tile picker can choose from (each compiled tile
    shape), not only the one it picks, at ragged shapes, with the bf16 and
    the f32 epilogue (int8 with f32 output takes f32 input, as the int8
    layers do): int8 exact, bf16 within one bf16 step."""
    from stable_renderer_tpu_torch.ops import conv_kernel as tck

    x_dtype = torch.float32 if int8 and out_dtype == torch.float32 else torch.bfloat16
    x, w_k, b, kw = _conv_case(cuda_device, *shape, int8=int8, x_dtype=x_dtype)
    kw["out_dtype"] = out_dtype
    ref = tck.conv3x3_kernel_reference(x, w_k, b, **kw).float()
    cands = tck.tile_candidates(*shape, int8)
    assert len(cands) == len(tck.TILE_CONFIGS)
    for t in cands:
        out = tck._launch(x, w_k, b, tiles=t, **kw)
        torch.cuda.synchronize()
        assert out.dtype == (out_dtype or x.dtype)
        err = (out.float() - ref).abs()
        if int8:
            assert err.max().item() == 0.0, t
        else:
            assert (err <= BF16_RTOL * ref.abs() + 1e-3).all(), (t, err.max().item())


def test_conv3x3_rejects_a_tile_shape_it_was_not_built_for(cuda_device):
    """A launch outside the compiled table raises; nothing falls back."""
    from stable_renderer_tpu_torch.ops import conv_kernel as tck

    x, w_k, b, kw = _conv_case(cuda_device, 1, 16, 16, 64, 64)
    t = tck.conv_tiles(1, 16, 16, 64, 64, False)._replace(bn=96)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tck._launch(x, w_k, b, tiles=t, **kw)


def test_conv3x3_int8_silu_and_prologue(cuda_device):
    """The SiLU epilogue's exp may differ in the last f32 bit (one bf16 step
    at most after the cast); with the prologue an input within an ulp of a .5
    quantization boundary may round to the neighbouring int8 value, which
    moves an output by a_scale * w_scale * |w_q| <= a_scale * max(w_scale) *
    127 per such input."""
    x, w_k, b, kw = _conv_case(cuda_device, 2, 32, 32, 640, 640, int8=True)
    err, mag = _check_conv(x, w_k, b, kw, act="silu")
    assert (err <= BF16_RTOL * mag).all(), err.max().item()
    x, w_k, b, kw = _conv_case(cuda_device, 1, 64, 64, 512, 512, int8=True, pre=True)
    err, mag = _check_conv(x, w_k, b, kw)
    step = (kw["a_scale"] * kw["w_scale"].max() * 127).item()
    assert (err <= BF16_RTOL * mag + 2 * step).all(), (err.max().item(), step)
    assert (err > BF16_RTOL * mag).float().mean().item() < 1e-3


def test_int8_convs_route_to_k3_on_the_card(cuda_device):
    """On a CUDA tensor an int8 3x3 conv that passes the gate takes K3 with
    the switch off; a stride-2 or 1x1 int8 conv takes conv2d_q (_int_mm),
    which is exact against the CPU's int32 sums."""
    from stable_renderer_tpu_torch.models import layers as tl
    from stable_renderer_tpu_torch.models import quant as tq
    from stable_renderer_tpu_torch.ops import conv_kernel as tck

    assert not tl._conv_pallas_on
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 32, 32, 320), generator=g, device=cuda_device).to(torch.bfloat16)
    for k, stride, pad, routed in ((3, 1, 1, True), (3, 2, 1, False), (1, 1, 0, False),
                                   (3, 2, 0, False)):
        p = tq.quantize_conv_params(
            {"weight": torch.randn((320, 320, k, k), generator=g, device=cuda_device) * 0.02,
             "bias": torch.zeros(320, device=cuda_device, dtype=torch.bfloat16)},
            a_scale=x.float().abs().amax().item())
        before = tck.conv3x3_kernel.launches
        out = tl.conv2d(p, x, stride=stride, padding=pad)
        torch.cuda.synchronize()
        assert tck.conv3x3_kernel.launches == before + int(routed)
        q = torch.clamp(torch.round(x.float() / p["a_scale"]), -127, 127).to(torch.int8)
        acc = tq.int_conv(q, p["weight_q"], stride=stride, padding=pad)
        ref = tq.int_conv(q.cpu(), p["weight_q"].cpu(), stride=stride, padding=pad)
        assert torch.equal(acc.cpu(), ref)
        assert torch.isfinite(out.float()).all()


# --- K4: the fused GroupNorm ----------------------------------------------------


def _gn_inputs(dev, shape, dtype, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.3).to(dtype)
    w = torch.randn((shape[2],), generator=g, device=dev).to(dtype)
    b = torch.randn((shape[2],), generator=g, device=dev).to(dtype)
    return x, w, b


@pytest.mark.parametrize("shape,groups,dtype", [((2, 1024, 640), 32, torch.bfloat16),
                                               ((2, 256, 1920), 32, torch.bfloat16),
                                               ((1, 4096, 512), 32, torch.bfloat16),
                                               ((1, 17, 256), 32, torch.float32),
                                               ((3, 8, 128), 4, torch.float32),
                                               ((1, 16384, 128), 32, torch.bfloat16),
                                               ((1, 65536, 32), 32, torch.bfloat16),
                                               ((1, 8, 32768), 32, torch.bfloat16)])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_kernel_matches_plain(cuda_device, shape, groups, dtype, act):
    """Statistics summed in another order (f32), then one rounding to the
    output type: within one bf16 step in bf16, 1e-5 in f32. (1, 65536, 32)
    keeps x out of registers and reads it twice; (1, 8, 32768) has the
    widest slice the kernel takes."""
    from stable_renderer_tpu_torch.ops import group_norm_kernel as tgn

    x, w, b = _gn_inputs(cuda_device, shape, dtype)
    before = tgn.group_norm_kernel.launches
    out = tgn.group_norm_kernel(x, w, b, groups=groups, act=act)
    torch.cuda.synchronize()
    assert tgn.group_norm_kernel.launches == before + 1
    ref = tgn.group_norm_kernel_reference(x, w, b, groups=groups, act=act)
    err = (out.float() - ref.float()).abs()
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
    assert (err <= rtol * ref.float().abs() + 1e-5).all(), err.max().item()


K4_CLASSES = sorted(chip_smoke.K4_SWITCHED_FRAME_SHAPES, key=str)


@pytest.mark.parametrize("key", K4_CLASSES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_frame_classes(cuda_device, key, dtype):
    """Every K4 shape class of the switched frame, with its activation and the
    other one, bf16 (the frame's type) and f32 input: the card holds its
    cluster (cudaOccupancyMaxActiveClusters), and the bars above hold."""
    from stable_renderer_tpu_torch.ops import group_norm_kernel as tgn

    n, s, c, act = key
    geo = tgn.gn_geometry(n, s, c, 32, 2 if dtype == torch.bfloat16 else 4)
    assert tgn.max_active_clusters(n, s, c, 32, geo, dtype == torch.float32) >= 1
    x, w, b = _gn_inputs(cuda_device, (n, s, c), dtype)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
    for a in (act, "silu" if act is None else None):
        out = tgn.group_norm_kernel(x, w, b, groups=32, act=a)
        torch.cuda.synchronize()
        ref = tgn.group_norm_kernel_reference(x, w, b, groups=32, act=a)
        err = (out.float() - ref.float()).abs()
        assert (err <= rtol * ref.float().abs() + 1e-5).all(), (a, err.max().item())


@pytest.mark.parametrize("shape", chip_smoke.K4_TIMED_SHAPES)
def test_group_norm_kernel_one_deterministic_launch(cuda_device, shape):
    """One kernel a call; two calls give the same bits; a CUDA graph of the
    call replays on new input to the same bits as an eager call."""
    from stable_renderer_tpu_torch.ops import group_norm_kernel as tgn

    x, w, b = _gn_inputs(cuda_device, shape, torch.bfloat16)
    call = lambda: tgn.group_norm_kernel(x, w, b, groups=32, act="silu")  # noqa: E731
    names = chip_smoke.device_kernels(call)
    assert len(names) == 1 and "gn_cluster" in names[0], names
    first, second = call(), call()
    assert chip_smoke.same_bits(first.view(torch.int16), second.view(torch.int16))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    x2, _, _ = _gn_inputs(cuda_device, shape, torch.bfloat16, seed=2)
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    eager = tgn.group_norm_kernel(x2, w, b, groups=32, act="silu")
    assert chip_smoke.same_bits(out.view(torch.int16), eager.view(torch.int16))


# --- the engine's present pipeline ----------------------------------------------


@pytest.mark.parametrize("depth", ["1", "2"])
def test_engine_presents_pinned_readbacks_in_order(cuda_device, monkeypatch, depth):
    """Engine.Run on the card (raster only, K2, a light): every frame is
    presented once, in order, equal to its device display, through a ring of
    at most SR_PRESENT_DEPTH + 1 pinned host buffers that are reused."""
    from stable_renderer_tpu_torch import engine as P
    from stable_renderer_tpu_torch.engine.managers import RenderManager

    monkeypatch.setenv("SR_PRESENT_DEPTH", depth)
    displays, buffers = {}, set()
    start = RenderManager._start_readback

    def spy(self, display, frame_index):
        entry = start(self, display, frame_index)
        displays[frame_index] = display.clone()
        assert entry[1].is_pinned() and entry[0] is display
        buffers.add(entry[1].data_ptr())
        return entry

    monkeypatch.setattr(RenderManager, "_start_readback", spy)
    presented = []

    class App(P.Engine):
        def beforePrepare(self):
            cam = P.GameObject("cam")
            cam.addComponent(P.Camera)
            cam.transform.position = [0.0, 0.5, 3.0]
            cam.transform.lookAt([0.0, 0.0, 0.0])
            box = P.GameObject("box")
            box.addComponent(P.MeshRenderer, mesh=Mesh.Cube(1.0))
            box.addComponent(P.AutoRotation, speed_deg=20.0)
            lamp = P.GameObject("lamp")  # lit faces change as the box turns
            lamp.transform.position = [2.0, 2.0, 2.0]
            lamp.transform.lookAt([0.0, 0.0, 0.0])
            lamp.addComponent(P.DirectionalLight)

    P.Engine._reset()
    try:
        eng = App.Run(winSize=(256, 256), disableComfyUI=True, max_frames=7, debug=True,
                      frame_callback=lambda f, i: presented.append((i, f)))
    finally:
        P.Engine._reset()
    assert eng.device.type == "cuda"
    assert [i for i, _ in presented] == list(range(7))
    for i, frame in presented:
        assert frame.dtype.name == "uint8" and frame.shape == (256, 256, 4)
        assert (torch.from_numpy(frame) == displays[i].cpu()).all(), i
    assert len(buffers) <= int(depth) + 1
    assert not (torch.from_numpy(presented[0][1]) == torch.from_numpy(presented[1][1])).all()


def test_host_sync_counter_matches_host_syncs(cuda_device):
    """The tracer's host-sync count for one sequential engine frame, recorded
    by a profiler, equals chip_smoke.host_syncs' count for that frame (a run
    of one frame more, less a run of one frame fewer) plus the present's
    event wait, which the debug mode does not see; the trace marks each."""
    from torch.profiler import ProfilerActivity, profile

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.utils.timer import SYNC_MARK

    pipe = DiffusionPipeline.from_random(tiny=True, device=cuda_device)
    corr = OverlapCorresponder(vertex_segments=4096, update_corrmap=False)
    frame = 3  # the present pipeline (depth 2) is full: the frame waits for frame 1's copy
    chip_smoke.run_engine(pipe, 64, frame + 1, corr)  # every cache warm

    def syncs(frames: int) -> int:
        return sum(chip_smoke.host_syncs(
            lambda: chip_smoke.run_engine(pipe, 64, frames, corr)).values())

    want = syncs(frame + 1) - syncs(frame)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_frame(eng, when):
        if when == "begin" and eng.RuntimeManager.FrameCount == frame:
            prof.start()

    eng, _ = chip_smoke.run_engine(pipe, 64, frame + 1, corr, on_frame=on_frame)
    prof.stop()
    counted = eng.RenderManager.timer.host_syncs
    assert want > 0 and counted["present_wait"] == 1
    assert sum(counted.values()) == want + 1, dict(counted)
    assert sum(1 for e in prof.events() if e.name == SYNC_MARK) == want + 1


@pytest.mark.parametrize("n,l,heads,d", [(4, 1024, 8, 40), (3, 1024, 8, 80), (16, 256, 8, 160)])
def test_cross_frame_attention_folds_into_k1(cuda_device, n, l, heads, d):
    """All-frames attention on the card: the batch folds into the query
    sequence and the fused-QKV chunk views go to K1 in one launch, against
    the dense plain version at the K1 bf16 bar and within K1_FOLD_REL_TOL
    of the largest |plain output|."""
    from stable_renderer_tpu_torch.parallel import ring_attention as pra

    g = torch.Generator(device=cuda_device).manual_seed(4)
    qkv = torch.randn((n, l, 3 * heads * d), generator=g, device=cuda_device).bfloat16()
    q, k, v = qkv.chunk(3, dim=-1)
    before = tfa.flash_attention.launches
    out = pra.cross_frame_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert out.shape == (n, l, heads * d)
    ref = pra.cross_frame_attention_reference(q, k, v, heads).float()
    err = (out.float() - ref).abs().max().item()
    assert err < K1_BF16_TOL
    assert err <= K1_FOLD_REL_TOL * ref.abs().max().item()


@pytest.mark.parametrize("fn", ["average", "weighted", "frame_distance"])
def test_segment_means_repeat_exactly(cuda_device, fn):
    """The group means on the card give the same bits on every call
    (``segment_add_``; ``index_add_``'s atomics did not): 2 x 512 x 512 rows
    into 4096 segments, as a bench frame's ids, ten calls."""
    from stable_renderer_tpu_torch.ops import math as tmath

    g = torch.Generator(device=cuda_device).manual_seed(5)
    n = 2 * 512 * 512
    vals = torch.randn((n, 4), generator=g, device=cuda_device)
    ids = torch.randint(-1, 4096, (n,), generator=g, device=cuda_device, dtype=torch.int32)
    frames = torch.randint(0, 2, (n,), generator=g, device=cuda_device)
    w = torch.rand((n,), generator=g, device=cuda_device)
    call = {"average": lambda: tmath.group_average_by_id(vals, ids, 4096)[1],
            "weighted": lambda: tmath.group_weighted_average_by_id(vals, ids, w, 4096),
            "frame_distance": lambda: tmath.group_frame_distance_average(vals, ids, frames,
                                                                         4096, 2)}[fn]
    first = call()
    assert all(torch.equal(call(), first) for _ in range(9))


def _tiny_denoisers(device):
    """The tiny f32 UNet's CFG denoiser on the CPU and on ``device``, with
    one param tree (the port's init on the CPU, seeded) and one pair of
    contexts. f32 stays f32 on the card, as the entry points keep it: cuDNN's
    default TF32 convolutions move the tiny run by ~1e-2."""
    from stable_renderer_tpu_torch.device import keep_f32
    from stable_renderer_tpu_torch.models.sampling.cfg import make_denoiser
    from stable_renderer_tpu_torch.models.sampling.schedules import ModelSampling
    from stable_renderer_tpu_torch.models.unet import TINY_UNET_CONFIG, UNetModel

    unet = UNetModel(TINY_UNET_CONFIG)
    g = torch.Generator().manual_seed(21)
    params = unet.init(g)
    ctx, unc = (torch.randn((1, 77, TINY_UNET_CONFIG.context_dim), generator=g)
                for _ in range(2))
    log_sigmas = torch.as_tensor(ModelSampling().log_sigmas)
    keep_f32()

    def on(dev):
        return make_denoiser(unet, _tree_to(params, dev), ctx.to(dev), unc.to(dev), log_sigmas,
                             cfg_scale=2.0)

    return on("cpu"), on(device)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("sampler", SAMPLER_NAMES)
def test_samplers_on_the_card_match_the_cpu(cuda_device, sampler):
    """Each sampler, 4 karras steps over the tiny f32 UNet, the same draws
    (per-step gaussians, or Brownian increments from one CPU bridge) handed
    to both devices: within chip_smoke.SAMPLER_TOL."""
    import math

    from stable_renderer_tpu_torch.models.sampling import samplers as smp
    from stable_renderer_tpu_torch.models.sampling.schedules import (
        ModelSampling,
        calculate_sigmas,
    )

    den_cpu, den_card = _tiny_denoisers(cuda_device)
    sig = torch.as_tensor(calculate_sigmas(ModelSampling(), "karras", 4))
    s = [float(v) for v in sig]
    g = torch.Generator().manual_seed(3)
    lat = (1, 16, 16, 4)
    noise, latent = torch.randn(lat, generator=g), torch.randn(lat, generator=g)
    bridge = smp.BrownianBridge(7, s[-2], s[0], lat)
    draws = []
    for i in range(4):
        if sampler.endswith("sde"):
            mid = math.exp(0.5 * (math.log(s[i]) + math.log(max(s[i + 1], 1e-10))))
            draws.append((bridge.increment(s[i], mid if sampler == "dpmpp_sde" else s[i + 1]),
                          bridge.increment(s[i], s[i + 1])))
        else:
            draws.append((torch.randn(lat, generator=g), torch.randn(lat, generator=g)))
    ref = smp.sample(den_cpu, noise, sig, latent, sampler=sampler, step_noise=draws)
    out = smp.sample(den_card, noise.to(cuda_device), sig, latent.to(cuda_device),
                     sampler=sampler, step_noise=[tuple(t.to(cuda_device) for t in d)
                                                  for d in draws])
    assert out.device.type == "cuda" and torch.isfinite(out).all()
    assert (out.cpu() - ref).abs().max().item() <= chip_smoke.SAMPLER_TOL


def test_brownian_bridge_on_the_card(cuda_device):
    """The bridge drawn on the card: one interval twice gives the same bits,
    adjacent increments add up, unit variance."""
    import math

    from stable_renderer_tpu_torch.models.sampling.samplers import BrownianBridge

    shape = (1, 64, 64, 4)
    br = BrownianBridge(1234, 0.03, 14.6, shape, device=cuda_device)
    a, b, c = 14.6, 5.0, 0.7
    inc = br.increment(a, b)
    assert inc.device.type == "cuda"
    assert torch.equal(inc, BrownianBridge(1234, 0.03, 14.6, shape,
                                           device=cuda_device).increment(a, b))
    whole = br.increment(a, c) * math.sqrt(a - c)
    parts = inc * math.sqrt(a - b) + br.increment(b, c) * math.sqrt(b - c)
    assert (whole - parts).abs().max().item() < 1e-4
    assert abs(inc.std().item() - 1.0) < 0.05 and abs(inc.mean().item()) < 0.05


def test_user_shaders_on_the_card(cuda_device):
    """The draw pass with identity vertex and fragment shaders equals the
    fixed pipeline bit for bit on the card, K2 rasterizing after the user
    vertex stage; the debug shader's color matches the CPU's."""
    from stable_renderer_tpu_torch.data.framebuffers import GBuffer
    from stable_renderer_tpu_torch.engine.render_exec import _draw_pass, mesh_device_buffers
    from stable_renderer_tpu_torch.engine.shader import Shader
    from stable_renderer_tpu_torch.ops.gbuffer import DrawUniforms

    mv, proj = chip_smoke.bench_matrices(0)

    def draw(dev, vertex_fn=None, fragment_fn=None):
        bufs = mesh_device_buffers(Mesh.Sphere(1.0, 48), dev)
        gbuf, _ = _draw_pass(GBuffer.empty(512, 512, device=dev),
                             torch.ones((512, 512), device=dev), bufs,
                             torch.from_numpy(mv).to(dev), torch.from_numpy(proj).to(dev),
                             DrawUniforms(sprite_id=1), 512, 512, fragment_fn=fragment_fn,
                             vertex_fn=vertex_fn)
        return gbuf

    ident = Shader("card_identity", fragment_fn=lambda f, u: f.color,
                   vertex_fn=lambda p, n, m, pr: tr.vertex_stage(p, n, m, pr))
    fixed = draw(cuda_device)
    before = trk.rasterize_kernel.launches
    same = draw(cuda_device, ident.vertex_fn, ident.bound_fragment())
    assert trk.rasterize_kernel.launches == before + 1
    for a, b in zip(same, fixed):
        assert chip_smoke.same_bits(a, b)
    debug = Shader.DefaultDebug().bound_fragment()
    on_card = draw(cuda_device, None, debug).color
    assert (on_card - fixed.color).abs().mean().item() > 1e-3
    covered = fixed.id[..., 0] > 0
    on_cpu = draw("cpu", None, debug).color
    agree = (on_card.cpu() - on_cpu).abs().amax(-1) < 1e-4
    assert agree[covered.cpu()].float().mean().item() > 0.99  # edge pixels may flip
