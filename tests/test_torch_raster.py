"""K2, the tile rasterizer, and the raster / G-buffer chain around it: the port
(ops/raster.py, ops/raster_kernel.py, ops/gbuffer.py, ops/postprocess.py,
ops/transforms.py) against the JAX package on the same inputs. The JAX Pallas
kernel runs in interpret mode, as tests/test_raster_pallas.py runs it; the
CUDA kernel is compared with the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_renderer_tpu.ops.raster_pallas as jrp
from stable_renderer_tpu.engine.mesh import Mesh as JMesh
from stable_renderer_tpu.ops import gbuffer as jg
from stable_renderer_tpu.ops import postprocess as jpost
from stable_renderer_tpu.ops import raster as jr
from stable_renderer_tpu.ops import transforms as jt
from stable_renderer_tpu_torch.engine.mesh import Mesh
from stable_renderer_tpu_torch.ops import gbuffer as tg
from stable_renderer_tpu_torch.ops import postprocess as tpost
from stable_renderer_tpu_torch.ops import raster as tr
from stable_renderer_tpu_torch.ops import raster_kernel as trk
from stable_renderer_tpu_torch.ops import transforms as tt

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = jrp.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jrp.pl, "pallas_call", patched)


def _scene(segments=12):
    """Sphere seen by the bench camera; the same float32 clip positions feed
    both packages."""
    mesh = JMesh.Sphere(1.0, segments)
    view = jt.look_at(jnp.asarray([0.0, 0.5, 3.0]), jnp.zeros(3), jnp.asarray([0.0, 1.0, 0.0]))
    proj = jt.perspective(45.0, 1.0, 0.1, 100.0)
    clip, vpos, vnrm = jr.vertex_stage(jnp.asarray(mesh.positions), jnp.asarray(mesh.normals),
                                       view, proj)
    return mesh, *(np.array(a) for a in (view, proj, clip, vpos, vnrm))


def _agree(out, ref):
    """The same triangle at every pixel; z within 1e-4 and barycentrics
    within 2e-4 at every pixel (measured on these scenes: z within 1.2e-5,
    bary within 9.3e-6)."""
    np.testing.assert_array_equal(np.asarray(out.tri_id), np.asarray(ref.tri_id))
    np.testing.assert_allclose(np.asarray(out.z), np.asarray(ref.z), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(out.bary), np.asarray(ref.bary), atol=2e-4, rtol=0)
    covered = np.asarray(out.tri_id) >= 0
    assert covered.any()
    np.testing.assert_allclose(np.asarray(out.bary)[covered].sum(-1), 1.0, atol=1e-4)


def test_transforms_match_jax():
    np.testing.assert_allclose(
        tt.look_at([0.0, 0.5, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]).numpy(),
        np.asarray(jt.look_at(jnp.asarray([0.0, 0.5, 3.0]), jnp.zeros(3),
                              jnp.asarray([0.0, 1.0, 0.0]))), **TOL)
    np.testing.assert_allclose(tt.perspective(45.0, 1.0, 0.1, 100.0).numpy(),
                               np.asarray(jt.perspective(45.0, 1.0, 0.1, 100.0)), **TOL)
    q = tt.quat_from_euler([10.0, 20.0, 30.0])
    np.testing.assert_allclose(q.numpy(), np.asarray(jt.quat_from_euler(jnp.asarray([10.0, 20.0, 30.0]))), **TOL)
    np.testing.assert_allclose(tt.trs([1.0, 2.0, 3.0], q, [2.0, 2.0, 2.0]).numpy(),
                               np.asarray(jt.trs(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray(q.numpy()),
                                                 jnp.asarray([2.0, 2.0, 2.0]))), **TOL)
    np.testing.assert_allclose(tt.orthographic(2.0, 1.5, 0.1, 50.0).numpy(),
                               np.asarray(jt.orthographic(2.0, 1.5, 0.1, 50.0)), **TOL)
    rng = np.random.default_rng(0)
    q2 = rng.standard_normal(4).astype(np.float32)
    pts = rng.standard_normal((5, 3)).astype(np.float32)
    m = tt.trs([0.5, -1.0, 2.0], q, [1.0, 2.0, 0.5]).numpy()
    m[3] = [0.01, 0.02, -0.03, 1.0]  # a projective row, so transform_points divides by w
    for name, args in (("quat_mul", (q.numpy(), q2)), ("quat_rotate", (q.numpy(), pts)),
                       ("normal_matrix", (m,)), ("transform_points", (m, pts)),
                       ("transform_dirs", (m, pts))):
        np.testing.assert_allclose(
            getattr(tt, name)(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy(),
            np.asarray(getattr(jt, name)(*(jnp.asarray(a) for a in args))), err_msg=name, **TOL)


def test_vertex_stage_matches_jax():
    mesh, view, proj, clip, vpos, vnrm = _scene()
    c, p, n = tr.vertex_stage(torch.from_numpy(mesh.positions), torch.from_numpy(mesh.normals),
                              torch.from_numpy(view), torch.from_numpy(proj))
    for a, b in ((c, clip), (p, vpos), (n, vnrm)):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


@pytest.mark.parametrize("cull", [False, True])
def test_triangle_setup_matches_jax(cull):
    mesh, _, _, clip, _, _ = _scene()
    ref = jrp.triangle_setup(jnp.asarray(clip), jnp.asarray(mesh.tris), 64, 64, cull_backface=cull)
    out = trk.triangle_setup(torch.from_numpy(clip), torch.from_numpy(mesh.tris), 64, 64,
                             cull_backface=cull)
    assert out.shape == (mesh.tris.shape[0], trk.N_COLS)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cull", [False, True])
def test_plain_matches_jax_rasterize(cull):
    """The plain version is a port of the XLA rasterizer: exact ids."""
    mesh, _, _, clip, _, _ = _scene()
    ref = jr.rasterize(jnp.asarray(clip), jnp.asarray(mesh.tris), 64, 64, cull_backface=cull)
    out = tr.rasterize(torch.from_numpy(clip), torch.from_numpy(mesh.tris), 64, 64,
                       cull_backface=cull)
    np.testing.assert_array_equal(out.tri_id.numpy(), np.asarray(ref.tri_id))
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **TOL)
    np.testing.assert_allclose(out.bary.numpy(), np.asarray(ref.bary), **TOL)


@pytest.mark.parametrize("cull", [False, True])
def test_plain_matches_jax_pallas_kernel(interpret_mode, cull):
    mesh, _, _, clip, _, _ = _scene()
    ref = jrp.rasterize_pallas(jnp.asarray(clip), jnp.asarray(mesh.tris), 64, 64, tile=32,
                               cull_backface=cull)
    out = trk.rasterize_kernel(torch.from_numpy(clip), torch.from_numpy(mesh.tris), 64, 64,
                               cull_backface=cull)
    _agree(out, ref)
    assert trk.rasterize_kernel.launches == 0  # CPU tensors take the plain version


def test_behind_camera_culled():
    clip = torch.tensor([[-4, -4, 0, -1.0], [4, -4, 0, 1.0], [0, 6, 0, 1.0]])
    vis = tr.rasterize_auto(clip, torch.tensor([[0, 1, 2]], dtype=torch.int32), 32, 32)
    assert int((vis.tri_id >= 0).sum()) == 0


def test_ztest_lowest_depth_wins():
    near = [[-4, -4, -0.5, 1.0], [4, -4, -0.5, 1.0], [0, 6, -0.5, 1.0]]
    far = [[-4, -4, 0.5, 1.0], [4, -4, 0.5, 1.0], [0, 6, 0.5, 1.0]]
    clip = torch.tensor(far + near)
    tris = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    vis = tr.rasterize_auto(clip, tris, 32, 32)
    assert int(vis.tri_id[16, 16]) == 1
    np.testing.assert_allclose(float(vis.z[16, 16]), 0.25, atol=1e-5)
    # equal depths: the lower triangle index wins
    vis = tr.rasterize_auto(torch.tensor(near + near), tris, 32, 32)
    assert int(vis.tri_id[16, 16]) == 0


def test_kernel_wrapper_rejects_non_cuda_devices():
    clip = torch.empty((3, 4), device="meta")
    with pytest.raises(ValueError):
        trk.rasterize_kernel(clip, torch.zeros((1, 3), dtype=torch.int32, device="meta"), 8, 8)


@pytest.mark.parametrize("render_mode", [jg.RENDER_MODE_NORMAL, jg.RENDER_MODE_BAKING])
def test_shade_and_compose_match_jax(render_mode):
    mesh, view, proj, clip, vpos, vnrm = _scene()
    jvis = jr.rasterize(jnp.asarray(clip), jnp.asarray(mesh.tris), 64, 64, cull_backface=True)
    tvis = tr.VisibilityBuffer(*(torch.from_numpy(np.array(a)) for a in jvis))
    noise_tex = np.random.default_rng(1).standard_normal((16, 16, 4)).astype(np.float32)
    args = (mesh.tris, vpos, vnrm, mesh.uvs, mesh.colors, mesh.vertex_ids)
    ju = jg.DrawUniforms(sprite_id=2, material_id=5, render_mode=render_mode)
    tu = tg.DrawUniforms(sprite_id=2, material_id=5, render_mode=render_mode)
    jgb = jg.shade_draw(jvis, *(jnp.asarray(a) for a in args), ju, noise_tex=jnp.asarray(noise_tex))
    tgb = tg.shade_draw(tvis, *(torch.from_numpy(np.array(a)) for a in args), tu,
                        noise_tex=torch.from_numpy(noise_tex))
    for name, a, b in zip(jgb._fields, tgb, jgb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    # compose over a previous half-transparent draw
    rng = np.random.default_rng(2)
    prev = [rng.random(np.asarray(f).shape).astype(np.asarray(f).dtype) for f in jgb]
    prev[1] = np.asarray(jgb.id)[::-1].copy()
    prev[0][..., 3] = 0.5
    zbuf = rng.random((64, 64)).astype(np.float32)
    jout, jz = jg.compose_draw(jg.GBuffer(*map(jnp.asarray, prev)), jnp.asarray(zbuf), jgb, jvis,
                               render_mode)
    from stable_renderer_tpu_torch.data.framebuffers import GBuffer

    tout, tz = tg.compose_draw(GBuffer(*(torch.from_numpy(p) for p in prev)),
                               torch.from_numpy(zbuf), tgb, tvis, render_mode)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    for name, a, b in zip(jout._fields, tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_view_angle_bins_and_canny_match_jax():
    n = np.random.default_rng(3).standard_normal((500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    np.testing.assert_array_equal(tg.view_angle_map_index(torch.from_numpy(n), 3).numpy(),
                                  np.asarray(jg.view_angle_map_index(jnp.asarray(n), 3)))
    np.testing.assert_array_equal(tg.canny_from_normal(torch.from_numpy(n)).numpy(),
                                  np.asarray(jg.canny_from_normal(jnp.asarray(n))))


@pytest.mark.parametrize("baking", [False, True])
def test_defer_and_post_process_match_jax(baking):
    rng = np.random.default_rng(4)
    color = rng.random((16, 16, 4)).astype(np.float32)
    ids = rng.integers(0, 3000, (16, 16, 4)).astype(np.int32)
    ids[::3, :, 2] = 2048
    np.testing.assert_allclose(
        tpost.defer_render(torch.from_numpy(color), torch.from_numpy(ids), is_baking=baking).numpy(),
        np.asarray(jpost.defer_render(jnp.asarray(color), jnp.asarray(ids), is_baking=baking)), **TOL)
    kw = dict(enable_gamma=True, enable_hdr=True, gamma=2.2, exposure=1.3, saturation=0.7,
              brightness=1.1, contrast=1.2)
    np.testing.assert_allclose(
        tpost.post_process(torch.from_numpy(color), tpost.PostProcessParams(**kw)).numpy(),
        np.asarray(jpost.post_process(jnp.asarray(color), jpost.PostProcessParams(**kw))), **TOL)


def test_mesh_buffers_follow_their_mesh():
    """A mesh dropped after its upload never hands its buffers to a new mesh
    that happens to get the same id (the cache is keyed by id)."""
    import gc

    from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers

    for segments in (2, 3, 4, 5, 6):
        mesh = Mesh.Plane(1.0, segments)
        bufs = mesh_device_buffers(mesh, "cpu")
        assert bufs["positions"].shape[0] == (segments + 1) ** 2
        np.testing.assert_array_equal(bufs["tris"].numpy(), mesh.tris)
        del mesh, bufs
        gc.collect()


def test_mesh_matches_jax():
    for name, args in (("Sphere", (1.0, 12)), ("Plane", (2.0, 3)), ("Cube", (1.5,))):
        a, b = getattr(Mesh, name)(*args), getattr(JMesh, name)(*args)
        for field in ("positions", "normals", "uvs", "colors", "tris", "vertex_ids", "tangents",
                      "bitangents", "tri_material"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert (a.vertex_count, a.triangle_count) == (b.vertex_count, b.triangle_count)
        for lo_hi_a, lo_hi_b in zip(a.bounds, b.bounds):
            np.testing.assert_array_equal(lo_hi_a, lo_hi_b)


# --- K2's plain versions: the binned tile kernel is held to them bit for bit
# on the card (tests/test_torch_cuda.py, chip_smoke.py phase 4) -----------------


@pytest.mark.parametrize("cull", [False, True])
def test_tiles_reference_matches_jax_pallas_kernel(interpret_mode, cull):
    """rasterize_tiles_reference over triangle_setup's constants against the
    JAX Pallas kernel in interpret mode (``_agree``)."""
    mesh, _, _, clip, _, _ = _scene()
    ref = jrp.rasterize_pallas(jnp.asarray(clip), jnp.asarray(mesh.tris), 64, 64, tile=32,
                               cull_backface=cull)
    tri_data = trk.triangle_setup(torch.from_numpy(clip), torch.from_numpy(mesh.tris), 64, 64,
                                  cull_backface=cull)
    _agree(trk.rasterize_tiles_reference(tri_data, 64, 64), ref)


@pytest.mark.parametrize("size", [(64, 64), (40, 56)])
def test_tiles_reference_matches_plain(size):
    """... and against the port's plain rasterize, at the same bars, on a
    frame whose edges are not multiples of the tile."""
    h, w = size
    mesh, _, _, clip, _, _ = _scene()
    clip_t, tris_t = torch.from_numpy(clip), torch.from_numpy(mesh.tris)
    ref = tr.rasterize(clip_t, tris_t, h, w, cull_backface=True)
    out = trk.rasterize_tiles_reference(trk.triangle_setup(clip_t, tris_t, h, w, True), h, w)
    _agree(out, ref)


def test_tiles_reference_ties_and_empty_inputs():
    """The lowest index wins a depth tie (a triangle drawn twice in one
    plane); no triangles, or only culled ones, leave the empty buffer."""
    import chip_smoke

    clip, tris = chip_smoke.raster_soup(40, 56, tiny=50)
    clip_t, tris_t = torch.from_numpy(clip), torch.from_numpy(tris)
    vis = trk.rasterize_tiles_reference(trk.triangle_setup(clip_t, tris_t, 40, 56), 40, 56)
    ids = set(vis.tri_id.unique().tolist())
    assert 2 in ids and 3 not in ids  # the pair's first copy, never its second
    empty = tr.VisibilityBuffer.empty(40, 56)
    for t in (torch.zeros((0, 3), dtype=torch.int32), tris_t[-40:-20]):  # none; behind the camera
        got = trk.rasterize_tiles_reference(trk.triangle_setup(clip_t, t, 40, 56), 40, 56)
        for a, b in zip(got, empty):
            assert torch.equal(a, b)


def _brute_force_ranges(tri_data, height, width):
    """Every tile's float test of the TPU kernel (inclusive at the tile's
    edges), per triangle: the first and last admitted column and row."""
    tiles_x, tiles_y = -(-width // trk.TILE), -(-height // trk.TILE)
    x0 = torch.arange(tiles_x, dtype=torch.float32) * trk.TILE
    y0 = torch.arange(tiles_y, dtype=torch.float32) * trk.TILE
    r = tri_data
    ok_x = (r[:, 16:17] >= x0) & (r[:, 15:16] <= x0 + trk.TILE)    # (T, tiles_x)
    ok_y = (r[:, 18:19] >= y0) & (r[:, 17:18] <= y0 + trk.TILE)    # (T, tiles_y)
    valid = r[:, 19] > 0.5
    out = []
    for t in range(r.shape[0]):
        xs, ys = ok_x[t].nonzero()[:, 0], ok_y[t].nonzero()[:, 0]
        if not valid[t] or not len(xs) or not len(ys):
            out.append([1, 0, 1, 0])
        else:  # the float test admits a contiguous run of tiles
            assert xs[-1] - xs[0] + 1 == len(xs) and ys[-1] - ys[0] + 1 == len(ys)
            out.append([xs[0].item(), xs[-1].item(), ys[0].item(), ys[-1].item()])
    return torch.tensor(out, dtype=torch.int16)


@pytest.mark.parametrize("size", [(64, 64), (200, 136), (17, 33)])
def test_tile_ranges_match_brute_force(size):
    """The setup kernel's compact tile ranges (its plain version) admit
    exactly the tiles that the tile kernel's float bbox test admits:
    bounds on tile edges, outside the frame, NaN and infinite, invalid."""
    h, w = size
    rng = np.random.default_rng(5)
    t = 400
    data = np.zeros((t, trk.N_COLS), np.float32)
    lo = rng.uniform(-40, max(h, w) + 40, (t, 2)).astype(np.float32)
    hi = lo + rng.exponential(20, (t, 2)).astype(np.float32)
    edge = rng.random((t, 2)) < 0.3  # bounds exactly on a tile edge, or 16 past it
    lo[edge] = np.round(lo[edge] / 16) * 16
    hi[edge] = np.round(hi[edge] / 16) * 16
    data[:, 15], data[:, 16], data[:, 17], data[:, 18] = lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]
    data[:, 19] = (rng.random(t) < 0.9).astype(np.float32)
    data[0, 15] = np.nan
    data[1, 18] = np.nan
    data[2, 15], data[2, 16] = -np.inf, np.inf
    data[3, 15] = np.inf
    data[4, 16] = -np.inf
    data[5, 15:19] = [16.0 * 2, 16.0 * 2, 0.0, 0.0]  # a point on a tile corner: four tiles
    tri_data = torch.from_numpy(data)
    got = trk.tile_ranges(tri_data, h, w)
    assert got.dtype == torch.int16 and got.shape == (t, 4)
    assert torch.equal(got, _brute_force_ranges(tri_data, h, w))
