"""The port's host runtime (stable_renderer_tpu_torch/engine/ and utils/)
against the JAX package's engine, on the CPU.

The whole loop runs the bench scene (bench.py:227-236) for three 64x64 frames
through both packages' ``Engine.Run`` with the same tiny pipeline (the JAX
params converted leaf by leaf). Randomness is passed in: the port takes the
JAX engine's background noise and, through a wrapper of its ``frame_step``,
the JAX program's sampler re-noise draws. The host-only tests hold the scene
graph, the controls and the lights to the JAX package without diffusion; the
behaviour tests mirror tests/test_engine.py on the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_renderer_tpu.engine as J
import stable_renderer_tpu_torch.engine as P
from stable_renderer_tpu.data.sprite import Sprite as JSprite
from stable_renderer_tpu_torch.data.sprite import Sprite as PSprite

torch.set_num_threads(1)

SIZE = 64
FRAMES = 3
FRAME_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def clean_scene():
    J.Engine._reset()
    P.Engine._reset()
    yield
    J.Engine._reset()
    P.Engine._reset()


def _np(x) -> np.ndarray:
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _port_kw(E) -> dict:
    """The port's engine is asked for the CPU by name."""
    return {"device": "cpu"} if E is P else {}


def _bench_scene(E, mesh_segments: int = 12):
    """bench.py:227-236's scene in package ``E``, with the sprite and
    material ids fixed, so the id maps of both packages agree whatever ids
    earlier tests drew."""
    sprite_cls = PSprite if E is P else JSprite
    cam = E.GameObject("camera")
    cam.addComponent(E.Camera).env_prompt.prompt = "a ball"
    cam.transform.position = [0.0, 0.5, 3.0]
    cam.transform.lookAt([0.0, 0.0, 0.0])
    mat = E.Material("ball")
    mat.materialID = 1
    obj = E.GameObject("ball")
    obj.addComponent(E.SpriteInfo, sprite=sprite_cls(spriteID=1, prompt="a shiny ball"))
    obj.addComponent(E.MeshRenderer, mesh=E.Mesh.Sphere(1.0, mesh_segments), materials=[mat])
    obj.addComponent(E.AutoRotation, speed_deg=4.0)
    return obj


def _run(E, frames: int = FRAMES, scene=_bench_scene, before_run=None, **kw):
    """Run ``scene`` through ``E.Engine`` with a pinned clock; returns the
    engine and, per frame, the decoded images, the id map and the presented
    (index, uint8 frame)."""
    rec = {"images": [], "ids": [], "presented": []}

    class App(E.Engine):
        def beforePrepare(self):
            scene(E)

        def beforeFrameEnd(self):
            rm = self.RenderManager
            if getattr(rm, "last_diffusion_frames", None) is not None:
                rec["images"].append(_np(rm.last_diffusion_frames).copy())
            rec["ids"].append(_np(rm.last_gbuffer.id).copy())

    kw.setdefault("winSize", (SIZE, SIZE))
    eng = App(max_frames=frames, frame_callback=lambda f, i: rec["presented"].append((i, f.copy())),
              debug=True, **_port_kw(E), **kw)
    eng.RuntimeManager.fixed_clock = True
    if before_run is not None:
        before_run(eng)
    eng.run()
    return eng, rec


def _jax_step_noise(seed: int, lat_shape) -> list:
    """The LCM sampler's re-noise draws inside the JAX frame program for the
    per-frame key [0, seed] (samplers.py:251-255), as tests/test_torch_frame.py
    draws them."""
    k = jax.random.fold_in(jnp.asarray(np.array([0, seed], np.uint32)), 1)
    out = []
    for _ in range(4):
        k, sub = jax.random.split(k)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, lat_shape))))
    return out


# --- the whole loop -----------------------------------------------------------


def test_engine_run_matches_jax(monkeypatch):
    """Three frames of the bench scene through both engines: the decoded
    frames at the frame bar (2e-4, f32), the G-buffer id maps exactly, and
    the presented uint8 frames within one step, at the same indices in the
    same order."""
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig
    from stable_renderer_tpu_torch.engine import frame_program
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    kw = dict(prompt="a ball", steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform")
    jpipe = JPipe.from_random(JConfig(**kw), tiny=True, seed=0)
    jeng, jrec = _run(J, pipeline=jpipe,
                      corresponder=JOverlap(vertex_segments=SIZE * SIZE, update_corrmap=False))
    bg = _np(jeng.RenderManager.GlobalBGNoise)

    pipe = _port_pipeline(jpipe, RenderConfig(**kw))
    port_step = frame_program.frame_step
    seeds = []

    def with_jax_draws(*args, **kwargs):
        seed = (pipe.config.seed + P.Engine.Instance().RuntimeManager.FrameCount) & 0xFFFFFFFF
        seeds.append(seed)
        kwargs["step_noise"] = _jax_step_noise(seed, (1, SIZE // 2, SIZE // 2, 4))
        return port_step(*args, **kwargs)

    monkeypatch.setattr(frame_program, "frame_step", with_jax_draws)

    def set_bg(eng):
        eng.RenderManager._bg_noise = torch.from_numpy(bg.copy())

    eng, rec = _run(P, pipeline=pipe, before_run=set_bg,
                    corresponder=OverlapCorresponder(vertex_segments=SIZE * SIZE,
                                                     update_corrmap=False))
    assert seeds == list(range(FRAMES))
    assert eng.device.type == "cpu" and eng.RuntimeManager.FrameCount == FRAMES
    assert len(rec["images"]) == len(jrec["images"]) == FRAMES
    for f in range(FRAMES):
        np.testing.assert_array_equal(rec["ids"][f], jrec["ids"][f], err_msg=f"frame {f}")
        np.testing.assert_allclose(rec["images"][f], jrec["images"][f], err_msg=f"frame {f}",
                                   **FRAME_TOL)
    assert not np.array_equal(rec["ids"][0], rec["ids"][-1])  # the ball turned
    assert [i for i, _ in rec["presented"]] == [i for i, _ in jrec["presented"]] == [0, 1, 2]
    for (_, a), (_, b) in zip(rec["presented"], jrec["presented"]):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (SIZE, SIZE, 4)
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1


# --- host-only parity -----------------------------------------------------------


def _hierarchy(E):
    p = E.GameObject("p")
    p.transform.position = [1.0, -0.5, 2.0]
    p.transform.rotate((0.2, 1.0, 0.1), 37.0)
    p.transform.localScale = [1.5, 0.5, 2.0]
    c = E.GameObject("c", parent=p)
    c.transform.localPosition = [0.0, 2.0, -1.0]
    c.transform.localEulerAngles = [10.0, -20.0, 30.0]
    g = E.GameObject("g", parent=c)
    g.transform.position = [0.3, 0.2, 0.1]
    g.transform.lookAt([0.0, 0.0, 0.0])
    g.transform.rotateAround([1.0, 0.0, 0.0], (0.0, 1.0, 0.0), 25.0)
    cam_obj = E.GameObject("cam")
    cam_obj.transform.position = [0.0, 0.5, 3.0]
    cam_obj.transform.lookAt([0.0, 0.0, 0.0])
    persp = cam_obj.addComponent(E.Camera, fov=50.0, near=0.2, far=80.0)
    ortho_obj = E.GameObject("ortho", parent=c)
    ortho = ortho_obj.addComponent(E.Camera, ortho=True, ortho_size=2.5, main=False)
    out = {}
    for name, o in (("p", p), ("c", c), ("g", g), ("cam", cam_obj), ("ortho", ortho_obj)):
        t = o.transform
        out.update({f"{name}.matrix": t.globalTransformMatrix, f"{name}.position": t.position,
                    f"{name}.rotation": t.rotation, f"{name}.scale": t.scale,
                    f"{name}.forward": t.forward, f"{name}.up": t.up, f"{name}.right": t.right,
                    f"{name}.euler": t.localEulerAngles,
                    f"{name}.inverse": t.inverseTransformPoint([0.5, 0.5, 0.5])})
    for name, cam in (("persp", persp), ("ortho", ortho)):
        out[f"{name}.view"] = cam.viewMatrix
        out[f"{name}.proj"] = cam.projectionMatrix(1.5)
    out["main_is_persp"] = np.asarray(E.Camera.MainCamera() is persp)
    return out


def test_transform_hierarchy_and_camera_match_jax():
    ref = _hierarchy(J)
    out = _hierarchy(P)
    assert out.keys() == ref.keys()
    for k in out:
        assert np.asarray(out[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_allclose(out[k], ref[k], atol=1e-6, rtol=0, err_msg=k)


_CONTROLS = {
    "AutoRotation": dict(axis=(0.0, 1.0, 0.5), speed_deg=4.0),
    "EqualIntervalRotation": dict(axis=(1.0, 0.0, 0.0), angle_deg=30.0, interval=3),
    "CircularOrbit": dict(center=(0.5, 0.0, -0.5), speed_deg=7.0),
    "HelicalOrbit": dict(center=(0.0, 0.2, 0.0), speed_deg=5.0, vertical_speed=0.3,
                         vertical_range=0.7),
    "CameraController": dict(move_speed=0.2, rotate_speed=0.5),
    "RigidBody": dict(mass=2.0),
    "RigidController": dict(velocity=(0.01, -0.02, 0.03), angular_axis=(0.0, 0.0, 1.0),
                            angular_speed_deg=6.0),
}


def _drive_control(E, name: str, frames: int = 10):
    """``frames`` fixed-clock frames of one control on an object at
    (1, 0.5, 2); the camera controller walks forward and right and turns
    with the mouse held."""
    eng = E.Engine(winSize=(16, 16), disableComfyUI=True, **_port_kw(E))
    rt, inp = eng.RuntimeManager, eng.InputManager
    rt.fixed_clock = True
    obj = E.GameObject("obj")
    obj.transform.position = [1.0, 0.5, 2.0]
    obj.addComponent(getattr(E, name), **_CONTROLS[name])
    inp.press_key("w")
    inp.press_key("D")
    inp.press_mouse(0)
    track = []
    for f in range(frames):
        inp.move_mouse(3.0 * f, -2.0 * f)
        rt.on_frame_begin()
        rt.on_frame_run()
        inp.on_frame_end()
        rt.on_frame_end()
        track.append(np.concatenate([obj.transform.position, obj.transform.rotation]))
    return np.stack(track)


@pytest.mark.parametrize("name", sorted(_CONTROLS))
def test_controls_match_jax(name):
    ref = _drive_control(J, name)
    out = _drive_control(P, name)
    assert np.abs(np.diff(ref, axis=0)).max() > 0  # the control moved the object
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def _lit_scene(E):
    cam = E.GameObject("cam")
    cam.transform.position = [0.0, 0.5, 3.0]
    cam.transform.lookAt([0.0, 0.0, 0.0])
    camera = cam.addComponent(E.Camera)
    sun = E.GameObject("sun")
    sun.transform.position = [2.0, 2.0, 2.0]
    sun.transform.lookAt([0.0, 0.0, 0.0])
    sun.addComponent(E.DirectionalLight, color=(1.0, 0.5, 0.2), intensity=1.5)
    bulb = E.GameObject("bulb")
    bulb.transform.position = [0.0, 0.0, 2.5]
    bulb.addComponent(E.PointLight, intensity=3.0, radius=8.0, ambient=0.2)
    spot = E.GameObject("spot")
    spot.transform.position = [-1.0, 1.0, 1.5]
    spot.transform.lookAt([0.0, 0.0, 0.0])
    spot.addComponent(E.SpotLight, color=(0.2, 0.4, 1.0), radius=5.0, angle_deg=25.0,
                      att_linear=0.1)
    off = E.GameObject("off")
    off.addComponent(E.PointLight, intensity=9.0).enable = False
    return camera


def test_pack_lights_match_jax():
    assert J.Light.pack_lights(np.eye(4)) is None and P.Light.pack_lights(np.eye(4)) is None
    ref = J.Light.pack_lights(_lit_scene(J).viewMatrix)
    out = P.Light.pack_lights(_lit_scene(P).viewMatrix)
    assert out.shape == ref.shape == (3, 16) and out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("light_type", ["directional", "point", "spot"])
def test_apply_lights_matches_jax(light_type):
    from stable_renderer_tpu.ops.postprocess import apply_lights as j_apply
    from stable_renderer_tpu_torch.ops.postprocess import apply_lights

    rng = np.random.default_rng({"directional": 0, "point": 1, "spot": 2}[light_type])
    h, w = 24, 20
    color = rng.random((h, w, 4)).astype(np.float32)
    normal = rng.random((h, w, 3)).astype(np.float32)
    normal[:5] = 0.0  # no geometry: left as it is
    pos = (rng.standard_normal((h, w, 3)) + [0.0, 0.0, -3.0]).astype(np.float32)
    row = np.zeros(16, np.float32)
    row[0] = {"directional": 0, "point": 1, "spot": 2}[light_type]
    row[1:5] = (0.9, 0.6, 0.3, 1.7)
    row[5:8] = (0.5, 0.8, -1.5)
    d = np.array([-0.3, -0.4, -1.0])
    row[8:11] = d / np.linalg.norm(d)
    row[11:14] = (1.0, 0.2, 0.05)
    row[14] = np.cos(np.radians(40.0))
    row[15] = 0.15
    weak = row.copy()
    weak[[4, 15]] = (0.4, 0.05)
    lights = np.stack([row, weak])
    ref = np.asarray(j_apply(*(jnp.asarray(a) for a in (color, normal, pos, lights))))
    out = apply_lights(*(torch.from_numpy(a) for a in (color, normal, pos, lights)))
    np.testing.assert_allclose(out.numpy(), ref, **FRAME_TOL)
    np.testing.assert_array_equal(out.numpy()[:5], color[:5])
    assert not np.allclose(out.numpy()[5:], color[5:], atol=1e-3)


def test_raster_only_loop_with_lights_matches_jax():
    """The raster path (disableComfyUI=True) with a directional, a point and a
    spot light presents the JAX engine's uint8 frames; the lights change the
    sphere and leave the background (tests/test_engine.py:78,96)."""
    def lit(E):
        _bench_scene(E)
        _lit_scene(E)  # its camera comes second: the bench camera stays the main one

    _, jrec = _run(J, frames=2, scene=lit, disableComfyUI=True)
    _, rec = _run(P, frames=2, scene=lit, disableComfyUI=True)
    _, unlit = _run(P, frames=1, scene=_bench_scene, disableComfyUI=True)
    assert [i for i, _ in rec["presented"]] == [i for i, _ in jrec["presented"]] == [0, 1]
    for (_, a), (_, b) in zip(rec["presented"], jrec["presented"]):
        assert a.dtype == np.uint8 and a.shape == (SIZE, SIZE, 4)
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
    first, plain = rec["presented"][0][1], unlit["presented"][0][1]
    assert not np.array_equal(first, plain)
    assert np.array_equal(first[0, 0], plain[0, 0])


# --- behaviour, as tests/test_engine.py holds the JAX engine ---------------------


def test_gameobject_hierarchy_and_components():
    parent = P.GameObject("p", tags=("a",))
    child = P.GameObject("c", parent=parent)
    assert child.parent is parent and child in parent.children
    mr = child.addComponent(P.MeshRenderer, mesh=P.Mesh.Cube())
    assert child.getComponent(P.MeshRenderer) is mr
    assert child.getComponents(P.Component) == [child.transform, mr]
    assert P.GameObject.find_by_name("c") is child
    assert P.GameObject.find_by_tag("a") == [parent]
    parent.active = False
    assert not child.is_active and not mr.enable
    parent.active = True
    child.removeComponent(mr)
    assert child.getComponent(P.MeshRenderer) is None
    child.destroy()
    assert child not in parent.children and P.GameObject.all_objects() == [parent]


def test_runtime_clock_and_fixed_update_accumulator():
    """DeltaTime is measured and fixedUpdate runs on a FixedDeltaTime
    accumulator; a pinned clock gives one fixed step a frame."""
    import time

    calls = {"fixed": 0, "update": 0}

    class Probe(P.Component):
        def fixedUpdate(self):
            calls["fixed"] += 1

        def update(self):
            calls["update"] += 1

    class App(P.Engine):
        def beforePrepare(self):
            P.GameObject("probe").addComponent(Probe)

        def beforeFrameEnd(self):
            time.sleep(0.02)  # ~1.2 fixed steps a frame at 60 Hz

    eng = App.Run(winSize=(16, 16), disableComfyUI=True, max_frames=5, device="cpu")
    rt = eng.RuntimeManager
    assert calls["update"] == 5
    assert 1 <= calls["fixed"] <= 5 * rt.max_substeps
    assert rt.DeltaTime > 0.0 and rt.fps.fps > 0.0
    calls["fixed"] = calls["update"] = 0
    P.Engine._reset()

    class AppFixed(App):
        def beforeFrameEnd(self):
            pass

    eng2 = AppFixed(winSize=(16, 16), disableComfyUI=True, max_frames=4, device="cpu")
    eng2.RuntimeManager.fixed_clock = True
    eng2.run()
    assert calls["fixed"] == 4 and calls["update"] == 4


def test_manager_error_containment_vs_debug_raise():
    """Production mode logs a failing component and keeps running; debug
    mode raises."""
    class Bomb(P.Component):
        def update(self):
            raise RuntimeError("boom")

    class App(P.Engine):
        def beforePrepare(self):
            P.GameObject("bomb").addComponent(Bomb)

    eng = App.Run(winSize=(16, 16), disableComfyUI=True, max_frames=3, device="cpu",
                  keep_frames_in_memory=True)
    assert eng.RuntimeManager.FrameCount == 3 and len(eng.WindowManager.frames) == 3
    P.Engine._reset()
    with pytest.raises(RuntimeError, match="boom"):
        App.Run(winSize=(16, 16), disableComfyUI=True, max_frames=3, device="cpu", debug=True)


@pytest.mark.parametrize("depth,frames", [("2", 5), ("1", 3)])
def test_present_pipeline_depth_order_and_flush(monkeypatch, depth, frames):
    """Every frame is presented once, in frame order, lagging dispatch by up
    to SR_PRESENT_DEPTH frames; release flushes the tail."""
    monkeypatch.setenv("SR_PRESENT_DEPTH", depth)
    log = []

    class App(P.Engine):
        def afterPrepare(self):
            log.append(("depth", self.RenderManager._present_depth))

        def beforeFrameEnd(self):
            log.append(("frame", self.RuntimeManager.FrameCount))

    App.Run(winSize=(16, 16), disableComfyUI=True, max_frames=frames, device="cpu",
            frame_callback=lambda f, i: log.append(("presented", i)))
    d = int(depth)
    assert log[0] == ("depth", d)
    presented = [i for what, i in log if what == "presented"]
    assert presented == list(range(frames))
    for i in range(frames - d):  # frame i is presented in frame i + d's run
        assert log.index(("frame", i + d)) == log.index(("presented", i)) + 1


def test_defer_and_post_tasks():
    """Defer tasks see the pre-post-process color and the G-buffer; post
    tasks run after the post-process chain; both apply to one frame."""
    applied = {"defer": 0, "post": 0}

    class App(P.Engine):
        def beforePrepare(self):
            _bench_scene(P)

        def beforeFrameRun(self):
            if self.RuntimeManager.FrameCount == 1:
                def defer_task(color, gbuf):
                    applied["defer"] += 1
                    assert gbuf is not None and gbuf.id.shape == (32, 32, 4)
                    return color * 0.0

                def post_task(color):
                    applied["post"] += 1
                    return color + 1.0

                self.RenderManager.AddDeferRenderTask(defer_task)
                self.RenderManager.AddPostProcessTask(post_task)

    eng = App.Run(winSize=(32, 32), disableComfyUI=True, max_frames=2, device="cpu",
                  keep_frames_in_memory=True)
    assert applied == {"defer": 1, "post": 1}
    f0, f1 = eng.WindowManager.frames
    assert f0.dtype == f1.dtype == np.uint8
    assert f0[..., :3].max() > 127  # the white sphere
    assert (f1 == 255).all()  # black * 0, then + 1 -> all white


def test_bake_accumulates_frames_into_one_batch():
    """BAKE mode holds each frame's pack and renders the batch every
    baking_interval-th frame, through frame_step's ``pending``."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    pipe = DiffusionPipeline.from_random(
        RenderConfig(steps=2, cfg_scale=1.0, sampler="euler", scheduler="sgm_uniform"),
        tiny=True, device="cpu")
    batches = []

    class App(P.Engine):
        def beforePrepare(self):
            _bench_scene(P, mesh_segments=6)

        def beforeFrameEnd(self):
            rm = self.RenderManager
            batches.append((len(rm._pending), getattr(rm, "last_diffusion_frames", None)))
            rm.last_diffusion_frames = None

    eng = App.Bake(winSize=(32, 32), pipeline=pipe, baking_interval=2, max_frames=4,
                   keep_frames_in_memory=True, debug=True)
    assert [n for n, _ in batches] == [1, 0, 1, 0]
    assert [None if im is None else tuple(im.shape) for _, im in batches] == [
        None, (2, 32, 32, 3), None, (2, 32, 32, 3)]
    assert all(torch.isfinite(im).all() for _, im in batches if im is not None)
    assert eng.Mode == P.EngineMode.BAKE and len(eng.WindowManager.frames) == 4


def test_map_dumps(tmp_path):
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    pipe = DiffusionPipeline.from_random(
        RenderConfig(steps=1, cfg_scale=1.0, sampler="euler", scheduler="sgm_uniform"),
        tiny=True, device="cpu")

    class App(P.Engine):
        def beforePrepare(self):
            _bench_scene(P, mesh_segments=6)

    App.Run(winSize=(32, 32), pipeline=pipe, max_frames=1, output_maps=True,
            map_output_dir=str(tmp_path), output_dir=str(tmp_path / "frames"), debug=True)
    assert (tmp_path / "frames" / "frame_0.png").exists()
    for name in ("color", "normal", "depth", "canny", "result"):
        assert (tmp_path / name / f"{name}_0.png").exists(), name
    ids = np.load(tmp_path / "id" / "id_0.npy")
    assert ids.shape == (32, 32, 4) and ids.dtype == np.int32 and (ids[..., 0] == 1).any()
    assert np.load(tmp_path / "noise" / "noise_0.npy").shape == (4, 4, 4)


def test_ai_canny_dump_matches_jax(tmp_path):
    """``output_ai_canny`` adds the canny edges of the frame's colour map to
    the dumped maps (ai_canny/ai_canny_<frame>.png), as the JAX package's
    RenderManager does; the edges equal the JAX package's canny of the same
    colour map but at pixels that f32 rounding may flip. The flat-shaded
    G-buffer's colour map has exact ties between neighbours in the
    suppression, which the two packages' sums break differently."""
    from test_torch_frame_options import assert_canny_agrees

    from stable_renderer_tpu.ops.canny import canny as j_canny

    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    pipe = DiffusionPipeline.from_random(
        RenderConfig(steps=1, cfg_scale=1.0, sampler="euler", scheduler="sgm_uniform"),
        tiny=True, device="cpu")
    dumped = []

    class App(P.Engine):
        def beforePrepare(self):
            _bench_scene(P, mesh_segments=6)
            dm = self.DiffusionManager
            dm.output_ai_canny = True
            dump = dm._dump_maps
            dm._dump_maps = lambda arrays, *a: (dumped.append(arrays), dump(arrays, *a))

    App.Run(winSize=(32, 32), pipeline=pipe, max_frames=1, output_maps=True,
            map_output_dir=str(tmp_path), debug=True)
    assert (tmp_path / "ai_canny" / "ai_canny_0.png").exists()
    arrays = dumped[0]
    assert arrays["ai_canny"].shape == arrays["color"].shape == (1, 32, 32, 3)
    assert_canny_agrees(arrays["ai_canny"], np.asarray(j_canny(arrays["color"])),
                        arrays["color"], 0.4, 0.8)
    assert arrays["ai_canny"].max() == 1.0  # the ball's outline


def test_submit_prompt_renders_engine_data():
    """DiffusionManager.SubmitPrompt renders a packed batch with a generator
    seeded with seed + frame, as the frame loop's sampler key."""
    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    pipe = DiffusionPipeline.from_random(
        RenderConfig(steps=2, cfg_scale=1.0, sampler="lcm", scheduler="sgm_uniform", seed=5),
        tiny=True, device="cpu")
    eng = P.Engine(winSize=(32, 32), pipeline=pipe)
    eng.RuntimeManager.FrameCount = 3
    rng = np.random.default_rng(0)
    data = EngineData(frame_indices=torch.arange(2),
                      color_maps=torch.from_numpy(rng.random((2, 32, 32, 3), np.float32)))
    seeds = []
    render = pipe.render

    def spy(engine_data, corresponder=None, key=None):
        seeds.append(key.initial_seed())
        return render(engine_data, corresponder=corresponder, key=key)

    pipe.render = spy
    images = eng.DiffusionManager.SubmitPrompt(data)
    assert seeds == [8] and images.shape == (2, 32, 32, 3) and torch.isfinite(images).all()
    assert P.Engine(winSize=(32, 32), device="cpu").DiffusionManager.SubmitPrompt(data) is None


def test_resources_upload_to_the_engine_device():
    from stable_renderer_tpu_torch.engine import resources
    from stable_renderer_tpu_torch.engine.render_exec import _mesh_cache

    mesh = P.Mesh.Cube(1.0)
    eng = P.Engine(winSize=(16, 16), disableComfyUI=True, device="cpu")
    res = resources.MeshResource(mesh, name="cube")
    tex = resources.TextureResource(np.ones((4, 4, 3), np.float32), name="white")
    assert resources.drain_load_queue() == 2
    assert res.loaded and res.buffers["tris"].device.type == "cpu"
    assert (id(mesh), "cpu") in _mesh_cache and tex.device.device.type == "cpu"
    assert resources.ResourcesObj.Find("cube") is res
    assert P.Texture(np.zeros((2, 2), np.float32)).array.shape == (2, 2, 1)
    assert P.Texture.CreateNoiseTex(8, 8).array.device == eng.device
    res.defer_destroy()
    assert resources.drain_destroy_queue() == 1
    assert (id(mesh), "cpu") not in _mesh_cache and res.buffers is None


def test_scene_save_load(tmp_path):
    p = P.GameObject("root", tags=("x",))
    c = P.GameObject("child", parent=p)
    c.transform.localPosition = [1.0, 2.0, 3.0]
    P.Scene("s").save(tmp_path / "scene.json")
    P.Engine._reset()
    assert P.GameObject.roots() == []
    P.Scene.load(tmp_path / "scene.json")
    root, child = P.GameObject.find_by_name("root"), P.GameObject.find_by_name("child")
    assert root is not None and child.parent is root and root.tags == {"x"}
    np.testing.assert_allclose(child.transform.localPosition, [1, 2, 3])


def test_profile_trace_written(monkeypatch, tmp_path):
    """SR_TPU_PROFILE=<dir> runs the loop under torch.profiler and writes a
    Chrome trace there."""
    import json

    monkeypatch.setenv("SR_TPU_PROFILE", str(tmp_path))
    P.Engine.Run(winSize=(16, 16), disableComfyUI=True, max_frames=1, device="cpu")
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(traces[0].read_text())


def test_engine_device():
    """No device means the card, and raises without one; with a pipeline
    the engine takes its device, and a different one raises."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline

    if torch.cuda.is_available():
        assert P.Engine(disableComfyUI=True).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.Engine(disableComfyUI=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.Texture(np.zeros((2, 2, 3), np.float32))  # no engine: the card
    pipe = DiffusionPipeline.from_random(tiny=True, device="cpu")
    assert P.Engine(pipeline=pipe).device.type == "cpu"
    assert P.Engine(pipeline=pipe, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="differs"):
        P.Engine(pipeline=pipe, device="cuda")


def _stream_run():
    """The stream runs a frame in production mode and carries its state; its
    multi-device mesh is not ported."""
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    pipe = DiffusionPipeline.from_random(
        RenderConfig(stream_pipeline=True, stream_kv_layers=(2,)), tiny=True, device="cpu")
    eng = P.Engine.Run(winSize=(16, 16), pipeline=pipe, max_frames=1)  # production mode
    assert eng.RenderManager._stream_state is not None and eng.RenderManager._stream_kv
    pipe.enable_stream_mesh(None)


def _corrmap_update_batch():
    from stable_renderer_tpu_torch.data.corrmap import CorrespondMap

    CorrespondMap(k=1, height=2, width=2, device="cpu").update_batch(None, None, None)


def _ring_cross_frame_attention():
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    x = torch.zeros((2, 4, 8))
    OverlapCorresponder(all_frames=True, mesh=object()).attn_hooks(None).attn(x, x, x, 2, 6)


_UNPORTED = {
    "stream": _stream_run,
    "editor": lambda: P.Engine(mode=P.EngineMode.EDITOR, device="cpu"),
    "run_editor": lambda: P.Engine.RunEditor(device="cpu", max_frames=1),
    "corrmap_update_batch": _corrmap_update_batch,
    "ring_cross_frame_attention": _ring_cross_frame_attention,
}


@pytest.mark.parametrize("name", sorted(_UNPORTED))
def test_unported_paths_raise(name):
    """Paths whose slices are not ported raise NotImplementedError, also in
    production mode, where other manager errors are logged."""
    with pytest.raises(NotImplementedError):
        _UNPORTED[name]()
