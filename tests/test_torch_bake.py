"""The port's bake path against the JAX package's, on the CPU: BASELINE config
1 (``Engine.Bake`` of scripts/bake_ball.py's scene into a CorrespondMap) and
config 3 (``Engine.Run`` in GAME mode replaying the baked map without
diffusion), and the engine-state checkpoint between the two packages.

Both packages bake the same scene at 64x64 with the same tiny pipeline (the
JAX params converted leaf by leaf), two submits of two frames. Randomness is
passed in as tests/test_torch_engine.py passes it: the port takes the JAX
engine's background noise and the JAX program's sampler re-noise draws.
Tolerances: ``written`` exact; ``values`` within the decoded frames' agreement
(2e-4, f32); presented uint8 frames within one step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import stable_renderer_tpu.engine as J
import stable_renderer_tpu_torch.engine as P
from stable_renderer_tpu.data.corrmap import CorrespondMap as JMap
from stable_renderer_tpu.data.sprite import Sprite as JSprite
from stable_renderer_tpu_torch.data.corrmap import CorrespondMap as PMap
from stable_renderer_tpu_torch.data.sprite import Sprite as PSprite

torch.set_num_threads(1)

SIZE = 64
INTERVAL = 2
FRAMES = 4
VALUES_TOL = 2e-4
CFG = dict(steps=4, cfg_scale=2.0, sampler="lcm", scheduler="sgm_uniform")


@pytest.fixture(autouse=True)
def clean_scene():
    J.Engine._reset()
    P.Engine._reset()
    yield
    J.Engine._reset()
    P.Engine._reset()


def _np(x) -> np.ndarray:
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _new_map(E):
    if E is P:
        return PMap(name="bake_ball", k=3, height=SIZE, width=SIZE, device="cpu")
    return JMap(name="bake_ball", k=3, height=SIZE, width=SIZE)


def _ball_scene(E, cmap, prompt: str = "a colorful beach ball, high quality"):
    """scripts/bake_ball.py's scene in package ``E`` (16 views, a CorrMapRenderer
    on a 12-segment sphere), with the sprite and material ids fixed."""
    sprite_cls = PSprite if E is P else JSprite
    cam = E.GameObject("camera")
    cam.addComponent(E.Camera)
    cam.transform.position = [0.0, 0.0, 3.0]
    mat = E.Material("ball")
    mat.materialID = 1
    ball = E.GameObject("ball")
    ball.addComponent(E.SpriteInfo, sprite=sprite_cls(spriteID=1, prompt=prompt))
    ball.addComponent(E.CorrMapRenderer, mesh=E.Mesh.Sphere(1.0, 12), corrmaps=[cmap],
                      materials=[mat])
    ball.addComponent(E.EqualIntervalRotation, angle_deg=360.0 / 16, interval=1)


def _run(E, cmap, frames: int, bake: bool, prompt: str = "a colorful beach ball, high quality",
         before_run=None, **kw):
    """The ball scene through ``E.Engine`` (BAKE or GAME mode) with a pinned
    clock; returns the engine, the presented (index, uint8 frame) list and
    the G-buffer id maps."""
    rec = {"presented": [], "ids": []}

    class App(E.Engine):
        def beforePrepare(self):
            _ball_scene(E, cmap, prompt)

        def beforeFrameEnd(self):
            rec["ids"].append(_np(self.RenderManager.last_gbuffer.id).copy())

    eng = App(winSize=(SIZE, SIZE), max_frames=frames, debug=True,
              mode=E.EngineMode.BAKE if bake else E.EngineMode.GAME,
              frame_callback=lambda f, i: rec["presented"].append((i, f.copy())),
              **({"device": "cpu"} if E is P and "pipeline" not in kw else {}), **kw)
    eng.RuntimeManager.fixed_clock = True
    if before_run is not None:
        before_run(eng)
    eng.run()
    return eng, rec


@pytest.fixture(scope="module")
def pipes():
    from test_torch_frame import _port_pipeline

    from stable_renderer_tpu.engine.pipeline import DiffusionPipeline as JPipe
    from stable_renderer_tpu.workflow.config import RenderConfig as JConfig
    from stable_renderer_tpu_torch.workflow.config import RenderConfig

    jpipe = JPipe.from_random(JConfig(**CFG), tiny=True, seed=0)
    return jpipe, _port_pipeline(jpipe, RenderConfig(**CFG))


def _bake_both(pipes, monkeypatch, corr_j, corr_p):
    """Bake the ball in both packages; returns (JAX map, port map, JAX
    engine record, port engine record)."""
    from test_torch_engine import _jax_step_noise

    from stable_renderer_tpu_torch.engine import frame_program

    jpipe, pipe = pipes
    jmap = _new_map(J)
    jeng, jrec = _run(J, jmap, FRAMES, True, pipeline=jpipe, corresponder=corr_j,
                      baking_interval=INTERVAL)
    bg = _np(jeng.RenderManager.GlobalBGNoise)

    port_step = frame_program.frame_step
    seeds = []

    def with_jax_draws(*args, **kwargs):
        rm = P.Engine.Instance().RenderManager
        seed = (pipe.config.seed + P.Engine.Instance().RuntimeManager.FrameCount) & 0xFFFFFFFF
        if args[6]:  # run_diffusion: the submit frame
            seeds.append(seed)
            kwargs["step_noise"] = _jax_step_noise(
                seed, (len(rm._pending) + 1, SIZE // 2, SIZE // 2, 4))
        return port_step(*args, **kwargs)

    monkeypatch.setattr(frame_program, "frame_step", with_jax_draws)

    def set_bg(eng):
        eng.RenderManager._bg_noise = torch.from_numpy(bg.copy())

    pmap = _new_map(P)
    eng, rec = _run(P, pmap, FRAMES, True, pipeline=pipe, corresponder=corr_p,
                    baking_interval=INTERVAL, before_run=set_bg)
    monkeypatch.setattr(frame_program, "frame_step", port_step)
    assert seeds == [INTERVAL - 1, 2 * INTERVAL - 1]  # two submits of two frames
    assert eng.device.type == "cpu" and pmap.values.device.type == "cpu"
    for f in range(FRAMES):
        np.testing.assert_array_equal(rec["ids"][f], jrec["ids"][f], err_msg=f"frame {f}")
    return jmap, pmap, jrec, rec


def _assert_maps_match(jmap, pmap):
    np.testing.assert_array_equal(pmap.written.numpy(), np.asarray(jmap.written))
    np.testing.assert_allclose(pmap.values.numpy(), np.asarray(jmap.values), atol=VALUES_TOL,
                               rtol=0)
    assert 0 < int(pmap.written.sum()) < pmap.written.numel()


@pytest.mark.parametrize("corresponder", ["default_first", "overlap"])
def test_bake_matches_jax(pipes, monkeypatch, corresponder):
    """scripts/bake_ball.py's bake in both packages: DefaultCorresponder in
    "first" mode (the script's), and OverlapCorresponder (K/V injection and
    vertex averaging, its own "first" mode). The map's written cells are
    exact and its values within the frames' agreement; the id maps of all
    four frames are equal."""
    from stable_renderer_tpu.ops.correspondence import DefaultCorresponder as JDefault
    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu_torch.ops.correspondence import (
        DefaultCorresponder,
        OverlapCorresponder,
    )

    if corresponder == "default_first":
        corr_j, corr_p = (JDefault(update_corrmap_mode="first"),
                          DefaultCorresponder(update_corrmap_mode="first"))
    else:
        corr_j, corr_p = (JOverlap(vertex_segments=SIZE * SIZE),
                          OverlapCorresponder(vertex_segments=SIZE * SIZE))
        assert corr_p.update_corrmap_mode == corr_j.update_corrmap_mode == "first"
    jmap, pmap, jrec, rec = _bake_both(pipes, monkeypatch, corr_j, corr_p)
    _assert_maps_match(jmap, pmap)
    assert [i for i, _ in rec["presented"]] == [i for i, _ in jrec["presented"]] == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(rec["presented"], jrec["presented"]):
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1


def test_bake_written_grows_per_submit(pipes):
    """Each submit adds written cells: the map after one submit is a strict
    subset of the map after two."""
    from stable_renderer_tpu_torch.ops.correspondence import DefaultCorresponder

    _, pipe = pipes
    sizes = []
    for frames in (INTERVAL, 2 * INTERVAL):
        P.Engine._reset()
        pmap = _new_map(P)
        _run(P, pmap, frames, True, pipeline=pipe, baking_interval=INTERVAL,
             corresponder=DefaultCorresponder(update_corrmap_mode="first"))
        sizes.append(pmap.written.clone())
    assert 0 < int(sizes[0].sum()) < int(sizes[1].sum())
    assert not (sizes[0] & ~sizes[1]).any()


def _baked_map_numpy(height: int = SIZE, width: int = SIZE):
    """A deterministic 'baked' map: smooth colors over the UV grid in every
    bin, two thirds of the cells written."""
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    rng = np.random.default_rng(60)
    values, written = [], []
    for b in range(9):
        v = np.stack([xx / width, yy / height, np.full(xx.shape, b / 9.0), np.ones(xx.shape)],
                     -1)
        values.append(v.reshape(-1, 4))
        written.append(rng.random(height * width) < 0.67)
    return np.stack(values).astype(np.float32), np.stack(written)


@pytest.mark.parametrize("map_size", [(SIZE, SIZE), (24, 40)])
def test_replay_matches_jax(map_size):
    """scripts/corrmap_render_example.py: a baked map replayed in GAME mode
    without diffusion (BAKED draws) in both packages: presented uint8 frames
    within one step, G-buffer ids exact, and the ball is not the pink of a
    missing map. The 24x40 map holds the BAKED lookup's swapped uv axes
    (ops/gbuffer.py) to the JAX package's where height and width differ."""
    h, w = map_size
    values, written = _baked_map_numpy(h, w)
    jmap = JMap(name="replay", k=3, height=h, width=w)
    import jax.numpy as jnp

    jmap.values, jmap.written = jnp.asarray(values), jnp.asarray(written)
    pmap = PMap.from_numpy(values, written, k=3, height=h, width=w, name="replay",
                           device="cpu")
    _, jrec = _run(J, jmap, 3, False, prompt="", disableComfyUI=True)
    eng, rec = _run(P, pmap, 3, False, prompt="", disableComfyUI=True)
    assert eng.Mode == P.EngineMode.GAME and eng.disableComfyUI
    assert [i for i, _ in rec["presented"]] == [i for i, _ in jrec["presented"]] == [0, 1, 2]
    for f in range(3):
        np.testing.assert_array_equal(rec["ids"][f], jrec["ids"][f])
        a, b = rec["presented"][f][1], jrec["presented"][f][1]
        assert a.dtype == np.uint8 and a.shape == (SIZE, SIZE, 4)
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
    frame, ids = rec["presented"][0][1], rec["ids"][0]
    ball = ids[..., 0] == 1
    pink = (frame[..., 0] == 255) & (frame[..., 1] == 0) & (frame[..., 2] == 255)
    assert ball.mean() > 0.05 and pink[ball].mean() < 0.5
    assert len(np.unique(frame[ball][:, :3], axis=0)) > 50  # the map's colors, not one


def test_draw_call_inputs_hand_over_the_map():
    """A CorrMapRenderer's draw call gives the G-buffer stage the map's values
    on the engine's device and its (height, width)."""
    from stable_renderer_tpu_torch.engine.frame_program import draw_call_inputs
    from stable_renderer_tpu_torch.ops.gbuffer import RENDER_MODE_BAKING, DrawUniforms

    values, written = _baked_map_numpy(24, 40)
    pmap = PMap.from_numpy(values, written, k=3, height=24, width=40, device="cpu")
    eng, _ = _run(P, pmap, 1, True, disableComfyUI=True)
    assert pmap.values.device == eng.device
    draw = P.DrawCall(mesh=P.Mesh.Sphere(1.0, 8), model_matrix=np.eye(4, dtype=np.float32),
                      uniforms=DrawUniforms(render_mode=RENDER_MODE_BAKING),
                      corrmap=pmap)
    draws, sigs = draw_call_inputs([draw], np.eye(4, dtype=np.float32), device="cpu")
    assert draws[0]["corrmap"] is pmap.values and sigs[0][1] == (24, 40)


def test_engine_checkpoint_interchange(tmp_path):
    """A state saved by either package loads in the other: frame count,
    sprites and the submitted CorrespondMap (on the uint8 grid)."""
    from stable_renderer_tpu.engine.checkpoint import load_engine_state as jload
    from stable_renderer_tpu.engine.checkpoint import save_engine_state as jsave
    from stable_renderer_tpu_torch.engine.checkpoint import load_engine_state as pload
    from stable_renderer_tpu_torch.engine.checkpoint import save_engine_state as psave

    values, written = _baked_map_numpy()
    saved = {}
    for E, save in ((P, psave), (J, jsave)):
        E.Engine._reset()
        cmap = (PMap.from_numpy(values, written, device="cpu") if E is P
                else JMap(k=3, height=SIZE, width=SIZE))
        if E is J:
            import jax.numpy as jnp

            cmap.values, cmap.written = jnp.asarray(values), jnp.asarray(written)
        eng, _ = _run(E, cmap, 2, False, disableComfyUI=True)
        saved[E] = save(eng, tmp_path / ("port" if E is P else "jax"))
        assert (tmp_path / ("port" if E is P else "jax") / "scene.json").exists()
    for E, load, src in ((J, jload, saved[P]), (P, pload, saved[J])):
        E.Engine._reset()
        eng = E.Engine(winSize=(SIZE, SIZE), disableComfyUI=True,
                       **({"device": "cpu"} if E is P else {}))
        state = load(eng, src)
        assert state["frame_count"] == eng.RuntimeManager.FrameCount == 2
        assert state["corrmaps"] == {"s1_m1": [1, 1]}
        sprite = eng.RenderManager._sprites[1]
        assert sprite.prompt == "a colorful beach ball, high quality"
        cmap = eng.RenderManager._corrmaps[(1, 1)]
        np.testing.assert_array_equal(_np(cmap.written), written)
        np.testing.assert_array_equal(
            _np(cmap.values), np.clip(255.0 * values, 0, 255).astype(np.uint8) / np.float32(255))
        names = sorted(o.name for o in E.GameObject.roots())
        assert names == ["ball", "camera"]  # the scene came back from scene.json
