"""Engine — lifecycle orchestration and the public entry point.

Counterpart of stable_renderer_tpu/engine/engine.py, the capability match for
the reference Engine singleton (reference: engine/engine.py:44-368 — modes
GAME/EDITOR/BAKE, Run/Bake class methods, manager init order, prepare ->
frame loop -> release with beforePrepare/afterPrepare/beforeFrameBegin/...
/beforeRelease user hooks).

Usage mirrors the reference example scripts (scripts/boat_example.py:81-111):

    class Sample(Engine):
        def beforePrepare(self):
            ball = GameObject("ball")
            ball.addComponent(MeshRenderer, mesh=Mesh.Sphere())
            cam = GameObject("cam")
            cam.addComponent(Camera)
            cam.transform.position = [0, 0, 3]

    Sample.Run(winSize=(512, 512), pipeline=pipe, max_frames=16)

The engine runs on one device: the pipeline's when it has one, else
``device`` (default: the card; it raises where there is none, and never falls
back to the CPU). Headless: ``max_frames`` bounds the loop and frames stream
to WindowManager's sink. EDITOR mode (``RunEditor``) also starts the
live-view / prompt HTTP server (server.py) and streams every presented
frame to it.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional, Tuple

import torch

from stable_renderer_tpu_torch.device import keep_f32, resolve_device
from stable_renderer_tpu_torch.engine.managers import (
    DiffusionManager,
    InputManager,
    Manager,
    RenderManager,
    ResourcesManager,
    RuntimeManager,
    SceneManager,
    WindowManager,
)
from stable_renderer_tpu_torch.utils.log import EngineLogger


class EngineMode(Enum):
    GAME = "game"
    EDITOR = "editor"
    BAKE = "bake"


def _run_device(pipeline, device) -> torch.device:
    """The pipeline's device, which an explicit ``device`` must name too;
    without a pipeline, ``device`` (default: the card)."""
    if pipeline is None:
        return resolve_device(device)
    dev = pipeline.device
    if device is not None:
        asked = torch.device(device)
        if asked.type != dev.type or (asked.index is not None and dev.index is not None
                                      and asked.index != dev.index):
            raise ValueError(f"device={asked} differs from the pipeline's device {dev}")
    return dev


def engine_device(device=None) -> torch.device:
    """Where an asset goes: ``device`` when given, else the running engine's
    device, else the card (raises without one)."""
    if device is None and Engine._instance is not None:
        return Engine._instance.device
    return resolve_device(device)


class Engine:
    _instance: Optional["Engine"] = None

    def __init__(
        self,
        winSize: Tuple[int, int] = (512, 512),
        mode: EngineMode = EngineMode.GAME,
        disableComfyUI: bool = False,  # reference kwarg name; disables diffusion
        pipeline=None,
        corresponder=None,
        baking_interval: int = 8,
        output_dir: Optional[str] = None,
        map_output_dir: Optional[str] = None,
        output_maps: bool = False,
        frame_callback=None,
        keep_frames_in_memory: bool = False,
        max_frames: Optional[int] = None,
        verbose: bool = False,
        debug: bool = False,
        device=None,
        editor_port: int = 8188,
        editor_host: str = "127.0.0.1",
        **kwargs,
    ):
        self.device = _run_device(pipeline, device)
        keep_f32()  # Run and Bake construct through here
        Engine._instance = self
        self.Mode = mode
        self.disableComfyUI = disableComfyUI or pipeline is None
        self.max_frames = max_frames
        self._managers: list[Manager] = []
        self._running = False
        self.verbose = verbose
        self.debug = debug  # True: manager errors raise; False: log + continue

        # manager init order matches the reference (engine.py:144-172)
        self.WindowManager = WindowManager(
            self,
            window_size=winSize,
            output_dir=output_dir,
            frame_callback=frame_callback,
            keep_frames_in_memory=keep_frames_in_memory,
        )
        self.InputManager = InputManager(self)
        self.RuntimeManager = RuntimeManager(self)
        self.RenderManager = RenderManager(self)
        self.DiffusionManager = DiffusionManager(
            self,
            pipeline=pipeline,
            corresponder=corresponder,
            baking_interval=baking_interval,
            output_maps=output_maps,
            map_output_dir=map_output_dir,
        )
        self.SceneManager = SceneManager(self)
        self.ResourcesManager = ResourcesManager(self)

        # EDITOR mode (reference engine.py:117-119 + comfyUI main.run editor
        # branch): boot the live-view/prompt HTTP server and stream every
        # presented frame to it (numpy uint8, already on the host) — the
        # stand-in for the PySide6 editor + web graph UI. GAME mode stays
        # headless.
        self.editor_server = None
        if mode == EngineMode.EDITOR:
            from stable_renderer_tpu_torch.server import FrameServer

            self.editor_server = FrameServer(host=editor_host, port=editor_port).start()
            # scene hierarchy + inspector (/scene, /hierarchy) — the
            # reference editor's left panel (ui/main.py gameobject list)
            self.editor_server.attach_engine(self)
            user_cb = self.WindowManager.frame_callback

            def _editor_cb(frame, idx, _srv=self.editor_server, _user=user_cb):
                _srv.publish(frame, idx)
                if _user is not None:
                    _user(frame, idx)

            self.WindowManager.frame_callback = _editor_cb

    # --- user hooks (engine.py:227-283) ---
    def beforePrepare(self): ...
    def afterPrepare(self): ...
    def beforeFrameBegin(self): ...
    def beforeFrameRun(self): ...
    def beforeFrameEnd(self): ...
    def beforeRelease(self): ...
    def afterRelease(self): ...

    @classmethod
    def Instance(cls) -> "Engine":
        if cls._instance is None:
            raise RuntimeError("Engine not created yet")
        return cls._instance

    # --- lifecycle (engine.py:286-341) ---

    def run(self) -> None:
        """The frame loop; with ``SR_TPU_PROFILE=<dir>`` set, under a
        torch.profiler trace written there (utils/timer.py:trace), which
        holds the frames' ``sr.*`` spans."""
        import contextlib
        import os

        profile_dir = os.environ.get("SR_TPU_PROFILE")
        profile_cm = contextlib.nullcontext()
        if profile_dir:
            from stable_renderer_tpu_torch.utils.timer import trace

            profile_cm = trace(profile_dir, cuda=self.device.type == "cuda")
        with profile_cm:
            self._run_inner()

    def _contained(self, manager: Manager, hook_name: str) -> None:
        """Run one manager hook with the reference's error policy
        (manager.py:147-199): debug mode raises, production logs the traceback
        and continues — one bad component must not kill the engine. A path the
        port does not run yet (NotImplementedError) raises in both: it is no
        component's fault, and logging it every frame would hide it."""
        try:
            getattr(manager, hook_name)()
        except (KeyboardInterrupt, SystemExit, NotImplementedError):
            raise
        except Exception:
            if self.debug:
                raise
            import traceback

            EngineLogger.error(
                f"{type(manager).__name__}.{hook_name} failed (continuing):\n"
                + traceback.format_exc()
            )

    def _run_inner(self) -> None:
        self._running = True
        self.beforePrepare()
        for m in sorted(self._managers, key=lambda m: m.PrepareFuncOrder):
            m.prepare()
        self.afterPrepare()
        EngineLogger.info(
            f"Engine running: mode={self.Mode.name}, size={self.WindowManager.WindowSize}, "
            f"device={self.device}, diffusion={'off' if self.disableComfyUI else 'on'}"
        )
        try:
            while self._running:
                if self.max_frames is not None and self.RuntimeManager.FrameCount >= self.max_frames:
                    break
                self.beforeFrameBegin()
                # the frame's span opens after the user's first hook, which
                # may start or stop a profiler at the frame boundary
                with self.RenderManager.timer.frame(self.RuntimeManager.FrameCount):
                    for m in sorted(self._managers, key=lambda m: m.FrameBeginFuncOrder):
                        self._contained(m, "on_frame_begin")
                    self.beforeFrameRun()
                    for m in sorted(self._managers, key=lambda m: m.FrameRunFuncOrder):
                        self._contained(m, "on_frame_run")
                    self.beforeFrameEnd()
                    for m in sorted(self._managers, key=lambda m: m.FrameEndFuncOrder):
                        self._contained(m, "on_frame_end")
        finally:
            self.beforeRelease()
            for m in sorted(self._managers, key=lambda m: m.ReleaseFuncOrder):
                m.release()
            self.afterRelease()
            # the editor server survives the frame loop (the reference's
            # editor window stays open after a run): stop it with
            # engine.editor_server.stop()
            self._running = False
            EngineLogger.info(
                "Engine released.\n" + self.RenderManager.timer.report()
            )

    def stop(self) -> None:
        self._running = False

    @classmethod
    def Run(cls, **kwargs) -> "Engine":
        """Create + run in GAME mode (engine.py:343-357)."""
        inst = cls(**kwargs)
        inst.run()
        return inst

    @classmethod
    def Bake(cls, **kwargs) -> "Engine":
        """Create + run in BAKE mode (engine.py:359-368): frames accumulate
        and every baking_interval-th frame renders the batch."""
        kwargs["mode"] = EngineMode.BAKE
        inst = cls(**kwargs)
        inst.run()
        return inst

    @classmethod
    def RunEditor(cls, **kwargs) -> "Engine":
        """Create + run in EDITOR mode: the engine loop plus the live-view /
        prompt HTTP server (the reference's editor-mode boot, engine.py:117-119
        with comfyUI main.run server branch)."""
        kwargs["mode"] = EngineMode.EDITOR
        return cls.Run(**kwargs)

    @classmethod
    def _reset(cls) -> None:
        """Test helper: clear the scene graph + singleton."""
        from stable_renderer_tpu_torch.engine.camera import Camera
        from stable_renderer_tpu_torch.engine.gameobj import GameObject
        from stable_renderer_tpu_torch.engine.renderers import Light
        from stable_renderer_tpu_torch.engine.resources import _clear_all

        GameObject._clear_scene()
        Camera._clear()
        Light._clear()
        _clear_all()
        cls._instance = None
