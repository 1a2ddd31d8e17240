"""Engine managers — the per-frame orchestration layer.

Counterpart of stable_renderer_tpu/engine/managers.py, the capability match
for the reference's manager framework + the six managers (reference:
engine/managers/manager.py:40-212 lifecycle framework, windowManager.py,
inputManager.py, runtimeManager.py, renderManager.py, diffusionManager.py,
sceneManager.py, resourcesManager.py), headless:

  * WindowManager — no GLFW; owns the output size and a frame sink (PNG dir /
    callback / in-memory).
  * InputManager — programmable key/mouse state with the GetKey/GetKeyDown API.
  * RuntimeManager — frame clock + fixedUpdate pacing + GameObject phase driver.
  * RenderManager — collects the sorted draw queue, sprites and lights, runs
    the port's ``frame_step`` (draws -> pack -> denoise -> decode -> defer ->
    post -> uint8) on the engine's device, accumulates the bake batch, and
    presents through a pipeline of in-flight frames.
  * DiffusionManager — owns the DiffusionPipeline + corresponder + bake pacing
    (ShouldSubmitBake every baking_interval frames) + async map dumping.
  * SceneManager / ResourcesManager — scene container + deferred resource load,
    matching the reference's thin versions.

Randomness differs from the JAX package's by design (torch and jax.random
never agree): the background noise and the per-frame sampler generator are
torch generators seeded with the JAX package's integers.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from stable_renderer_tpu_torch.data.engine_data import EngineData
from stable_renderer_tpu_torch.data.sprite import EnvPrompt, Sprite
from stable_renderer_tpu_torch.utils.events import AutoSortTask
from stable_renderer_tpu_torch.utils.log import EngineLogger
from stable_renderer_tpu_torch.utils.timer import FPSCounter, StageTimer


class Manager:
    """Lifecycle base (manager.py:40-212): ordered prepare/frame hooks."""

    PrepareFuncOrder = 0
    FrameBeginFuncOrder = 0
    FrameRunFuncOrder = 0
    FrameEndFuncOrder = 0
    ReleaseFuncOrder = 0

    def __init__(self, engine):
        self.engine = engine
        engine._managers.append(self)

    def prepare(self): ...
    def on_frame_begin(self): ...
    def on_frame_run(self): ...
    def on_frame_end(self): ...
    def release(self): ...


class WindowManager(Manager):
    def __init__(self, engine, window_size: Tuple[int, int] = (512, 512),
                 output_dir: Optional[str] = None,
                 frame_callback: Optional[Callable[[np.ndarray, int], None]] = None,
                 keep_frames_in_memory: bool = False):
        super().__init__(engine)
        self.WindowSize = window_size  # (W, H) like the reference
        self.output_dir = output_dir
        self.frame_callback = frame_callback
        self.keep_frames_in_memory = keep_frames_in_memory
        self.frames: List[np.ndarray] = []

    def present(self, frame: np.ndarray, frame_index: int) -> None:
        """The swap_buffers equivalent: deliver the final composited frame."""
        if self.frame_callback is not None:
            self.frame_callback(frame, frame_index)
        if self.keep_frames_in_memory:
            self.frames.append(frame)
        if self.output_dir:
            from PIL import Image

            os.makedirs(self.output_dir, exist_ok=True)
            img = frame[..., :3]
            if img.dtype != np.uint8:  # frames arrive uint8 from the frame step
                img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(self.output_dir, f"frame_{frame_index}.png"))


class InputManager(Manager):
    """Headless key/mouse state with the reference's query API
    (inputManager.py:6-170). Feed events via press/release/move."""

    def __init__(self, engine):
        super().__init__(engine)
        self._down: set = set()
        self._pressed: set = set()
        self._released: set = set()
        self._mouse_btns: set = set()
        self._mouse_pos = (0.0, 0.0)
        self._mouse_delta = (0.0, 0.0)

    def press_key(self, key: str) -> None:
        key = key.lower()
        if key not in self._down:
            self._pressed.add(key)
        self._down.add(key)

    def release_key(self, key: str) -> None:
        # (named *_key: `release` is the Manager lifecycle hook)
        key = key.lower()
        self._down.discard(key)
        self._released.add(key)

    def move_mouse(self, x: float, y: float) -> None:
        self._mouse_delta = (x - self._mouse_pos[0], y - self._mouse_pos[1])
        self._mouse_pos = (x, y)

    def press_mouse(self, btn: int = 0) -> None:
        self._mouse_btns.add(btn)

    def release_mouse(self, btn: int = 0) -> None:
        self._mouse_btns.discard(btn)

    def GetKey(self, key: str) -> bool:
        return key.lower() in self._down

    def GetKeyDown(self, key: str) -> bool:
        return key.lower() in self._pressed

    def GetKeyUp(self, key: str) -> bool:
        return key.lower() in self._released

    def GetMouseBtn(self, btn: int = 0) -> bool:
        return btn in self._mouse_btns

    @property
    def MousePos(self) -> Tuple[float, float]:
        return self._mouse_pos

    @property
    def MouseDelta(self) -> Tuple[float, float]:
        return self._mouse_delta

    def on_frame_end(self):
        self._pressed.clear()
        self._released.clear()
        self._mouse_delta = (0.0, 0.0)


class RuntimeManager(Manager):
    """Frame clock + GameObject phase driver (runtimeManager.py:15-325).

    Real wall clock: ``DeltaTime`` is measured per frame, and ``fixedUpdate``
    runs on an accumulator at ``FixedDeltaTime`` cadence (0..max_substeps
    times per frame) so physics/controls are per-second, not per-frame
    (reference runtimeManager.py fixedUpdate pacing). Headless runs that want
    determinism can pin the clock with ``fixed_clock=True`` (every frame
    advances exactly FixedDeltaTime, as the tests do)."""

    FrameRunFuncOrder = 0  # runs before RenderManager (order 100)

    def __init__(self, engine, fixed_delta_time: float = 1.0 / 60.0,
                 fixed_clock: bool = False, max_substeps: int = 4):
        super().__init__(engine)
        self.FrameCount = 0
        self.FixedDeltaTime = fixed_delta_time
        self.DeltaTime = fixed_delta_time
        self.Gravity = np.asarray([0.0, -9.8, 0.0], np.float32)
        self.fps = FPSCounter()
        self.fixed_clock = fixed_clock
        self.max_substeps = max_substeps
        self._last_time: Optional[float] = None
        self._accum = 0.0

    def on_frame_begin(self):
        import time

        if self.fixed_clock:
            self.DeltaTime = self.FixedDeltaTime
            self._accum = self.FixedDeltaTime
            return
        now = time.perf_counter()
        if self._last_time is None:
            self.DeltaTime = self.FixedDeltaTime
        else:
            # clamp huge stalls (debugger, first kernel build) to one substep burst
            self.DeltaTime = min(now - self._last_time,
                                 self.FixedDeltaTime * self.max_substeps)
        self._last_time = now
        self._accum += self.DeltaTime

    def on_frame_run(self):
        from stable_renderer_tpu_torch.engine.gameobj import GameObject

        n_fixed = 0
        while self._accum >= self.FixedDeltaTime and n_fixed < self.max_substeps:
            self._accum -= self.FixedDeltaTime
            n_fixed += 1
        for _ in range(n_fixed):
            for root in GameObject.roots():
                root._run_phase("fixedUpdate")
        for phase in ("update", "lateUpdate"):
            for root in GameObject.roots():
                root._run_phase(phase)

    def on_frame_end(self):
        self.FrameCount += 1
        self.fps.tick()


_PACK_KEYS = ("color", "mask", "id", "pos", "normal", "depth", "noise", "canny")


class RenderManager(Manager):
    """The hot loop (renderManager.py:135-1047): each frame runs the port's
    ``frame_step`` on the engine's device, and presents are pipelined: frame
    N's uint8 display is copied to pinned host memory asynchronously and
    handed to the WindowManager only after ``SR_PRESENT_DEPTH`` (default 2)
    later frames were dispatched, so the copy overlaps their device work."""

    FrameRunFuncOrder = 100

    def __init__(self, engine):
        super().__init__(engine)
        self.gbuffer_tasks = AutoSortTask()
        self._sprites: Dict[int, Sprite] = {}
        self._corrmaps: Dict[Tuple[int, int], object] = {}
        self._env_prompts: List[EnvPrompt] = []
        self._pending: List[dict] = []  # accumulated frame packs for bake batching
        self._pending_indices: List[int] = []
        # the stream pipeline's state (RenderConfig.stream_pipeline and
        # stream_kv_layers): in-flight latents (with hints and ids) and the
        # lag-1 K/V contexts, carried frame to frame
        self._stream_state = None
        self._stream_kv = None
        # present pipeline: frames awaiting host readback, FIFO. Depth 1 = the
        # reference's double buffering (renderManager double-buffered FBO
        # presents).
        self._present_depth = max(1, int(os.environ.get("SR_PRESENT_DEPTH", "2")))
        self._inflight: list = []  # [(device display, host buffer, event, frame index)]
        self._free_host: list = []  # pinned host buffers whose copy has been read
        self.timer = StageTimer()
        self._bg_noise = None
        self.last_gbuffer = None
        self.post_process_params = None  # set lazily; PostProcessParams
        self.defer_tasks = AutoSortTask()
        self.post_tasks = AutoSortTask()

    # --- submission API (renderManager.py:709-790, 678-706) ---

    def AddGBufferTask(self, draw_call) -> None:
        self.gbuffer_tasks.add_task(lambda dc=draw_call: dc, order=draw_call.order)

    def AddIdenticalGBufferTask(self, draw_call) -> None:
        """API parity with the reference's per-object isolated pre-pass
        (renderManager.py:709-756). Every draw already depth-merges through
        the explicit z-buffer compose and BAKING draws shade fully (see
        ops/gbuffer.py), so the isolated pre-pass is unnecessary — the task
        joins the ordinary queue."""
        self.AddGBufferTask(draw_call)

    def AddDeferRenderTask(self, task: Callable, order: float = 0.0) -> None:
        """Register a defer-stage pass for this frame (renderManager.py:771-777).
        ``task(color, gbuffer) -> color | None``: a returned tensor replaces the
        display color; None means side-effect only. Fewer-arg callables are
        called with as many leading args as they accept."""
        self.defer_tasks.add_task(task, order)

    def AddPostProcessTask(self, task: Callable, order: float = 0.0) -> None:
        """Register a post-process pass for this frame (renderManager.py:779-790).
        ``task(color) -> color | None`` with the same replace/side-effect rule."""
        self.post_tasks.add_task(task, order)

    _TASK_ARITY_CACHE: dict = {}

    @classmethod
    def _task_arity(cls, fn) -> int:
        """Parameter count of a task callable, memoized — inspect.signature is
        ~10 µs and _apply_tasks runs per task per frame."""
        try:
            hit = cls._TASK_ARITY_CACHE.get(fn)
        except TypeError:  # unhashable callable
            hit = None
        if hit is not None:
            return hit
        import inspect

        try:
            n = len(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            n = 0
        try:
            if len(cls._TASK_ARITY_CACHE) > 512:
                cls._TASK_ARITY_CACHE.clear()
            cls._TASK_ARITY_CACHE[fn] = n
        except TypeError:
            pass
        return n

    @classmethod
    def _apply_tasks(cls, queue: AutoSortTask, *args):
        """Run user defer/post tasks: each may return a replacement color."""
        color = args[0]
        for t in sorted(queue._tasks):
            n_params = cls._task_arity(t.fn) - len(t.args) - len(t.kwargs)
            out = t.fn(*args[: max(n_params, 0)], *t.args, **t.kwargs)
            if out is not None:
                color = out
                args = (color,) + args[1:]
        queue.clear()
        return color

    def SubmitSprite(self, sprite: Sprite) -> None:
        self._sprites[sprite.spriteID] = sprite

    def SubmitCorrmap(self, sprite_id: int, material_id: int, corrmap) -> None:
        self._corrmaps[(sprite_id, material_id)] = corrmap

    def SubmitEnvPrompt(self, prompt: EnvPrompt) -> None:
        self._env_prompts.append(prompt)

    @property
    def GlobalBGNoise(self) -> torch.Tensor:
        """Fixed background latent noise (renderManager.py:869-875): (1, H, W, 4)
        on the engine's device, from a generator seeded with 7 there (the JAX
        package's key, not its values)."""
        if self._bg_noise is None:
            w, h = self.engine.WindowManager.WindowSize
            dev = self.engine.device
            gen = torch.Generator(device=dev).manual_seed(7)
            self._bg_noise = torch.randn((1, h, w, 4), generator=gen, device=dev)
        return self._bg_noise

    # --- the frame ---

    def on_frame_run(self):
        from stable_renderer_tpu_torch.engine import frame_program
        from stable_renderer_tpu_torch.ops.postprocess import PostProcessParams

        engine = self.engine
        dev = engine.device
        dm = engine.DiffusionManager
        w, h = engine.WindowManager.WindowSize
        frame_count = engine.RuntimeManager.FrameCount

        with self.timer.stage("assemble"):
            draw_calls = [t.fn() for t in sorted(self.gbuffer_tasks._tasks)]
            self.gbuffer_tasks.clear()
            cam = self._main_camera()
            lights = None
            if cam is not None and draw_calls:
                from stable_renderer_tpu_torch.engine.renderers import Light

                # host numpy: view, projection, lights and model-view go to
                # the device with the frame step's other inputs
                view = cam.viewMatrix
                proj = cam.projectionMatrix(w / h)
                draws, sigs = frame_program.draw_call_inputs(draw_calls, view, device=dev)
                lights = Light.pack_lights(view)
            else:
                draws, sigs, proj = (), (), np.eye(4, dtype=np.float32)

            pipe = None if engine.disableComfyUI else dm.pipeline
            is_baking = engine.Mode.name == "BAKE"
            run_diffusion = pipe is not None and (not is_baking or dm.ShouldSubmitBake)
            corresponder = None
            sprite_ids: tuple = ()
            ctx = nctx = sigmas = key = None
            y_cond = y_uncond = None
            pending = None
            unet_params = vae_params = None
            cn_sources: tuple = ()
            cn_params: tuple = ()
            if run_diffusion:
                corresponder = dm.corresponder
                n = len(self._pending) + 1
                env = self._env_tuple()
                sprite_ids, ctx, nctx, y_cond, y_uncond = pipe.prepare_conditioning(
                    dict(self._sprites), env, n, image_size=(h, w)
                )
                sigmas = pipe.scheduler_sigmas()
                # the sampler's generator, seeded with the integer of the JAX
                # package's per-frame key [0, (seed + frame) & 0xFFFFFFFF]
                seed = (pipe.config.seed + frame_count) & 0xFFFFFFFF
                key = torch.Generator(device=dev).manual_seed(seed)
                if self._pending:
                    pending = {
                        k: torch.stack([p[k] for p in self._pending]) for k in _PACK_KEYS
                    }
                cn_sources = tuple(spec.source for _, _, spec in pipe.controlnets)
                unet_params, vae_params, cn_params = pipe.compute_params()

            pp = self.post_process_params or PostProcessParams()
            have_tasks = bool(len(self.defer_tasks) or len(self.post_tasks))

        use_stream = run_diffusion and pipe.config.stream_pipeline and not is_baking

        with self.timer.stage("dispatch"):
            display, gbuf, pack, images, stream_state, stream_kv = frame_program.frame_step(
                pipe if run_diffusion else None,
                corresponder,
                sprite_ids,
                sigs,
                h,
                w,
                run_diffusion,
                is_baking,
                pp,
                cn_sources,
                not have_tasks,  # uint8 on the device unless host tasks intervene
                draws,
                proj,
                self.GlobalBGNoise,
                pending,
                ctx,
                nctx,
                sigmas,
                key,
                unet_params,
                vae_params,
                cn_params,
                y_cond,
                y_uncond,
                apply_post=not have_tasks,
                lights=lights,
                stream_state=self._stream_state if use_stream else None,
                stream_init=use_stream and self._stream_state is None,
                stream_kv=self._stream_kv if use_stream else None,
            )
        if use_stream:
            self._stream_state, self._stream_kv = stream_state, stream_kv
        self.last_gbuffer = gbuf

        if have_tasks:
            # reference ordering (renderManager.py:1027-1043): user defer tasks
            # see pre-post-process color; the post-process chain runs after them
            from stable_renderer_tpu_torch.ops.postprocess import post_process

            with self.timer.stage("host_tasks"):
                display = self._apply_tasks(self.defer_tasks, display, gbuf)
                display = post_process(display, pp)
                display = self._apply_tasks(self.post_tasks, display)
                display = frame_program.display_to_uint8(display)

        if run_diffusion:
            with self.timer.stage("finish"):
                self.last_diffusion_frames = images
                # build EngineData only for consumers: corrmap bake updates or
                # map dumping; the realtime loop skips the batch concatenation
                from stable_renderer_tpu_torch.ops.correspondence import (
                    Corresponder as _C,
                    DefaultCorresponder as _DC,
                )

                stock_finished = type(corresponder).finished in (
                    _DC.finished, _C.finished)
                wants_bake = (bool(self._corrmaps) and getattr(
                    corresponder, "update_corrmap", False)) or not stock_finished
                wants_dump = dm.output_maps and dm.map_output_dir
                if wants_bake or wants_dump:
                    engine_data = self._build_engine_data(pending, pack, frame_count)
                    corresponder.finished(engine_data, images)
                    if wants_dump:
                        dm._dump_maps_async(engine_data, images)
                self._pending.clear()
                self._pending_indices.clear()
        elif pipe is not None:
            # bake accumulation frame: hold the pack for the batched submit
            self._pending.append(pack)
            self._pending_indices.append(frame_count)

        with self.timer.stage("present"):
            # pipelined presents: start this frame's copy to the host now,
            # then hand over the oldest in-flight frames
            self._inflight.append(self._start_readback(display, frame_count))
            while len(self._inflight) > self._present_depth:
                self._present(self._inflight.pop(0))

    def _start_readback(self, display: torch.Tensor, frame_index: int) -> tuple:
        """Enqueue the uint8 display's copy into a pinned host buffer, with an
        event recorded after it. The device tensor stays referenced by the
        entry until the copy has landed; a host buffer is reused only after
        its event fired and its bytes were copied out (``_present``)."""
        if display.device.type != "cuda":
            return display, None, None, frame_index
        host = next((b for b in self._free_host if b.shape == display.shape), None)
        if host is None:
            host = torch.empty(display.shape, dtype=display.dtype, pin_memory=True)
        else:
            self._free_host.remove(host)
        host.copy_(display, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return display, host, done, frame_index

    def _present(self, entry: tuple) -> None:
        display, host, done, frame_index = entry
        if host is None:
            frame = display.numpy()
        else:
            done.synchronize()
            frame = host.numpy().copy()  # the buffer goes back to the ring
            self._free_host.append(host)
        self.engine.WindowManager.present(frame, frame_index)

    def flush_present(self) -> None:
        """Read back + deliver all in-flight frames (end of run / tests)."""
        pending, self._inflight = self._inflight, []
        for entry in pending:
            self._present(entry)

    def release(self):
        self.flush_present()

    def _main_camera(self):
        from stable_renderer_tpu_torch.engine.camera import Camera

        return Camera.MainCamera()

    def _env_tuple(self) -> tuple:
        cam = self._main_camera()
        env = (cam.env_prompt,) if cam is not None else ()
        return env + tuple(self._env_prompts)

    def _build_engine_data(self, pending, pack, frame_count: int) -> EngineData:
        def batch(k):
            if pending is None:
                return pack[k][None]
            return torch.cat([pending[k], pack[k][None]], dim=0)

        return EngineData(
            frame_indices=torch.as_tensor(self._pending_indices + [frame_count]),
            color_maps=batch("color"),
            id_maps=batch("id"),
            pos_maps=batch("pos"),
            noise_maps=batch("noise"),
            normal_maps=batch("normal"),
            depth_maps=batch("depth"),
            canny_maps=batch("canny"),
            masks=batch("mask"),
            sprite_infos=dict(self._sprites),
            env_prompts=self._env_tuple(),
            correspond_maps=dict(self._corrmaps),
        )

    def on_frame_end(self):
        self._env_prompts.clear()


class DiffusionManager(Manager):
    """Engine <-> diffusion bridge (diffusionManager.py:24-352)."""

    def __init__(self, engine, pipeline=None, corresponder=None,
                 baking_interval: int = 8,
                 output_maps: bool = False,
                 map_output_dir: Optional[str] = None,
                 output_ai_canny: bool = False):
        super().__init__(engine)
        self.pipeline = pipeline
        if corresponder is None:
            from stable_renderer_tpu_torch.ops.correspondence import default_corresponder

            corresponder = default_corresponder()
        self.corresponder = corresponder
        self.baking_interval = baking_interval
        self.output_maps = output_maps
        self.map_output_dir = map_output_dir
        self.output_ai_canny = output_ai_canny
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._dump_futures: List = []

    @property
    def ShouldSubmitBake(self) -> bool:
        """True every baking_interval-th frame (diffusionManager.py:97-102)."""
        fc = self.engine.RuntimeManager.FrameCount
        return (fc + 1) % self.baking_interval == 0

    @property
    def ShouldOutputFrame(self) -> bool:
        return self.output_maps

    def SubmitPrompt(self, engine_data: EngineData):
        """Run the render program on the packed frames
        (diffusionManager.py:289-352 -> the whole ComfyUI execute path), with
        a generator on the pipeline's device seeded with seed + frame."""
        if self.pipeline is None:
            return None
        key = torch.Generator(device=self.pipeline.device).manual_seed(
            self.pipeline.config.seed + self.engine.RuntimeManager.FrameCount
        )
        images = self.pipeline.render(engine_data, corresponder=self.corresponder, key=key)
        if self.output_maps and self.map_output_dir:
            self._dump_maps_async(engine_data, images)
        return images

    # --- map dumping (diffusionManager.py:160-285), async like the reference ---

    def _dump_maps_async(self, engine_data: EngineData, images) -> None:
        def host(t):
            return t.detach().cpu().numpy()

        arrays = {
            "color": host(engine_data.color_maps),
            "normal": host(engine_data.normal_maps),
            "depth": host(engine_data.depth_maps),
            "canny": host(engine_data.canny_maps),
            "id": host(engine_data.id_maps),
            "pos": host(engine_data.pos_maps),
            "noise": host(engine_data.noise_maps),
            "result": host(images),
        }
        if self.output_ai_canny:
            from stable_renderer_tpu_torch.ops.canny import canny

            arrays["ai_canny"] = host(canny(engine_data.color_maps))
        frames = [int(i) for i in engine_data.frame_indices.tolist()]
        self._dump_futures.append(
            self._pool.submit(self._dump_maps, arrays, frames, self.map_output_dir)
        )

    @staticmethod
    def _dump_maps(arrays: dict, frames: List[int], out_dir: str) -> None:
        from PIL import Image

        for name, arr in arrays.items():
            d = os.path.join(out_dir, name)
            os.makedirs(d, exist_ok=True)
            for i, f in enumerate(frames):
                a = arr[i]
                if name in ("id", "pos", "noise"):
                    np.save(os.path.join(d, f"{name}_{f}.npy"), a)
                else:
                    img = np.clip(a[..., :3] * 255, 0, 255).astype(np.uint8)
                    Image.fromarray(img).save(os.path.join(d, f"{name}_{f}.png"))

    def release(self):
        for fut in self._dump_futures:
            try:
                fut.result(timeout=8)  # reference drains with 8s timeout
            except Exception as e:  # noqa: BLE001
                EngineLogger.warning(f"map dump failed: {e}")
        self._pool.shutdown(wait=False)


class SceneManager(Manager):
    """Scene container (sceneManager.py:3-26) + scene save/load, which the
    reference left TODO (scene.py:8) — here implemented via scene.py."""

    def __init__(self, engine):
        super().__init__(engine)
        from stable_renderer_tpu_torch.engine.scene import Scene

        self.MainScene = Scene("main")

    def prepare(self):
        pass


class ResourcesManager(Manager):
    """Deferred resource preparation (resourcesManager.py:12-60): drains the
    ResourcesObj load queue (sorted by LoadOrder) after the scene is built so
    all host-to-device uploads happen in one batched pass before the frame
    loop, and drains the destroy queue at release."""

    PrepareFuncOrder = 100
    ReleaseFuncOrder = 0

    def prepare(self):
        from stable_renderer_tpu_torch.engine.resources import drain_load_queue

        n = drain_load_queue()
        if n:
            EngineLogger.info(f"ResourcesManager: uploaded {n} resources to {self.engine.device}")

    def release(self):
        from stable_renderer_tpu_torch.engine.resources import drain_destroy_queue

        drain_destroy_queue()
