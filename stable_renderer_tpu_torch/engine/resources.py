"""ResourcesObj — named/format-dispatched resources with deferred device upload.

Counterpart of stable_renderer_tpu/engine/resources.py, the capability match
for the reference's resource framework
(reference: engine/static/resources_obj.py:30-213 — ResourcesObjMeta format
registry, named-object registry, __TO_BE_LOAD_RESOURCES__ /
__TO_BE_DESTROY_RESOURCES__ queues, LoadOrder; and
engine/managers/resourcesManager.py:12-60 prepare/release draining).

"Loading" means the one host-to-device copy of an asset's tensors onto the
engine's device; "destroying" drops the device references so the caching
allocator can reuse the memory. The queues exist so assets created during
scene construction upload in one batched prepare pass (sorted by LoadOrder)
before the frame loop starts, instead of stalling the first frames with lazy
uploads.
"""

from __future__ import annotations

from typing import ClassVar, Dict, List, Optional, Type, TypeVar
from uuid import uuid4

import torch

from stable_renderer_tpu_torch.utils.log import EngineLogger

_FORMAT_SUBCLSES: Dict[str, Dict[str, type]] = {}   # base_cls_name -> {fmt: cls}
_NAMED_OBJS: Dict[str, Dict[str, "ResourcesObj"]] = {}  # base_cls_name -> {name: obj}
_TO_BE_LOAD: List["ResourcesObj"] = []
_TO_BE_DESTROY: List["ResourcesObj"] = []

_R = TypeVar("_R", bound="ResourcesObj")


class ResourcesObj:
    """Base for assets that upload to the device before the main loop."""

    Format: ClassVar[Optional[str]] = None  # e.g. "obj" for Mesh_OBJ
    LoadOrder: ClassVar[int] = 0            # smaller loads earlier
    BaseClsName: ClassVar[str] = "ResourcesObj"

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        # format registry (ResourcesObjMeta.__new__, resources_obj.py:30-49)
        base = cls.BaseClsName
        if cls.Format is not None:
            fmt = cls.Format.strip().lower().lstrip(".")
            _FORMAT_SUBCLSES.setdefault(base, {}).setdefault(fmt, cls)

    def __init__(self, name: Optional[str] = None, immediate_load: bool = False,
                 alias: Optional[str] = None):
        self.id = uuid4().hex
        self.name = name
        self.alias = alias
        self.loaded = False
        self._destroyed = False
        if name is not None:
            _NAMED_OBJS.setdefault(self.BaseClsName, {})[name] = self
        if immediate_load:
            self.load()
        else:
            _TO_BE_LOAD.append(self)

    # --- subclass contract ---

    def _load(self) -> None:
        """Do the actual host-to-device upload. Override."""

    def _destroy(self) -> None:
        """Drop device references. Override."""

    # --- lifecycle ---

    def load(self) -> None:
        if self.loaded or self._destroyed:
            return
        self._load()
        self.loaded = True

    def destroy(self) -> None:
        if self._destroyed:
            return
        self._destroy()
        self._destroyed = True
        self.loaded = False
        if self.name is not None:
            _NAMED_OBJS.get(self.BaseClsName, {}).pop(self.name, None)

    def defer_destroy(self) -> None:
        """Queue for destruction at the next release pass
        (__TO_BE_DESTROY_RESOURCES__)."""
        _TO_BE_DESTROY.append(self)

    # --- registries (resources_obj.py:79-121) ---

    @classmethod
    def FindFormatCls(cls: Type[_R], fmt: str) -> Optional[Type[_R]]:
        fmt = fmt.strip().lower().lstrip(".")
        if cls.Format is not None and cls.Format == fmt:
            return cls
        return _FORMAT_SUBCLSES.get(cls.BaseClsName, {}).get(fmt)

    @classmethod
    def Find(cls: Type[_R], name: str) -> Optional[_R]:
        if cls is ResourcesObj:
            for objs in _NAMED_OBJS.values():
                if name in objs:
                    return objs[name]  # type: ignore[return-value]
            return None
        return _NAMED_OBJS.get(cls.BaseClsName, {}).get(name)  # type: ignore

    @classmethod
    def AllNamed(cls) -> Dict[str, "ResourcesObj"]:
        return dict(_NAMED_OBJS.get(cls.BaseClsName, {}))

    def __repr__(self) -> str:
        label = self.name or self.alias or self.id[:8]
        return f"<{type(self).__name__} {label} loaded={self.loaded}>"


def drain_load_queue() -> int:
    """Load everything queued, sorted by LoadOrder; loading may enqueue more
    (resourcesManager.py:17-38). Returns the number loaded."""
    prepared = 0
    seen: set = set()
    while _TO_BE_LOAD:
        batch = sorted(_TO_BE_LOAD, key=lambda o: o.LoadOrder)
        _TO_BE_LOAD.clear()
        for obj in batch:
            if obj.id in seen or obj.loaded:
                seen.add(obj.id)
                continue
            try:
                obj.load()
                prepared += 1
            except Exception as ex:  # noqa: BLE001
                raise RuntimeError(f"Error loading {obj!r}: {ex}") from ex
            finally:
                seen.add(obj.id)
    return prepared


def drain_destroy_queue() -> int:
    """Destroy everything queued (resourcesManager.py:40-60)."""
    released = 0
    seen: set = set()
    while _TO_BE_DESTROY:
        batch = list(_TO_BE_DESTROY)
        _TO_BE_DESTROY.clear()
        for obj in batch:
            if obj.id in seen or obj._destroyed or not obj.loaded:
                seen.add(obj.id)
                continue
            obj.destroy()
            released += 1
            seen.add(obj.id)
    return released


def _clear_all() -> None:
    """Test helper."""
    _TO_BE_LOAD.clear()
    _TO_BE_DESTROY.clear()
    _NAMED_OBJS.clear()


# ---------------------------------------------------------------------------
# concrete resources


class MeshResource(ResourcesObj):
    """Device-buffer upload for a Mesh (the reference Mesh's sendToGPU;
    render_exec.mesh_device_buffers consumes the uploaded dict) onto
    ``device`` (default: the engine's)."""

    BaseClsName = "Mesh"
    LoadOrder = 10

    def __init__(self, mesh, device=None, **kw):
        self.mesh = mesh
        self.device = device
        self.buffers: Optional[dict] = None
        super().__init__(**kw)

    def _load(self) -> None:
        from stable_renderer_tpu_torch.engine.render_exec import mesh_device_buffers
        from stable_renderer_tpu_torch.engine.engine import engine_device

        self.device = engine_device(self.device)
        self.buffers = mesh_device_buffers(self.mesh, self.device)
        EngineLogger.debug(f"uploaded mesh buffers: {self.mesh.name}")

    def _destroy(self) -> None:
        from stable_renderer_tpu_torch.engine.render_exec import _mesh_cache

        # the cache keys on (id, device) and holds the mesh, so the key
        # cannot belong to another mesh while this one is alive
        _mesh_cache.pop((id(self.mesh), str(self.device)), None)
        self.buffers = None


class TextureResource(ResourcesObj):
    """Device upload of a host image array (texture.py Texture's GL upload)
    onto ``device`` (default: the engine's)."""

    BaseClsName = "Texture"
    LoadOrder = 5

    def __init__(self, array, device=None, **kw):
        self._host = array
        self._device = device
        self.device: Optional[torch.Tensor] = None
        super().__init__(**kw)

    def _load(self) -> None:
        from stable_renderer_tpu_torch.engine.engine import engine_device

        self.device = torch.as_tensor(self._host).to(engine_device(self._device))

    def _destroy(self) -> None:
        self.device = None


class CorrMapResource(ResourcesObj):
    """A CorrespondMap's (values, written) pair, moved as one unit onto the
    engine's device at load."""

    BaseClsName = "CorrespondMap"
    LoadOrder = 20

    def __init__(self, corrmap, **kw):
        self.corrmap = corrmap
        super().__init__(**kw)

    def _load(self) -> None:
        from stable_renderer_tpu_torch.engine.engine import engine_device

        self.corrmap.to(engine_device())

    def _destroy(self) -> None:
        pass  # the map owns its tensors; dropping the resource is enough
