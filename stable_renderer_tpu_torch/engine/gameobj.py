"""GameObject / Component runtime — the Unity-style host scene graph.

Counterpart of stable_renderer_tpu/engine/gameobj.py, the capability match for
the reference's runtime layer (reference:
engine/runtime/gameObj.py:28-300, engine/runtime/component.py:24-165): parent/
children hierarchy, tags, active flags, component add/get/remove, and the
lifecycle hooks awake/start/fixedUpdate/update/lateUpdate/onEnable/onDisable/
onDestroy.

This layer is deliberately thin host Python: its only job is to *produce
arrays* (transforms, draw lists, sprite tables) consumed by the frame step. No
GL state, no device calls.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Type, TypeVar

_C = TypeVar("_C", bound="Component")


class Component:
    """Base component with the reference's lifecycle surface."""

    def __init__(self, game_object: "GameObject", enable: bool = True):
        self.gameObj = game_object
        self._enable = enable
        self._awaked = False
        self._started = False

    # --- lifecycle hooks (override freely) ---
    def awake(self): ...
    def start(self): ...
    def fixedUpdate(self): ...
    def update(self): ...
    def lateUpdate(self): ...
    def onEnable(self): ...
    def onDisable(self): ...
    def onDestroy(self): ...

    @property
    def engine(self):
        from stable_renderer_tpu_torch.engine.engine import Engine

        return Engine.Instance()

    @property
    def transform(self):
        from stable_renderer_tpu_torch.engine.transform import Transform

        return self.gameObj.transform

    @property
    def enable(self) -> bool:
        return self._enable and self.gameObj.is_active

    @enable.setter
    def enable(self, value: bool) -> None:
        if value == self._enable:
            return
        self._enable = value
        (self.onEnable if value else self.onDisable)()

    # --- internal drivers (called by RuntimeManager) ---
    def _run_awake(self):
        if not self._awaked:
            self._awaked = True
            self.awake()

    def _run_start(self):
        if not self._started:
            self._started = True
            self.start()


class GameObject:
    """Scene-graph node. Construct with an optional parent; components attach via
    addComponent (mirrors gameObj.py surface)."""

    _roots: List["GameObject"] = []

    def __init__(
        self,
        name: str = "GameObject",
        parent: Optional["GameObject"] = None,
        active: bool = True,
        tags: Iterable[str] = (),
    ):
        from stable_renderer_tpu_torch.engine.transform import Transform

        self.name = name
        self.tags = set(tags)
        self._active = active
        self._parent: Optional[GameObject] = None
        self.children: List[GameObject] = []
        self.components: List[Component] = []
        self._destroyed = False
        self.transform: Transform = Transform(self)
        self.components.append(self.transform)
        if parent is not None:
            self.set_parent(parent)
        else:
            GameObject._roots.append(self)

    # --- hierarchy ---
    @property
    def parent(self) -> Optional["GameObject"]:
        return self._parent

    def set_parent(self, parent: Optional["GameObject"]) -> None:
        if self._parent is not None:
            self._parent.children.remove(self)
        elif self in GameObject._roots:
            GameObject._roots.remove(self)
        self._parent = parent
        if parent is not None:
            parent.children.append(self)
        else:
            GameObject._roots.append(self)

    @property
    def is_active(self) -> bool:
        node: Optional[GameObject] = self
        while node is not None:
            if not node._active:
                return False
            node = node._parent
        return True

    @property
    def active(self) -> bool:
        return self._active

    @active.setter
    def active(self, value: bool) -> None:
        self._active = value

    # --- components ---
    def addComponent(self, cls: Type[_C], *args, **kwargs) -> _C:
        comp = cls(self, *args, **kwargs)
        self.components.append(comp)
        return comp

    def getComponent(self, cls: Type[_C]) -> Optional[_C]:
        for c in self.components:
            if isinstance(c, cls):
                return c
        return None

    def getComponents(self, cls: Type[_C]) -> List[_C]:
        return [c for c in self.components if isinstance(c, cls)]

    def removeComponent(self, comp: Component) -> None:
        if comp in self.components:
            comp.onDestroy()
            self.components.remove(comp)

    def destroy(self) -> None:
        if self._destroyed:
            return
        self._destroyed = True
        for child in list(self.children):
            child.destroy()
        for comp in list(self.components):
            comp.onDestroy()
        self.components.clear()
        self.set_parent(None)
        if self in GameObject._roots:
            GameObject._roots.remove(self)

    # --- traversal / queries ---
    @classmethod
    def roots(cls) -> List["GameObject"]:
        return list(cls._roots)

    @classmethod
    def all_objects(cls) -> List["GameObject"]:
        out: List[GameObject] = []

        def walk(node: GameObject):
            out.append(node)
            for c in node.children:
                walk(c)

        for r in cls._roots:
            walk(r)
        return out

    @classmethod
    def find_by_name(cls, name: str) -> Optional["GameObject"]:
        for obj in cls.all_objects():
            if obj.name == name:
                return obj
        return None

    @classmethod
    def find_by_tag(cls, tag: str) -> List["GameObject"]:
        return [o for o in cls.all_objects() if tag in o.tags]

    @classmethod
    def _clear_scene(cls) -> None:
        """Test/reset helper: drop every root object."""
        for r in list(cls._roots):
            r.destroy()
        cls._roots.clear()

    # --- lifecycle fan-out (RuntimeManager drivers) ---
    def _run_phase(self, phase: str) -> None:
        if not self.is_active:
            return
        for comp in list(self.components):
            if not comp._enable:
                continue
            if phase == "update":
                comp._run_awake()
                comp._run_start()
            getattr(comp, phase)()
        for child in list(self.children):
            child._run_phase(phase)

    def __repr__(self) -> str:
        return f"<GameObject {self.name} children={len(self.children)} comps={len(self.components)}>"
