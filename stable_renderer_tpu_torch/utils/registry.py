"""Cross-module global value registry + singleton decorator.

Counterpart of stable_renderer_tpu/utils/registry.py.

Equivalent capability to the reference's DI mechanism
(reference: source/common_utils/global_utils.py:187-231 and
source/common_utils/decorators/singleton) but without the duplicate-module-import
gymnastics: one process-wide dict plus a class decorator.
"""

from __future__ import annotations

from typing import Any, TypeVar

_GLOBALS: dict[str, Any] = {}

_T = TypeVar("_T")


def GetGlobalValue(key: str, default: Any = None) -> Any:
    return _GLOBALS.get(key, default)


def SetGlobalValue(key: str, value: Any) -> None:
    _GLOBALS[key] = value


def GetOrAddGlobalValue(key: str, default: Any) -> Any:
    if key not in _GLOBALS:
        _GLOBALS[key] = default
    return _GLOBALS[key]


def ClearGlobalValue(key: str) -> None:
    _GLOBALS.pop(key, None)


def cross_module_singleton(cls: type[_T]) -> type[_T]:
    """Class decorator: at most one live instance per process, re-init returns it.

    The instance is exposed as ``cls.instance()``.
    """

    key = f"__singleton__.{cls.__module__}.{cls.__qualname__}"

    orig_new = cls.__new__
    orig_init = cls.__init__

    def __new__(klass, *args, **kwargs):  # noqa: ANN001
        inst = GetGlobalValue(key)
        if inst is not None and isinstance(inst, klass):
            return inst
        if orig_new is object.__new__:
            inst = orig_new(klass)
        else:
            inst = orig_new(klass, *args, **kwargs)
        SetGlobalValue(key, inst)
        return inst

    def __init__(self, *args, **kwargs):  # noqa: ANN001
        if getattr(self, "__singleton_inited__", False):
            return
        orig_init(self, *args, **kwargs)
        self.__singleton_inited__ = True

    def instance(klass):  # noqa: ANN001
        return GetGlobalValue(key)

    def _reset_singleton(klass):  # noqa: ANN001
        ClearGlobalValue(key)

    cls.__new__ = __new__  # type: ignore[method-assign]
    cls.__init__ = __init__  # type: ignore[method-assign]
    cls.instance = classmethod(instance)  # type: ignore[attr-defined]
    cls._reset_singleton = classmethod(_reset_singleton)  # type: ignore[attr-defined]
    return cls
