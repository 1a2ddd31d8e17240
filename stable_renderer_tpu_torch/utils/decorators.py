"""Decorator utilities.

Counterpart of stable_renderer_tpu/utils/decorators.py.

Capability match for the reference's decorator toolbox
(reference: source/common_utils/decorators/ — singleton (see utils/registry.py),
prevent_re_init, class_property, cache_property, Overload runtime dispatch).
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, List, Tuple


def prevent_re_init(cls: type) -> type:
    """__init__ runs at most once per instance (reference prevent_re_init)."""
    orig = cls.__init__

    @functools.wraps(orig)
    def __init__(self, *args, **kwargs):
        if getattr(self, "__inited__", False):
            return
        orig(self, *args, **kwargs)
        self.__inited__ = True

    cls.__init__ = __init__
    return cls


class class_property:
    """Property on the class itself (reference class_property)."""

    def __init__(self, fget: Callable):
        self.fget = fget

    def __get__(self, obj, owner=None):
        return self.fget(owner if owner is not None else type(obj))


class class_or_ins_property:
    """Property usable from both the class and instances."""

    def __init__(self, fget: Callable):
        self.fget = fget

    def __get__(self, obj, owner=None):
        return self.fget(obj if obj is not None else owner)


def cache_property(fn: Callable) -> property:
    """Computed once per instance, cached (reference cache_property)."""
    attr = f"__cached_{fn.__name__}__"

    @functools.wraps(fn)
    def getter(self):
        if not hasattr(self, attr):
            setattr(self, attr, fn(self))
        return getattr(self, attr)

    return property(getter)


class Overload:
    """Runtime multiple dispatch by annotation match (reference Overload).

    Register variants by decorating repeatedly; calls pick the first variant
    whose annotated parameter types accept the arguments.

        @Overload
        def f(x: int): ...
        @f.register
        def _(x: str): ...
    """

    def __init__(self, fn: Callable):
        functools.update_wrapper(self, fn)
        self._variants: List[Tuple[inspect.Signature, Callable]] = []
        self.register(fn)

    def register(self, fn: Callable) -> "Overload":
        self._variants.append((inspect.signature(fn), fn))
        return self

    @staticmethod
    def _accepts(sig: inspect.Signature, args: tuple, kwargs: dict) -> bool:
        try:
            bound = sig.bind(*args, **kwargs)
        except TypeError:
            return False
        for name, value in bound.arguments.items():
            ann = sig.parameters[name].annotation
            if ann is inspect.Parameter.empty or isinstance(ann, str):
                continue
            if isinstance(ann, type) and not isinstance(value, ann):
                return False
        return True

    def __call__(self, *args, **kwargs):
        for sig, fn in self._variants:
            if self._accepts(sig, args, kwargs):
                return fn(*args, **kwargs)
        raise TypeError(
            f"no overload of {self.__name__} matches args={args} kwargs={kwargs}"
        )

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return functools.partial(self.__call__, obj)
