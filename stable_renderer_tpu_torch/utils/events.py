"""Typed multi-listener events and ordered task queues.

Counterpart of stable_renderer_tpu/utils/events.py: host-side plumbing with the
same capability surface as the reference's event system
(reference: source/common_utils/data_struct/event.py:90-799 — Event + AutoSortTask
ordered task queues that drive the render-task scheduling). The host layer is
kept thin, so this is a compact re-design: listeners are plain callables,
tasks carry an integer order and drain sorted.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable


class Event:
    """Multi-listener event. ``event.invoke(*args)`` calls listeners in add order."""

    def __init__(self, *arg_types: type):
        self._arg_types = arg_types
        self._listeners: list[Callable] = []
        self._once: list[Callable] = []

    def add_listener(self, fn: Callable) -> None:
        if fn not in self._listeners:
            self._listeners.append(fn)

    def add_once(self, fn: Callable) -> None:
        self._once.append(fn)

    def remove_listener(self, fn: Callable) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def clear(self) -> None:
        self._listeners.clear()
        self._once.clear()

    def invoke(self, *args: Any, **kwargs: Any) -> None:
        for fn in list(self._listeners):
            fn(*args, **kwargs)
        once, self._once = self._once, []
        for fn in once:
            fn(*args, **kwargs)

    def __len__(self) -> int:
        return len(self._listeners) + len(self._once)


_counter = itertools.count()


@dataclass(order=True)
class _Task:
    order: float
    seq: int
    fn: Callable = field(compare=False)
    args: tuple = field(compare=False, default=())
    kwargs: dict = field(compare=False, default_factory=dict)


class AutoSortTask:
    """Ordered task queue: add tasks with an order key, execute sorted (stable).

    Used by the render manager for the G-buffer draw queues, where draw order
    encodes opaque near-to-far / transparent far-to-near sorting
    (reference: mesh_renderer.py:100-125 order computation).
    """

    def __init__(self) -> None:
        self._tasks: list[_Task] = []

    def add_task(self, fn: Callable, order: float = 0.0, *args: Any, **kwargs: Any) -> None:
        self._tasks.append(_Task(order, next(_counter), fn, args, kwargs))

    def execute(self, clear: bool = True) -> list[Any]:
        results = [t.fn(*t.args, **t.kwargs) for t in sorted(self._tasks)]
        if clear:
            self._tasks.clear()
        return results

    def clear(self) -> None:
        self._tasks.clear()

    def __len__(self) -> int:
        return len(self._tasks)
