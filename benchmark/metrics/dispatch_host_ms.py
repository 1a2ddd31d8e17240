"""Host ms a frame in RenderManager's ``dispatch`` stage (``StageTimer``):
the time the host spends enqueueing ``frame_step``, over the window's frames.
Host time, not device time."""


def read(rec):
    total, count = rec["dispatch"]
    return total / count * 1e3 if count else None
