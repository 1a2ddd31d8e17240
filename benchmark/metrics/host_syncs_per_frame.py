"""Host syncs a frame: the program's ``sr.host_sync`` marks (one for each
synchronizing CUDA call the port's tracer counted, and one for each present
wait) in the second profiled stretch, which records the host's operations,
over its frames. A program without the counter (no ``SYNC_MARK`` in its
``utils/timer.py``) reads nothing."""


def read(rec):
    tr = rec.get("trace_host")
    if tr is None:
        return None
    try:
        from stable_renderer_tpu_torch.utils.timer import SYNC_MARK
    except ImportError:
        return None
    return sum(1 for name, _, _ in tr["host"] if name == SYNC_MARK) / rec["stretch_frames"]
