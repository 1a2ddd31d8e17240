"""Device kernels in the profiled stretch per frame (copies and sets left
out): the host-launch count."""


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    n = sum(1 for name, _, _ in tr["device"] if not name.startswith(("Memcpy", "Memset")))
    return n / rec["stretch_frames"] if n else None
