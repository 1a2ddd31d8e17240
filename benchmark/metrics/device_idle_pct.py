"""The share of the profiled stretch in which no device operation runs (the
union of the device intervals against the stretch), %."""

from benchmark.harness.stats import union_seconds


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr["device"]:
        return None
    span = tr["seconds"]
    return 100.0 * (1.0 - union_seconds([(s, t) for _, s, t in tr["device"]]) / span)
