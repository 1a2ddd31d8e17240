"""The 95th percentile of all present-to-present gaps in the window, ms."""

from benchmark.harness.stats import gaps_ms, in_window, percentile


def read(rec):
    gaps = gaps_ms(in_window([t for _, t in rec["presents"]], rec["t_start"], rec["t_end"]))
    return percentile(gaps, 95.0) if gaps else None
