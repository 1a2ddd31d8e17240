"""The 95th percentile, over the window's presented frames, of the present
time less the time the engine began the frame whose scene the present shows
(``lag`` frames earlier: the stream program's depth), ms."""

from benchmark.harness.stats import percentile


def read(rec):
    lag = rec["lag"]
    lat = [(t - rec["begins"][max(0, i - lag)]) * 1e3 for i, t in rec["presents"]
           if rec["t_start"] <= t <= rec["t_end"]]
    return percentile(lat, 95.0) if lat else None
