"""Frames completed in the window over the window's seconds: all the work
over all the time, with no median of chunks. Realtime: a frame is completed
when it is presented; bake: when its submit's map update has returned. The
count holds the partial frames at the window's two ends (linear between the
completions around each end), so a slow frame rate reads without a whole
frame's rounding."""

from benchmark.harness.stats import completions_at


def read(rec):
    done = rec["completions"]
    return (completions_at(done, rec["t_end"]) - completions_at(done, rec["t_start"])) / \
        rec["seconds"]
