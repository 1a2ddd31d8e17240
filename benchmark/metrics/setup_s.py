"""Process start to the first timed frame: weights, pipeline, int8
calibration, engine prepare and the warm frames."""


def read(rec):
    return rec["t_start"] - rec["t0"]
