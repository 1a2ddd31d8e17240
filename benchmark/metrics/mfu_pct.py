"""The whole step's share of the card's dense bf16 peak: the model FLOPs of
the frames in the profiled stretch (counted on the reference's towers at
the cell's shapes, ``reference/flops.py``) over the stretch's seconds times
989e12 (one H100 SXM, NVIDIA's data sheet), %."""

PEAK_BF16 = 989e12


def read(rec):
    tr, work = rec.get("trace"), rec.get("work")
    if tr is None or work is None or not tr["device"]:
        return None
    span = tr["seconds"]
    return 100.0 * work.flops * rec["stretch_frames"] / (span * PEAK_BF16)
