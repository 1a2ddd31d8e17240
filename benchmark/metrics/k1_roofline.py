"""K1's share of its roofline: the least time of the frames' attention at
2048 keys or more (the larger of operations over the peak of the served
type and bytes over 3.35e12 B/s, q, k and v read once and the output written
once; bf16 989e12, f32 with TF32 off 67e12 FLOP/s), over the device time of
the attention kernels in the profiled stretch (K1's ``flash_*``, or SDPA's
``fmha`` / flash kernels where a change routes there), %."""

import re

PEAK = {2: 989e12, 4: 67e12}
HBM = 3.35e12
NAMES = re.compile(r"flash|fmha")
MIN_KEYS = 2048


def least_seconds(work) -> float:
    t = 0.0
    for b, heads, lq, lk, d, eb, k in work.attention:
        if lk < MIN_KEYS:
            continue
        ops = 4.0 * b * heads * lq * lk * d
        nbytes = (2 * b * heads * lq * d + 2 * b * heads * lk * d) * eb
        t += max(ops / PEAK[eb], nbytes / HBM) * k
    return t


def read(rec):
    tr, work = rec.get("trace"), rec.get("work")
    if tr is None or work is None:
        return None
    spent = sum(t - s for name, s, t in tr["device"] if NAMES.search(name))
    need = least_seconds(work) * rec["stretch_frames"]
    if spent <= 0 or need <= 0:
        return None
    return 100.0 * need / spent
