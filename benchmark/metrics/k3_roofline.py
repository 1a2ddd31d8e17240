"""K3's share of its roofline over the calibrated int8 3x3 convs: the least
time of the frames' int8 convs that the int8 path sends to K3 (operations
over 1979e12 int8 OP/s, bytes over 3.35e12 B/s: the activation in its type
read once, the int8 weights read once, the output written once) over the
device time of the ``conv3x3`` kernels in the profiled stretch, %."""

import re

PEAK_INT8 = 1979e12
HBM = 3.35e12
NAMES = re.compile(r"conv3x3")


def least_seconds(work) -> float:
    from benchmark.reference.flops import int8_k3_convs

    t = 0.0
    for n, h, w, cin, cout, kh, kw, stride, pad, eb, path, k in int8_k3_convs(work):
        ops = 2.0 * n * h * w * cin * cout * kh * kw
        nbytes = n * h * w * (cin + cout) * eb + kh * kw * cin * cout
        t += max(ops / PEAK_INT8, nbytes / HBM) * k
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
