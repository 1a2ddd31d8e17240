"""The reference held against the port's plain CPU path at tiny widths.

On the CPU the port's kernel wrappers take their plain versions, so the
program and the frozen copy compute the same frames bit for bit: each tiny
twin of a cell must read 0 on every number compared. This test may import
the port; the reference itself imports nothing of it.

    python -m pytest benchmark/tests -q
"""

import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness.weights import make_weights  # noqa: E402
from benchmark.tests.tiny import TINY_SD, TINY_XL, tiny_cell  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell_name,config", [
    ("sd15-stream-512", TINY_SD),
    ("sdxl-1024-seq", TINY_XL),
])
def test_tiny_cell_matches_the_port_bit_for_bit(cell_name, config):
    cell = tiny_cell(cell_name, config)
    line = cells.run_cell(cell, 2**31 + 12345, 2.0, False, CPU, time.perf_counter())
    assert line["checks"] and all(c["value"] == 0.0 for c in line["checks"].values())
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert line["metrics"]["frames_per_s"]["value"] > 0


def test_int8_stream_matches_the_port():
    """The calibrated int8 path: both sides calibrate from the same trees."""
    cell = tiny_cell("sd15-stream-512", TINY_SD, size=(128, 128))
    line = cells.run_cell(cell, 77, 6.0, False, CPU, time.perf_counter())
    assert line["checks"] and all(c["value"] == 0.0 for c in line["checks"].values())


def test_weights_have_the_ports_layout_and_scales():
    from stable_renderer_tpu_torch.models.unet import UNetConfig, UNetModel

    w = make_weights(TINY_SD, 5, CPU)
    port = UNetModel(UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in TINY_SD["unet"].items()}))
    ref = port.init(torch.Generator().manual_seed(5))

    def flat(t, p=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, p + (k,))
        else:
            yield p, t

    ours, theirs = dict(flat(w["unet"])), dict(flat(ref))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        a, b = ours[k].float().std().item(), theirs[k].float().std().item()
        if ours[k].numel() > 256:
            assert a == pytest.approx(b, rel=0.2, abs=1e-6), k
    assert torch.equal(make_weights(TINY_SD, 5, CPU)["unet"]["out"]["2"]["weight"],
                       w["unet"]["out"]["2"]["weight"])


def test_frame_work_counts_the_cfg_batch_and_the_vae():
    from benchmark.reference.flops import count_frame
    from benchmark.reference.programs import build_towers

    seq = tiny_cell("sdxl-1024-seq", TINY_SD).traffic
    stream = tiny_cell("sd15-stream-512", TINY_SD).traffic
    w_seq = count_frame(build_towers(TINY_SD), TINY_SD, seq)
    w_stream = count_frame(build_towers(TINY_SD), TINY_SD, stream)
    # 4 evaluations of batch 2 against one of batch 8: the same UNet work
    assert w_seq.flops == pytest.approx(w_stream.flops, rel=1e-6)
    unet_seq = [a for a in w_seq.attention if a[0] == 2]
    unet_stream = [a for a in w_stream.attention if a[0] == 8]
    assert unet_stream and len(unet_seq) == 4 * len(unet_stream)
    assert any(c[-2].startswith("vae.") for c in w_seq.convs)
