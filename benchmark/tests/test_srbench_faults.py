"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a run (the harness's look for a card skipped:
the tiny twins of the cells run on the CPU, where the sound program and the
reference agree bit for bit) with one fault planted in the port, and the
cell's own limits must call the run wrong. The faults a frame cell can have:
a step that returns its state unchanged, half of the batch left out, and an
answer altered where it is produced. No cell runs on more than one chip, so
no exchange between chips can be left out.

    python -m pytest benchmark/tests -q
"""

import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.tests.tiny import TINY_SD, TINY_XL, tiny_cell  # noqa: E402

CELLS = [("sd15-stream-512", TINY_SD), ("sdxl-1024-seq", TINY_XL)]


def state_unchanged(monkeypatch):
    """The stream's frame returns the state it was given; the sequential
    denoise loop returns its starting latent."""
    from stable_renderer_tpu_torch.engine import pipeline

    real_stream = pipeline.DiffusionPipeline._render_stream

    def stale(self, *a, **kw):
        image, new_state, kv = real_stream(self, *a, **kw)
        state = a[5] if len(a) > 5 else kw.get("state")
        return image, (new_state if state is None else state), kv

    def no_step(den, noise, sigmas, latent_image=None, **kw):
        return latent_image + noise * sigmas[0]

    monkeypatch.setattr(pipeline.DiffusionPipeline, "_render_stream", stale)
    monkeypatch.setattr(pipeline, "sample", no_step)


def half_batch(monkeypatch):
    """The UNet evaluates the first half of its batch and leaves the rest
    out (zeros)."""
    from stable_renderer_tpu_torch.models import unet

    real = unet.UNetModel.apply

    def half(self, params, x, t, context, y=None, *a, **kw):
        n = x.shape[0] // 2
        out = real(self, params, x[:n], t[:n], context[:n], None if y is None else y[:n],
                   *a, **kw)
        return torch.cat([out, torch.zeros_like(out)], 0)

    monkeypatch.setattr(unet.UNetModel, "apply", half)


def answer_altered(monkeypatch):
    """The presented frame is brightened by 32 levels where it is made."""
    from stable_renderer_tpu_torch.engine import frame_program

    real = frame_program.display_to_uint8

    def brighter(display):
        return real(display + 32.0 / 255.0)

    monkeypatch.setattr(frame_program, "display_to_uint8", brighter)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered])
@pytest.mark.parametrize("cell_name,config", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, cell_name, config):
    fault(monkeypatch)
    cell = tiny_cell(cell_name, config)
    line = cells.run_cell(cell, 2**31 + 99, 2.0, False, torch.device("cpu"),
                          time.perf_counter())
    assert line["correct"] is False, line["checks"]
