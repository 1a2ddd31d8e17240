"""bench.py's default mode on the CPU at tiny widths: the stream frame
through both packages' ``Engine.Run`` (the port's ``frame_step`` stream
branch and the engine's ``_stream_state`` / ``_stream_kv``), and the int8
stream frame against the JAX package's. The helpers, and how randomness is
handed across, are tests/test_torch_stream.py's.
"""

from __future__ import annotations

import numpy as np
import torch
from test_torch_stream import TOL, _jax_stream_draws, _pipelines, _run_streams

torch.set_num_threads(1)


def test_engine_run_stream_matches_jax(monkeypatch):
    """Three frames of the bench scene through both engines in stream mode,
    with a perturbed ControlNet on the normal map: the port's ``frame_step``
    takes its stream branch (``stream_init`` on the first frame only), the
    decoded frames match at the f32 bar, and ``_stream_state`` /
    ``_stream_kv`` carried over the three frames match the JAX engine's
    (the ids exactly, the hints at the pack bar)."""
    import stable_renderer_tpu.engine as J
    import stable_renderer_tpu_torch.engine as P
    from test_torch_engine import SIZE as ESIZE, _np, _run

    from stable_renderer_tpu.ops.correspondence import OverlapCorresponder as JOverlap
    from stable_renderer_tpu_torch.engine import frame_program
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    J.Engine._reset()
    P.Engine._reset()
    jpipe, pipe = _pipelines("lcm", True)
    corr_kw = dict(vertex_segments=ESIZE * ESIZE, update_corrmap=False)
    jeng, jrec = _run(J, pipeline=jpipe, corresponder=JOverlap(**corr_kw))
    bg = _np(jeng.RenderManager.GlobalBGNoise)

    port_step = frame_program.frame_step
    calls = []

    def with_jax_draws(*args, **kwargs):
        frame = P.Engine.Instance().RuntimeManager.FrameCount
        calls.append((kwargs["stream_init"], kwargs["stream_state"] is None))
        key = np.array([0, (pipe.config.seed + frame) & 0xFFFFFFFF], np.uint32)
        kwargs["step_noise"] = _jax_stream_draws(key, (4, ESIZE // 2, ESIZE // 2, 4))
        return port_step(*args, **kwargs)

    monkeypatch.setattr(frame_program, "frame_step", with_jax_draws)

    def set_bg(eng):
        eng.RenderManager._bg_noise = torch.from_numpy(bg.copy())

    eng, rec = _run(P, pipeline=pipe, before_run=set_bg,
                    corresponder=OverlapCorresponder(**corr_kw))
    J.Engine._reset()
    P.Engine._reset()
    assert calls == [(True, True), (False, False), (False, False)]
    assert len(rec["images"]) == len(jrec["images"]) == 3
    for f in range(3):
        np.testing.assert_array_equal(rec["ids"][f], jrec["ids"][f], err_msg=f"frame {f}")
        np.testing.assert_allclose(rec["images"][f], jrec["images"][f], err_msg=f"frame {f}",
                                   **TOL)
    state, jstate = eng.RenderManager._stream_state, jeng.RenderManager._stream_state
    np.testing.assert_allclose(state["x"].numpy(), np.asarray(jstate["x"]), **TOL)
    # the hints are the G-buffer's normals, which the packages shade to
    # within f32 rounding (tests/test_torch_frame.py's pack bar); the ids
    # are exact
    np.testing.assert_allclose(state["hints"][0].numpy(), np.asarray(jstate["hints"][0]), **TOL)
    np.testing.assert_array_equal(state["ids"].numpy(), np.asarray(jstate["ids"]))
    kv, jkv = eng.RenderManager._stream_kv, jeng.RenderManager._stream_kv
    assert sorted(kv) == sorted(jkv) == ["2"]
    np.testing.assert_allclose(kv["2"].numpy(), np.asarray(jkv["2"]), **TOL)


def test_int8_stream_frame_matches_jax():
    """The int8 stream frame (bench.py's default mode: stream, lag-1 K/V,
    calibrated int8 convs) at the bars of tests/test_torch_frame.py's
    ``test_int8_frame_step_matches_jax``: the port's int8 frame lies at most
    half as far from the JAX int8 frame (mean abs on [0, 1] pixels) as the
    same pipeline's float frame does."""
    from dataclasses import replace

    jpipe, pipe = _pipelines("lcm", False, int8=True)
    assert "weight_q" in pipe.unet_params["input_blocks"]["1"]["0"]["in_layers"]["2"]
    _, cn_pipe = _pipelines("lcm", True)  # the same float weights (seed 0)
    float_pipe = replace(cn_pipe, controlnets=[])
    (_, (img, _, _), (jimg, _, _)), = _run_streams(jpipe, pipe, False, frames=1)
    (_, (fimg, _, _), _), = _run_streams(jpipe, float_pipe, False, frames=1)
    assert np.isfinite(img.numpy()).all()
    err = np.abs(img.numpy() - np.asarray(jimg)).mean()
    quant_effect = np.abs(fimg.numpy() - np.asarray(jimg)).mean()
    assert err <= 0.5 * quant_effect, (err, quant_effect)
