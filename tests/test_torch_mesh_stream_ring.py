"""The stream mesh, ring attention and the sharded CorrespondMap update of
the port (stable_renderer_tpu_torch/parallel/) against its one-process
forms and the JAX package's, on spawned gloo ranks (see
tests/test_torch_mesh.py, whose helpers this file shares).

Tolerances: the mesh stream against the port's one-process stream 3e-4 and
the JAX package's 2e-4 (tests/test_torch_stream.py's f32 bar), the ring
2e-5 (tests/test_ring_attention.py's), the all-frames denoise 5e-4 (its
dense-vs-ring bar); the sharded map's ``written`` exactly and its values
2e-6 (tests/test_corrmap_sharded.py's).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP
from test_torch_mesh import JAX_TOL, MESH_TOL, SIZE, _batch, _engine_data, _jax_mesh, _pipes
from torch_mesh_ranks import launch, pipeline_payload, rank_ring_corrmap, rank_stream

torch.set_num_threads(1)


# --- the stream mesh, 4 ranks -------------------------------------------------------------


def test_stream_mesh_matches_one_process_and_jax(tmp_path):
    """tests/test_stream_multichip.py's cases on the port: the stream's 4
    stages over dp 2 x tp 2 (two stages and half the heads a rank) and dp 4
    (one stage a rank), 3 frames each. "rich" is the LCM stream with lag-1
    K/V, a perturbed ControlNet on the normal map riding the state and the
    vertex averaging over the in-flight rows; "plain" the Euler stream with
    lag-1 K/V; "late" enables the mesh after the first frame, whose state
    holds every stage. Images on every rank within the bars of the port's
    one-process stream and of the JAX package's (whose mesh stream equals
    its one-device stream, tests/test_stream_multichip.py); each rank's
    state and K/V its rows of the one-process ones."""
    from test_torch_stream import _frame_inputs, _jax_stream_draws, _pipelines, _run_streams

    cases, pipes, frames, single, jax_out = [], {}, None, {}, {}
    for name, sampler, riding in (("rich", "lcm", True), ("plain", "euler", False)):
        jpipe, pipe = _pipelines(sampler, riding)
        single[name], jax_out[name] = [], []
        for f, port, jx in _run_streams(jpipe, pipe, riding):
            single[name].append(port)
            jax_out[name].append(np.asarray(jx[0]))
        pipes[name] = pipeline_payload(pipe)
    frames = []
    for f in range(3):
        inp = _frame_inputs(f)
        frames.append(dict(
            color=torch.from_numpy(inp["color"]), noise=torch.from_numpy(inp["noise"]),
            id=torch.from_numpy(inp["id"]), hints=(torch.from_numpy(inp["normal"]),),
            draw=_jax_stream_draws(np.array([0, 7 + f], np.uint32), (4, SIZE // 2, SIZE // 2, 4))))
    corr = dict(vertex_segments=64, update_corrmap=False)
    cases = [dict(name="rich dp2tp2", pipe="rich", shape={"dp": 2, "tp": 2}, corr=corr, late=False),
             dict(name="rich dp4", pipe="rich", shape={"dp": 4, "tp": 1}, corr=corr, late=False),
             dict(name="plain dp2tp2", pipe="plain", shape={"dp": 2, "tp": 2}, corr=None,
                  late=False),
             dict(name="plain late dp4", pipe="plain", shape={"dp": 4, "tp": 1}, corr=None,
                  late=True)]
    outs = launch(rank_stream, 4, tmp_path, dict(pipes=pipes, frames=frames, cases=cases))
    for case in cases:
        name, ref, jref = case["name"], single[case["pipe"]], jax_out[case["pipe"]]
        dp = case["shape"]["dp"]
        for r, o in enumerate(outs):
            got = o[name]
            assert got["version"] == 1
            for f in range(3):
                np.testing.assert_allclose(got["images"][f].numpy(), ref[f][0].numpy(),
                                           err_msg=f"{name} frame {f}", **MESH_TOL)
                np.testing.assert_allclose(got["images"][f].numpy(), jref[f],
                                           err_msg=f"{name} frame {f}", **JAX_TOL)
            d = r // (4 // dp)  # the dp index of rank r on the ("dp", "tp") grid
            rows = slice(d * 4 // dp, (d + 1) * 4 // dp)
            state, ref_state = got["state"], ref[-1][1]
            if case["pipe"] == "rich":
                np.testing.assert_array_equal(state["ids"].numpy(), ref_state["ids"][rows].numpy())
                np.testing.assert_array_equal(state["hints"][0].numpy(),
                                              ref_state["hints"][0][rows].numpy())
                state, ref_state = state["x"], ref_state["x"]
            np.testing.assert_allclose(state.numpy(), ref_state[rows].numpy(), err_msg=name,
                                       **MESH_TOL)
            for layer, kv in got["kv"].items():
                np.testing.assert_allclose(kv.numpy(), ref[-1][2][layer][rows].numpy(),
                                           err_msg=name, **MESH_TOL)


# --- the ring and the sharded CorrespondMap update, 4 ranks ----------------------------------


def _corrmap_frames():
    """tests/test_corrmap_sharded.py's frames, from numpy."""
    rng = np.random.default_rng(1)
    b, h, w, m, bins = 8, 16, 16, 64, 9
    ids = np.stack([np.ones((b, h, w), np.int32), np.ones((b, h, w), np.int32),
                    rng.integers(0, bins, (b, h, w)).astype(np.int32),
                    rng.integers(0, m, (b, h, w)).astype(np.int32)], -1)
    ids[:, 0, 0] = [0, 0, -1, 999999]  # invalid pixels: background, out of range
    return dict(colors=rng.random((b, h, w, 3)).astype(np.float32), ids=ids,
                masks=(rng.random((b, h, w)) > 0.5).astype(np.float32),
                pre_colors=np.full((1, h, w, 3), 0.25, np.float32))


def test_ring_all_frames_and_sharded_corrmap(tmp_path):
    """The ring over dp 4 (one and two frames a rank) and dp 2 (two frames a
    rank) against JAX's ring on its mesh and the dense form; the all-frames
    corresponder in a render over dp 4 (the ring at every self-attention)
    against the port's dense one-process render, also with the
    corresponder's mesh and no render mesh; the sharded CorrespondMap
    update, four modes with and without masks, against JAX's
    corrmap_update_sharded over 8 devices and the port's sequential loop."""
    from stable_renderer_tpu.data.corrmap import CorrespondMap as JMap, corrmap_update_sharded
    from stable_renderer_tpu.parallel.ring_attention import (
        cross_frame_attention as jdense,
        ring_cross_frame_attention as jring,
    )
    from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.parallel import cross_frame_attention

    ring_in, ring_ref = {}, {}
    rng = np.random.default_rng(3)
    for name, n, l, c, heads, key in (("dp4 one a rank", 4, 16, 32, 4, (("dp", 4), ("tp", 1))),
                                      ("dp4 two a rank", 8, 8, 16, 2, (("dp", 4), ("tp", 1))),
                                      ("dp2 two a rank", 4, 8, 16, 2, (("dp", 2), ("tp", 2)))):
        q, k, v = (rng.standard_normal((n, l, c)).astype(np.float32) for _ in range(3))
        jmesh = _jax_mesh({"dp": dict(key)["dp"]})
        put = lambda a: jax.device_put(a, NamedSharding(jmesh, JP("dp")))  # noqa: E731
        ring_ref[name] = np.asarray(jax.jit(lambda a, b_, c_: jring(a, b_, c_, heads, jmesh))(
            put(q), put(k), put(v)))
        dense = cross_frame_attention(*(torch.from_numpy(a) for a in (q, k, v)), heads).numpy()
        np.testing.assert_allclose(dense, np.asarray(jdense(q, k, v, heads)), atol=1e-5)
        np.testing.assert_allclose(ring_ref[name], dense, atol=2e-5)
        ring_in[name] = (*(torch.from_numpy(a) for a in (q, k, v)), heads, key)

    _, pipe = _pipes()
    arrays = _batch(with_ids=False)
    _, ed = _engine_data(arrays)
    dense_render = pipe.render(ed, corresponder=OverlapCorresponder(
        all_frames=True, layer_range=None, update_corrmap=False),
        key=torch.Generator().manual_seed(3)).numpy()

    cm = _corrmap_frames()
    jmesh8 = _jax_mesh({"dp": 8})
    seq, jsh = {}, {}
    for mode in ("first", "first_avg", "replace", "replace_avg"):
        # jitted: eager shard_map runs op by op over the 8 devices
        sharded = jax.jit(lambda v, w, c, i, msk, mode=mode: corrmap_update_sharded(
            v, w, c, i, jmesh8, mode=mode, masks=msk, sprite_id=1, material_id=1, num_bins=9))
        for masked in (False, True):
            m = CorrespondMap(k=3, height=8, width=8, device="cpu")
            m.update(torch.from_numpy(cm["pre_colors"]), torch.from_numpy(cm["ids"][:1]),
                     spriteID=1, materialID=1, mode="replace")
            jm = JMap(k=3, height=8, width=8)
            jm.update(jnp.asarray(cm["pre_colors"]), jnp.asarray(cm["ids"][:1]), spriteID=1,
                      materialID=1, mode="replace")
            masks = torch.from_numpy(cm["masks"]) if masked else None
            jsh[(mode, masked)] = sharded(
                jm.values, jm.written, jnp.asarray(cm["colors"]), jnp.asarray(cm["ids"]),
                None if masks is None else jnp.asarray(cm["masks"]))
            m.update(torch.from_numpy(cm["colors"]), torch.from_numpy(cm["ids"]), spriteID=1,
                     materialID=1, mode=mode, masks=masks)
            seq[(mode, masked)] = (m.values, m.written)

    outs = launch(rank_ring_corrmap, 4, tmp_path, dict(
        ring=ring_in, pipe=pipeline_payload(pipe),
        ed={k: torch.from_numpy(v) for k, v in arrays.items()},
        corrmap={k: torch.from_numpy(v) for k, v in cm.items()}))
    for o in outs:
        for name, ref in ring_ref.items():
            np.testing.assert_allclose(o["ring"][name].numpy(), ref, atol=2e-5, err_msg=name)
        np.testing.assert_allclose(o["all_frames"].numpy(), dense_render, atol=5e-4, rtol=0)
        np.testing.assert_allclose(o["all_frames_own"].numpy(), dense_render, atol=5e-4, rtol=0)
        for key, (vals, writ) in o["corrmap"].items():
            np.testing.assert_array_equal(writ.numpy(), seq[key][1].numpy(), err_msg=str(key))
            np.testing.assert_array_equal(writ.numpy(), np.asarray(jsh[key][1]), err_msg=str(key))
            np.testing.assert_allclose(vals.numpy(), seq[key][0].numpy(), atol=2e-6,
                                       err_msg=str(key))
            np.testing.assert_allclose(vals.numpy(), np.asarray(jsh[key][0]), atol=2e-6,
                                       err_msg=str(key))
    assert outs[0]["corrmap"][("first_avg", True)][1].any()
