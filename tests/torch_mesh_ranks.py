"""Rank programs of the port's multi-rank tests (tests/test_torch_mesh.py,
tests/test_torch_mesh_stream_ring.py, tests/test_torch_train_mesh.py,
tests/test_torch_pipeline.py).

``launch`` runs one function on ``world`` spawned processes joined in a gloo
group on a file store under the test's temporary directory (no TCP port, so
parallel test workers cannot collide), each with one CPU thread; the group's
collectives time out after GROUP_TIMEOUT and the parent stops waiting after
``timeout``. The parent writes the inputs to a file, each rank writes its
result beside it. This module imports neither JAX nor the JAX package: the
parent computes the JAX side.
"""

from __future__ import annotations

import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

GROUP_TIMEOUT = timedelta(seconds=60)


def launch(fn, world: int, tmp_path: Path, payload, timeout: float = 120.0) -> list:
    """Run ``fn(rank, world, payload)`` on ``world`` spawned ranks; return
    their results in rank order."""
    import torch.multiprocessing as mp

    tmp_path = Path(tmp_path)
    torch.save(payload, tmp_path / "payload.pt")
    ctx = mp.start_processes(_entry, args=(world, str(tmp_path), fn.__name__), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {world} ranks took over {timeout} s")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, out_dir: str, name: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    try:
        payload = torch.load(Path(out_dir) / "payload.pt", weights_only=False)
        result = globals()[name](rank, world, payload)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# --- pipelines across processes --------------------------------------------------


def pipeline_payload(pipe) -> dict:
    """What a rank needs to rebuild ``pipe`` (a CPU DiffusionPipeline),
    with the text encodings it has cached: the tiny tokenizer hashes words
    with Python's per-process ``hash``, so a rank encodes a prompt as the
    parent did only from the parent's cache."""
    return dict(unet=pipe.unet.config, vae=pipe.vae.config, clip=pipe.clip.config,
                unet_params=pipe.unet_params, vae_params=pipe.vae_params,
                clip_params=pipe.clip_params, config=pipe.config,
                prediction=pipe.model_sampling.prediction,
                controlnets=[(p, spec) for _, p, spec in pipe.controlnets],
                cond_cache=dict(pipe._cond_cache))


def pipeline_from_payload(d: dict):
    from stable_renderer_tpu_torch.engine.pipeline import DiffusionPipeline
    from stable_renderer_tpu_torch.models.clip import CLIPTextModel, Tokenizer
    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.models.vae import VAE

    pipe = DiffusionPipeline(
        unet=UNetModel(d["unet"]), vae=VAE(d["vae"]), clip=CLIPTextModel(d["clip"]),
        tokenizer=Tokenizer(d["clip"]), unet_params=d["unet_params"],
        vae_params=d["vae_params"], clip_params=d["clip_params"], config=d["config"],
        model_sampling=ModelSampling(prediction=d["prediction"]), device="cpu")
    for params, spec in d["controlnets"]:
        pipe.add_controlnet(params, spec)
    pipe._cond_cache.update(d["cond_cache"])
    return pipe


def _mesh(shape: dict):
    from stable_renderer_tpu_torch.parallel import create_mesh, init_distributed

    assert init_distributed("cpu") == torch.device("cpu")  # the group is up: kept
    return create_mesh(shape)


# --- rank programs -----------------------------------------------------------------


def rank_tp(rank: int, world: int, d: dict) -> dict:
    """Tensor parallelism on {"dp": 1, "tp": world}: the UNet and a
    ControlNet forward, the tp-only render and compute_params' cache; the
    UNet with a post hook that mixes heads, and a denoiser with SAG over a
    model patch's attn_all (hooks that see every head)."""
    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.models.controlnet import ControlNet, ControlNetConfig
    from stable_renderer_tpu_torch.models.unet import AttnHooks
    from stable_renderer_tpu_torch.parallel import apply_param_sharding, create_mesh
    from stable_renderer_tpu_torch.parallel.mesh import frame_sharding, tp_context

    out = {}
    try:
        create_mesh({"dp": world + 1, "tp": 1})
    except ValueError as e:
        out["cover_error"] = str(e)
    mesh = _mesh({"dp": 1, "tp": world})
    tp = frame_sharding(mesh, "tp")
    pipe = pipeline_from_payload(d["pipe"])
    x, t, ctx = d["x"], d["t"], d["ctx"]
    local = apply_param_sharding(pipe.unet_params, mesh)
    with torch.no_grad(), tp_context(tp):
        out["unet"] = pipe.unet.apply(local, x, t, ctx)
        cn = ControlNet(ControlNetConfig(unet=pipe.unet.config))
        ctl = cn.apply(apply_param_sharding(d["cn_params"], mesh), x, d["hint"], t, ctx)
    out["control"] = [r for k in sorted(ctl) for r in ctl[k] if r is not None]
    out["q_rows"] = local["input_blocks"]["1"]["1"]["transformer_blocks"]["0"]["attn1"][
        "to_q"]["weight"].shape[0]
    ed = EngineData(**d["ed"])
    out["render"] = pipe.render(ed, key=torch.Generator().manual_seed(3), mesh=mesh)
    u1, _ = pipe._tp_params(mesh, "tp")
    u2, _ = pipe._tp_params(mesh, "tp")
    pipe.unet_params = dict(pipe.unet_params)
    u3, _ = pipe._tp_params(mesh, "tp")
    out["cache"] = (u1 is u2, u3 is not u1)
    from stable_renderer_tpu_torch.models.sampling.cfg import make_denoiser

    den = make_denoiser(pipe.unet, local, d["cond"], d["uncond"], d["log_sigmas"],
                        cfg_scale=2.0, hooks=AttnHooks(attn_all=half_keys_attn_all),
                        sag=d["sag"])
    with tp_context(tp), torch.no_grad():
        out["post"] = pipe.unet.apply(local, x, t, ctx, hooks=AttnHooks(post=mix_heads_post))
        out["sag_attn_all"] = den(d["x_sag"], d["sigma"])
    return out


def mix_heads_post(vals, layer):
    """A post hook that mixes the heads (each column with its mirror)."""
    return vals + (0.1 + 0.05 * layer) * vals.flip(-1)


def half_keys_attn_all(q, k, v, heads, layer):
    """A model patch's attn_all: attention with the keys halved."""
    from stable_renderer_tpu_torch.models.layers import attention

    return attention(q, k * 0.5, v, heads)


def rank_render(rank: int, world: int, d: dict) -> dict:
    """``render(mesh=...)`` of one EngineData under each case's mesh shape
    and corresponder; the frames every rank returns."""
    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    pipe = pipeline_from_payload(d["pipe"])
    ed = EngineData(**d["ed"])
    out = {}
    meshes = {}
    for name, shape, corr_kw, own_mesh in d["cases"]:
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = _mesh(shape)
        mesh = meshes[key]
        corr = OverlapCorresponder(**corr_kw, mesh=mesh if own_mesh else None)
        out[name] = pipe.render(ed, corresponder=corr, key=torch.Generator().manual_seed(3),
                                mesh=mesh)
    from stable_renderer_tpu_torch.parallel import shard_engine_data

    local = shard_engine_data(ed, meshes[(("dp", world), ("tp", 1))])
    out["local_frames"] = (local.frame_indices, local.color_maps, local.pos_maps,
                           local.env_prompts)
    return out


def rank_stream(rank: int, world: int, d: dict) -> dict:
    """Stream frames under each case's stream mesh (``enable_stream_mesh``;
    ``late``: after the first frame): the images, this rank's final state
    and captured contexts."""
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder

    out = {}
    meshes = {}
    for case in d["cases"]:
        pipe = pipeline_from_payload(d["pipes"][case["pipe"]])
        key = tuple(case["shape"].items())
        if key not in meshes:
            meshes[key] = _mesh(case["shape"])
        corr = None if case["corr"] is None else OverlapCorresponder(**case["corr"])
        late = 1 if case["late"] else 0
        if not late:
            pipe.enable_stream_mesh(meshes[key])
        out[case["name"]] = run_stream(pipe, d["frames"], corr, (late, meshes[key]))
        out[case["name"]]["version"] = pipe.stream_version
    return out


def run_stream(pipe, frames: list, corr, enable_at=None) -> dict:
    """``_render_stream`` over ``frames`` (dicts of color, noise, id, hints
    and the LCM draw), carrying state and K/V; ``enable_at`` = (frame, mesh)
    enables the stream mesh before that frame."""
    _, ctx, nctx, _, _ = pipe.prepare_conditioning({}, (), 1)
    state = kv = None
    images = []
    for i, f in enumerate(frames):
        if enable_at is not None and enable_at[0] == i and i > 0:
            pipe.enable_stream_mesh(enable_at[1])
        unet_p, cn_p = pipe.stream_params()
        img, state, kv = pipe._render_stream(
            unet_p, pipe.vae_params, f["color"], f["noise"], f["id"], state,
            pipe.scheduler_sigmas(), None, ctx, nctx, stream_init=i == 0, kv_state=kv,
            cn_params=cn_p, hints=f["hints"] if pipe.controlnets else None,
            corresponder=corr, step_noise=f["draw"])
        images.append(img)
    return {"images": images, "state": state, "kv": kv}


def rank_ring_corrmap(rank: int, world: int, d: dict) -> dict:
    """Ring attention over each case's frame axis, the all-frames
    corresponder in a render, and the sharded CorrespondMap update."""
    from stable_renderer_tpu_torch.data.corrmap import CorrespondMap
    from stable_renderer_tpu_torch.data.engine_data import EngineData
    from stable_renderer_tpu_torch.ops.correspondence import OverlapCorresponder
    from stable_renderer_tpu_torch.parallel import ring_cross_frame_attention
    from stable_renderer_tpu_torch.parallel.mesh import frame_sharding

    out = {"ring": {}, "corrmap": {}}
    meshes = {k: _mesh(dict(k)) for k in ((("dp", world), ("tp", 1)), (("dp", 2), ("tp", 2)))}
    for name, (q, k, v, heads, mesh_key) in d["ring"].items():
        mesh = meshes[mesh_key]
        shard = frame_sharding(mesh, "dp")
        local = ring_cross_frame_attention(shard.take(q), shard.take(k), shard.take(v), heads,
                                           mesh)
        out["ring"][name] = shard.gather(local)
    mesh = meshes[(("dp", world), ("tp", 1))]
    pipe = pipeline_from_payload(d["pipe"])
    corr = OverlapCorresponder(all_frames=True, layer_range=None, update_corrmap=False,
                               mesh=mesh)
    out["all_frames"] = pipe.render(EngineData(**d["ed"]), corresponder=corr,
                                    key=torch.Generator().manual_seed(3), mesh=mesh)
    # the corresponder's mesh without a render mesh: the whole batch on every rank
    out["all_frames_own"] = pipe.render(EngineData(**d["ed"]), corresponder=corr,
                                        key=torch.Generator().manual_seed(3))
    cm = d["corrmap"]
    for mode in ("first", "first_avg", "replace", "replace_avg"):
        for masked in (False, True):
            m = CorrespondMap(k=3, height=8, width=8, device="cpu")
            m.update(cm["pre_colors"], cm["ids"][:1], spriteID=1, materialID=1, mode="replace")
            m.update_batch(cm["colors"], cm["ids"], mesh, spriteID=1, materialID=1, mode=mode,
                           masks=cm["masks"] if masked else None)
            out["corrmap"][(mode, masked)] = (m.values, m.written)
    return out



# --- training and the pipelines (ROADMAP 1.14b) ------------------------------------------


def rank_train(rank: int, world: int, d: dict) -> dict:
    """``diffusion_train_step`` on ``d["shape"]``'s mesh for each case
    (name, remat, backward): the rank's params after the steps, the losses,
    the step and the calls of K1's plain backward, which ``"noop"`` swaps
    for one that returns zero gradients (and still counts its calls). The
    level-0 self-attention takes FlashAttentionFn (``d["min_kv"]``)."""
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.ops import flash_attention as fa
    from stable_renderer_tpu_torch.parallel import apply_param_sharding
    from stable_renderer_tpu_torch.parallel.train import diffusion_train_step, make_train_state

    calls = []
    plain = fa.attention_grad_reference

    def counted(*a):
        calls.append(a[0].shape)
        return plain(*a)

    def noop(q, k, v, dout):
        calls.append(q.shape)
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    fa.FLASH_MIN_KV_LEN = d["min_kv"]
    mesh = _mesh(d["shape"])
    unet = UNetModel(d["config"])
    out = {}
    for name, remat, backward in d["cases"]:
        fa.attention_grad_reference = counted if backward == "plain" else noop
        calls.clear()
        st, opt = make_train_state(unet, apply_param_sharding(d["params"], mesh),
                                   learning_rate=d["lr"])
        losses = []
        for t, eps in d["draws"]:
            st, loss = diffusion_train_step(unet, opt, st, d["sigmas"], d["latents"],
                                            d["context"], t, eps, remat=remat, mesh=mesh)
            losses.append(float(loss))
        out[name] = {"params": st.params, "losses": losses, "step": st.step,
                     "grad_calls": len(calls)}
    return out


def mlp_stage(p, x):
    """tests/test_pipeline_parallel.py's stage: tanh(x w + b) + x."""
    return torch.tanh(x @ p["w"] + p["b"]) + x


def pytree_stage(p, act):
    x, skip = act
    return torch.tanh(x @ p["w"] + p["b"]) + skip, skip + 1.0


def rank_pipeline(rank: int, world: int, d: dict) -> dict:
    """Each case (name, kind, mesh shape, inputs, keyword arguments) through
    pipeline_apply / clip_pipeline_encode / unet_middle_pipeline on its
    mesh; a case that raises ValueError gives its message."""
    from stable_renderer_tpu_torch.models.clip import CLIPTextModel
    from stable_renderer_tpu_torch.models.unet import UNetModel
    from stable_renderer_tpu_torch.parallel.pipeline import (
        clip_pipeline_encode,
        pipeline_apply,
        stack_stage_params,
        unet_middle_pipeline,
    )

    meshes, out = {}, {}
    for name, kind, shape, a, kw in d["cases"]:
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = _mesh(shape)
        mesh = meshes[key]
        try:
            if kind in ("mlp", "pytree"):
                out[name] = pipeline_apply(mlp_stage if kind == "mlp" else pytree_stage,
                                           stack_stage_params(a["stages"]), a["x"], mesh, **kw)
            elif kind == "clip":
                out[name] = clip_pipeline_encode(CLIPTextModel(a["config"]), a["params"],
                                                 a["tokens"], mesh, **kw)
            else:
                out[name] = unet_middle_pipeline(UNetModel(a["config"]), a["params"], a["h"],
                                                 a["emb"], a["ctx"], mesh, **kw)
        except ValueError as e:
            out[name] = str(e)
    return out
