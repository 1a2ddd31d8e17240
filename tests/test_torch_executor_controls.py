"""Control files and differential diffusion through both packages'
executors, on the CPU at tiny widths: a ControlNet checkpoint
(``control_model.``), a control-LoRA and a T2I-Adapter file, each behind a
ControlNetLoader and chained by ControlNetApply into one KSampler over the
2-res-block tiny UNet (so the adapter's features land on res blocks), read
by both packages from the same files; and DifferentialDiffusion over a
latent with a soft noise mask. KSampler outputs agree with JAX's, its draws
handed in; f32: TOL."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_control_checkpoints import RANK, _adapter_flat, _controlnet_flat, _flat, _np, _ucfg2
from test_torch_executor import assert_close, graphs, port_config, run_both

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe
from stable_renderer_tpu_torch.models.weights import write_safetensors

torch.set_num_threads(1)

RNG = np.random.default_rng(13)


def _models():
    """The 2-res-block tiny UNet as a MODEL dict in each package, one param
    tree (the port's init, seed 4)."""
    from stable_renderer_tpu.models.sampling import ModelSampling as JMS
    from stable_renderer_tpu.models.unet import UNetModel as JUNet

    from stable_renderer_tpu_torch.models.sampling import ModelSampling
    from stable_renderer_tpu_torch.models.unet import UNetModel

    unet = UNetModel(_ucfg2(False))
    params = unet.init(torch.Generator().manual_seed(4))
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    assert port_config(type(_ucfg2(False)), _ucfg2(True)) == _ucfg2(False)
    return ({"unet": JUNet(_ucfg2(True)), "params": jparams, "sampling": JMS()},
            {"unet": unet, "params": params, "sampling": ModelSampling()})


@pytest.fixture
def sources():
    """_Model (the MODEL pair), _Hints (two hint images) and _Latent nodes."""
    jm, pm = _models()
    hints = [RNG.uniform(size=(1, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    latent = RNG.standard_normal((1, 8, 8, 4)).astype(np.float32)
    soft = RNG.uniform(size=(1, 8, 8)).astype(np.float32)
    for mod, m in ((je, jm), (pe, pm)):
        arr = jnp.asarray if mod is je else (lambda a: torch.from_numpy(a.copy()))
        mod.register_node("_Model")(lambda ctx, node, _m=m: (_m,))
        mod.register_node("_Hints")(lambda ctx, node, _a=arr: tuple(_a(h) for h in hints))
        mod.register_node("_Latent")(lambda ctx, node, _a=arr: (
            {"samples": _a(latent), "noise_mask": _a(soft)},))
    yield pm
    for mod in (je, pe):
        for n in ("_Model", "_Hints", "_Latent"):
            mod.NODE_REGISTRY.pop(n, None)


def _write_control_files(d, unet_params) -> None:
    """cn.safetensors (a perturbed ControlNet under control_model.),
    lora.safetensors (a control-LoRA over two trunk weights, with the
    ControlNet's hint block, zero convs and middle_block_out) and
    adapter.safetensors (a full T2I-Adapter)."""
    cn = _controlnet_flat(6)
    write_safetensors({k: torch.from_numpy(v) for k, v in cn.items()}, d / "cn.safetensors")
    unet = _flat(_np(unet_params))
    lora = {"lora_controlnet": np.zeros((0,), np.float32)}
    for k in ("input_blocks.1.1.proj_in.weight", "middle_block.0.in_layers.2.weight"):
        w = unet[k]
        lora[k[: -len(".weight")] + ".up"] = (
            RNG.standard_normal((w.shape[0], RANK)) * 0.05).astype(np.float32)
        lora[k[: -len(".weight")] + ".down"] = (
            RNG.standard_normal((RANK,) + w.shape[1:]) * 0.05).astype(np.float32)
    lora.update({k[len("control_model."):]: v for k, v in _controlnet_flat(7).items()
                 if k.startswith(("control_model.zero_convs", "control_model.input_hint_block",
                                  "control_model.middle_block_out"))})
    write_safetensors({k: torch.from_numpy(v) for k, v in lora.items()}, d / "lora.safetensors")
    write_safetensors({k: torch.from_numpy(np.asarray(v, np.float32))
                       for k, v in _adapter_flat().items()}, d / "adapter.safetensors")


def _sampler(nid, model, positive, latent, widgets=(3, "fixed", 3, 2.5, "lcm", "sgm_uniform",
                                                     1.0)):
    return (nid, "KSampler", list(widgets), {"model": model, "positive": positive,
                                             "negative": (3, 0), "latent_image": latent})


def test_control_files_chained_match_jax(monkeypatch, tmp_path, sources):
    _write_control_files(tmp_path, sources["params"])
    spec = [(1, "CheckpointLoaderSimple", ["missing.safetensors"], {}),
            (2, "CLIPTextEncode", ["a red boat"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
            (4, "_Model", [], {}), (5, "_Hints", [], {}), (6, "_Latent", [], {}),
            (7, "ControlNetLoader", ["cn.safetensors"], {}),
            (8, "ControlNetLoader", ["lora.safetensors"], {}),
            (9, "ControlNetLoader", ["adapter.safetensors"], {}),
            (10, "ControlNetApply", [0.8], {"conditioning": (2, 0), "control_net": (7, 0),
                                            "image": (5, 0)}),
            (11, "ControlNetApplyAdvanced", [0.6, 0.0, 0.7],
             {"positive": (10, 0), "negative": (3, 0), "control_net": (8, 0), "image": (5, 1)}),
            (12, "ControlNetApply", [0.9], {"conditioning": (11, 0), "control_net": (9, 0),
                                            "image": (5, 0)}),
            _sampler(20, (4, 0), (12, 0), (6, 0))]
    jctx, pctx, _, _ = run_both(spec, monkeypatch, seeds=(3,), model_dirs=(tmp_path,))
    assert len(pctx.outputs[12][0]["controls"]) == 3
    assert_close(pctx.outputs[20][0], jctx.outputs[20][0])
    for drop in (10, 11, 12):  # each control moved the output
        rows = [r for r in spec if r[0] != drop]
        up = {10: (2, 0), 11: (10, 0), 12: (11, 0)}[drop]
        rows = [(i, t, w, {k: (up if v == (drop, 0) else v) for k, v in inp.items()})
                for i, t, w, inp in rows]
        _, pwf = graphs(rows)
        ex = pe.PromptExecutor(pwf, model_dirs=(str(tmp_path),), device="cpu")
        ex._cache[1] = pctx.outputs[1]
        moved = ex.execute().outputs[20][0]["samples"] - pctx.outputs[20][0]["samples"]
        assert float(moved.abs().max()) > 1e-4, drop


def test_differential_diffusion_matches_jax(monkeypatch, sources):
    """DifferentialDiffusion thresholds the latent's soft noise mask by the
    step's timestep, in the plain CFG path's mask and the inpaint keep."""
    spec = [(1, "CheckpointLoaderSimple", ["missing.safetensors"], {}),
            (2, "CLIPTextEncode", ["a red boat"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
            (4, "_Model", [], {}), (6, "_Latent", [], {}),
            (7, "DifferentialDiffusion", [], {"model": (4, 0)}),
            _sampler(20, (7, 0), (2, 0), (6, 0),
                     (3, "fixed", 4, 3.0, "euler", "normal", 1.0))]
    jctx, pctx, _, pex = run_both(spec, monkeypatch, seeds=(3,))
    assert_close(pctx.outputs[20][0], jctx.outputs[20][0])
    rows = [r for r in spec if r[0] != 7]
    rows = [(i, t, w, {**inp, "model": (4, 0)} if t == "KSampler" else inp)
            for i, t, w, inp in rows]
    _, pwf = graphs(rows)
    ex = pe.PromptExecutor(pwf, device="cpu")
    ex._cache[1] = pex._cache[1]
    moved = ex.execute().outputs[20][0]["samples"] - pctx.outputs[20][0]["samples"]
    assert float(moved.abs().max()) > 1e-3
