"""The model-patch nodes (workflow/nodes_extra.py) through both packages'
executors, on the CPU at tiny widths: FreeU, HyperTile and
SelfAttentionGuidance chained; FreeU_V2, a hypernetwork file and PerpNeg
chained; and TomePatchModel, RescaleCFG, two PatchModelAddDownscale (Deep
Shrink) and VideoLinearCFGGuidance (the linear cfg ramp) chained. Each
KSampler output agrees with JAX's (its draws handed in) and moved from the
unpatched graph's. f32: TOL.

HyperTile's and ToMe's splits come from ``random.Random(hash(sig))``, which
changes with PYTHONHASHSEED from one process to the next; in one process
both packages pick the same splits."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_executor import assert_close, graphs, run_both

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe

torch.set_num_threads(1)

LOADER = (1, "CheckpointLoaderSimple", ["missing.safetensors"], {})
LATENT = np.random.default_rng(4).standard_normal((1, 16, 16, 4)).astype(np.float32)


@pytest.fixture(autouse=True)
def latent_node():
    for mod in (je, pe):
        mod.register_node("_Latent")(lambda ctx, node, _m=mod: ({"samples": (
            jnp.asarray(LATENT) if _m is je else torch.from_numpy(LATENT.copy()))},))
    yield
    for mod in (je, pe):
        mod.NODE_REGISTRY.pop("_Latent", None)


def patched_graph(patches, sampler=("euler_ancestral", "karras", 3, 3.0), batch_latent=None):
    """Loader, prompts, the latent, ``patches`` (rows whose model input is
    the previous model, ids from 10), a KSampler on the last model."""
    name, sched, steps, cfg = sampler
    rows, model = [], (1, 0)
    for i, (ntype, widgets, extra) in enumerate(patches):
        nid = 10 + i
        rows.append((nid, ntype, widgets, {"model": model, **extra}))
        model = (nid, 0)
    return [LOADER,
            (2, "CLIPTextEncode", ["a red boat"], {"clip": (1, 1)}),
            (3, "CLIPTextEncode", ["blurry"], {"clip": (1, 1)}),
            (4, "CLIPTextEncode", [""], {"clip": (1, 1)}),
            (5, "_Latent", [], {}),
            *rows,
            (30, "KSampler", [9, "fixed", steps, cfg, name, sched, 1.0],
             {"model": model, "positive": (2, 0), "negative": (3, 0), "latent_image": (5, 0)})]


def port_rerun(pex, spec_without, monkeypatch):
    """The port's KSampler output for ``spec_without`` with the same loader
    outputs and draws (its loader output copied from ``pex``)."""
    _, pwf = graphs(spec_without)
    ex = pe.PromptExecutor(pwf, device="cpu")
    ex._cache[1] = pex._cache[1]
    return ex.execute().outputs[30][0]["samples"]


def _check(spec, monkeypatch, n_patches):
    jctx, pctx, _, pex = run_both(spec, monkeypatch, seeds=(9,))
    assert_close(pctx.outputs[30][0], jctx.outputs[30][0])
    patched = pctx.outputs[30][0]["samples"]
    assert len(pctx.outputs[10 + n_patches - 1][0]["patches"]) == n_patches
    without = [r for r in spec if not 10 <= r[0] < 30]
    without = [(i, t, w, {**inp, "model": (1, 0)} if t == "KSampler" else inp)
               for i, t, w, inp in without]
    assert float((patched - port_rerun(pex, without, monkeypatch)).abs().max()) > 1e-3


def test_freeu_hypertile_sag_match_jax(monkeypatch):
    spec = patched_graph([("FreeU", [1.3, 1.4, 0.7, 0.5], {}),
                          ("HyperTile", [32, 2, 0, "false"], {}),
                          ("SelfAttentionGuidance", [0.9, 1.5], {})])
    _check(spec, monkeypatch, 3)


# ROADMAP queue 3, fault 3.2: with the hypernetwork's weights at std 0.3 the
# port's and JAX's f32 outputs differ by as much as each differs from the same
# graph in f64 (3.6e-4 to 8.5e-4 over hash seeds 0-3), and the gap does not
# grow over the steps: it is set by the first and flat after it
# (tests/hypernet_drift.py prints the table). That case is held at the
# largest sum of the two drifts measured (1.36e-3), rounded up; every other
# case at TOL.
HYPERNET_STD03_TOL = dict(atol=1.5e-3, rtol=2e-4)


def write_hypernetwork(path, std: float = 0.05) -> None:
    """A tiny A1111-style hypernetwork .pt: per context width, a k-net and a
    v-net of linear -> layer norm -> linear, relu, layer norm on; weights
    and biases N(0, std^2) (small, as a trained hypernetwork's residual MLPs
    have, at 0.05), norm scales 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(8)

    def net(dim):
        t = {}
        for name, shape in (("linear.0", (dim * 2, dim)), ("linear.1", (dim * 2,)),
                            ("linear.2", (dim, dim * 2))):
            t[name + ".weight"] = torch.from_numpy(
                (rng.standard_normal(shape) * (std if len(shape) == 2 else 0.1)
                 + (1.0 if len(shape) == 1 else 0.0)).astype(np.float32))
            t[name + ".bias"] = torch.from_numpy(
                (rng.standard_normal(shape[:1]) * std).astype(np.float32))
        return t

    sd = {32: [net(32), net(32)], 64: [net(64), net(64)], "activation_func": "relu",
          "is_layer_norm": True, "activate_output": False, "name": "tiny"}
    torch.save(sd, path)


def hypernetwork_spec(steps: int = 3):
    """FreeU_V2, HypernetworkLoader (hn.pt at 0.7) and PerpNeg chained,
    sampled by euler_ancestral over 3 karras steps at cfg 3.0, the first
    ``steps`` of them (KSamplerAdvanced, leftover noise returned)."""
    spec = patched_graph([("FreeU_V2", [1.2, 1.1, 0.8, 0.6], {}),
                          ("HypernetworkLoader", ["hn.pt", 0.7], {}),
                          ("PerpNeg", [0.8], {"empty_conditioning": (4, 0)})])
    if steps != 3:
        spec[-1] = (30, "KSamplerAdvanced", ["enable", 9, "fixed", 3, 3.0, "euler_ancestral",
                                             "karras", 0, steps, "enable"], spec[-1][3])
    return spec


def port_f64(pex, spec, model_dir, monkeypatch):
    """The port's output of ``spec`` with ``pex``'s loader outputs in f64 and
    every f32 step of the graph in f64 (``Tensor.float`` and the default
    dtype widened for the call): the f64 graph the f32 runs are held to."""
    from test_torch_executor import to_f64

    _, pwf = graphs(spec)
    ex = pe.PromptExecutor(pwf, model_dirs=(str(model_dir),), device="cpu")
    ex._cache[1] = to_f64(pex._cache[1])
    monkeypatch.setitem(pe.NODE_REGISTRY, "_Latent", lambda ctx, node: (
        {"samples": torch.from_numpy(LATENT.astype(np.float64))},))
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", lambda self, *a, **kw: self.double())
        default = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            return ex.execute().outputs[30][0]["samples"].double()
        finally:
            torch.set_default_dtype(default)


@pytest.mark.parametrize("std", [0.05, 0.3])
def test_freeu_v2_hypernetwork_perp_neg_match_jax(monkeypatch, tmp_path, std):
    """The chain agrees with JAX's at TOL with the hypernetwork's weights at
    std 0.05. At std 0.3 (fault 3.2) it agrees at HYPERNET_STD03_TOL, the
    two packages' f32-against-f64 drift, and the port's f32 output is
    within that bar of its f64 graph. Each patch moves the output (std
    0.05)."""
    write_hypernetwork(tmp_path / "hn.pt", std)
    spec = hypernetwork_spec()
    jctx, pctx, _, pex = run_both(spec, monkeypatch, seeds=(9,), model_dirs=(tmp_path,))
    assert sorted(pctx.outputs[11][0]["patches"][1]["nets"]) == [32, 64]
    if std == 0.3:
        out = pctx.outputs[30][0]["samples"]
        assert_close(out, jctx.outputs[30][0], **HYPERNET_STD03_TOL)
        drift = float((out.double() - port_f64(pex, spec, tmp_path, monkeypatch)).abs().max())
        assert drift <= HYPERNET_STD03_TOL["atol"]
        return
    assert_close(pctx.outputs[30][0], jctx.outputs[30][0])
    # each patch moved the output: rerun without it
    for drop in (10, 11, 12):
        rows = [r for r in spec if r[0] != drop]
        rows = [(i, t, w, {**inp, "model": (drop - 1 if drop > 10 else 1, 0)}
                 if inp.get("model") == (drop, 0) else inp) for i, t, w, inp in rows]
        _, pwf = graphs(rows)
        ex = pe.PromptExecutor(pwf, model_dirs=(str(tmp_path),), device="cpu")
        ex._cache[1] = pex._cache[1]
        moved = ex.execute().outputs[30][0]["samples"] - pctx.outputs[30][0]["samples"]
        assert float(moved.abs().max()) > 1e-3, drop


def test_tome_rescale_downscale_linear_cfg_match_jax(monkeypatch):
    global LATENT
    saved = LATENT
    LATENT = np.random.default_rng(6).standard_normal((2, 16, 16, 4)).astype(np.float32)
    try:
        spec = patched_graph([("TomePatchModel", [0.4], {}),
                              ("RescaleCFG", [0.6], {}),
                              ("PatchModelAddDownscale",
                               [1, 2.0, 0.0, 0.6, True, "bicubic", "bilinear"], {}),
                              ("PatchModelAddDownscale",
                               [2, 1.5, 0.2, 1.0, False, "bilinear", "nearest-exact"], {}),
                              ("VideoLinearCFGGuidance", [1.2], {})],
                             sampler=("euler", "normal", 3, 3.0))
        _check(spec, monkeypatch, 5)
    finally:
        LATENT = saved
