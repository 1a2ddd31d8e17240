"""The restoration zoo's entry (models/upscale.py: RRDBNet, SRVGG,
Swift-SRGAN, the old-arch ESRGAN keys, the sniffing loader), the zoo's two
workflow nodes and the CLI's ``upscale`` against the JAX package's, on the
CPU at tiny widths.

Each model's tree is the port's init, held to the JAX init's keys and
shapes, with every leaf moved by a seeded draw (``model_tree``), so zero
biases and unit norms hide no term; one numpy tree feeds both packages, the
JAX side jitted. Files are written with
``torch.save`` (both packages read ``.pth`` through torch).
Tolerances: PURE (1e-6) for tensor work in f32, TOL (2e-4) for a model.

Held here (ROADMAP queue 3): a published BasicSR-style file nests its state
dict under ``params_ema``; the JAX package's reader keeps only top-level
tensors, so it reads such a file as empty and raises, while the port
unwraps it. A flattened ``params_ema.``-prefixed DAT, SCUNet or SPSR file
raises in JAX (its sniffing strips the prefix, those loaders do not); the
port strips it in every loader. A LaMa file has no branch in either
package's sniffing and raises KeyError in both. The loader node's fallback
without a file is the tiny RRDBNet in both, drawn from ``PRNGKey(0)`` in
JAX and from a generator seeded 0 in the port.
"""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe
from stable_renderer_tpu.models import upscale as ju
from stable_renderer_tpu_torch.convert import params_from_numpy
from stable_renderer_tpu_torch.models import upscale as pu
from stable_renderer_tpu_torch.models.weights import flatten

torch.set_num_threads(1)

PURE = dict(atol=1e-6, rtol=1e-6)  # tensor work in f32: rounding of the same ops
TOL = dict(atol=2e-4, rtol=2e-4)   # a model's output in f32
RNG = np.random.default_rng(19)


def image(*shape, lo=0.0, hi=1.0):
    return RNG.uniform(lo, hi, size=shape).astype(np.float32)


def perturb(tree, rng, scale=0.02, key=""):
    """``tree`` as numpy f32 with each leaf moved by ``scale`` x N(0, 1)
    (BatchNorm running variances kept positive)."""
    if isinstance(tree, dict):
        return {k: perturb(v, rng, scale, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    a = a + (rng.standard_normal(a.shape) * scale).astype(np.float32)
    return np.abs(a) if key == "running_var" else a


def port_model(jmodel):
    """The port's counterpart of a JAX zoo model, at the same config."""
    mod = importlib.import_module(type(jmodel).__module__.replace(
        "stable_renderer_tpu.", "stable_renderer_tpu_torch.", 1))
    cfg = jmodel.config
    return getattr(mod, type(jmodel).__name__)(
        getattr(mod, type(cfg).__name__)(**dataclasses.asdict(cfg)))


def model_tree(jmodel, seed: int = 0, scale: float = 0.02) -> dict:
    """The port's init of ``jmodel``'s counterpart from a generator seeded
    ``seed``, held to the JAX init's tree (keys and shapes, by
    ``jax.eval_shape``: no JAX draw is made), perturbed (see the module
    docstring), as numpy."""
    want = flatten(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    tree = port_model(jmodel).init(torch.Generator().manual_seed(seed))
    got = flatten(tree)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    return perturb(jax.tree_util.tree_map(lambda t: t.numpy(), tree),
                   np.random.default_rng(seed + 100), scale)


def both(jmodel, pmodel, tree, *xs, jit=True, **kw):
    """(port output, JAX output) of ``apply(tree, *xs, **kw)``, as numpy."""
    jfn = lambda p, *a: jmodel.apply(p, *a, **kw)  # noqa: E731
    jout = (jax.jit(jfn) if jit else jfn)(jax.tree_util.tree_map(jnp.asarray, tree),
                                         *map(jnp.asarray, xs))
    pout = pmodel.apply(params_from_numpy(tree, device="cpu"),
                        *(torch.from_numpy(np.ascontiguousarray(x)) for x in xs), **kw)
    return pout.detach().numpy(), np.asarray(jout)


def write_pth(tree, path, nest_key=None, prefix="") -> Path:
    """A tree as a flat torch file (``{nest_key: flat}`` when given)."""
    flat = {prefix + k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in flatten(tree).items()}
    torch.save({nest_key: flat} if nest_key else flat, str(path))
    return Path(path)


def same_config(pcfg, jcfg):
    assert type(pcfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)


# --- RRDBNet, SRVGG, Swift-SRGAN ---------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(num_feat=16, num_block=2, num_grow_ch=8, scale=4),
                                 dict(num_feat=16, num_block=1, num_grow_ch=8, scale=2)],
                         ids=["x4", "x2"])
def test_rrdbnet_matches_jax(cfg):
    tree = model_tree(ju.RRDBNet(ju.RRDBConfig(**cfg)), scale=0.05)
    out, ref = both(ju.RRDBNet(ju.RRDBConfig(**cfg)), pu.RRDBNet(pu.RRDBConfig(**cfg)), tree,
                    image(1, 12, 10, 3))
    assert out.shape == (1, 12 * cfg["scale"], 10 * cfg["scale"], 3)
    assert 0 < (out > 0).mean() < 1  # the clip acts on part of the image, not all
    np.testing.assert_allclose(out, ref, **TOL)


def test_srvgg_matches_jax():
    tree = model_tree(ju.SRVGGNetCompact(ju.SRVGGConfig(16, 2, 2)))
    out, ref = both(ju.SRVGGNetCompact(ju.SRVGGConfig(16, 2, 2)),
                    pu.SRVGGNetCompact(pu.SRVGGConfig(16, 2, 2)), tree, image(2, 9, 11, 3))
    assert out.shape == (2, 18, 22, 3)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("scale", [2, 4])
def test_swift_srgan_matches_jax(scale):
    jm = ju.SwiftSRGAN(ju.SwiftSRGANConfig(8, 2, scale))
    tree = model_tree(jm)
    out, ref = both(jm, pu.SwiftSRGAN(pu.SwiftSRGANConfig(8, 2, scale)), tree, image(1, 10, 12, 3))
    assert out.shape == (1, 10 * scale, 12 * scale, 3)
    np.testing.assert_allclose(out, ref, **TOL)


def test_batch_norm_and_prelu_match_jax():
    x = RNG.standard_normal((2, 5, 6, 8)).astype(np.float32)
    p = perturb({"weight": np.ones(8), "bias": np.zeros(8), "running_mean": np.zeros(8),
                 "running_var": np.ones(8)}, RNG, 0.3)
    ref = ju._swift_bn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    out = pu.batch_norm(params_from_numpy(p, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **PURE)
    w = RNG.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(pu.prelu(torch.from_numpy(w), torch.from_numpy(x)).numpy(),
                               np.asarray(ju._prelu(jnp.asarray(w), jnp.asarray(x))), **PURE)


def test_old_arch_keys_convert_as_jax():
    tree = model_tree(ju.RRDBNet(ju.RRDBConfig(16, 2, 8, 4)))
    new = flatten(tree)
    inverse = {v: k for k, v in ju._OLD_ARCH_MAP.items()}
    old = {}
    for k, v in new.items():
        name, leaf = k.rsplit(".", 1)
        if name in inverse:
            old[f"{inverse[name]}.{leaf}"] = v
        else:  # body.N.rdbK.convM -> model.1.sub.N.RDBK.convM.0
            _, n, rdb, conv = name.split(".")
            old[f"model.1.sub.{n}.{rdb.upper()}.{conv}.0.{leaf}"] = v
    jconv = ju.convert_esrgan_state_dict(old)
    pconv = pu.convert_esrgan_state_dict({k: torch.from_numpy(v) for k, v in old.items()})
    assert sorted(pconv) == sorted(jconv) == sorted(new)
    for k in new:
        np.testing.assert_array_equal(pconv[k].numpy(), np.asarray(jconv[k]))


# --- the sniffing loader ------------------------------------------------------------


def zoo_cases():
    """(label, JAX model, loader input) for a tiny file of each family the
    sniffing loader dispatches: label -> (JAX model, input, whether the
    detected config runs the tiny file)."""
    from stable_renderer_tpu.models import (
        codeformer,
        dat,
        gfpgan,
        hat,
        omnisr,
        restoreformer,
        scunet,
        spsr,
        swin2sr,
        swinir,
    )

    rgb = image(1, 16, 16, 3)
    face = image(1, 16, 16, 3, lo=-1.0)
    return {
        "RRDBNet": (ju.RRDBNet(ju.RRDBConfig(16, 2, 8, 4)), rgb, True),
        "SRVGGNetCompact": (ju.SRVGGNetCompact(ju.SRVGGConfig(16, 2, 2)), rgb, True),
        "SwiftSRGAN": (ju.SwiftSRGAN(ju.SwiftSRGANConfig(8, 2, 2)), rgb, True),
        "SwinIR": (swinir.SwinIR(swinir.TINY_SWINIR_CONFIG), rgb, True),
        "Swin2SR": (swin2sr.Swin2SR(swin2sr.TINY_SWIN2SR_CONFIG), rgb, True),
        "HAT": (hat.HAT(hat.TINY_HAT_CONFIG), rgb, True),
        "DAT": (dat.DAT(dat.TINY_DAT_CONFIG), rgb, True),
        "OmniSR": (omnisr.OmniSR(omnisr.TINY_OMNISR_CONFIG), rgb, True),
        "SPSRNet": (spsr.SPSRNet(spsr.TINY_SPSR_CONFIG), rgb, True),
        "SCUNet": (scunet.SCUNet(scunet.TINY_SCUNET_CONFIG), rgb, True),
        "GFPGAN": (gfpgan.GFPGAN(gfpgan.TINY_GFPGAN_CONFIG), image(1, 32, 32, 3, lo=-1.0), True),
        # detection reads the published encoder and generator plans: the tiny
        # file loads in both, with the same config, but does not run
        "CodeFormer": (codeformer.CodeFormer(codeformer.TINY_CODEFORMER_CONFIG), face, False),
        "RestoreFormer": (restoreformer.RestoreFormer(restoreformer.TINY_RESTOREFORMER_CONFIG),
                          face, True),
    }


@pytest.mark.parametrize("family", list(zoo_cases()))
def test_loader_dispatches_each_family_as_jax(family, tmp_path):
    """A tiny file of each family: both loaders pick the same class and
    config and load the same tensors (each module's own tests hold its
    outputs to JAX's on such trees)."""
    jm, _, _ = zoo_cases()[family]
    tree = model_tree(jm, seed=3)
    path = write_pth(tree, tmp_path / f"{family}.pth")
    jmodel, jparams = ju.load_upscale_model(str(path))
    pmodel, pparams = pu.load_upscale_model(path, device="cpu")
    assert type(pmodel).__name__ == type(jmodel).__name__ == family
    same_config(pmodel.config, jmodel.config)
    jflat, pflat = flatten(jparams), flatten(pparams)
    assert sorted(pflat) == sorted(jflat)
    for k, v in pflat.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]), err_msg=k)


def test_loaded_esrgan_runs_as_jax(tmp_path):
    tree = model_tree(ju.RRDBNet(ju.RRDBConfig(16, 2, 8, 4)), seed=3, scale=0.05)
    path = write_pth(tree, tmp_path / "esrgan.pth")
    jmodel, jparams = ju.load_upscale_model(str(path))
    pmodel, pparams = pu.load_upscale_model(path, device="cpu")
    x = image(1, 10, 14, 3)
    out, ref = both(jmodel, pmodel, flatten_to_tree(jparams), x)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(pmodel.apply(pparams, torch.from_numpy(x)).numpy(), out)


def flatten_to_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def test_nested_params_ema_file_loads_in_the_port_only(tmp_path):
    """A BasicSR-style {"params_ema": state_dict} file: JAX's reader keeps
    only top-level tensors and raises on the empty dict; the port unwraps
    it and runs as JAX does on the same tensors handed in flat."""
    jm = ju.RRDBNet(ju.RRDBConfig(16, 2, 8, 4))
    tree = model_tree(jm, scale=0.05)
    nested = write_pth(tree, tmp_path / "nested.pth", nest_key="params_ema")
    assert pu.read_upscale_state(nested).keys() == flatten(tree).keys()
    with pytest.raises(KeyError, match="conv_first.weight"):
        ju.load_upscale_model(str(nested))
    flat = write_pth(tree, tmp_path / "flat.pth")
    jmodel, jparams = ju.load_upscale_model(str(flat))
    pmodel, pparams = pu.load_upscale_model(nested, device="cpu")
    same_config(pmodel.config, jmodel.config)
    x = image(1, 8, 8, 3)
    out, ref = both(jmodel, pmodel, flatten_to_tree(jparams), x)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(pmodel.apply(pparams, torch.from_numpy(x)).numpy(), out)
    params_only = write_pth(tree, tmp_path / "params.pth", nest_key="params")
    assert pu.read_upscale_state(params_only).keys() == flatten(tree).keys()


@pytest.mark.parametrize("family", ["DAT", "SCUNet", "SPSRNet", "SwinIR"])
def test_prefixed_flat_file(family, tmp_path):
    """A flattened ``params_ema.``-prefixed file: JAX's SwinIR loader strips
    the prefix, its DAT, SCUNet and SPSR loaders do not and raise; the port
    strips it in every loader."""
    jm, _, _ = zoo_cases()[family]
    tree = model_tree(jm, seed=4)
    path = write_pth(tree, tmp_path / "prefixed.pth", prefix="params_ema.")
    pmodel, pparams = pu.load_upscale_model(path, device="cpu")
    assert type(pmodel).__name__ == family
    if family == "SwinIR":
        jmodel, _ = ju.load_upscale_model(str(path))
        same_config(pmodel.config, jmodel.config)
    else:
        with pytest.raises(ValueError, match="checkpoint"):
            ju.load_upscale_model(str(path))
    jmodel, _ = ju.load_upscale_model(str(write_pth(tree, tmp_path / "flat.pth")))
    same_config(pmodel.config, jmodel.config)
    want = flatten(tree)
    for k, v in flatten(pparams).items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_lama_file_has_no_branch_in_either_loader(tmp_path):
    from stable_renderer_tpu.models import lama as jl

    from stable_renderer_tpu_torch.models import lama as pl

    tree = model_tree(jl.LaMa(jl.TINY_LAMA_CONFIG))
    path = write_pth(tree, tmp_path / "lama.pth")
    with pytest.raises(KeyError, match="conv_first.weight"):
        ju.load_upscale_model(str(path))
    with pytest.raises(KeyError, match="conv_first.weight"):
        pu.load_upscale_model(path, device="cpu")
    jmodel, _ = jl.load_lama(str(path))
    pmodel, _ = pl.load_lama(path, device="cpu")
    same_config(pmodel.config, jmodel.config)


def test_loaders_default_to_the_card(tmp_path):
    path = write_pth(model_tree(ju.RRDBNet(ju.RRDBConfig(16, 1, 8, 2))), tmp_path / "e.pth")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is checked where there is none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pu.load_upscale_model(path)


# --- the workflow nodes and the CLI ------------------------------------------------


@pytest.fixture
def image_node():
    x = image(1, 12, 12, 3)
    for mod in (je, pe):
        mod.register_node("_Image")(
            lambda ctx, node, _m=mod: ((jnp.asarray(x) if _m is je else torch.from_numpy(x)),))
    yield x
    for mod in (je, pe):
        mod.NODE_REGISTRY.pop("_Image", None)


UPSCALE_GRAPH = [(1, "UpscaleModelLoader", ["zoo/esrgan.pth"], {}), (2, "_Image", [], {}),
                 (3, "ImageUpscaleWithModel", [], {"upscale_model": (1, 0), "image": (2, 0)})]


def test_upscale_graph_matches_jax(tmp_path, image_node):
    """UpscaleModelLoader -> ImageUpscaleWithModel through both executors on
    a written file (the port's in the published params_ema nesting, JAX's
    flat: its reader drops the nesting): the same family and config, the
    image within TOL, in f32."""
    from test_torch_executor import graphs

    tree = model_tree(ju.RRDBNet(ju.RRDBConfig(16, 2, 8, 4)), scale=0.05)
    for d, nest_key in ((tmp_path / "port", "params_ema"), (tmp_path / "jax", None)):
        (d / "zoo").mkdir(parents=True)
        write_pth(tree, d / "zoo" / "esrgan.pth", nest_key=nest_key)
    jwf, pwf = graphs(UPSCALE_GRAPH)
    jex = je.PromptExecutor(jwf, model_dirs=(str(tmp_path / "jax"),))
    pex = pe.PromptExecutor(pwf, model_dirs=(str(tmp_path / "port"),), device="cpu")
    jctx, pctx = jex.execute(), pex.execute()
    (pm, _), (jmod, _) = pex._cache[1][0], jex._cache[1][0]
    assert type(pm).__name__ == type(jmod).__name__ == "RRDBNet"
    same_config(pm.config, jmod.config)
    out, ref = pctx.outputs[3][0], jctx.outputs[3][0]
    assert tuple(out.shape) == (1, 48, 48, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_upscale_loader_without_a_file_builds_the_tiny_rrdbnet(image_node):
    from test_torch_executor import graphs

    spec = [(1, "UpscaleModelLoader", ["missing.pth"], {}), (2, "_Image", [], {}),
            (3, "ImageUpscaleWithModel", [], {"upscale_model": (1, 0), "image": (2, 0)})]
    jwf, pwf = graphs(spec)
    jex, pex = je.PromptExecutor(jwf), pe.PromptExecutor(pwf, device="cpu")
    jctx, pctx = jex.execute(), pex.execute()
    (pm, pp), (jm, jp) = pex._cache[1][0], jex._cache[1][0]
    assert type(pm).__name__ == type(jm).__name__ == "RRDBNet"
    same_config(pm.config, jm.config)
    assert pm.config == pu.TINY_RRDB_CONFIG
    want = pu.RRDBNet(pu.TINY_RRDB_CONFIG).init(torch.Generator().manual_seed(0))
    assert flatten(pp).keys() == flatten(jp).keys() == flatten(want).keys()
    for k, v in flatten(want).items():
        assert torch.equal(flatten(pp)[k], v), k
    assert tuple(pctx.outputs[3][0].shape) == tuple(jctx.outputs[3][0].shape) == (1, 48, 48, 3)


@pytest.mark.parametrize("family", ["RRDBNet", "GFPGAN"])
def test_cli_upscale_matches_jax(family, tmp_path, capsys):
    """``upscale --device cpu`` writes the JAX CLI's image within one uint8
    step and prints its line (GFPGAN: the face models' [-1, 1] mapping)."""
    from stable_renderer_tpu import cli as jcli

    from stable_renderer_tpu_torch import cli as pcli

    jm, _, _ = zoo_cases()[family]
    path = write_pth(model_tree(jm, seed=5, scale=0.05), tmp_path / "m.pth")
    size = 32 if family == "GFPGAN" else 12
    img = (image(size, size, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    outs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.png"
        assert main(["upscale", "--model", str(path), "--image", str(tmp_path / "in.png"),
                     "--out", str(out)] + extra) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        outs[name] = (line.replace(str(out), "<out>"), np.asarray(Image.open(out)))
    assert outs["port"][0] == outs["jax"][0]
    scale = 4 if family == "RRDBNet" else 1
    assert outs["port"][0] == f"{family}: {size}x{size} -> {size * scale}x{size * scale} -> <out>"
    diff = np.abs(outs["port"][1].astype(int) - outs["jax"][1].astype(int))
    assert outs["port"][1].shape == (size * scale, size * scale, 3) and diff.max() <= 1


def test_cli_upscale_raises_on_a_lama_file_as_jax(tmp_path):
    from stable_renderer_tpu_torch import cli as pcli

    Image.fromarray((image(8, 8, 3) * 255).astype(np.uint8)).save(tmp_path / "in.png")
    from stable_renderer_tpu.models import lama as jl

    path = write_pth(model_tree(jl.LaMa(jl.TINY_LAMA_CONFIG)), tmp_path / "lama.pth")
    argv = ["upscale", "--model", str(path), "--image", str(tmp_path / "in.png"), "--out",
            str(tmp_path / "o.png"), "--device", "cpu"]
    with pytest.raises(KeyError, match="conv_first.weight"):  # as the JAX CLI: no LaMa branch
        pcli.main(argv)
    assert not (tmp_path / "o.png").exists()
