"""The port's workflow executor (workflow/executor.py) against the JAX package's.

Both packages' PromptExecutor run the same graphs on the CPU at tiny widths.
Randomness is carried across: the JAX executor's loader outputs (the tiny
fallback models of CheckpointLoaderSimple) go into the port executor's
cache under the loader's node id (loader nodes are untainted, so they are
not re-run), ControlNet files are written from numpy params both read, and
the KSampler's noise and sampler draws are JAX's, handed to the port's
``sample`` by wrapping it (``jax_noise``). f32 throughout: TOL.

The helpers here serve the other executor test files too.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu_torch.workflow.executor as pe
from stable_renderer_tpu.workflow.loader import Workflow as JWorkflow, WorkflowNode as JNode
from stable_renderer_tpu_torch.workflow.loader import Workflow as PWorkflow, WorkflowNode as PNode

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)  # f32 tiny graphs: summation order only

ENGINE_SLOTS = {"color": 0, "id": 1, "pos": 2, "normal": 3, "depth": 4, "canny": 5,
                "noise": 6, "masks": 7}


# --- graphs, engine data and conversions -----------------------------------------


def graphs(spec):
    """(JAX Workflow, port Workflow) of ``spec``: (id, type, widgets,
    {input: (src id, slot)}) rows; each package gets its own widget lists
    (validation coerces them in place)."""
    def build(wf_cls, node_cls):
        return wf_cls(nodes={i: node_cls(id=i, type=t, widgets=copy.deepcopy(list(w)),
                                         inputs=dict(inp), output_names=[])
                             for i, t, w, inp in spec}, unknown_types=[], path=None)

    return build(JWorkflow, JNode), build(PWorkflow, PNode)


def engine_maps(n=1, h=32, w=32, seed=0) -> dict:
    """numpy EngineData fields: a sprite square in the id map, random colour,
    normal and depth maps, latent-resolution noise for the tiny VAE (f = 2)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, h, w, 4), np.int32)
    ids[:, h // 4: 3 * h // 4, w // 4: 3 * w // 4] = [1, 1, 4, 7]
    ids[:, h // 4: 3 * h // 4, w // 4: 3 * w // 4, 3] += np.arange(w // 2, dtype=np.int32)
    f32 = np.float32
    return dict(
        frame_indices=np.arange(n, dtype=np.int32),
        color_maps=rng.uniform(size=(n, h, w, 3)).astype(f32),
        id_maps=ids,
        pos_maps=rng.uniform(size=(n, h, w, 3)).astype(f32),
        noise_maps=rng.standard_normal((n, h // 2, w // 2, 4)).astype(f32),
        normal_maps=rng.uniform(size=(n, h, w, 3)).astype(f32),
        depth_maps=rng.uniform(size=(n, h, w, 3)).astype(f32),
        canny_maps=np.zeros((n, h, w, 3), f32),
        masks=(ids[..., 0] == 0).astype(f32),
    )


def jax_engine_data(maps: dict, **extra):
    from stable_renderer_tpu.data.engine_data import EngineData

    return EngineData(**{k: jnp.asarray(v) for k, v in maps.items()}, **extra)


def port_engine_data(maps: dict, **extra):
    from stable_renderer_tpu_torch.data.engine_data import EngineData

    return EngineData(**{k: torch.as_tensor(v) for k, v in maps.items()}, **extra)


def port_config(cls, jcfg):
    """The port's config dataclass ``cls`` with the fields of JAX's ``jcfg``."""
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def to_f64(tree):
    """Floating tensors (in nested dicts, lists, tuples) widened to f64."""
    if isinstance(tree, dict):
        return {k: to_f64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_f64(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.double()
    return tree


def to_torch(tree):
    """JAX arrays (in nested dicts, lists, tuples) as CPU torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    if isinstance(tree, (jax.Array, np.ndarray)):
        a = np.asarray(tree)
        return torch.from_numpy(np.array(a, dtype=np.float32 if a.dtype.kind == "f" else a.dtype))
    return tree


def port_loader_outputs(model, clip, vae):
    """CheckpointLoaderSimple's (MODEL, CLIP, VAE) of the JAX executor as the
    port's: the same configs and params, on the CPU in f32."""
    from stable_renderer_tpu_torch.models import clip as pclip, unet as punet, vae as pvae
    from stable_renderer_tpu_torch.models.sampling import ModelSampling

    pm = {**to_torch({k: v for k, v in model.items() if k not in ("unet", "sampling")}),
          "unet": punet.UNetModel(port_config(punet.UNetConfig, model["unet"].config)),
          "sampling": ModelSampling(prediction=model["sampling"].prediction)}
    ccfg = port_config(pclip.CLIPConfig, clip["clip"].config)
    pc = {**to_torch({k: v for k, v in clip.items() if k not in ("clip", "tokenizer")}),
          "clip": pclip.CLIPTextModel(ccfg), "tokenizer": pclip.Tokenizer(ccfg)}
    pv = {"vae": pvae.VAE(port_config(pvae.VAEConfig, vae["vae"].config)),
          "params": to_torch(vae["params"])}
    return pm, pc, pv


def jax_noise(monkeypatch, seeds):
    """Wrap the port executor's ``sample`` so that a KSampler's noise drawn
    from a torch generator seeded with one of ``seeds`` becomes JAX's
    ``normal(PRNGKey(seed))``, and the sampler's draws JAX's for that key."""
    from test_torch_samplers import jax_draws

    real = pe.sample

    def wrapped(den, noise, sigmas, latent_image=None, sampler="euler", generator=None,
                step_callback=None, **kw):
        seed = generator.initial_seed()
        shape = tuple(noise.shape)
        if seed in seeds:
            torch_draw = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
            if torch.equal(noise, torch_draw):
                noise = torch.from_numpy(np.array(
                    jax.random.normal(jax.random.PRNGKey(seed), shape)))
            kw["step_noise"] = jax_draws(sampler, np.asarray(sigmas), shape,
                                         jax.random.PRNGKey(seed))
        return real(den, noise, sigmas, latent_image=latent_image, sampler=sampler,
                    generator=generator, step_callback=step_callback, **kw)

    monkeypatch.setattr(pe, "sample", wrapped)


def run_both(spec, monkeypatch, maps=None, seeds=(), model_dirs=(), jax_extra=None,
             port_extra=None, executes=1):
    """Both executors over ``spec`` (``executes`` times each), the JAX
    loader outputs carried into the port's cache: (JAX ctx, port ctx, JAX
    executor, port executor)."""
    jwf, pwf = graphs(spec)
    jex = je.PromptExecutor(jwf, model_dirs=tuple(map(str, model_dirs)))
    pex = pe.PromptExecutor(pwf, model_dirs=tuple(map(str, model_dirs)), device="cpu")
    jax_noise(monkeypatch, set(seeds))
    jed = None if maps is None else jax_engine_data(maps, **(jax_extra or {}))
    ped = None if maps is None else port_engine_data(maps, **(port_extra or {}))
    for _ in range(executes):
        jctx = jex.execute(engine_data=jed)
        for nid, node in pwf.nodes.items():
            if node.type == "CheckpointLoaderSimple" and nid not in pex._cache:
                pex._cache[nid] = port_loader_outputs(*jex._cache[nid])
        pctx = pex.execute(engine_data=ped)
    return jctx, pctx, jex, pex


def assert_close(out, ref, **tol):
    out = out["samples"] if isinstance(out, dict) else out
    ref = ref["samples"] if isinstance(ref, dict) else ref
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))


def write_controlnet(path, seed: int) -> None:
    """A tiny ControlNet file under ``control_model.``, zero convs perturbed."""
    from test_torch_controlnet import perturbed_controlnet

    from stable_renderer_tpu_torch.models.weights import flatten, write_safetensors

    flat = flatten(perturbed_controlnet(seed))
    write_safetensors({"control_model." + k: torch.from_numpy(np.asarray(v, np.float32))
                       for k, v in flat.items()}, path)


# --- the miku-control graph ----------------------------------------------------------


def miku_spec(sampler=("lcm", "sgm_uniform", 4, 2.0), seed=7, extra=()):
    """miku-control.json's shape: checkpoint, two prompts, EngineData, two
    ControlNetLoader + ControlNetApplyAdvanced fed from normal and depth,
    VAEEncode of the colour, KSampler, VAEDecode, InferenceOutput. The
    negative prompt goes to the applies and the KSampler straight from its
    CLIPTextEncode: both packages' specs declare one output for
    ControlNetApplyAdvanced, so a link from its slot 1 fails validation
    (and the KSampler reads the positive's controls only)."""
    name, sched, steps, cfg = sampler
    return [
        (1, "CheckpointLoaderSimple", ["missing.safetensors"], {}),
        (2, "CLIPTextEncode", ["hatsune miku, masterpiece"], {"clip": (1, 1)}),
        (3, "CLIPTextEncode", ["lowres, bad anatomy"], {"clip": (1, 1)}),
        (4, "EngineData", [], {}),
        (5, "ControlNetLoader", ["cn_normal.safetensors"], {}),
        (6, "ControlNetLoader", ["cn_depth.safetensors"], {}),
        (7, "ControlNetApplyAdvanced", [0.6, 0.0, 0.8],
         {"positive": (2, 0), "negative": (3, 0), "control_net": (5, 0), "image": (4, 3)}),
        (8, "ControlNetApplyAdvanced", [0.5, 0.1, 1.0],
         {"positive": (7, 0), "negative": (3, 0), "control_net": (6, 0), "image": (4, 4)}),
        (9, "VAEEncode", [], {"pixels": (4, 0), "vae": (1, 2)}),
        (10, "KSampler", [seed, "fixed", steps, cfg, name, sched, 1.0],
         {"model": (1, 0), "positive": (8, 0), "negative": (3, 0), "latent_image": (9, 0)}),
        (11, "VAEDecode", [], {"samples": (10, 0), "vae": (1, 2)}),
        (12, "InferenceOutput", [], {"images": (11, 0)}),
        *extra,
    ]


@pytest.fixture(scope="module")
def cn_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("controlnets")
    write_controlnet(d / "cn_normal.safetensors", 5)
    write_controlnet(d / "cn_depth.safetensors", 6)
    return d


def test_miku_control_graph_matches_jax(monkeypatch, cn_dir):
    """The miku-shaped graph, two executes each: the loader outputs are the
    same objects across executes, the frame-dependent nodes re-run, and both
    final outputs agree with JAX's."""
    maps = engine_maps()
    jctx, pctx, jex, pex = run_both(miku_spec(), monkeypatch, maps=maps, seeds=(7,),
                                    model_dirs=(cn_dir,), executes=2)
    assert pctx.final_output.shape == (1, 32, 32, 3)
    assert_close(pctx.final_output, jctx.final_output)
    assert set(pex._cache) == set(jex._cache) == {1, 2, 3, 5, 6}
    assert pctx.outputs[1] is pex._cache[1]
    assert pex._frame_tainted == jex._frame_tainted == {4, 7, 8, 9, 10, 11, 12}


def test_correspond_sampler_with_overlap_corresponder_matches_jax(monkeypatch):
    """CorrespondSampler (no seed widget) with an OverlapCorresponder and
    ddim over two frames: K/V injection from frame 1 and the vertex-averaging
    step callback; its OverlapCorresponder gate refuses lcm in both."""
    maps = engine_maps(n=2, seed=1)
    spec = [
        (1, "CheckpointLoaderSimple", ["missing.safetensors"], {}),
        (2, "CLIPTextEncode", ["a boat"], {"clip": (1, 1)}),
        (3, "CLIPTextEncode", [""], {"clip": (1, 1)}),
        (4, "EngineData", [], {}),
        (5, "OverlapCorresponder", [], {}),
        (6, "CorrespondSampler", [3, 2.5, "ddim", "karras", 1.0],
         {"model": (1, 0), "positive": (2, 0), "negative": (3, 0), "latent_image": (4, 6),
          "corresponder": (5, 0)}),
        (7, "VAEDecode", [], {"samples": (6, 0), "vae": (1, 2)}),
        (8, "InferenceOutput", [], {"images": (7, 0)}),
    ]
    jctx, pctx, _, _ = run_both(spec, monkeypatch, maps=maps, seeds=(0,))
    assert pctx.final_output.shape == (2, 32, 32, 3)
    assert_close(pctx.final_output, jctx.final_output)
    bad = [(i, t, ["lcm" if v == "ddim" else v for v in w], inp) for i, t, w, inp in spec]
    for ex_mod, wf in zip((je, pe), graphs(bad)):
        kw = {} if ex_mod is je else {"device": "cpu"}
        ed = (jax_engine_data if ex_mod is je else port_engine_data)(maps)
        with pytest.raises(ex_mod.NodeExecutionError, match="ddim or ddpm"):
            ex_mod.PromptExecutor(wf, **kw).execute(engine_data=ed)


# --- the executor's core, each against JAX ---------------------------------------------


@pytest.fixture
def boom_nodes():
    """_OkLoader -> _Boom -> _Sink in both registries; _Boom raises."""
    names = ("_OkLoaderTest", "_BoomNodeTest", "_SinkNodeTest")
    for mod in (je, pe):
        mod.register_node(names[0])(lambda ctx, node: ("model-object",))

        def boom(ctx, node, model=None):
            raise ValueError("deliberate kaboom")

        mod.register_node(names[1])(boom)
        mod.register_node(names[2])(lambda ctx, node, x=None: (x,))
    yield [(1, names[0], [], {}), (2, names[1], [], {"model": (1, 0)}),
           (3, names[2], [], {"x": (2, 0)})]
    for mod in (je, pe):
        for n in names:
            mod.NODE_REGISTRY.pop(n, None)


def _failures(spec, prepare=None):
    """Both executors' NodeExecutionError details (and the executors)."""
    out = []
    for mod, wf in zip((je, pe), graphs(spec)):
        ex = mod.PromptExecutor(wf, validate=False, **({} if mod is je else {"device": "cpu"}))
        if prepare:
            prepare(ex)
        with pytest.raises(mod.NodeExecutionError) as ei:
            ex.execute()
        out.append((ei.value.details, ex))
    return out


def test_error_details_and_pruning_match_jax(boom_nodes):
    def prepare(ex):
        ex._frame_tainted = {2, 3}
        ex._cache[3] = ("stale-downstream",)

    (jd, jex), (pd, pex) = _failures(boom_nodes, prepare)
    assert sorted(pd) == sorted(jd)
    for key in ("node_id", "node_type", "exception_type", "exception_message",
                "current_inputs", "executed"):
        assert pd[key] == jd[key], key
    assert pd["node_id"] == 2 and any("deliberate kaboom" in ln for ln in pd["traceback"])
    assert set(pex._cache) == set(jex._cache) == set()  # the stale sink output pruned
    (jd, _), (pd, _) = _failures([(1, "KSamplerr", [], {})])
    assert pd == jd and "KSampler" in pd["exception_message"]


def test_tensor_inputs_are_summarized_like_jax(boom_nodes):
    for mod in (je, pe):
        mod.register_node("_OkLoaderTest")(
            lambda ctx, node, _m=mod: (jnp.zeros((2, 3)) if _m is je else torch.zeros(2, 3),))
    (jd, _), (pd, _) = _failures(boom_nodes)
    assert pd["current_inputs"] == jd["current_inputs"] == {
        "model": "<array shape=(2, 3) dtype=float32>"}


def test_node_pool_and_interrupt_match_jax():
    counts = []
    for mod in (je, pe):
        @mod.register_node("_CounterNodeTest")
        class Counter:
            def __init__(self):
                self.count = 0

            def __call__(self, ctx, node):
                self.count += 1
                return (self.count,)

    try:
        for mod, wf in zip((je, pe), graphs([(1, "_CounterNodeTest", [], {})])):
            kw = {} if mod is je else {"device": "cpu"}
            ex = mod.PromptExecutor(wf, validate=False, **kw)
            ex._frame_tainted = {1}
            counts.append([ex.execute().outputs[1][0] for _ in range(3)])
            assert (1, "_CounterNodeTest") in ex.node_pool
            mod.interrupt_processing()
            assert mod.processing_interrupted()
            with pytest.raises(mod.InterruptProcessingException):
                ex.execute()
            assert not mod.processing_interrupted()  # consumed
            assert ex.execute().outputs[1][0] == 4
    finally:
        for mod in (je, pe):
            mod.NODE_REGISTRY.pop("_CounterNodeTest", None)
    assert counts == [[1, 2, 3], [1, 2, 3]]


def test_lazy_if_and_reflected_nodes_match_jax():
    """If's branches are Lazy: only the taken branch's subgraph runs; a
    register_reflected node gets the same spec and runs."""
    import stable_renderer_tpu.workflow.validation as jv
    import stable_renderer_tpu_torch.workflow.validation as pv

    ran = {je: [], pe: []}
    for mod in (je, pe):
        mod.register_node("_TestProbeA")(lambda ctx, node, _m=mod: ran[_m].append("A") or ("a",))
        mod.register_node("_TestProbeB")(lambda ctx, node, _m=mod: ran[_m].append("B") or ("b",))
        mod.register_node("_TestCond")(lambda ctx, node: (bool(node.widgets[0]),))

    class Scale:
        RETURN_TYPES = ("LATENT",)

        def __call__(self, ctx, node, samples: "LATENT" = None, factor: float = 2.0):
            return ({"samples": samples["samples"] * factor},)

    jv.register_reflected("_ReflectedScaleTest", Scale)
    pv.register_reflected("_ReflectedScaleTest", Scale)
    try:
        assert pv.NODE_SPECS["_ReflectedScaleTest"] == pv.NodeSpec(
            **vars(jv.NODE_SPECS["_ReflectedScaleTest"]))
        for taken in (True, False):
            spec = [(1, "_TestProbeA", [], {}), (2, "_TestProbeB", [], {}),
                    (3, "_TestCond", [taken], {}),
                    (4, "If", [], {"condition": (3, 0), "true_value": (1, 0),
                                   "false_value": (2, 0)}),
                    (5, "InferenceOutput", [], {"value": (4, 0)}),
                    (6, "EmptyLatentImage", [16, 16, 1], {}),
                    (7, "_ReflectedScaleTest", [3.0], {"samples": (6, 0)})]
            for mod, wf in zip((je, pe), graphs(spec)):
                ran[mod].clear()
                ex = mod.PromptExecutor(wf, validate=False,
                                        **({} if mod is je else {"device": "cpu"}))
                ctx = ex.execute()
                assert ctx.final_output == ("a" if taken else "b")
                assert ran[mod] == (["A"] if taken else ["B"])
                assert tuple(ctx.outputs[7][0]["samples"].shape) == (1, 2, 2, 4)
    finally:
        for mod in (je, pe):
            for n in ("_TestProbeA", "_TestProbeB", "_TestCond", "_ReflectedScaleTest"):
                mod.NODE_REGISTRY.pop(n, None)
        for v in (jv, pv):
            v.NODE_SPECS.pop("_ReflectedScaleTest", None)


def test_progress_sink_gets_every_step(monkeypatch):
    """A progress sink set on the executor gets (step, total, preview) from
    the sampler's step callback, as the JAX executor's io_callback does."""
    spec = [(1, "CheckpointLoaderSimple", ["missing.safetensors"], {}),
            (2, "CLIPTextEncode", ["x"], {"clip": (1, 1)}),
            (3, "EmptyLatentImage", [16, 16, 1], {}),
            (4, "KSampler", [1, "fixed", 3, 1.0, "euler", "normal", 1.0],
             {"model": (1, 0), "positive": (2, 0), "negative": (2, 0), "latent_image": (3, 0)})]
    _, pwf = graphs(spec)
    ex = pe.PromptExecutor(pwf, device="cpu")
    steps = []
    ex.progress_holder[0] = lambda s, t, img: steps.append((s, t, img.shape))
    ex.execute()
    assert steps == [(i, 3, (1, 2, 2, 3)) for i in range(3)]


def test_executor_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pwf = graphs([(1, "EmptyLatentImage", [16, 16, 1], {})])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.PromptExecutor(pwf)
    assert pe.PromptExecutor(pwf, device="cpu").device == torch.device("cpu")
