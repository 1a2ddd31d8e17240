"""The port's workflow validation (workflow/validation.py) and node registry
against the JAX package's: the same 183 node names and 166 specs, each name
the port leaves for a later slice (1.13) a stub that raises
NotImplementedError naming its ROADMAP item, and ``validate_workflow`` giving equal error lists
and equal coerced widgets on the graphs of tests/test_validation.py (caught
by running its tests with the validator wrapped), on string-typed widgets
and on one node of every spec with widgets drawn in range, out of range and
of the wrong type."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import test_validation
import torch

import stable_renderer_tpu.workflow.executor as je
import stable_renderer_tpu.workflow.validation as jv
import stable_renderer_tpu_torch.workflow.executor as pe
import stable_renderer_tpu_torch.workflow.validation as pv
from stable_renderer_tpu_torch.workflow.loader import Workflow as PWorkflow, WorkflowNode as PNode

torch.set_num_threads(1)

LATER = {"ImageUpscaleWithModel": "1.13", "UpscaleModelLoader": "1.13"}
JAX_VALIDATE = jv.validate_workflow  # the validator itself, before any test wraps it


def expected_item(name: str):
    """The ROADMAP item a node name waits for in the port, or None."""
    return LATER.get(name)


def test_registries_and_specs_hold_the_same_names():
    assert len(pe.NODE_REGISTRY) == len(je.NODE_REGISTRY) == 183
    assert set(pe.NODE_REGISTRY) == set(je.NODE_REGISTRY)
    assert set(pv.NODE_SPECS) == set(jv.NODE_SPECS)
    for name, spec in jv.NODE_SPECS.items():
        assert pv.NODE_SPECS[name] == pv.NodeSpec(
            input_types=spec.input_types, return_types=spec.return_types,
            widgets=tuple(pv.WidgetSpec(**vars(w)) for w in spec.widgets),
            lazy_inputs=spec.lazy_inputs), name
    assert pv.UNIQUE_NODE_TYPES == jv.UNIQUE_NODE_TYPES
    assert pv.type_matchings() == jv.type_matchings()
    implemented = [n for n in pe.NODE_REGISTRY if expected_item(n) is None]
    assert len(implemented) == 181


@pytest.mark.parametrize("name", sorted(je.NODE_REGISTRY))
def test_each_name_is_implemented_or_a_stub_naming_its_item(name):
    item = expected_item(name)
    impl = pe.NODE_REGISTRY[name]
    assert getattr(impl, "roadmap_item", None) == item
    if item is not None:
        node = PNode(id=1, type=name, widgets=[], inputs={}, output_names=[])
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}$"):
            impl(None, node)


def test_running_a_stub_fails_with_the_structured_error():
    wf = PWorkflow(nodes={1: PNode(id=1, type="UpscaleModelLoader", widgets=["s"],
                                   inputs={}, output_names=[])}, unknown_types=[], path=None)
    ex = pe.PromptExecutor(wf, device="cpu")
    with pytest.raises(pe.NodeExecutionError) as ei:
        ex.execute()
    d = ei.value.details
    assert d["node_id"] == 1 and d["node_type"] == "UpscaleModelLoader"
    assert d["exception_type"] == "NotImplementedError"
    assert "ROADMAP 1.13" in d["exception_message"]


def to_port(jwf):
    return PWorkflow(nodes={i: PNode(id=n.id, type=n.type, widgets=copy.deepcopy(n.widgets),
                                     inputs=dict(n.inputs), output_names=list(n.output_names))
                            for i, n in jwf.nodes.items()},
                     unknown_types=list(jwf.unknown_types), path=jwf.path)


def assert_same_validation(jwf):
    """Both validators over copies of ``jwf``: equal errors, equal widgets."""
    pwf = to_port(jwf)
    jwf = copy.deepcopy(jwf)
    ref = JAX_VALIDATE(jwf, je.NODE_REGISTRY)
    out = pv.validate_workflow(pwf, pe.NODE_REGISTRY)
    assert out == ref
    for i, n in jwf.nodes.items():
        assert pwf.nodes[i].widgets == n.widgets
        assert [type(v) for v in pwf.nodes[i].widgets] == [type(v) for v in n.widgets]
    return out


@pytest.mark.parametrize("test_name", ["test_unknown_node_type_is_collected_not_raised_midrun",
                                       "test_link_to_missing_node_and_bad_slot",
                                       "test_widget_range_and_combo_validation",
                                       "test_type_mismatch_needs_adapter"])
def test_validation_graphs_give_equal_errors(monkeypatch, test_name):
    seen = []

    def recording(workflow, registry):
        seen.append(copy.deepcopy(workflow))
        return JAX_VALIDATE(workflow, registry)

    monkeypatch.setattr(jv, "validate_workflow", recording)
    monkeypatch.setattr(test_validation, "validate_workflow", recording)
    getattr(test_validation, test_name)()
    assert seen
    for wf in seen:
        assert assert_same_validation(wf)


def test_string_typed_widgets_coerce_like_jax():
    """A miku-shaped graph whose widgets all arrive as strings (as an editor
    may send them), then the same with bad values."""
    from test_torch_executor import graphs, miku_spec

    spec = [(i, t, [str(v) for v in w], inp) for i, t, w, inp in miku_spec()]
    jwf, _ = graphs(spec)
    assert assert_same_validation(jwf) == []
    bad = {10: ["7", "fixed", "four", "2.0", "lcm", "karras_typo", "1.5"],
           7: ["-1", "0.0", "0.8"], 2: [""]}
    spec = [(i, t, bad.get(i, w), inp) for i, t, w, inp in spec]
    jwf, _ = graphs(spec)
    errors = assert_same_validation(jwf)
    assert {e["type"] for e in errors} == {"invalid_input_type", "value_not_in_list",
                                            "value_smaller_than_min", "value_bigger_than_max"}


def test_every_spec_validates_like_jax(rng):
    """One node of every spec (inputs unlinked), its widgets drawn per
    widget: in range, below min, above max, a string of a number, a bad
    string, a choice or not; then every typed link of every spec from a
    node whose output type differs."""
    def draw(w):
        kind = rng.integers(6)
        lo = -5.0 if w.min is None else w.min
        hi = 5.0 if w.max is None else min(w.max, 1e6)
        if w.choices is not None:
            return str(rng.choice(list(w.choices))) if kind < 3 else "not_a_choice"
        if kind == 0:
            return float(rng.uniform(lo, hi)) if w.type == "FLOAT" else int(rng.uniform(lo, hi))
        if kind == 1:
            return lo - 1
        if kind == 2:
            return hi + 1
        if kind == 3:
            return str(int(rng.uniform(lo, hi)))
        if kind == 4:
            return "bad"
        return None

    nodes = {}
    names = sorted(jv.NODE_SPECS)
    for i, name in enumerate(names, start=1):
        nodes[i] = je.WorkflowNode(id=i, type=name, inputs={}, output_names=[],
                                   widgets=[draw(w) for w in jv.NODE_SPECS[name].widgets])
    errors = assert_same_validation(jv_workflow(nodes))
    assert {"value_smaller_than_min", "value_bigger_than_max", "value_not_in_list",
            "invalid_input_type"} <= {e["type"] for e in errors}
    # typed links: each declared input fed from every producer's slot 0
    producers = [n for n in names if jv.NODE_SPECS[n].return_types]
    nodes = {i: je.WorkflowNode(id=i, type=n, widgets=[], inputs={}, output_names=[])
             for i, n in enumerate(producers, start=1)}
    nid = len(nodes) + 1
    for name in names:
        for inp in jv.NODE_SPECS[name].input_types:
            src = int(rng.integers(1, len(producers) + 1))
            nodes[nid] = je.WorkflowNode(id=nid, type=name, widgets=[], output_names=[],
                                         inputs={inp: (src, int(rng.integers(0, 3)))})
            nid += 1
    errors = assert_same_validation(jv_workflow(nodes))
    assert {"return_type_mismatch", "bad_linked_input"} <= {e["type"] for e in errors}


def jv_workflow(nodes):
    from stable_renderer_tpu.workflow.loader import Workflow

    return Workflow(nodes=nodes, unknown_types=[], path=None)


def test_adapters_and_lazy_resolve_match_jax():
    img = np.random.default_rng(0).uniform(size=(1, 8, 8, 4)).astype(np.float32)
    mask = img[..., 0]
    for frm, to, v in (("IMAGE", "MASK", img), ("MASK", "IMAGE", mask), ("INT", "FLOAT", 3),
                       ("STRING", "INT", "7"), ("ANY", "STRING", 2.5), ("IMAGE", "NUMPY", img)):
        ref = jv.find_adapter(frm, to)(v)
        out = pv.find_adapter(frm, to)(torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    assert pv.find_adapter("LATENT", "CLIP") is jv.find_adapter("LATENT", "CLIP") is None
    assert pv.find_adapter("*", "ANY") is None
    assert pv.resolve(5) == 5
