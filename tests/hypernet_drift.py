"""The measurement behind ROADMAP queue 3's fault 3.2: the hypernetwork
chain of tests/test_torch_executor_patches.py (FreeU_V2, a hypernetwork at
strength 0.7, PerpNeg; euler_ancestral over 3 karras steps at cfg 3.0) after
each of its 3 steps, with the hypernetwork's weights at std 0.05 and 0.3.

For each it prints the port's f32 output against JAX's (the gap), and each
package's f32 output against the port's f64 graph (the drift): the f32
rounding that the same graph carries in either package. The bar of the std
0.3 case (HYPERNET_STD03_TOL) is the two drifts' sum, rounded up over hash
seeds: the tiny models' hash tokenizer makes the prompts' ids, and so the
numbers, depend on PYTHONHASHSEED.

Run from the repository root on the CPU:
    PYTHONHASHSEED=0 JAX_PLATFORMS=cpu python tests/hypernet_drift.py [--std 0.3]
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]


def measure(std: float, steps: int, model_dir: Path, monkeypatch) -> dict:
    """{"gap", "port_drift", "jax_drift", "ref_max"} after ``steps`` steps."""
    import test_torch_executor_patches as tp
    from test_torch_executor import run_both

    tp.write_hypernetwork(model_dir / "hn.pt", std)
    spec = tp.hypernetwork_spec(steps)
    jctx, pctx, _, pex = run_both(spec, monkeypatch, seeds=(9,), model_dirs=(model_dir,))
    p32 = pctx.outputs[30][0]["samples"].double().numpy()
    j32 = np.asarray(jctx.outputs[30][0]["samples"], np.float64)
    p64 = tp.port_f64(pex, spec, model_dir, monkeypatch).numpy()
    return {"gap": float(np.abs(p32 - j32).max()), "port_drift": float(np.abs(p32 - p64).max()),
            "jax_drift": float(np.abs(j32 - p64).max()), "ref_max": float(np.abs(j32).max())}


def main() -> None:
    import argparse

    import jax.numpy as jnp

    import stable_renderer_tpu.workflow.executor as je
    import stable_renderer_tpu_torch.workflow.executor as pe
    import test_torch_executor_patches as tp

    ap = argparse.ArgumentParser()
    ap.add_argument("--std", type=float, nargs="*", default=[0.05, 0.3])
    stds = ap.parse_args().std
    torch.set_num_threads(1)
    print("std  step  gap (port vs JAX)  port f32 vs f64  JAX f32 vs port f64  max |out|")
    with tempfile.TemporaryDirectory() as tmp:
        for std in stds:
            for steps in (1, 2, 3):
                mp = pytest.MonkeyPatch()
                for mod in (je, pe):
                    mod.register_node("_Latent")(lambda ctx, node, _m=mod: ({"samples": (
                        jnp.asarray(tp.LATENT) if _m is je
                        else torch.from_numpy(tp.LATENT.copy()))},))
                try:
                    r = measure(std, steps, Path(tmp), mp)
                finally:
                    mp.undo()
                print(f"{std:<4} {steps:>5}  {r['gap']:.3e}          {r['port_drift']:.3e}"
                      f"        {r['jax_drift']:.3e}            {r['ref_max']:.2f}", flush=True)


if __name__ == "__main__":
    main()
