"""The measurement behind TRAIN_PARAM_TOL (tests/test_torch_train.py): three
AdamW steps of the diffusion step at lr 1e-3 on TINY_UNET_CONFIG (batch 4,
16x16 latents, JAX's own timestep and noise draws), in the port in f32,
in the JAX package in f32, and in the port's f64 graph (``Tensor.float``
and the default dtype widened, as tests/hypernet_drift.py does).

For each step it prints the loss gap and, over the params, the port's f32
against JAX's (the gap) and each package's f32 against the port's f64 (the
drift). AdamW divides each gradient by the root of its second moment, so a
gradient that is f32 rounding noise (the biases of layers that a GroupNorm
follows get ~1e-9 against a largest |gradient| of ~0.15) still moves its
parameter by up to the learning rate a step, in a direction the rounding
picks: both packages drift from the f64 graph by that much, and the bar is
the two drifts' sum, rounded up.

Run from the repository root on the CPU:
    JAX_PLATFORMS=cpu python tests/train_drift.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]


def main() -> None:
    import test_torch_train as tt

    torch.set_num_threads(1)
    states, jlosses, draws, inputs = tt.jax_steps(3)
    jparams = [s.params for s in states]
    port = tt.port_steps(jparams[0], draws, inputs)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.Tensor, "float", lambda self, *a, **kw: self.double())
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        f64 = tt.port_steps(jparams[0], draws, inputs, dtype=torch.float64)
    finally:
        torch.set_default_dtype(default)
        mp.undo()
    print("step  loss gap (port vs JAX, relative)  params: gap  port f32 vs f64  "
          "JAX f32 vs port f64  max |param|")
    for i in range(3):
        p32, p64 = port["params"][i], f64["params"][i]
        j32 = tt.flat_numpy(jparams[i + 1])
        gap = max(np.abs(p32[k] - j32[k]).max() for k in j32)
        port_drift = max(np.abs(p32[k] - p64[k]).max() for k in j32)
        jax_drift = max(np.abs(j32[k] - p64[k]).max() for k in j32)
        top = max(np.abs(v).max() for v in j32.values())
        lgap = abs(port["losses"][i] - jlosses[i]) / abs(jlosses[i])
        print(f"{i + 1:>4}  {lgap:.3e}                          {gap:.3e}  {port_drift:.3e}"
              f"        {jax_drift:.3e}            {top:.3f}", flush=True)


if __name__ == "__main__":
    main()
