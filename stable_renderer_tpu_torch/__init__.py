"""stable_renderer_tpu_torch — the PyTorch / CUDA port of stable_renderer_tpu.

Same module paths, function names and parameter layouts as the JAX package
(stable_renderer_tpu), which stays the reference the port is tested against.
The port imports torch and never jax. Kernels hand-written for Hopper live in
``csrc/`` and are built on first use (``kernels/_build.py``); each has a
plain PyTorch version beside its wrapper, used for CPU tensors.
"""
