"""A frozen plain copy of the port's frame path, the benchmark's reference.

Copied from ``stable_renderer_tpu_torch`` (device, data, engine/mesh,
engine/render_exec, ops, models, models/sampling, parallel/mesh) with its
imports renamed, and every kernel route cut: attention is the plain
einsum-softmax (``ops/attention.py``), int8 convs the exact int32 convolution,
float convs ``F.conv2d``, the rasterizer the plain edge-function version. No
module here imports the port, so a later change to the port cannot move the
reference. Lazy imports of modules not copied sit on paths the benchmark's
cells never take.
"""
