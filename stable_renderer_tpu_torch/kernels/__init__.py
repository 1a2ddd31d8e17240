"""Building and loading the hand-written CUDA kernels (see ``_build.py``)."""
