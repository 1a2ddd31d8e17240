"""Rendering and numeric ops (raster, G-buffer, correspondence, kernels' wrappers)."""
