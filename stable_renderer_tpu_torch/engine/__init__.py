"""The frame program, draw execution, meshes and the diffusion pipeline."""
