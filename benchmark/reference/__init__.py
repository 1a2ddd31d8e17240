"""The benchmark's plain reference: a frozen copy of the port's plain frame
path (``plain/``), the scene it draws (``scene.py``), the frame programs
(``programs.py``) and the model FLOP count (``flops.py``). It imports neither
JAX, nor the JAX package, nor the port."""
