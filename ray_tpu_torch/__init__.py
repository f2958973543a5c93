"""PyTorch/CUDA port of ray_tpu's model path, for NVIDIA Hopper (sm_90a).

Mirrors ``ray_tpu``'s module layout (``ops/``, ``models/``) so each
counterpart is easy to find. Imports torch and numpy only, never jax and
never ``ray_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a CUDA tensor every ported kernel launches the
hand-written kernel under ``csrc/`` or raises.
"""
