"""Compute ops: plain PyTorch, plus the hand-written CUDA kernels that
replace ``ray_tpu``'s Pallas kernels (``flash``). No kernel is built when
this package is imported: ``_build`` compiles at first launch."""
