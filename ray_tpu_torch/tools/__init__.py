"""Tools: ``profile`` (``rt profile``), ``kv_bench`` and ``stream_bench``
(the engine legs of JAX's benches), run as ``python -m
ray_tpu_torch.tools.<name>``; and the ones run by hand on a GPU host
(kernel tuning, the RL gate's spread)."""
