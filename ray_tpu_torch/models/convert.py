"""Carry a JAX parameter pytree into the port.

The JAX package's Llama and MoE params (``ray_tpu/models/llama.py`` and
``moe.py``, ``init_params``) arrive as numpy arrays, layers stacked on a
leading [L] axis; the port keeps that structure and orientation, so
conversion is a checked copy of each leaf the config's family lists
(``cfg.param_shapes()``) and one cast to the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, Params, _unflatten


def params_from_jax(np_params: dict, cfg: LlamaConfig, *,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """``{"embed", "layers": {...}, "final_norm", ["lm_head"]}`` of numpy
    arrays -> the port's params on ``device`` in ``dtype`` (default: the
    compute dtype). Raises on a missing leaf or a shape that does not
    match ``cfg``."""
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    flat = {}
    for name, shape in cfg.param_shapes().items():
        node = np_params
        for part in name.split("/"):
            if part not in node:
                raise KeyError(f"JAX params lack {name!r}")
            node = node[part]
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants "
                             f"{shape}")
        # a copy: a numpy view of a JAX buffer is read-only
        flat[name] = torch.tensor(arr).to(device=device, dtype=dtype)
    return _unflatten(flat)


def params_to_numpy(params: Params) -> dict:
    """The inverse of ``params_from_jax``: the port's params as a pytree of
    float32 numpy arrays shaped like JAX's (``{"embed", "layers": {...},
    "final_norm", ["lm_head"]}``), copied to the host."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()

    return {name: ({k: host(w) for k, w in node.items()}
                   if isinstance(node, dict) else host(node))
            for name, node in params.items()}
