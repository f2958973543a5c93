"""Carry a JAX parameter pytree into the port.

The JAX package's Llama and MoE params (``ray_tpu/models/llama.py`` and
``moe.py``, ``init_params``) arrive as numpy arrays, layers stacked on a
leading [L] axis; the port keeps that structure and orientation, so
conversion is a checked copy of each leaf the config's family lists
(``cfg.param_shapes()``) and one cast to the compute dtype. The same
holds for the RLHF reward model (a Llama trunk plus a head,
``ray_tpu/rl/rlhf/models.py``), the RL policy MLPs (``ray_tpu/rl/
models.py``) and ViT (``ray_tpu/models/vit.py``). Every converter raises
on a missing leaf or a shape the config does not give.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, Params, _unflatten


def _checked(np_params, shapes: Dict[str, Tuple[int, ...]],
             device: torch.device, dtype: torch.dtype
             ) -> Dict[str, torch.Tensor]:
    """Each leaf named in ``shapes`` (a path of ``/``-joined keys, list
    items by index) copied to ``device`` in ``dtype``, by name."""
    flat = {}
    for name, shape in shapes.items():
        node = np_params
        for part in name.split("/"):
            if isinstance(node, (list, tuple)):
                if not part.isdigit() or int(part) >= len(node):
                    raise KeyError(f"JAX params lack {name!r}")
                node = node[int(part)]
            elif part not in node:
                raise KeyError(f"JAX params lack {name!r}")
            else:
                node = node[part]
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape}, config wants "
                             f"{tuple(shape)}")
        # a copy: a numpy view of a JAX buffer is read-only
        flat[name] = torch.tensor(arr).to(device=device, dtype=dtype)
    return flat


def params_from_jax(np_params: dict, cfg: LlamaConfig, *,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Params:
    """``{"embed", "layers": {...}, "final_norm", ["lm_head"]}`` of numpy
    arrays -> the port's params on ``device`` in ``dtype`` (default: the
    compute dtype). Raises on a missing leaf or a shape that does not
    match ``cfg``."""
    return _unflatten(_checked(np_params, cfg.param_shapes(),
                               resolve_device(device),
                               dtype or cfg.compute_dtype))


def reward_params_from_jax(np_params: dict, cfg: LlamaConfig, *,
                           device: DeviceLike = None,
                           dtype: Optional[torch.dtype] = None) -> Params:
    """The RLHF reward model ``{"lm": <Llama params>, "head": [d, 1]}``."""
    if "lm" not in np_params:
        raise KeyError("JAX params lack 'lm'")
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    head = _checked(np_params, {"head": (cfg.d_model, 1)}, device, dtype)
    return {"lm": params_from_jax(np_params["lm"], cfg, device=device,
                                  dtype=dtype), **head}


def policy_params_from_jax(np_params: dict, spec, hidden: Sequence[int], *,
                           device: DeviceLike = None) -> dict:
    """A flat discrete policy ``{"pi": {"layers": [{"w", "b"}, ...]},
    "vf": ...}`` (``ray_tpu/rl/models.py:init_policy``) in float32."""
    from ray_tpu_torch.rl.models import policy_dims, policy_param_shapes

    flat = _checked(np_params, policy_param_shapes(spec, hidden),
                    resolve_device(device), torch.float32)
    return {head: {"layers": [{"w": flat[f"{head}/layers/{i}/w"],
                               "b": flat[f"{head}/layers/{i}/b"]}
                              for i in range(len(dims) - 1)]}
            for head, dims in policy_dims(spec, hidden).items()}


def vit_params_from_jax(np_params: dict, cfg, *, device: DeviceLike = None,
                        dtype: Optional[torch.dtype] = None) -> Params:
    """ViT params (``ray_tpu/models/vit.py:init_params``), layer weights
    stacked on [L], in ``dtype`` (default: ``cfg.param_dtype``)."""
    return _unflatten(_checked(np_params, cfg.param_shapes(),
                               resolve_device(device),
                               dtype or cfg.param_dtype))


def params_to_numpy(params: Params) -> dict:
    """The inverse of ``params_from_jax``: the port's params as a pytree of
    float32 numpy arrays shaped like JAX's, copied to the host. Nested
    dicts and lists (the reward model's ``lm``, a policy's layers) keep
    their structure."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [host(v) for v in node]
        return node.detach().to(device="cpu", dtype=torch.float32,
                                copy=True).numpy()

    return host(params)
