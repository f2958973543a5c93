"""Carry a JAX parameter pytree into the port.

The JAX package's Llama and MoE params (``ray_tpu/models/llama.py`` and
``moe.py``, ``init_params``) arrive as numpy arrays, layers stacked on a
leading [L] axis; the port keeps that structure and orientation, so
conversion is a checked copy of each leaf the config's family lists
(``cfg.param_shapes()``) and one cast to the compute dtype. The same
holds for the RLHF reward model (a Llama trunk plus a head,
``ray_tpu/rl/rlhf/models.py``), the RL policies (``ray_tpu/rl/models.py``
and ``rl_module.py``'s Catalog: heads, conv encoder, ``log_std``), the
off-policy and recurrent RL algorithms' trees (checked against the
port's own init of the same config) and ViT
(``ray_tpu/models/vit.py``). Every converter raises
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


def _tree_from_paths(flat: Dict[str, torch.Tensor]) -> dict:
    """Nest ``{"a/0/b": t}`` back into ``{"a": [{"b": t}]}``: a part of
    digits indexes a list."""
    root: dict = {}
    for name, leaf in flat.items():
        parts = name.split("/")
        node = root
        for part, nxt in zip(parts[:-1], parts[1:]):
            key = int(part) if isinstance(node, list) else part
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = child
            else:
                node.setdefault(key, child)
            node = node[key]
        last = parts[-1]
        if isinstance(node, list):
            while len(node) <= int(last):
                node.append(None)
            node[int(last)] = leaf
        else:
            node[last] = leaf
    return root


def policy_params_from_jax(np_params: dict, spec,
                           hidden: Sequence[int] = (64, 64), *,
                           activation: str = "tanh", encoder_out: int = 512,
                           device: DeviceLike = None) -> dict:
    """A policy tree that ``ray_tpu/rl/models.py:init_policy`` or the
    Catalog's ``mlp``/``cnn`` builders make, in float32: the heads, and
    where the spec asks, the conv encoder ``enc`` (HWIO weights, stride
    leaves ``s``), ``log_std``, and for ``activation="relu"`` the ``act``
    markers. Every leaf is shape-checked against
    ``policy_param_shapes``."""
    from ray_tpu_torch.rl.models import policy_param_shapes

    shapes = policy_param_shapes(spec, hidden, activation=activation,
                                 encoder_out=encoder_out)
    return _tree_from_paths(_checked(np_params, shapes,
                                     resolve_device(device), torch.float32))


def rl_params_from_jax(np_params: dict, like, *,
                       device: DeviceLike = None) -> dict:
    """The params tree of an off-policy, recurrent, multi-agent or
    model-based RL algorithm from JAX's numpy tree, in float32: DQN's
    ``{q, target}``, DDPG's and TD3's ``{pi, q1[, q2], *_target}``, SAC's,
    CQL's and CRR's ``{pi, q1, q2, q1_target, q2_target[, log_alpha]}``,
    R2D2's ``{q, target}`` with the GRU's ``wx``, ``wh``, ``b``; QMIX's
    ``{agent, mixer, target_agent, target_mixer}`` (the mixer's four
    hypernetworks), MADDPG's lists ``{actors, critics, actors_t,
    critics_t}``, MAML's ``{pi, log_std}``, MBMPO's [K]-stacked ensemble
    (every leaf led by the member axis), DreamerV3's world model
    ``{enc, gru, prior, post, dec, rew, cont}``, actor and critic,
    AlphaZero's and LeelaChessZero's ``{pi, v}``, SlateQ's ``{q,
    target}`` and the Decision Transformer's tree (its ``blocks`` list of
    ``{qkv, proj, fc1, fc2}`` and the ``emb_t`` table). ES and ARS take
    JAX's flat float64 center as it is.
    ``like`` is a tree the port's own init
    made for the same config (an algorithm's ``get_params()``): every leaf
    it has is copied from ``np_params`` and shape-checked against it, on
    ``device`` (``like``'s device unless given)."""
    from ray_tpu_torch.parallel.train_step import _leaves

    leaves = _leaves(like)
    shapes = {name: tuple(t.shape) for name, t in leaves.items()}
    if device is None:
        device = next(iter(leaves.values())).device
    return _tree_from_paths(_checked(np_params, shapes,
                                     resolve_device(device), torch.float32))


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
    their structure; numpy leaves (the bandits' float64 arm statistics)
    are copied as they are."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [host(v) for v in node]
        if isinstance(node, np.ndarray):
            return node.copy()
        return node.detach().to(device="cpu", dtype=torch.float32,
                                copy=True).numpy()

    return host(params)
