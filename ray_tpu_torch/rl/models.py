"""Policy and value networks and the categorical distribution (the MLP and
categorical parts of ``ray_tpu/rl/models.py``; the CNN encoder and the
Gaussian distribution are not ported yet).

Params keep JAX's tree: ``{"pi": {"layers": [{"w", "b"}, ...]}, "vf":
...}``, each ``w`` [in, out] for ``x @ w + b``. Init is JAX's recipe
(orthogonal from the QR of a normal matrix, sqrt(2) gain, ``out_scale``
on the last layer, zero biases) drawn from a ``torch.Generator``; the
draws are not JAX's.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from ray_tpu_torch.rl.env import EnvSpec


def _dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
                scale: float = 1.0) -> Dict[str, torch.Tensor]:
    mat = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                      device=gen.device)
    q, r = torch.linalg.qr(mat)
    q = q * torch.sign(torch.diagonal(r))[None, :q.shape[1]]
    if q.shape != (in_dim, out_dim):
        # jnp.resize: the flattened matrix repeated to fill the shape
        flat = q.reshape(-1)
        reps = math.ceil(in_dim * out_dim / flat.numel())
        q = flat.repeat(reps)[:in_dim * out_dim].reshape(in_dim, out_dim)
    return {"w": q * scale,
            "b": torch.zeros(out_dim, dtype=torch.float32,
                             device=gen.device)}


def init_mlp(gen: torch.Generator, dims: Sequence[int],
             out_scale: float = 0.01) -> Dict:
    """Dense layers ``dims[0] -> ... -> dims[-1]`` on ``gen``'s device."""
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        scale = out_scale if i == len(dims) - 2 else math.sqrt(2.0)
        layers.append(_dense_init(gen, a, b, scale))
    return {"layers": layers}


def mlp_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """tanh between layers, none after the last. (JAX's relu marker, an
    ``act`` leaf the rl_module catalogs add, is not ported: no port
    params carry it.)"""
    h = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = h @ layer["w"] + layer["b"]
        if i < n - 1:
            h = torch.tanh(h)
    return h


def policy_dims(spec: EnvSpec, hidden: Sequence[int]
                ) -> Dict[str, Tuple[int, ...]]:
    """The layer widths of each head of a flat discrete policy."""
    if spec.is_pixel or not spec.discrete:
        raise NotImplementedError(
            "pixel and continuous policies (the CNN encoder, the Gaussian "
            "head) are not ported yet")
    return {"pi": (spec.obs_dim, *hidden, spec.num_actions),
            "vf": (spec.obs_dim, *hidden, 1)}


def policy_param_shapes(spec: EnvSpec, hidden: Sequence[int] = (64, 64)
                        ) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape by its path (``pi/layers/0/w``)."""
    shapes = {}
    for head, dims in policy_dims(spec, hidden).items():
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"{head}/layers/{i}/w"] = (a, b)
            shapes[f"{head}/layers/{i}/b"] = (b,)
    return shapes


def init_policy(gen: torch.Generator, spec: EnvSpec,
                hidden: Sequence[int] = (64, 64)) -> Dict:
    """A flat discrete policy's params on ``gen``'s device: the logits
    head at out_scale 0.01, the value head at 1.0."""
    dims = policy_dims(spec, hidden)
    return {"pi": init_mlp(gen, dims["pi"]),
            "vf": init_mlp(gen, dims["vf"], out_scale=1.0)}


def policy_logits(params: Dict, obs: torch.Tensor) -> torch.Tensor:
    return mlp_forward(params["pi"], obs)


def value(params: Dict, obs: torch.Tensor) -> torch.Tensor:
    return mlp_forward(params["vf"], obs)[..., 0]


# ---- distributions ----


def categorical_sample(gen: torch.Generator,
                       logits: torch.Tensor) -> torch.Tensor:
    """One action per row, drawn as ``jax.random.categorical`` draws
    (Gumbel-max: argmax of logits plus Gumbel noise) from ``gen``; no host
    read."""
    tiny = torch.finfo(logits.dtype).tiny
    u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype,
                   device=logits.device).clamp_(min=tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def categorical_logp(logits: torch.Tensor,
                     actions: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)
