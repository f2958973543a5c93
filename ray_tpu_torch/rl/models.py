"""Policy and value networks and their action distributions (port of
``ray_tpu/rl/models.py``): MLP heads, the conv encoder for pixel specs,
and the categorical and diagonal Gaussian distributions.

Params keep JAX's tree: ``{"pi": {"layers": [{"w", "b"}, ...]}, "vf":
...}`` with each ``w`` [in, out] for ``x @ w + b``; pixel specs add
``"enc": {"convs": [{"w", "b", "s"}, ...], "dense": {"w", "b"}}`` with
HWIO conv weights, continuous specs a ``"log_std"`` [action_dim]. Two
kinds of zero leaves carry meaning by their shape alone, as in JAX: a
conv's ``s`` (its stride is ``s.shape[0]``) and an MLP's ``act`` (shape
(1,) means relu; no leaf means tanh). They go through the optimizer,
conversion and checkpoints like any leaf and stay zero. Init is JAX's
recipe (orthogonal from the QR of a normal matrix, sqrt(2) gain,
``out_scale`` on the last layer, He-normal convs, zero biases) drawn from
a ``torch.Generator``; the draws are not JAX's.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.train_step import _leaves
from ray_tpu_torch.rl.env import EnvSpec


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists),
    as ``jax.tree_util.tree_map``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *items) for items in zip(*trees)]
    return fn(*trees)


def clone_tree(tree):
    """A copy of every tensor leaf (JAX's ``tree_map(jnp.copy, ...)``):
    the copy shares no storage with ``tree``; other leaves are kept."""
    return tree_map(
        lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
        tree)


def host_tree(tree):
    """A tree's tensor leaves on the host (other leaves kept): what an
    actor without a GPU can read."""
    return tree_map(
        lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
        tree)


def params_to_device(params, device: torch.device):
    """A params tree (numpy arrays or tensors) as float32 tensors on
    ``device``: numpy leaves are copied, tensors already there are kept."""
    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(x), dtype=torch.float32,
                            device=device)

    return tree_map(put, params)


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
    """tanh between layers (relu where the tree has an ``act`` leaf of
    shape (1,)), none after the last."""
    h = x
    n = len(params["layers"])
    relu = "act" in params and params["act"].shape[0] == 1
    for i, layer in enumerate(params["layers"]):
        h = h @ layer["w"] + layer["b"]
        if i < n - 1:
            h = torch.relu(h) if relu else torch.tanh(h)
    return h


# Conv encoder for pixel specs: the Nature CNN (Mnih et al. 2015) for
# full-size frames, a compact stack for small boards (Nature's 8x4 front
# end collapses anything under 36px to zero). Shared by the policy and
# value heads.
_NATURE_SPECS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (feat, kernel, stride)
_SMALL_SPECS = ((32, 3, 1), (64, 3, 2), (64, 3, 1))  # boards >= 9px


def _conv_specs_for(h: int, w: int):
    return _NATURE_SPECS if min(h, w) >= 36 else _SMALL_SPECS


def _conv_out_hw(h: int, w: int, specs) -> Tuple[int, int]:
    for _, k, s in specs:
        h = (h - k) // s + 1
        w = (w - k) // s + 1
        if h < 1 or w < 1:
            raise ValueError(f"obs too small for conv stack at {(h, w)}")
    return h, w


def init_cnn(gen: torch.Generator, obs_shape: Sequence[int],
             out_dim: int = 512) -> Dict:
    """The conv stack for (H, W, C) frames and its dense layer to
    ``out_dim`` features, on ``gen``'s device."""
    h, w, c = obs_shape
    specs = _conv_specs_for(h, w)
    convs = []
    in_ch = c
    for feat, k, stride in specs:
        fan_in = k * k * in_ch
        wt = torch.randn((k, k, in_ch, feat), generator=gen,
                         dtype=torch.float32, device=gen.device)
        convs.append({
            "w": wt * math.sqrt(2.0 / fan_in),
            "b": torch.zeros(feat, dtype=torch.float32, device=gen.device),
            # the stride rides as a shape: cnn_forward reads s.shape[0]
            "s": torch.zeros(stride, dtype=torch.float32, device=gen.device),
        })
        in_ch = feat
    oh, ow = _conv_out_hw(h, w, specs)
    dense = _dense_init(gen, oh * ow * in_ch, out_dim, scale=math.sqrt(2.0))
    return {"convs": convs, "dense": dense}


def cnn_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] pixels -> [..., F] features (relu conv stack, VALID
    padding). JAX convolves NHWC input with HWIO weights; ``conv2d`` takes
    NCHW and OIHW, so both are permuted for the conv and the features are
    permuted back to NHWC before the flatten, which keeps the dense rows
    in JAX's order."""
    lead = x.shape[:-3]
    x = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    for conv in params["convs"]:
        stride = conv["s"].shape[0]
        x = F.conv2d(x, conv["w"].permute(3, 2, 0, 1), conv["b"],
                     stride=stride)
        x = torch.relu(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(x @ params["dense"]["w"] + params["dense"]["b"])
    return x.reshape(tuple(lead) + (x.shape[-1],))


def policy_dims(spec: EnvSpec, hidden: Sequence[int] = (64, 64),
                encoder_out: int = 512) -> Dict[str, Tuple[int, ...]]:
    """The layer widths of each head: from the obs through ``hidden`` for
    flat specs, from the encoder's ``encoder_out`` features straight to the
    output for pixel specs (``hidden`` unused), as ``init_policy``
    builds them."""
    out = spec.num_actions if spec.discrete else spec.action_dim
    if spec.is_pixel:
        return {"pi": (encoder_out, out), "vf": (encoder_out, 1)}
    return {"pi": (spec.obs_dim, *hidden, out),
            "vf": (spec.obs_dim, *hidden, 1)}


def policy_param_shapes(spec: EnvSpec, hidden: Sequence[int] = (64, 64), *,
                        activation: str = "tanh", encoder_out: int = 512
                        ) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape by its path (``pi/layers/0/w``) in the tree that
    ``init_policy`` (tanh) or a Catalog's ``mlp``/``cnn`` builder
    (``activation`` relu adds ``pi/act`` and ``vf/act`` to a flat
    policy) makes."""
    shapes = {}
    if spec.is_pixel:
        h, w, c = spec.obs_shape
        specs = _conv_specs_for(h, w)
        in_ch = c
        for i, (feat, k, stride) in enumerate(specs):
            shapes[f"enc/convs/{i}/w"] = (k, k, in_ch, feat)
            shapes[f"enc/convs/{i}/b"] = (feat,)
            shapes[f"enc/convs/{i}/s"] = (stride,)
            in_ch = feat
        oh, ow = _conv_out_hw(h, w, specs)
        shapes["enc/dense/w"] = (oh * ow * in_ch, encoder_out)
        shapes["enc/dense/b"] = (encoder_out,)
    for head, dims in policy_dims(spec, hidden, encoder_out).items():
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"{head}/layers/{i}/w"] = (a, b)
            shapes[f"{head}/layers/{i}/b"] = (b,)
        if activation == "relu" and not spec.is_pixel:
            shapes[f"{head}/act"] = (1,)
    if not spec.discrete:
        shapes["log_std"] = (spec.action_dim,)
    return shapes


def init_policy(gen: torch.Generator, spec: EnvSpec,
                hidden: Sequence[int] = (64, 64)) -> Dict:
    """A policy's params on ``gen``'s device: the logits head at out_scale
    0.01, the value head at 1.0, a 512-feature conv encoder for pixel
    specs and a zero ``log_std`` for continuous ones."""
    dims = policy_dims(spec, hidden)
    params = {"pi": init_mlp(gen, dims["pi"]),
              "vf": init_mlp(gen, dims["vf"], out_scale=1.0)}
    if spec.is_pixel:
        params = {"enc": init_cnn(gen, spec.obs_shape, dims["pi"][0]),
                  **params}
    if not spec.discrete:
        params["log_std"] = torch.zeros(spec.action_dim, dtype=torch.float32,
                                        device=gen.device)
    return params


def _encode(params: Dict, obs: torch.Tensor) -> torch.Tensor:
    if "enc" in params:
        return cnn_forward(params["enc"], obs)
    return obs


def policy_logits(params: Dict, obs: torch.Tensor) -> torch.Tensor:
    return mlp_forward(params["pi"], _encode(params, obs))


def value(params: Dict, obs: torch.Tensor) -> torch.Tensor:
    return mlp_forward(params["vf"], _encode(params, obs))[..., 0]


# ---- distributions ----

# the device mesh of the learner update running on this thread, if any
# (``noise_on_mesh``)
_noise_mesh = threading.local()


@contextlib.contextmanager
def noise_on_mesh(mesh):
    """Within this block, on this thread, every draw of ``gumbel``,
    ``normal`` and ``uniform`` is a ``Replicate()`` DTensor on ``mesh``:
    the generator is rank-identical, so each rank draws the same global
    noise, which DTensor then combines with a sharded batch as JAX's
    jitted update combines its replicated key's draws."""
    before = getattr(_noise_mesh, "mesh", None)
    _noise_mesh.mesh = mesh
    try:
        yield
    finally:
        _noise_mesh.mesh = before


def _drawn(t: torch.Tensor) -> torch.Tensor:
    mesh = getattr(_noise_mesh, "mesh", None)
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gumbel(gen: torch.Generator, shape,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard Gumbel draws of ``shape`` on ``gen``'s device:
    ``-log(-log(u))`` of uniform draws clamped below at ``dtype``'s tiny
    (``jax.random.gumbel``'s recipe; the draws are not JAX's)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype,
                   device=gen.device).clamp_(min=tiny)
    return _drawn(-torch.log(-torch.log(u)))


def categorical_sample(gen: torch.Generator,
                       logits: torch.Tensor) -> torch.Tensor:
    """One action per row, drawn as ``jax.random.categorical`` draws
    (Gumbel-max: argmax of logits plus ``gumbel`` noise of their shape)
    from ``gen``; no host read."""
    return torch.argmax(logits + gumbel(gen, logits.shape, logits.dtype),
                        dim=-1)


def categorical_logp(logits: torch.Tensor,
                     actions: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def gaussian_sample(gen: torch.Generator, mean: torch.Tensor,
                    log_std: torch.Tensor) -> torch.Tensor:
    noise = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                        device=mean.device)
    return mean + torch.exp(log_std) * noise


def gaussian_logp(mean: torch.Tensor, log_std: torch.Tensor,
                  actions: torch.Tensor) -> torch.Tensor:
    var = torch.exp(2 * log_std)
    return torch.sum(
        -0.5 * ((actions - mean) ** 2 / var + 2 * log_std
                + math.log(2 * math.pi)), dim=-1)


def gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))


# ---- noise inside the off-policy losses ----
# SAC, CQL, CRR and TD3 draw their noise through these two, in the order
# JAX's losses draw theirs from the learner's key; the draws come from the
# learner's generator (they are not JAX's).


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal draws of ``shape`` on ``gen``'s device."""
    return _drawn(torch.randn(tuple(shape), generator=gen,
                              dtype=torch.float32, device=gen.device))


def uniform(gen: torch.Generator, shape, low: float,
            high: float) -> torch.Tensor:
    """Uniform draws in [low, high) of ``shape`` on ``gen``'s device."""
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                   device=gen.device)
    return _drawn(low + (high - low) * u)


def num_params(params) -> int:
    return sum(int(t.numel()) for t in _leaves(params).values())
