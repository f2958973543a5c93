"""ViT: the Vision Transformer classification family (port of
``ray_tpu/models/vit.py``).

A pre-LN ViT (Dosovitskiy et al. 2020) in the Llama module's style: layer
params stacked on a leading [n_layers] axis, ``x @ W`` orientation, fp32
master params cast to the compute dtype where they are used, and the
patch embedding one reshaped matmul (non-overlapping patches need no
convolution).

Attention is bidirectional and written out (two matmuls and an fp32
softmax), as JAX's einsum (``vit.py:130-133``) is: it reaches no Pallas
kernel there, so it launches no flash kernel here. The MLP's GELU is
the tanh approximation, ``jax.nn.gelu``'s default. With ``cfg.remat``
and grad enabled each block runs under ``torch.utils.checkpoint``, as
JAX's ``jax.checkpoint`` over the scan body.

On a mesh (``sharding_rules``, ``data_rules``) the params and batch are
DTensors: the patch embedding and head run under DTensor propagation
with their weights gathered over fsdp, and each block's attention and
MLP run on the rank's blocks (``sharding.rows_map``: rows over dp and
fsdp, heads and ff columns over tp), as the Llama family's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import _unflatten
from ray_tpu_torch.parallel import sharding
from ray_tpu_torch.parallel.sharding import P, ShardingRules

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_classes: int = 1000
    norm_eps: float = 1e-6
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        d, f, L = self.d_model, self.d_ff, self.n_layers
        per_layer = 4 * d * d + 2 * d * f + 4 * d + f + d  # attn+mlp+ln
        return (self.patch_dim * d + d                      # patch proj
                + (self.num_patches + 1) * d + d            # pos + cls
                + L * per_layer + 2 * d                     # final ln
                + d * self.num_classes + self.num_classes)  # head

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's shape, layer weights as ``layers/<name>``."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        return {
            "patch_proj": (self.patch_dim, d), "patch_bias": (d,),
            "cls": (1, 1, d), "pos": (self.num_patches + 1, d),
            "layers/ln1": (L, d), "layers/ln1_b": (L, d),
            "layers/wq": (L, d, d), "layers/wk": (L, d, d),
            "layers/wv": (L, d, d), "layers/wo": (L, d, d),
            "layers/ln2": (L, d), "layers/ln2_b": (L, d),
            "layers/w_up": (L, d, f), "layers/b_up": (L, f),
            "layers/w_down": (L, f, d), "layers/b_down": (L, d),
            "final_ln": (d,), "final_ln_b": (d,),
            "head": (d, self.num_classes), "head_b": (self.num_classes,),
        }


PRESETS: Dict[str, ViTConfig] = {
    "debug": ViTConfig(image_size=32, patch_size=8, d_model=64,
                       n_layers=2, n_heads=4, d_ff=128, num_classes=10),
    "s16": ViTConfig(d_model=384, n_layers=12, n_heads=6, d_ff=1536),
    "b16": ViTConfig(),  # ViT-B/16
}

# JAX's init of each weight matrix: scaled normal over its fan-in
_FAN_IN = {"patch_proj": 0, "wq": 1, "wk": 1, "wv": 1, "wo": 1, "w_up": 1,
           "w_down": 1, "head": 0}


def init_params(cfg: ViTConfig, *, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """JAX's recipe drawn from ``generator`` (on ``device``): weight
    matrices normal / sqrt(fan_in), ``pos`` normal * 0.02, the cls token,
    biases and LN shifts zero, LN scales one; stored in ``dtype``
    (default: ``cfg.param_dtype``)."""
    return _unflatten(dict(init_leaves(cfg, generator=generator,
                                       device=resolve_device(device),
                                       dtype=dtype or cfg.param_dtype)))


def init_leaves(cfg: ViTConfig, *, generator: torch.Generator,
                device: torch.device, dtype: torch.dtype):
    """``init_params``' leaves one at a time, as (flat name, tensor) in
    ``cfg.param_shapes()`` order."""
    for name, shape in cfg.param_shapes().items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in _FAN_IN or leaf == "pos":
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            fan_in = shape[-2] if leaf in _FAN_IN else None
            x.mul_(0.02 if fan_in is None else 1.0 / math.sqrt(fan_in))
            yield name, x.to(dtype)
        elif leaf in ("ln1", "ln2", "final_ln"):
            yield name, torch.ones(shape, dtype=dtype, device=device)
        else:
            yield name, torch.zeros(shape, dtype=dtype, device=device)


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, num_patches, patch_dim] (non-overlapping
    patches as a reshape, equivalent to the stride-P convolution)."""
    B = images.shape[0]
    p = cfg.patch_size
    n = cfg.image_size // p
    x = images.reshape(B, n, p, n, p, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, n, n, p, p, C]
    return x.reshape(B, n * n, cfg.patch_dim)


ATTN_KEYS = ("ln1", "ln1_b", "wq", "wk", "wv", "wo")
MLP_KEYS = ("ln2", "ln2_b", "w_up", "b_up", "w_down")


def _attention_out(cfg: ViTConfig, x: torch.Tensor,
                   lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """What pre-LN attention adds to the residual stream (on a rank's
    blocks, its heads' share); ``lp`` in the compute dtype."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    h = _ln(x, lp["ln1"], lp["ln1_b"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, -1, hd).transpose(1, 2)
    k = (h @ lp["wk"]).reshape(B, S, -1, hd).transpose(1, 2)
    v = (h @ lp["wv"]).reshape(B, S, -1, hd).transpose(1, 2)
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)       # [B, h, S, S]
    att = torch.softmax(att.float(), dim=-1).to(x.dtype)  # bidirectional
    out = (att @ v).transpose(1, 2).reshape(B, S, -1)
    return out @ lp["wo"]


def _mlp_out(cfg: ViTConfig, x: torch.Tensor,
             lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The pre-LN GELU MLP's output before its last bias (on a rank's
    blocks, its ff columns' share)."""
    h = _ln(x, lp["ln2"], lp["ln2_b"], cfg.norm_eps)
    h = F.gelu(h @ lp["w_up"] + lp["b_up"], approximate="tanh")
    return h @ lp["w_down"]


def _tp_split(w, dim: int):
    """A replicated DTensor split over tp along ``dim`` (a local slice,
    no collective): ``b_up`` must match its matmul's ff columns."""
    from torch.distributed.tensor import Shard

    names = w.device_mesh.mesh_dim_names
    if "tp" not in names:
        return w
    places = list(w.placements)
    places[names.index("tp")] = Shard(dim)
    return w.redistribute(w.device_mesh, places)


def _block(cfg: ViTConfig, x: torch.Tensor,
           lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    cd = cfg.compute_dtype
    if not sharding.is_sharded(x):
        lp = {k: w.to(cd) for k, w in lp.items()}
        x = x + _attention_out(cfg, x, lp)
        return x + (_mlp_out(cfg, x, lp) + lp["b_down"])
    lp = {k: sharding.gather_fsdp(w.to(cd)) for k, w in lp.items()}
    lp["b_up"] = _tp_split(lp["b_up"], 0)

    def on_blocks(fn, keys):
        local = lambda x, *ws: fn(cfg, x, dict(zip(keys, ws)))
        return sharding.rows_map(local, x, tuple(lp[k] for k in keys))

    x = sharding.residual_add(x, on_blocks(_attention_out, ATTN_KEYS))
    return sharding.residual_add(x, on_blocks(_mlp_out, MLP_KEYS)
                                 + lp["b_down"])


def forward(params: Params, images: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] float images -> [B, num_classes] fp32 logits."""
    cd = cfg.compute_dtype
    x = patchify(images.to(cd), cfg)
    proj = sharding.gather_fsdp(params["patch_proj"].to(cd))
    x = x @ proj + params["patch_bias"].to(cd)
    B = x.shape[0]
    cls = params["cls"].to(cd).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(cd)
    layers = {k: w.unbind(0) for k, w in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = {k: ws[i] for k, ws in layers.items()}
        if remat:
            x = checkpoint(_block, cfg, x, lp, use_reentrant=False)
        else:
            x = _block(cfg, x, lp)
    x = _ln(x.float(), params["final_ln"], params["final_ln_b"],
            cfg.norm_eps)
    cls_out = x[:, 0]
    head = sharding.gather_fsdp(params["head"].float())
    return cls_out @ head + params["head_b"].float()


def cls_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: ViTConfig) -> torch.Tensor:
    """Softmax cross-entropy over ``batch["images"]`` / ``["labels"]``."""
    logits = forward(params, batch["images"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0]
    return nll.mean()


def sharding_rules() -> ShardingRules:
    """JAX's layout over (dp, fsdp, tp) (``ray_tpu/models/vit.py:175-190``):
    attention and MLP matrices with their contracting and output dims on
    (fsdp, tp); vectors replicated."""
    return ShardingRules([
        (r"patch_proj$", P("fsdp", "tp")),
        (r"head$", P("fsdp", "tp")),
        (r"layers/w[qkv]$", P(None, "fsdp", "tp")),
        (r"layers/wo$", P(None, "tp", "fsdp")),
        (r"layers/w_up$", P(None, "fsdp", "tp")),
        (r"layers/w_down$", P(None, "tp", "fsdp")),
        (r".*", P()),
    ])


def data_rules() -> ShardingRules:
    return ShardingRules([(r".*", P(("dp", "fsdp")))])
