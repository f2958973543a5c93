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
JAX's ``jax.checkpoint`` over the scan body. The mesh ``sharding_rules``
and ``data_rules`` are not ported yet.
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
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    flat = {}
    for name, shape in cfg.param_shapes().items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in _FAN_IN or leaf == "pos":
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            fan_in = shape[-2] if leaf in _FAN_IN else None
            x.mul_(0.02 if fan_in is None else 1.0 / math.sqrt(fan_in))
            flat[name] = x.to(dtype)
        elif leaf in ("ln1", "ln2", "final_ln"):
            flat[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            flat[name] = torch.zeros(shape, dtype=dtype, device=device)
    return _unflatten(flat)


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


def _block(cfg: ViTConfig, x: torch.Tensor,
           lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    cd = cfg.compute_dtype
    lp = {k: w.to(cd) for k, w in lp.items()}
    B, S, d = x.shape
    hd = cfg.head_dim
    h = _ln(x, lp["ln1"], lp["ln1_b"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, hd).transpose(1, 2)
    k = (h @ lp["wk"]).reshape(B, S, cfg.n_heads, hd).transpose(1, 2)
    v = (h @ lp["wv"]).reshape(B, S, cfg.n_heads, hd).transpose(1, 2)
    att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)       # [B, h, S, S]
    att = torch.softmax(att.float(), dim=-1).to(x.dtype)  # bidirectional
    out = (att @ v).transpose(1, 2).reshape(B, S, d)
    x = x + out @ lp["wo"]
    h = _ln(x, lp["ln2"], lp["ln2_b"], cfg.norm_eps)
    h = F.gelu(h @ lp["w_up"] + lp["b_up"], approximate="tanh")
    return x + (h @ lp["w_down"] + lp["b_down"])


def forward(params: Params, images: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] float images -> [B, num_classes] fp32 logits."""
    cd = cfg.compute_dtype
    x = patchify(images.to(cd), cfg)
    x = x @ params["patch_proj"].to(cd) + params["patch_bias"].to(cd)
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
    return cls_out @ params["head"].float() + params["head_b"].float()


def cls_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: ViTConfig) -> torch.Tensor:
    """Softmax cross-entropy over ``batch["images"]`` / ``["labels"]``."""
    logits = forward(params, batch["images"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0]
    return nll.mean()
