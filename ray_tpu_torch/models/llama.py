"""Llama-family decoder-only transformer (port of ``ray_tpu/models/llama.py``).

Parameters are a plain dict shaped like the JAX pytree: layer weights are
stacked on a leading [n_layers] axis and keep JAX's ``x @ W`` orientation
(``wq`` is [d, hq*hd], ``lm_head`` is [d, V]); with ``tie_embeddings`` the
head is ``embed.T``. The JAX package keeps fp32 params and casts them at
every use; here they are stored in the compute dtype, cast once when they
are made or loaded (``init_params``, ``convert.params_from_jax``): the
values are the same, and casting 27 GB of 7b weights on every decode step
would cost more than the step.

Attention backends: ``attn_impl="xla"`` runs the plain PyTorch ``mha``;
``"flash"`` runs the CUDA flash kernel (its plain version on the CPU).
The pipeline, ring/ulysses, loss and 1f1b branches are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import mha
from ray_tpu_torch.ops.flash import flash_attention
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_angles

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    # "xla" (plain PyTorch mha, the reference) or "flash" (CUDA kernel)
    attn_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        return sum(math.prod(s) for s in _flat_shapes(self).values())


PRESETS: Dict[str, LlamaConfig] = {
    "debug": LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128, max_seq_len=128),
    "debug_draft": LlamaConfig(vocab_size=256, d_model=32, n_layers=1,
                               n_heads=2, n_kv_heads=1, d_ff=64,
                               max_seq_len=128),
    "160m": LlamaConfig(vocab_size=32000, d_model=768, n_layers=12, n_heads=12,
                        n_kv_heads=12, d_ff=2048, max_seq_len=2048),
    "410m": LlamaConfig(vocab_size=32000, d_model=1024, n_layers=24, n_heads=16,
                        n_kv_heads=16, d_ff=2816, max_seq_len=2048),
    "1b": LlamaConfig(vocab_size=32000, d_model=2048, n_layers=22, n_heads=32,
                      n_kv_heads=4, d_ff=5632, max_seq_len=2048),
    "7b": LlamaConfig(),
}

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")


def _flat_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape, layer weights as ``layers/<name>``."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "embed": (cfg.vocab_size, d),
        "layers/attn_norm": (L, d),
        "layers/wq": (L, d, hq * hd),
        "layers/wk": (L, d, hkv * hd),
        "layers/wv": (L, d, hkv * hd),
        "layers/wo": (L, hq * hd, d),
        "layers/mlp_norm": (L, d),
        "layers/w_gate": (L, d, f),
        "layers/w_up": (L, d, f),
        "layers/w_down": (L, f, d),
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def _fan_in(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """Scaled-normal fan-in of a matrix; None for a norm (ones)."""
    if name.endswith("norm"):
        return None
    return shape[1] if name == "embed" else shape[-2]


def _unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    params: Params = {"layers": {}}
    for name, t in flat.items():
        if name.startswith("layers/"):
            params["layers"][name[len("layers/"):]] = t
        else:
            params[name] = t
    return params


def init_params(cfg: LlamaConfig, *, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Scaled-normal init from ``generator`` (which must live on
    ``device``); layer params stacked on a leading [n_layers] axis, stored
    in ``dtype`` (default: the compute dtype)."""
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    flat = {}
    for name, shape in _flat_shapes(cfg).items():
        fan_in = _fan_in(name, shape)
        if fan_in is None:
            flat[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        flat[name] = x.mul_(1.0 / math.sqrt(fan_in)).to(dtype)
        del x
    return _unflatten(flat)


def layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights: views into the stacked tensors."""
    return {k: w[i] for k, w in params["layers"].items()}


def lm_head(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def attend(cfg: LlamaConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, *, q_offset: Union[int, torch.Tensor] = 0,
           segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention through the configured backend."""
    if cfg.attn_impl != "xla" and segment_ids is not None:
        raise NotImplementedError(
            f"segment_ids (packed sequences) require attn_impl='xla'; got "
            f"{cfg.attn_impl!r} — failing loudly rather than attending "
            f"across document boundaries")
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True, q_offset=q_offset)
    if cfg.attn_impl == "xla":
        return mha(q, k, v, causal=True, segment_ids=segment_ids,
                   q_offset=q_offset)
    raise NotImplementedError(
        f"attn_impl={cfg.attn_impl!r} is not ported yet (ROADMAP.md)")


def attention_half(cfg: LlamaConfig, x: torch.Tensor,
                   layer: Dict[str, torch.Tensor],
                   sin: torch.Tensor, cos: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Pre-norm attention + residual."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    q = apply_rope((h @ layer["wq"]).reshape(b, s, hq, hd), sin, cos)
    k = apply_rope((h @ layer["wk"]).reshape(b, s, hkv, hd), sin, cos)
    v = (h @ layer["wv"]).reshape(b, s, hkv, hd)
    attn = attend(cfg, q, k, v, segment_ids=segment_ids)
    return x + attn.reshape(b, s, hq * hd) @ layer["wo"]


def ffn_half(cfg: LlamaConfig, x: torch.Tensor,
             layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pre-norm SwiGLU MLP + residual — shared by the train and decode
    paths."""
    h = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
    gate = F.silu(h @ layer["w_gate"])
    up = h @ layer["w_up"]
    return x + (gate * up) @ layer["w_down"]


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [batch, seq] -> (final-norm hidden [batch, seq, d], head
    [d, V]), both in the compute dtype."""
    x = params["embed"][tokens]
    sin, cos = rope_angles(tokens.shape[1], cfg.head_dim, cfg.rope_theta,
                           cfg.compute_dtype, x.device)
    for i in range(cfg.n_layers):
        layer = layer_params(params, i)
        x = attention_half(cfg, x, layer, sin, cos, segment_ids)
        x = ffn_half(cfg, x, layer)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, lm_head(params, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [batch, seq] -> logits [batch, seq, vocab] (fp32)."""
    x, head = forward_hidden(params, tokens, cfg, segment_ids)
    return (x @ head).float()
