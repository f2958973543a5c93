"""Analytic FLOPs of a train step or a generation and model-FLOPs
utilization on one H100.

The port's own copy of ``ray_tpu/util/flops.py``'s formulas (the
standard estimates: a matmul touching N parameters costs 2N FLOPs a token
forward and 4N backward, so a train step is 6N a token plus the attention
term 6 * L * S * hq * hd; a decoded token 2N plus attention over its live
context, 4 * L * hq * hd * ctx, with no causal halving; a prefill 2N a
token plus 2 * L * S * hq * hd; a MoE config counts its ACTIVE
parameters, the top-k experts a token runs through, not all of them; a
ViT step counts every patch token and the non-causal attention term).
JAX's ``peak_flops_per_chip`` reads a table of TPU peaks; the port has
one peak, the H100 SXM's dense bf16 tensor rate from NVIDIA's data sheet,
at the full 700 W power limit."""

from __future__ import annotations

from typing import Optional

H100_BF16_PEAK_FLOPS = 989e12


def _flops_params(cfg) -> int:
    """The FLOPs-relevant parameter count: active params for MoE (top-k
    experts per token), total params otherwise."""
    active = getattr(cfg, "active_params", None)
    return active() if callable(active) else cfg.num_params()


def train_flops_per_token(cfg, seq: int) -> float:
    """Fwd+bwd FLOPs per trained token: 6N + the attention term."""
    attn = 6 * cfg.n_layers * seq * cfg.n_heads * cfg.head_dim
    return 6.0 * _flops_params(cfg) + attn


def train_step_flops(cfg, batch: int, seq: int) -> float:
    """One optimizer step over a [batch, seq] token block."""
    return batch * seq * train_flops_per_token(cfg, seq)


def decode_flops_per_token(cfg, context: int) -> float:
    """One-token forward with a KV cache holding ``context`` positions."""
    attn = 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * context
    return 2.0 * _flops_params(cfg) + attn


def prefill_flops(cfg, batch: int, seq: int) -> float:
    """Batched prompt forward (causal attention over the prompt)."""
    attn = 2 * cfg.n_layers * seq * cfg.n_heads * cfg.head_dim
    return batch * seq * (2.0 * _flops_params(cfg) + attn)


def generate_flops(cfg, batch: int, prompt_len: int,
                   new_tokens: int) -> float:
    """Prefill + autoregressive decode of ``new_tokens`` tokens. The decode
    attention term uses the mean live context (prompt + T/2)."""
    ctx = prompt_len + new_tokens / 2.0
    return (prefill_flops(cfg, batch, prompt_len)
            + batch * new_tokens * decode_flops_per_token(cfg, ctx))


def vit_step_flops(cfg, batch: int) -> float:
    """ViT classification train step: 6N per patch token (the cls token
    included) plus the NON-causal attention term (every token attends to
    every token)."""
    tokens = cfg.num_patches + 1
    attn = 12 * cfg.n_layers * tokens * cfg.n_heads * cfg.head_dim
    return batch * tokens * (6.0 * cfg.num_params() + attn)


def mfu(flops: float, seconds: float, n_devices: int = 1,
        peak_per_device: Optional[float] = None) -> float:
    """Model-FLOPs utilization: analytic work / (wall * aggregate peak)."""
    if seconds <= 0 or flops <= 0:
        return 0.0
    peak = H100_BF16_PEAK_FLOPS if peak_per_device is None else peak_per_device
    return flops / (seconds * peak * max(1, n_devices))
