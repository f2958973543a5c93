"""Analytic FLOPs of a train step and model-FLOPs utilization on one H100.

The port's own copy of ``ray_tpu/util/flops.py``'s training formulas (the
standard estimates: a matmul touching N parameters costs 2N FLOPs a token
forward and 4N backward, so a train step is 6N a token plus the attention
term 6 * L * S * hq * hd). The peak is the H100 SXM's dense bf16 tensor
rate from NVIDIA's data sheet, at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Optional

H100_BF16_PEAK_FLOPS = 989e12


def train_flops_per_token(cfg, seq: int) -> float:
    """Fwd+bwd FLOPs per trained token: 6N + the attention term."""
    attn = 6 * cfg.n_layers * seq * cfg.n_heads * cfg.head_dim
    return 6.0 * cfg.num_params() + attn


def train_step_flops(cfg, batch: int, seq: int) -> float:
    """One optimizer step over a [batch, seq] token block."""
    return batch * seq * train_flops_per_token(cfg, seq)


def mfu(flops: float, seconds: float, n_devices: int = 1,
        peak_per_device: Optional[float] = None) -> float:
    """Model-FLOPs utilization: analytic work / (wall * aggregate peak)."""
    if seconds <= 0 or flops <= 0:
        return 0.0
    peak = H100_BF16_PEAK_FLOPS if peak_per_device is None else peak_per_device
    return flops / (seconds * peak * max(1, n_devices))
