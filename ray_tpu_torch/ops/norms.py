"""Normalization ops (port of ``ray_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the variance in float32 (bf16 squares underflow), the
    result cast back to the input dtype and then scaled by the weight in
    that dtype."""
    dtype = x.dtype
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(dtype) * weight
