"""Rotary position embeddings (port of ``ray_tpu/ops/rope.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_angles(seq_len: int, head_dim: int, theta: float = 10000.0,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables of shape [seq_len, head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, inv_freq)
    return torch.sin(angles).to(dtype), torch.cos(angles).to(dtype)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate the interleaved pairs (x[..., ::2], x[..., 1::2]).

    x: [batch, seq, heads, head_dim]; sin/cos: [max_seq, head_dim//2]
    tables, gathered at ``positions`` ([batch, seq], defaults to arange)."""
    if positions is None:
        s = sin[: x.shape[1]][None, :, None, :]
        c = cos[: x.shape[1]][None, :, None, :]
    else:
        s = sin[positions][:, :, None, :]
        c = cos[positions][:, :, None, :]
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    rotated = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)
