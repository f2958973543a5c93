"""Multi-head attention with GQA, causal masking and segment ids.

Port of ``ray_tpu/ops/attention.py``: plain PyTorch, the always-correct
path and the numerics reference for the flash kernel. ``q_offset`` may be
an int or a per-row tensor ``[b]`` (batched decode gives each row its own
position).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -2.0**30  # large finite negative; avoids NaN from (-inf) - (-inf)


def causal_mask(sq: int, sk: int, q_offset: Union[int, torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """Bool mask ``[b or 1, 1, sq, sk]``: query i (at ``i + q_offset``)
    sees keys ``<=`` its position."""
    qpos = torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    if isinstance(q_offset, torch.Tensor):
        off = q_offset.to(device=device, dtype=torch.long).reshape(-1, 1, 1, 1)
    else:
        off = int(q_offset)
    return (qpos[None, None, :, None] + off) >= kpos[None, None, None, :]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True,
        segment_ids: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        scale: Optional[float] = None,
        q_offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Attention over [batch, seq, heads, head_dim] tensors.

    Supports GQA: k/v may have fewer heads than q as long as
    ``q_heads % kv_heads == 0``. ``q`` is scaled before the dot, the
    softmax runs in fp32 and its weights are cast to q's dtype before PV.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    scale = scale if scale is not None else d ** -0.5
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    group = hq // hkv
    # fp32 products of the compute-dtype inputs: the einsum's
    # preferred_element_type=float32 in the reference
    qs = (q * scale).reshape(b, sq, hkv, group, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.float())
    logits = logits.reshape(b, hq, sq, sk)

    mask = causal_mask(sq, sk, q_offset, q.device) if causal else None
    if segment_ids is not None:
        # [b, 1, sq, sk]; cross-segment attention is masked (packed sequences)
        seg_mask = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    if bias is not None:
        logits = logits + bias

    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    weights = weights.reshape(b, hkv, group, sq, sk)
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights, v)
    return out.reshape(b, sq, hq, d)
