"""Flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Port of ``ray_tpu/ops/pallas/flash.py``'s forward (``_fwd_kernel``, launched
by ``_flash_fwd_bhsd``). The kernel is ``csrc/flash_fwd.cu``; its source
note says what bounds it and what the design does about it. The wrappers
keep the JAX layout: q, k, v are [batch, seq, heads, head_dim], ``lse`` is
[batch, heads, seq].

``q_offset`` is the absolute position of q[0] relative to k[0]: an int, or
an int32 tensor of shape [b] (one position per row, as batched decode
needs), on the device of q. It may be negative: a fully masked row gives
``o == 0`` and ``lse == NEG_INF``.

For a CPU tensor the wrappers run the plain version; for a CUDA tensor
they launch the kernel or raise. There is no backward yet (ROADMAP.md,
Queue 2: ``_dq_kernel`` and ``_dkv_kernel``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import NEG_INF, causal_mask

Offset = Union[int, torch.Tensor]
HEAD_DIMS = (16, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SQ = 65535 * 16    # grid.y holds one 16-row query tile per index
_fns = None


def _offsets(q_offset: Offset, b: int, device: torch.device) -> torch.Tensor:
    """``q_offset`` as a contiguous int32 tensor [b] on ``device``."""
    if not isinstance(q_offset, torch.Tensor):
        return torch.full((b,), int(q_offset), dtype=torch.int32,
                          device=device)
    if q_offset.dim() > 1 or q_offset.numel() not in (1, b):
        raise ValueError(f"q_offset must be a scalar or shape [{b}], got "
                         f"{tuple(q_offset.shape)}")
    if q_offset.device != device:
        raise ValueError(f"q_offset is on {q_offset.device}, q on {device}")
    return q_offset.to(torch.int32).reshape(-1).expand(b).contiguous()


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: Offset = 0, *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (o [b,sq,hq,d], lse [b,hq,sq]).

    The kernel's arithmetic in one pass: fp32 scores scaled after the dot,
    masked to NEG_INF, exp against the row max, p rounded to V's dtype
    before PV, l summed from the fp32 p, and the dead-row rule (o = 0,
    lse = NEG_INF where no key is visible)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    scale = scale if scale is not None else d ** -0.5
    group = hq // hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.reshape(b, sq, hkv, group, d).float(), k.float())
    s = s.reshape(b, hq, sq, sk) * scale
    if causal:
        s = torch.where(causal_mask(sq, sk, q_offset, q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    dead = m <= NEG_INF / 2
    p = torch.where(dead, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)                       # [b, hq, sq, 1]
    l_safe = torch.where(l == 0.0, 1.0, l)
    pv = p.to(v.dtype).float().reshape(b, hkv, group, sq, sk)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", pv, v.float())
    o = acc.reshape(b, hq, sq, d) / l_safe
    o = o.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return o, lse


def _kernel_fns():
    """(launch, error_string) from the built library, typed once."""
    global _fns
    if _fns is None:
        lib = _build.load("flash_fwd")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rtt_flash_fwd.argtypes = ([I, I] + [P] * 6 + [I] * 5 + [L] * 9
                                      + [ctypes.c_float, I, P])
        lib.rtt_flash_fwd.restype = I
        lib.rtt_cuda_error_string.argtypes = [I]
        lib.rtt_cuda_error_string.restype = ctypes.c_char_p
        _fns = (lib.rtt_flash_fwd, lib.rtt_cuda_error_string)
    return _fns


def _check_cuda_inputs(q, k, v) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_fwd takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_fwd takes head_dim in {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim must be contiguous")
        # rows are read as 16-byte chunks
        if x.data_ptr() % 16 or any((st * x.element_size()) % 16
                                    for st in x.stride()[:-1]):
            raise ValueError(f"{name} must be 16-byte aligned in every row")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: Offset = 0, *, causal: bool = True,
              scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ported ``_fwd_kernel``: (o [b,sq,hq,d] in q's dtype,
    lse [b,hq,sq] fp32). ``flash_fwd.launches`` counts kernel launches."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not divisible by kv heads {hkv}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention has no backward yet: see ROADMAP.md, Queue 2 "
            "(_dq_kernel and _dkv_kernel, with the train step)")
    scale = float(scale if scale is not None else d ** -0.5)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, q_offset, causal=causal,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, got {q.device}")
    _check_cuda_inputs(q, k, v)
    if sq > MAX_SQ:
        raise ValueError(f"flash_fwd takes at most {MAX_SQ} queries, got {sq}")
    offs = _offsets(q_offset, b, q.device)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or sk == 0:
        o.zero_()
        lse.fill_(NEG_INF)
        return o, lse
    launch, error_string = _kernel_fns()
    # the C side launches on the calling thread's current device
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                     offs.data_ptr(), b, sq, sk, hq, hkv, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], scale, int(causal),
                     stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: "
                           + error_string(err).decode())
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: Offset = 0) -> torch.Tensor:
    """Flash attention over [batch, seq, heads, head_dim]; forward only."""
    return flash_fwd(q, k, v, q_offset, causal=causal, scale=scale)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             scale: Optional[float] = None,
                             q_offset: Offset = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [b,s,h,d], lse [b,h,s]) — the composable form for ring
    attention."""
    return flash_fwd(q, k, v, q_offset, causal=causal, scale=scale)
