"""Flash attention: the hand-written CUDA kernels and their plain PyTorch
versions.

Port of ``ray_tpu/ops/pallas/flash.py``: the forward (``_fwd_kernel``,
launched by ``_flash_fwd_bhsd``) is ``csrc/flash_fwd.cu``, three kernels
of which the C side picks one per call (``fwd_tiling``); the backward
(``_dq_kernel`` and ``_dkv_kernel``, launched by ``_flash_bwd_bhsd``) is
``csrc/flash_bwd.cu``. Each source note says what bounds the kernel and
what its design does about it. The wrappers keep the JAX layout: q, k, v,
o and do are [batch, seq, heads, head_dim], ``lse`` and ``delta`` are
[batch, heads, seq].

``q_offset`` is the absolute position of q[0] relative to k[0]: an int, or
an int32 tensor of shape [b] (one position per row, as batched decode
needs), on the device of q. It may be negative: a fully masked row gives
``o == 0`` and ``lse == NEG_INF``.

For a CPU tensor the wrappers run the plain version; for a CUDA tensor
they launch the kernel or raise. ``flash_attention`` is differentiable (a
``torch.autograd.Function`` over ``flash_fwd`` and ``flash_bwd``);
``flash_fwd`` and ``flash_attention_with_lse`` are forward-only, as JAX's
``flash_attention_with_lse`` is.
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
# Forward: the C side picks the kernel by the code it reports (float32:
# CUDA cores, "simt"; bf16 decode, s_q * group within one 16-row tile:
# split-KV, "dec"; other bf16: tensor cores, "tcb"). grid.y holds one
# query tile per index (simt, tcb) or one key chunk (dec); the C side
# refuses a launch that needs more. Query rows per tile of simt and tcb:
FWD_KERNELS = ("simt", "tcb", "dec")
FWD_TILE_ROWS = {"simt": 16, "tcb": 64}
# dec: keys are split into chunks of whole tiles of DEC_KEY_TILE keys, as
# many as give DEC_BLOCKS_PER_SM blocks for every SM of the card, each of
# at least DEC_MIN_CHUNK_TILES tiles. Measured with
# ray_tpu_torch/tools/tune_flash_fwd.py on an H100 (PERF.md): one wave of
# blocks with chunks of 4 tiles or more was the fastest at every decode
# shape of the serve path; more, shorter chunks pay each block's fixed
# cost again, and a second wave its tail.
DEC_KEY_TILE = 64
DEC_BLOCKS_PER_SM = 1
DEC_MIN_CHUNK_TILES = 4
# backward: one query tile (dq) or key tile (dkv) per index, 16 rows in
# the fp32 kernels and 64 in the bf16 tensor-core kernels
BWD_TILE_ROWS = {torch.float32: 16, torch.bfloat16: 64}
MAX_GRID_Y = 65535
_fns = {}              # library name -> (launch, error_string, pick)
_sms = {}              # CUDA device index -> SM count


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
    o, lse = _fwd_plain(q, k, v, q_offset, causal, scale)
    return o.to(q.dtype), lse


def _fwd_plain(q, k, v, q_offset, causal, scale):
    """``flash_fwd_reference`` with o left in fp32."""
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
    o = (acc.reshape(b, hq, sq, d) / l_safe).permute(0, 2, 1, 3)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return o.contiguous(), lse


def merge_partials(os, lses):
    """n partial softmax results over disjoint key sets merged into one:
    JAX's ``context._merge`` (``ray_tpu/parallel/context.py:71-82``) taken
    over n partials in order. o_i [b,s,h,d], lse_i [b,h,s]; a partial with
    lse_i <= NEG_INF/2 has weight 0, a row whose partials are all dead
    gets o = 0 and lse = NEG_INF. Returns o in o_0's dtype."""
    lse = torch.stack(lses)                                # [n, b, h, s]
    m = lse.amax(dim=0)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    w = torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(lse - m_safe))
    denom = w.sum(dim=0)
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    to_o = lambda wi: (wi / denom_safe).transpose(1, 2)[..., None]
    o = sum(oi * to_o(wi) for oi, wi in zip(os, w))
    lse = torch.where(denom == 0.0, NEG_INF, m_safe + torch.log(denom_safe))
    return o.to(os[0].dtype), lse


def decode_chunk(sk: int, splits: int) -> int:
    """Keys per chunk when ``sk`` keys are split ``splits`` ways, as the
    dec kernel splits them: whole tiles of DEC_KEY_TILE keys, the same
    number in every chunk, none empty. Raises ValueError for a split count
    that rule does not allow (the C side refuses it too)."""
    tiles = -(-sk // DEC_KEY_TILE)
    per = -(-tiles // splits) if 1 <= splits <= tiles else 0
    if not per or -(-tiles // per) != splits:
        raise ValueError(f"{sk} keys do not split into {splits} chunks of "
                         f"whole {DEC_KEY_TILE}-key tiles")
    return per * DEC_KEY_TILE


def decode_splits(b: int, hkv: int, sk: int, sms: int) -> Tuple[int, int]:
    """(splits, keys per chunk) of a dec call: enough chunks that the grid
    of b * hkv * splits blocks reaches DEC_BLOCKS_PER_SM blocks for each
    of ``sms`` SMs, unless that would cut chunks below DEC_MIN_CHUNK_TILES
    whole key tiles; no chunk empty. A function of the shapes and the
    card alone, never of positions: ``sk`` is the cache's length, and
    each block clips its chunk to its row's causal end on the device."""
    tiles = max(1, -(-sk // DEC_KEY_TILE))
    want = -(-DEC_BLOCKS_PER_SM * sms // max(1, b * hkv))
    splits = -(-tiles // max(1, DEC_MIN_CHUNK_TILES, tiles // want))
    return splits, decode_chunk(sk, splits)


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_offset: Offset, splits: int,
                           *, causal: bool = True,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dec kernel's split arithmetic: the
    keys cut into ``splits`` chunks (``decode_chunk``), the plain forward
    on each with its offset moved to the chunk's first key and o kept in
    fp32, the partials merged in split order (``merge_partials``), o cast
    once to q's dtype. Used by the tests and ``chip_smoke.py``; the
    wrappers take ``flash_fwd_reference`` for a CPU tensor."""
    d, sk = q.shape[-1], k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    chunk = decode_chunk(sk, splits)
    if isinstance(q_offset, torch.Tensor):
        q_offset = _offsets(q_offset, q.shape[0], q.device)
    parts = [_fwd_plain(q, k[:, c0:c0 + chunk], v[:, c0:c0 + chunk],
                        q_offset - c0, causal, scale)
             for c0 in range(0, sk, chunk)]
    o, lse = merge_partials(*zip(*parts))
    return o.to(q.dtype), lse


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each library's launch function and its argument types
_LAUNCH = {
    "flash_fwd": ("rtt_flash_fwd", [_I, _I] + [_P] * 6 + [_I] * 5 + [_L] * 9
                  + [ctypes.c_float, _I, _I, _P, _P]),
    "flash_bwd": ("rtt_flash_bwd", [_I, _I, _I] + [_P] * 11 + [_I] * 5
                  + [_L] * 15 + [ctypes.c_float, _I, _P]),
}


def typed_fns(lib: ctypes.CDLL, name: str):
    """(launch, error_string, pick) of a library built from
    ``csrc/<name>.cu``: pick(dtype code, sq, group) is the forward's
    kernel choice, None for the backward."""
    fn_name, argtypes = _LAUNCH[name]
    launch = getattr(lib, fn_name)
    launch.argtypes, launch.restype = argtypes, _I
    lib.rtt_cuda_error_string.argtypes = [_I]
    lib.rtt_cuda_error_string.restype = ctypes.c_char_p
    pick = None
    if name == "flash_fwd":
        pick = lib.rtt_flash_fwd_kernel
        pick.argtypes, pick.restype = [_I, _I, _I], _I
    return launch, lib.rtt_cuda_error_string, pick


def _kernel_fns(name: str):
    """``typed_fns`` of the built library ``name``, typed once."""
    if name not in _fns:
        _fns[name] = typed_fns(_build.load(name), name)
    return _fns[name]


def _sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _aligned(x: torch.Tensor) -> bool:
    """Rows are read as 16-byte chunks: head_dim contiguous, every row
    16-byte aligned."""
    return x.stride(-1) == 1 and not (
        x.data_ptr() % 16 or any((st * x.element_size()) % 16
                                 for st in x.stride()[:-1]))


def _check_cuda_inputs(**tensors: torch.Tensor) -> None:
    """The kernels' contract on CUDA inputs, checked against the first."""
    (first_name, first), *_ = tensors.items()
    if first.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{first.dtype}")
    if first.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash attention takes head_dim in {HEAD_DIMS}, "
                         f"got {first.shape[-1]}")
    for name, x in tensors.items():
        if x.dtype != first.dtype:
            raise TypeError(f"{name} is {x.dtype}, {first_name} "
                            f"{first.dtype}")
        if x.device != first.device:
            raise ValueError(f"{name} is on {x.device}, {first_name} on "
                             f"{first.device}")
        if not _aligned(x):
            raise ValueError(f"{name} must have a contiguous head_dim and "
                             f"16-byte aligned rows")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    if (k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[3] != q.shape[3]):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not divisible by kv heads "
                         f"{k.shape[2]}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_offset: Offset = 0, *, causal: bool = True,
              scale: Optional[float] = None, splits: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ported ``_fwd_kernel``: (o [b,sq,hq,d] in q's dtype,
    lse [b,hq,sq] fp32). ``flash_fwd.launches`` counts wrapper launches,
    ``flash_fwd.launches_by_kernel`` splits them by the kernel the C side
    picked ("tcb": bf16 tensor cores, "dec": bf16 split-KV decode, "simt":
    float32 CUDA cores; ``fwd_tiling`` says which a shape takes).
    ``splits`` sets the dec kernel's key chunks (default:
    ``decode_splits`` for this card); the other kernels take only 1."""
    _check_shapes(q, k, v)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_fwd and flash_attention_with_lse are forward-only; "
            "flash_attention is the differentiable form")
    scale = float(scale if scale is not None else d ** -0.5)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, q_offset, causal=causal,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, got {q.device}")
    _check_cuda_inputs(q=q, k=k, v=v)
    offs = _offsets(q_offset, b, q.device)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or sk == 0:
        o.zero_()
        lse.fill_(NEG_INF)
        return o, lse
    launch, error_string, pick = _kernel_fns("flash_fwd")
    kernel = FWD_KERNELS[pick(_DTYPE_CODE[q.dtype], sq, hq // hkv)]
    if splits is None:
        splits = (decode_splits(b, hkv, sk, _sm_count(q.device))[0]
                  if kernel == "dec" else 1)
    # dec's partials (o_i, lse_i) in fp32: one allocation, no fill
    scratch = (torch.empty(splits * b * hq * sq * (d + 1),
                           dtype=torch.float32, device=q.device)
               if kernel == "dec" and splits > 1 else None)
    # the C side launches on the calling thread's current device
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                     offs.data_ptr(), b, sq, sk, hq, hkv, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], scale, int(causal),
                     splits, None if scratch is None else scratch.data_ptr(),
                     stream)
    if err:
        if kernel != "dec" and splits != 1:
            raise ValueError(f"flash_fwd's {kernel} kernel takes no splits, "
                             f"got {splits}")
        if kernel == "dec":
            decode_chunk(sk, splits)   # raises for a count the rule refuses
        elif sq > MAX_GRID_Y * FWD_TILE_ROWS[kernel]:
            raise ValueError(
                f"flash_fwd's {kernel} kernel takes at most "
                f"{MAX_GRID_Y * FWD_TILE_ROWS[kernel]} queries, got {sq}")
        raise RuntimeError("flash_fwd launch failed: "
                           + error_string(err).decode())
    flash_fwd.launches += 1
    flash_fwd.launches_by_kernel[kernel] += 1
    return o, lse


flash_fwd.launches = 0
flash_fwd.launches_by_kernel = dict.fromkeys(FWD_KERNELS, 0)


def fwd_tiling(dtype: torch.dtype, head_dim: int, sq: int, group: int = 1,
               *, b: Optional[int] = None, hkv: Optional[int] = None,
               sk: Optional[int] = None) -> dict:
    """The forward kernel a call with ``sq`` query rows and GQA group
    ``group`` (hq / hkv) takes on the current card, and its tiling: the
    kernel ("tcb", "dec" or "simt"), query rows per block, keys per
    streamed tile, threads, dynamic shared memory bytes, blocks resident
    per SM, ``tc_min_sq`` (the fewest bf16 rows that take the tensor-core
    kernel at group 1) and the K/V stages in flight. For "dec", given
    ``b``, ``hkv`` and ``sk``, also its ``splits`` and ``chunk`` (keys)
    on this card."""
    lib = _build.load("flash_fwd")
    fn = lib.rtt_flash_fwd_config
    fn.argtypes, fn.restype = [_I, _I, _I, _I, ctypes.POINTER(_I)], _I
    _, error_string, _ = _kernel_fns("flash_fwd")
    vals = (_I * 8)()
    err = fn(_DTYPE_CODE[dtype], head_dim, sq, group, vals)
    if err:
        raise RuntimeError("flash_fwd config failed: "
                           + error_string(err).decode())
    out = dict(zip(("kernel", "block_rows", "key_tile", "threads",
                    "smem_bytes", "blocks_per_sm", "tc_min_sq", "stages"),
                   vals))
    out["kernel"] = FWD_KERNELS[out["kernel"]]
    if out["kernel"] == "dec" and None not in (b, hkv, sk):
        out["splits"], out["chunk"] = decode_splits(
            b, hkv, sk, _sm_count(torch.device("cuda")))
    return out


def _p_ds(q, k, v, lse, do, delta, q_offset, causal, scale):
    """(p, ds), each [b, hkv, group, sq, sk] fp32: the TPU kernels' fp32
    arithmetic. p = exp(s - lse) where the key is visible and the row is
    live (lse > NEG_INF/2), else 0; ds = p (dp - delta) scale. Both stay
    fp32 here; the bf16 CUDA kernels form them in fp32 too but round them
    to bf16 as the operand of the dq, dk and dv products."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    grouped = lambda x: x.reshape(b, sq, hkv, group, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", grouped(q), k.float()) * scale
    lse = lse.reshape(b, hkv, group, sq, 1)
    live = lse > NEG_INF / 2
    if causal:
        live = live & causal_mask(sq, sk, q_offset, q.device)[:, :, None]
    p = torch.where(live, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", grouped(do), v.float())
    ds = p * (dp - delta.reshape(b, hkv, group, sq, 1)) * scale
    return p, ds


def flash_dq_reference(q, k, v, o, lse, do, q_offset: Offset = 0, *,
                       causal: bool = True, scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dq kernel: (dq [b,sq,hq,d] in q's
    dtype, delta [b,hq,sq] fp32), dq summed in fp32 and cast once."""
    b, sq, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    # rowsum(o * do) in fp32 from o as stored: [b, hq, sq]
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    _, ds = _p_ds(q, k, v, lse, do, delta, q_offset, causal, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return dq.reshape(b, sq, hq, d).to(q.dtype), delta


def flash_dkv_reference(q, k, v, lse, delta, do, q_offset: Offset = 0, *,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dkv kernel: (dk, dv) [b,sk,hkv,d] in
    k's and v's dtypes, summed in fp32 over the query rows and over the
    GQA group of q heads that read each kv head, cast once."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    p, ds = _p_ds(q, k, v, lse, do, delta, q_offset, causal, scale)
    grouped = lambda x: x.reshape(b, sq, hkv, hq // hkv, d).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, grouped(do))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, grouped(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, o, lse, do, q_offset: Offset = 0, *,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: (dq, dk, dv). The TPU
    kernels' fp32 arithmetic: s in fp32 scaled after the dot, p from the
    saved lse (0 where masked or where lse <= NEG_INF/2) kept in fp32,
    delta = rowsum(o * do) in fp32, dq/dk/dv summed in fp32 (dk, dv over
    the GQA group too) and each cast once to its input's dtype. The fp32
    CUDA kernels do the same; the bf16 ones round p and ds to bf16 for the
    three second products (as the forward rounds p before PV) and sum them
    in fp32, within 1e-2 of this version (max |g - plain| / max |plain|)."""
    dq, delta = flash_dq_reference(q, k, v, o, lse, do, q_offset,
                                   causal=causal, scale=scale)
    dk, dv = flash_dkv_reference(q, k, v, lse, delta, do, q_offset,
                                 causal=causal, scale=scale)
    return dq, dk, dv


def _bwd_checks(q, k, v, lse, do, scale) -> float:
    """Shapes every backward wrapper takes; returns the scale."""
    _check_shapes(q, k, v)
    b, sq, hq, d = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    if tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"lse {tuple(lse.shape)} must be {(b, hq, sq)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, got "
                         f"{q.device}")
    return float(scale if scale is not None else d ** -0.5)


def _launch_bwd(which, q, k, v, o, do, lse, delta, dq, dk, dv, offs, causal,
                scale) -> None:
    """One backward kernel: which 0 writes dq and delta, 1 dk and dv."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    max_seq = MAX_GRID_Y * BWD_TILE_ROWS[q.dtype]
    if max(sq, sk) > max_seq:
        raise ValueError(f"flash attention's backward takes at most {max_seq}"
                         f" queries and keys in {q.dtype}, got {sq} and {sk}")
    ptr = lambda x: 0 if x is None else x.data_ptr()
    strides = lambda x: (0, 0, 0) if x is None else x.stride()[:3]
    launch, error_string, _ = _kernel_fns("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(which, _DTYPE_CODE[q.dtype], d, ptr(q), ptr(k), ptr(v),
                     ptr(o), ptr(do), ptr(lse), ptr(delta), ptr(dq), ptr(dk),
                     ptr(dv), offs.data_ptr(), b, sq, sk, hq, hkv,
                     *strides(q), *strides(k), *strides(v), *strides(o),
                     *strides(do), scale, int(causal), stream)
    if err:
        raise RuntimeError(f"flash backward kernel {which} launch failed: "
                           + error_string(err).decode())


def bwd_tiling(dtype: torch.dtype, head_dim: int) -> dict:
    """How the backward kernels tile on the current card, per kernel ("dq",
    "dkv"): rows per block (queries, keys), the streamed tile (keys,
    queries), threads, dynamic shared memory bytes, blocks resident per
    SM."""
    lib = _build.load("flash_bwd")
    fn = lib.rtt_flash_bwd_config
    fn.argtypes, fn.restype = [_I, _I, _I, ctypes.POINTER(_I)], _I
    _, error_string, _ = _kernel_fns("flash_bwd")
    out = {}
    for which, name in enumerate(("dq", "dkv")):
        vals = (_I * 5)()
        err = fn(which, _DTYPE_CODE[dtype], head_dim, vals)
        if err:
            raise RuntimeError("flash backward config failed: "
                               + error_string(err).decode())
        out[name] = dict(zip(("block_rows", "stream_tile", "threads",
                              "smem_bytes", "blocks_per_sm"), vals))
    return out


def _cuda_do(do: torch.Tensor) -> torch.Tensor:
    """The gradient autograd hands over may be strided or expanded: the
    kernels read it through its strides when its rows are aligned, a
    contiguous copy otherwise."""
    return do if _aligned(do) else do.contiguous()


def flash_dq(q, k, v, o, lse, do, q_offset: Offset = 0, *,
             causal: bool = True, scale: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ported ``_dq_kernel``: (dq [b,sq,hq,d] in q's dtype, delta
    [b,hq,sq] fp32 = rowsum(o * do), which ``flash_dkv`` reads).
    ``flash_dq.launches`` counts kernel launches."""
    scale = _bwd_checks(q, k, v, lse, do, scale)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, o, lse, do, q_offset,
                                  causal=causal, scale=scale)
    do = _cuda_do(do)
    _check_cuda_inputs(q=q, k=k, v=v, o=o, do=do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32 [b, hq, sq]")
    b, sq, hq, d = q.shape
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return dq, delta
    _launch_bwd(0, q, k, v, o, do, lse, delta, dq, None, None,
                _offsets(q_offset, b, q.device), causal, scale)
    flash_dq.launches += 1
    return dq, delta


def flash_dkv(q, k, v, lse, delta, do, q_offset: Offset = 0, *,
              causal: bool = True, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ported ``_dkv_kernel``: (dk, dv) [b,sk,hkv,d] in k's and v's
    dtypes, summed over the GQA group in the kernel. ``delta`` is
    ``flash_dq``'s. ``flash_dkv.launches`` counts kernel launches."""
    scale = _bwd_checks(q, k, v, lse, do, scale)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, lse, delta, do, q_offset,
                                   causal=causal, scale=scale)
    do = _cuda_do(do)
    _check_cuda_inputs(q=q, k=k, v=v, do=do)
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.shape != lse.shape):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[b, hq, sq]")
    b, sk, hkv, d = k.shape
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, hkv, d), dtype=v.dtype, device=v.device)
    if sk == 0:
        return dk, dv
    _launch_bwd(1, q, k, v, None, do, lse, delta, None, dk, dv,
                _offsets(q_offset, b, q.device), causal, scale)
    flash_dkv.launches += 1
    return dk, dv


flash_dq.launches = 0
flash_dkv.launches = 0


def flash_bwd(q, k, v, o, lse, do, q_offset: Offset = 0, *,
              causal: bool = True, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ported backward: (dq, dk, dv) through ``flash_dq`` then
    ``flash_dkv`` on a CUDA tensor, ``flash_bwd_reference`` on a CPU one.
    ``flash_bwd.launches`` counts the backward passes launched on the
    card (two kernels each)."""
    if q.device.type == "cpu":
        scale = _bwd_checks(q, k, v, lse, do, scale)
        return flash_bwd_reference(q, k, v, o, lse, do, q_offset,
                                   causal=causal, scale=scale)
    offs = _offsets(q_offset, q.shape[0], q.device)
    dq, delta = flash_dq(q, k, v, o, lse, do, offs, causal=causal,
                         scale=scale)
    dk, dv = flash_dkv(q, k, v, lse, delta, do, offs, causal=causal,
                       scale=scale)
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


def flash_vjp_chunk(q, k, v, o, do, lse, *, q_offset: Offset,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One k/v chunk's additive share of the backward, for ring attention
    (``ray_tpu/ops/pallas/flash.py:363-408``): (dq, dk, dv) of the chunk
    from the GLOBAL (o, lse) of the softmax over every chunk, so that
    p = exp(s - lse) is the true weight; dk and dv are summed over the GQA
    group. Summing dq over the chunks, and each chunk's dk and dv over the
    query chunks, gives the exact gradients. ``flash_dq`` then
    ``flash_dkv`` (their plain versions for a CPU tensor): delta =
    rowsum(o * do) comes from ``o`` as given, in q's dtype, as JAX saves
    it."""
    dq, delta = flash_dq(q, k, v, o, lse, do, q_offset, causal=causal,
                         scale=scale)
    dk, dv = flash_dkv(q, k, v, lse, delta, do, q_offset, causal=causal,
                       scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_fwd`` forward, ``flash_bwd`` backward; the counterpart of
    JAX's ``_flash_core`` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, offs, causal, scale):
        o, lse = flash_fwd(q, k, v, offs, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse, offs)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, offs = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, offs, causal=ctx.causal,
                               scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: Offset = 0) -> torch.Tensor:
    """Differentiable flash attention over [batch, seq, heads, head_dim]:
    the forward kernel, and the dq/dkv kernels for its gradients. Where no
    gradient is wanted (serving), the forward is called directly and
    autograd records nothing."""
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        return flash_fwd(q, k, v, q_offset, causal=causal, scale=scale)[0]
    _check_shapes(q, k, v)
    offs = _offsets(q_offset, q.shape[0], q.device)
    return _FlashAttention.apply(q, k, v, offs, causal, scale)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             scale: Optional[float] = None,
                             q_offset: Offset = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [b,s,h,d], lse [b,h,s]) — the composable form for ring
    attention; forward-only, as in JAX."""
    return flash_fwd(q, k, v, q_offset, causal=causal, scale=scale)
