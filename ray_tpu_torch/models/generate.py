"""Autoregressive generation with a static KV cache (port of
``ray_tpu/models/generate.py``).

The cache is a [L, B, max_len, kv_heads, head_dim] buffer per K and V, in
the compute dtype. Unlike the JAX package, which returns new cache arrays
from every step, the port writes the cache IN PLACE: at 7b one layer's
slot cache is hundreds of megabytes, and a functional update would copy it
on every decode step. Callers hand in views (a slot's rows of a shared
cache) and see the writes.

Positions may differ per row (batched decode of requests at different
lengths): the rope gather, the cache write and the attention offset are
all per row. A write position past ``max_len - 1`` is clamped to it, as
JAX's ``dynamic_update_slice`` clamps: only surplus steps of a request
that already finished reach there, and their tokens are discarded.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import torch

from ray_tpu_torch._device import DeviceLike, check_params_on, resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_angles

Cache = Dict[str, torch.Tensor]


def init_cache(cfg: llama.LlamaConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Cache:
    """Zeroed KV cache [L, B, max_len, kv_heads, head_dim] (compute
    dtype)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def _block_with_cache(cfg, x, layer, ck, cv, sin, cos, positions, offsets):
    """One decoder block over [B, S, d]; writes this step's K/V into the
    layer's [B, max_len, hkv, hd] cache at ``positions`` ([B, S], already
    clamped) and attends with per-row causal offsets ``offsets`` ([B])."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    q = apply_rope((h @ layer["wq"]).reshape(b, s, hq, hd), sin, cos,
                   positions)
    k = apply_rope((h @ layer["wk"]).reshape(b, s, hkv, hd), sin, cos,
                   positions)
    v = (h @ layer["wv"]).reshape(b, s, hkv, hd)
    rows = torch.arange(b, device=x.device)[:, None]
    ck[rows, positions] = k   # in place (module docstring)
    cv[rows, positions] = v
    attn = llama.attend(cfg, q, ck, cv, q_offset=offsets)
    x = x + attn.reshape(b, s, hq * hd) @ layer["wo"]
    return llama.ffn_half(cfg, x, layer)


@torch.inference_mode()
def _forward_with_cache(params, tokens: torch.Tensor, cfg, cache: Cache,
                        pos: Union[int, torch.Tensor],
                        last_only: bool = True) -> torch.Tensor:
    """tokens [B, S] at absolute position ``pos`` (an int, or a tensor [B]
    of per-row positions) -> fp32 logits; ``cache`` is updated in place.
    ``last_only`` projects ONLY the final position to the vocab —
    generation never needs the full [B, S, V] prefill logits."""
    b, s = tokens.shape
    device = tokens.device
    max_len = cache["k"].shape[2]
    x = params["embed"][tokens]
    sin, cos = rope_angles(max_len, cfg.head_dim, cfg.rope_theta,
                           cfg.compute_dtype, device)
    if isinstance(pos, torch.Tensor):
        start = pos.to(device=device, dtype=torch.long).reshape(-1).expand(b)
    else:
        start = torch.full((b,), int(pos), dtype=torch.long, device=device)
    positions = start[:, None] + torch.arange(s, device=device)[None, :]
    positions = positions.clamp(max=max_len - 1)
    offsets = start.to(torch.int32)
    for i in range(cfg.n_layers):
        x = _block_with_cache(cfg, x, llama.layer_params(params, i),
                              cache["k"][i], cache["v"][i], sin, cos,
                              positions, offsets)
    if last_only:
        x = x[:, -1:, :]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ llama.lm_head(params, cfg)).float()


def _sample_token(last_logits: torch.Tensor, temperature: float,
                  top_k: Optional[int],
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy (temperature<=0) or temperature/top-k categorical sampling
    from ``generator`` — the one sampling rule of the decode paths."""
    if temperature <= 0:
        return torch.argmax(last_logits, dim=-1)
    scaled = last_logits / temperature
    if top_k is not None:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate_stream(params, prompt, cfg, *, max_new_tokens: int,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    max_len: Optional[int] = None,
                    device: DeviceLike = None) -> Iterator[torch.Tensor]:
    """Yield tokens [B] one at a time — the serve token-streaming path.

    ``prompt`` is [B, S] int (array or tensor). Sampling draws from
    ``generator`` (a fresh one seeded 0 on ``device`` when omitted)."""
    device = resolve_device(device)
    check_params_on(params, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(device)
    b, s = prompt.shape
    total = max_len or (s + max_new_tokens)
    if total < s + max_new_tokens:
        raise ValueError(f"max_len {total} < prompt {s} + new {max_new_tokens}")
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cache = init_cache(cfg, b, total, device=device)
    last = _forward_with_cache(params, prompt, cfg, cache, 0)[:, -1]
    for i in range(max_new_tokens):
        tok = _sample_token(last, temperature, top_k, generator)
        yield tok
        if i + 1 < max_new_tokens:
            last = _forward_with_cache(params, tok[:, None], cfg, cache,
                                       s + i)[:, -1]


def generate(params, prompt, cfg, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """prompt [B, S] -> generated tokens [B, max_new_tokens] (int64).

    ``temperature == 0``: greedy. Otherwise softmax sampling (optionally
    top-k truncated) from ``generator``."""
    toks = list(generate_stream(
        params, prompt, cfg, max_new_tokens=max_new_tokens,
        temperature=temperature, top_k=top_k, generator=generator,
        max_len=max_len, device=device))
    if not toks:
        b = len(prompt)
        return torch.zeros((b, 0), dtype=torch.long,
                           device=resolve_device(device))
    return torch.stack(toks, dim=1)
