"""Autoregressive generation with a static KV cache (port of
``ray_tpu/models/generate.py``).

The cache is a [L, B, max_len, kv_heads, head_dim] buffer per K and V, in
the compute dtype. Unlike the JAX package, which returns new cache arrays
from every step, the port writes the cache IN PLACE: at 7b one layer's
slot cache is hundreds of megabytes, and a functional update would copy it
on every decode step. Callers hand in views (a slot's rows of a shared
cache) and see the writes.

Both model families decode here: a layer without ``w_gate`` is an MoE
layer and runs ``moe.ffn_half`` with drop-free routing, as in JAX.

Positions may differ per row (batched decode of requests at different
lengths): the rope gather, the cache write and the attention offset are
all per row. A write position past ``max_len - 1`` is clamped to it, as
JAX's ``dynamic_update_slice`` clamps: only surplus steps of a request
that already finished reach there, and their tokens are discarded.

With the step profiler (``util/step_profiler.py``) enabled, ``generate``,
``generate_speculative`` and ``generate_stream`` write JAX's records
(kinds, tokens, analytic FLOPs, meta); disabled, they pay one predicate
check a call.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, check_params_on, resolve_device
from ray_tpu_torch.models import llama, moe
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_angles
from ray_tpu_torch.util import flops as FL
from ray_tpu_torch.util import step_profiler

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
    if "w_gate" in layer:   # dense Llama FFN
        return llama.ffn_half(cfg, x, layer)
    # MoE FFN: drop-free inference routing, so rows never compete for
    # capacity and each row's output is its own
    return moe.ffn_half(cfg, x, layer, drop_free=True)[0]


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


def _last_logits(params, tokens, cfg, cache: Cache, pos) -> torch.Tensor:
    """The fp32 logits [B, V] of the last position of ``tokens`` at
    ``pos``; the cache is written in place."""
    return _forward_with_cache(params, tokens, cfg, cache, pos)[:, -1]


def _setup(params, prompt, max_new_tokens: int, max_len: Optional[int],
           temperature: float, generator: Optional[torch.Generator],
           device: DeviceLike):
    """(prompt on the device, cache length, generator) of a decode call,
    checked as JAX checks them."""
    device = resolve_device(device)
    check_params_on(params, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(device)
    s = prompt.shape[1]
    total = max_len or (s + max_new_tokens)
    if total < s + max_new_tokens:
        raise ValueError(f"max_len {total} < prompt {s} + new {max_new_tokens}")
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return prompt, total, generator


def _token_stream(params, prompt: torch.Tensor, cfg, max_new_tokens: int,
                  temperature: float, top_k: Optional[int],
                  generator: Optional[torch.Generator], total: int,
                  profiled: bool) -> Iterator[torch.Tensor]:
    """The decode loop: a prefill, then one forward a token. With
    ``profiled`` the prefill and each decode step are one step-profiler
    record each, under JAX's kinds ``"prefill"`` and ``"decode"``."""
    b, s = prompt.shape
    cache = init_cache(cfg, b, total, device=prompt.device)

    def step(kind, args, key, tokens, flops, meta=None) -> torch.Tensor:
        # per-launch records: the streamed path pays launch overhead PER
        # TOKEN, which the profiler's dispatch/sync split exposes
        if not profiled:
            return _last_logits(*args)
        return step_profiler.profiled_call(kind, _last_logits, args,
                                           key=key, tokens=tokens,
                                           flops=flops, meta=meta)

    last = step("prefill", (params, prompt, cfg, cache, 0),
                ("prefill", cfg, b, s, total), b * s,
                FL.prefill_flops(cfg, b, s), {"batch": b})
    for i in range(max_new_tokens):
        tok = _sample_token(last, temperature, top_k, generator)
        yield tok
        if i + 1 < max_new_tokens:
            last = step("decode", (params, tok[:, None], cfg, cache, s + i),
                        ("decode", cfg, b, total), b,
                        b * FL.decode_flops_per_token(cfg, s + i))


def generate_stream(params, prompt, cfg, *, max_new_tokens: int,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    max_len: Optional[int] = None,
                    device: DeviceLike = None) -> Iterator[torch.Tensor]:
    """Yield tokens [B] one at a time — the serve token-streaming path.

    ``prompt`` is [B, S] int (array or tensor). Sampling draws from
    ``generator`` (a fresh one seeded 0 on ``device`` when omitted). With
    the step profiler enabled, the prefill and every decode step are a
    record each (``"prefill"``, then ``"decode"``), as in JAX."""
    prompt, total, generator = _setup(params, prompt, max_new_tokens,
                                      max_len, temperature, generator,
                                      device)
    yield from _token_stream(params, prompt, cfg, max_new_tokens,
                             temperature, top_k, generator, total,
                             step_profiler.is_enabled())


def generate(params, prompt, cfg, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """prompt [B, S] -> generated tokens [B, max_new_tokens] (int64).

    ``temperature == 0``: greedy. Otherwise softmax sampling (optionally
    top-k truncated) from ``generator``. With the step profiler enabled
    the whole call is one ``"generate"`` record, as in JAX."""
    prompt, total, generator = _setup(params, prompt, max_new_tokens,
                                      max_len, temperature, generator,
                                      device)
    b, s = prompt.shape

    def run() -> torch.Tensor:
        toks = list(_token_stream(params, prompt, cfg, max_new_tokens,
                                  temperature, top_k, generator, total,
                                  False))
        if not toks:
            return torch.zeros((b, 0), dtype=torch.long,
                               device=prompt.device)
        return torch.stack(toks, dim=1)

    if not step_profiler.is_enabled():
        return run()
    return step_profiler.profiled_call(
        "generate", run,
        key=("generate", cfg, b, s, total, max_new_tokens,
             float(temperature), top_k),
        tokens=b * max_new_tokens,
        flops=FL.generate_flops(cfg, b, s, max_new_tokens),
        meta={"batch": b, "prompt_len": s})


def generate_speculative(params, draft_params, prompt, cfg, draft_cfg, *,
                         max_new_tokens: int, speculate_k: int = 4,
                         max_len: Optional[int] = None,
                         return_stats: bool = False,
                         device: DeviceLike = None):
    """Greedy speculative decoding: the DRAFT model proposes
    ``speculate_k`` tokens a round, one row at a time; the TARGET verifies
    its current token and the proposals in ONE (k+1)-row forward and
    emits the longest matching prefix plus its own correction token. The
    output is exactly the target's greedy continuation (``generate``);
    the draft only changes how many target forwards it takes.

    Acceptance is lockstep over the batch: ``a = min_b argmin(match ++
    [False])``. A row that would have accepted more emits those tokens in
    later rounds. ``a`` is read back to the host once a round (JAX runs
    the whole loop as one ``while_loop`` program); it sets the next
    round's positions. Both caches are written in place; entries past a
    rejection are stale until the next round's write, which starts at the
    first stale position, overwrites them. After a round that accepts all
    ``k``, the draft's cache lacks the last proposal's position (it was
    never fed back to the draft), as in JAX: that lowers acceptance, never
    exactness.

    ``max_len`` must cover ``prompt + max_new_tokens + speculate_k + 1``:
    the port clamps each write position to the cache, where JAX's
    ``dynamic_update_slice`` shifts the block, and the two agree only
    while a block fits.

    ``return_stats=True`` also returns ``{"rounds", "accept_per_round"}``
    (tokens emitted per target verify, less the correction token). With
    the step profiler enabled the whole call is one ``"speculative"``
    record, its FLOPs the target's and the draft's generations, as in
    JAX."""
    device = resolve_device(device)
    check_params_on(params, device)
    check_params_on(draft_params, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(device)
    b, s = prompt.shape
    k = speculate_k
    total = max_len or (s + max_new_tokens + k + 1)
    if total < s + max_new_tokens + k + 1:
        raise ValueError(f"max_len {total} < prompt {s} + new "
                         f"{max_new_tokens} + k {k} + 1")
    args = (params, draft_params, prompt, cfg, draft_cfg, max_new_tokens,
            k, total)
    if not step_profiler.is_enabled():
        out, rounds = _speculative(*args)
    else:
        # analytic work: the target's prefill and decode plus the draft's
        # proposals (about one draft forward per emitted token too)
        out, rounds = step_profiler.profiled_call(
            "speculative", _speculative, args,
            key=("speculative", cfg, draft_cfg, b, s, total,
                 max_new_tokens, k),
            tokens=b * max_new_tokens,
            flops=(FL.generate_flops(cfg, b, s, max_new_tokens)
                   + FL.generate_flops(draft_cfg, b, s, max_new_tokens)),
            meta={"batch": b, "prompt_len": s, "speculate_k": k})
    if not return_stats:
        return out
    return out, {"rounds": rounds,
                 "accept_per_round": round(
                     max(0.0, max_new_tokens / max(1, rounds) - 1.0), 3)}


@torch.inference_mode()
def _speculative(params, draft_params, prompt: torch.Tensor, cfg, draft_cfg,
                 max_new_tokens: int, k: int, total: int):
    """The speculative loop of ``generate_speculative``: (tokens [B,
    max_new_tokens], rounds)."""
    device = prompt.device
    b, s = prompt.shape
    # invariant from here on: both caches hold KV for positions < pos, and
    # cur is the (already decided) token AT pos
    tcache = init_cache(cfg, b, total, device=device)
    dcache = init_cache(draft_cfg, b, total, device=device)
    tlogits = _forward_with_cache(params, prompt, cfg, tcache, 0)
    _forward_with_cache(draft_params, prompt, draft_cfg, dcache, 0)
    cur = torch.argmax(tlogits[:, -1], dim=-1)
    out = torch.zeros((b, max_new_tokens + k + 1), dtype=torch.long,
                      device=device)
    out[:, 0] = cur
    lanes = torch.arange(k + 1, device=device)[None, :]
    no_match = torch.zeros((b, 1), dtype=torch.int32, device=device)
    n, pos, rounds = 0, s, 0
    while n < max_new_tokens:
        tok, drafts = cur, []
        for i in range(k):
            logits = _forward_with_cache(draft_params, tok[:, None],
                                         draft_cfg, dcache, pos + i)
            tok = torch.argmax(logits[:, -1], dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)                       # [B, k]
        block = torch.cat([cur[:, None], drafts], dim=1)
        logits = _forward_with_cache(params, block, cfg, tcache, pos,
                                     last_only=False)
        t = torch.argmax(logits, dim=-1)    # t[:, j] follows pos + j
        # torch's argmin takes no bool: the first False is the first 0
        match = (drafts == t[:, :k]).to(torch.int32)
        a = int(torch.cat([match, no_match], dim=1).argmin(dim=1).min())
        # draft tokens below a, the target's from a on (position a is the
        # correction; beyond it is scratch the next round overwrites)
        emit = torch.where(lanes < a, F.pad(drafts, (0, 1)), t)
        out[:, n + 1:n + k + 2] = emit
        cur = emit[:, a]
        n, pos, rounds = n + a + 1, pos + a + 1, rounds + 1
    return out[:, :max_new_tokens], rounds
