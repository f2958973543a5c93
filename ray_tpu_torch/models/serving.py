"""Continuous batching for autoregressive serving (port of
``ray_tpu/models/serving.py``: ``PrefixKVCache``, ``ContinuousBatcher``
and ``ContinuousEngine``).

- ONE static KV cache [L, max_slots, max_len, hkv, hd]; a request occupies
  a SLOT for its lifetime. The cache is written in place (see
  ``generate``'s module docstring).
- Admission is a batch-1 prefill of the prompt into the slot's rows, which
  returns the first generated token. A reused slot's stale KV past the new
  prompt is never read: every position a row attends to was written after
  its admission, and the causal mask hides the rest.
- Prefix KV reuse: with a :class:`PrefixKVCache` attached, a finished or
  cancelled slot's written span is kept as host pages, and an admission
  whose prompt starts with a cached chunk-aligned prefix of ``c`` tokens
  copies those pages into the slot and prefills only the suffix at
  position ``c`` (JAX's ``_compiled_cached_prefill``). Pages are captured
  in ``step_many`` as a request finishes and in ``cancel``, before the
  slot is freed: the full bucket (below) writes free slots' rows at
  position 0, so a freed slot's pages would not survive the next tick.
- Every engine tick decodes the ACTIVE slots together, each row at its own
  position (per-row rope, cache write and attention offset). Two buckets,
  as in JAX: a lone active row decodes alone; otherwise every slot decodes,
  in slot order, so each layer's cache is read in place with no gather
  (JAX gathers the active rows and pads with a repeat of one). Free slots
  decode token 0 at position 0 of their own rows, and their tokens are
  dropped. ``step_many(k)`` runs ``k`` steps per tick; a request finishing
  mid-tick has its surplus tokens dropped.
- Greedy decoding: each request's output is ``generate.generate`` on its
  own prompt, whatever else shares the batch.
- Sampling (``sampling=True``): each slot holds a temperature, a top-k and
  a seed. The masking rule is JAX's ``_row_sample`` exactly (the k-th
  largest scaled logit is the threshold, ties at it are kept, top-k 0
  disables it), and a row with temperature <= 0 takes the argmax, the
  same bits as the greedy engine.

The draws differ from JAX's. ``jax.random``'s key chain (threefry, one
split per token) cannot be reproduced in torch, so a sampled stream is not
the JAX engine's stream for the same seed; nothing compares the two. What
the port keeps is the chain's property: a row's n-th draw depends only on
(seed, n) and that row's logits, never on the other rows of the batch, the
bucket or the tick stride, so a seeded request replays exactly. Draw n is
Gumbel-max (``argmax(masked + g)``, which samples ``softmax(masked)``)
with noise ``g`` a counter-based hash of (seed, n, vocab id): the whole
batch draws in one batched op whatever its seeds, the noise is
identical on the CPU and the card, and the tick stays capturable in a
CUDA graph. Admission's first token is draw 0; free rows of the full
bucket advance no row's count.
"""

from __future__ import annotations

import itertools
import os
import queue as _queue
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, check_params_on, resolve_device
from ray_tpu_torch.models import generate as G
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.util import engine_recorder as _rec
from ray_tpu_torch.util import prefix_hash as PH
from ray_tpu_torch.util.recorder_core import Sinks

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Prefix/KV-cache reuse: retain completed slots' KV pages, admit
# shared-prefix requests by restoring them so prefill runs only on the
# uncached suffix.
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _PrefixEntry:
    __slots__ = ("key", "length", "k", "v", "nbytes", "chunk_keys",
                 "chunk_digests", "created_at")

    def __init__(self, key: bytes, length: int, k: torch.Tensor,
                 v: torch.Tensor, chunk_keys: List[bytes],
                 chunk_digests: List[str]):
        self.key = key
        self.length = length
        self.k = k
        self.v = v
        self.nbytes = _nbytes(k) + _nbytes(v)
        self.chunk_keys = chunk_keys
        self.chunk_digests = chunk_digests
        self.created_at = time.time()


# live caches in this process (the memory report's local view)
_kv_registry_lock = threading.Lock()
_kv_registry: "weakref.WeakSet" = weakref.WeakSet()  # rt: guarded-by(_kv_registry_lock)


def live_kv_cache_stats() -> List[Dict[str, Any]]:
    """Stats of every live PrefixKVCache in this process."""
    with _kv_registry_lock:
        caches = list(_kv_registry)
    return [c.stats() for c in caches]


class PrefixKVCache:
    """Bytes-budgeted LRU of chunk-aligned token-prefix KV pages.

    Pages are host copies ``[L, c, hkv, hd]`` of a slot row's first ``c``
    positions (pinned CPU tensors when the engine runs on ``cuda``, so a
    restore is an asynchronous copy), keyed by the EXACT token bytes of
    the prefix (equality is byte equality, no hash-collision risk). One
    entry of length ``n`` serves every chunk-aligned prefix ``c <= n``
    through the chunk index, so a multi-turn session's growing context is
    one entry, not a ladder of copies. Eviction is LRU by entry under a
    bytes budget (``RT_KV_CACHE_BYTES`` when unset, default 256 MiB); a
    weight swap must :meth:`clear` the whole cache, since every page was
    computed under the old weights.

    Thread-safe: the engine thread mutates, stats/digest readers come
    from other threads.
    """

    def __init__(self, *, chunk: Optional[int] = None,
                 max_bytes: Optional[int] = None, label: str = ""):
        self.chunk = int(chunk or PH.chunk_size())
        if max_bytes is None:
            max_bytes = int(os.environ.get("RT_KV_CACHE_BYTES",
                                           str(256 * 1024 * 1024)))
        self.max_bytes = int(max_bytes)
        self.label = label
        self._lock = threading.Lock()
        # full-prefix key -> entry, in LRU order (oldest first)
        self._entries: "OrderedDict[bytes, _PrefixEntry]" = \
            OrderedDict()  # rt: guarded-by(_lock)
        # chunk-aligned prefix key -> full key of an entry covering it
        self._index: Dict[bytes, bytes] = {}  # rt: guarded-by(_lock)
        self._bytes = 0  # rt: guarded-by(_lock)
        self._hits = 0  # rt: guarded-by(_lock)
        self._misses = 0  # rt: guarded-by(_lock)
        self._evictions = 0  # rt: guarded-by(_lock)
        self._inserts = 0  # rt: guarded-by(_lock)
        self._invalidations = 0  # rt: guarded-by(_lock)
        self._hit_tokens = 0  # rt: guarded-by(_lock)
        with _kv_registry_lock:
            _kv_registry.add(self)

    def aligned(self, n: int) -> int:
        return PH.aligned_len(n, self.chunk)

    def lookup(self, tokens: np.ndarray
               ) -> Optional[Tuple[int, torch.Tensor, torch.Tensor]]:
        """Longest cached QUANTIZED prefix of ``tokens``:
        ``(c, k_pages[L, c, hkv, hd], v_pages)`` (views of the entry's
        pages) or None. ``c`` is capped at ``len(tokens) - 1``, since
        admission always prefills at least one suffix token (the first
        generated token comes from the last prompt position's logits), and
        the probe ladder is GEOMETRIC (power-of-two multiples of the
        chunk), as in JAX, where it bounds the set of compiled warm
        prefills."""
        cmax = self.aligned(len(tokens) - 1)
        if cmax < self.chunk:
            return None
        # largest power-of-two multiple of chunk <= cmax
        c = self.chunk * (1 << ((cmax // self.chunk).bit_length() - 1))
        buf = PH.token_key(tokens, c)  # pack once, slice per length
        with self._lock:
            while c >= self.chunk:
                key = buf[:PH.TOKEN_WIDTH * c]
                fk = self._index.get(key)
                if fk is None:
                    c //= 2
                    continue
                e = self._entries.get(fk)
                if e is None or e.length < c or not e.key.startswith(key):
                    self._index.pop(key, None)  # stale index row
                    c //= 2
                    continue
                self._entries.move_to_end(fk)
                self._hits += 1
                self._hit_tokens += c
                return (c, e.k[:, :c], e.v[:, :c])
            self._misses += 1
        return None

    def cached_len(self, tokens: np.ndarray) -> int:
        """Longest cached aligned prefix length WITHOUT touching hit/miss
        counters or LRU order (capture-skip probe)."""
        cmax = self.aligned(len(tokens))
        if cmax < self.chunk:
            return 0
        buf = PH.token_key(tokens, cmax)
        with self._lock:
            for c in range(cmax, 0, -self.chunk):
                fk = self._index.get(buf[:PH.TOKEN_WIDTH * c])
                if fk is None:
                    continue
                e = self._entries.get(fk)
                if e is not None and e.length >= c:
                    return c
        return 0

    def insert(self, tokens: np.ndarray, k_pages: torch.Tensor,
               v_pages: torch.Tensor) -> bool:
        """Retain ``tokens``' KV pages (length must be chunk-aligned).
        Returns False when already resident or larger than the budget."""
        n = len(tokens)
        key = PH.token_key(tokens, n)
        nbytes = _nbytes(k_pages) + _nbytes(v_pages)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return False
            if nbytes > self.max_bytes:
                return False
            chunk_keys = [key[:PH.TOKEN_WIDTH * c]
                          for c in range(self.chunk, n + 1, self.chunk)]
            chunk_digests = PH.chunked_digests(key, self.chunk)
            # coalesce: an older entry that IS a prefix of this one is now
            # fully covered; drop it, or a growing session would retain a
            # ladder of duplicate unreachable pages against the budget
            ck_set = set(chunk_keys)
            for fk in [fk for fk in self._entries if fk in ck_set]:
                covered = self._entries.pop(fk)
                self._bytes -= covered.nbytes
            e = _PrefixEntry(key, n, k_pages, v_pages, chunk_keys,
                             chunk_digests)
            self._entries[key] = e
            self._bytes += nbytes
            self._inserts += 1
            for ck in chunk_keys:
                self._index[ck] = key  # newest entry serves the prefix
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                self._evict_one_locked()
            if self._bytes > self.max_bytes:  # lone oversized survivor
                self._evict_one_locked()
                return False
        return True

    def _evict_one_locked(self) -> None:
        _, old = self._entries.popitem(last=False)
        self._bytes -= old.nbytes
        self._evictions += 1
        for ck in old.chunk_keys:
            if self._index.get(ck) != old.key:
                continue
            # repoint to a surviving covering entry (sessions that share
            # only a short prefix overlap on its chunk rows); deleting
            # outright would stop resident entries serving those hits.
            # token_key is fixed-width per token, so byte-prefix equality
            # IS token-prefix equality.
            for fk in reversed(self._entries):  # MRU first
                if fk.startswith(ck):
                    self._index[ck] = fk
                    break
            else:
                del self._index[ck]

    def clear(self) -> int:
        """Weight-swap invalidation: every page was computed under the
        old weights; drop them all. Returns pages dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._index.clear()
            self._bytes = 0
            self._invalidations += n
        return n

    def digests(self, limit: int = 2 * PH.MAX_PROBE_CHUNKS) -> List[str]:
        """Chunk digests of resident entries (the residency report for
        cache-affinity routing), bounded. INTERLEAVED round-robin across
        entries in MRU order, longest-prefix-first within each: one long
        entry must not hide every other resident context from the
        router, which scores by set membership."""
        per_entry: List[List[str]] = []
        with self._lock:
            # bounded work under the lock: at most `limit` MRU entries, at
            # most `limit` digests each
            for e in reversed(self._entries.values()):
                if len(per_entry) >= limit:
                    break
                per_entry.append(e.chunk_digests[:-limit - 1:-1])
        out: List[str] = []
        for i in range(max((len(d) for d in per_entry), default=0)):
            for d in per_entry:
                if i < len(d):
                    out.append(d[i])
                    if len(out) >= limit:
                        return out
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"label": self.label, "chunk": self.chunk,
                    "bytes": self._bytes, "max_bytes": self.max_bytes,
                    "pages": len(self._entries),
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions, "inserts": self._inserts,
                    "invalidations": self._invalidations,
                    "hit_tokens": self._hit_tokens}


# ---------------------------------------------------------------------------
# Sampling: JAX's per-row masking rule, and counter-based draws
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# an odd multiplier below 2**31: x * _MUL stays inside int64 for x < 2**32
_MUL = 0x45D9F3B


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply) of int64 tensors holding
    values in [0, 2**32); the same bits on every device."""
    x = ((x >> 16) ^ x) * _MUL & _M32
    x = ((x >> 16) ^ x) * _MUL & _M32
    return (x >> 16) ^ x


def _gumbel(seed: torch.Tensor, draw: torch.Tensor, vocab: int
            ) -> torch.Tensor:
    """Gumbel(0, 1) noise [B, vocab], a pure function of each row's
    (seed, draw) and the vocab id: 24 bits of a hash of the three as a
    uniform u in (0, 1), then -log(-log(u))."""
    row = _mix32((seed & _M32) ^ 0x2545F491)
    row = _mix32(row ^ ((seed >> 32) & _M32))
    row = _mix32(row ^ (draw & _M32))
    col = _mix32(torch.arange(vocab, device=seed.device) ^ 0x68E31DA4)
    bits = _mix32(row[:, None] ^ col[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    return -torch.log(-torch.log(u))


def _mask_logits(logits: torch.Tensor, temp: torch.Tensor,
                 top_k: torch.Tensor) -> torch.Tensor:
    """JAX's ``_row_sample`` masking, per row: logits [B, V] (fp32) over
    the row's temperature (1 where it is <= 0), with every value below
    the row's k-th largest set to -inf (ties at it kept; ``top_k`` 0
    keeps all, above V clips to V)."""
    v = logits.shape[-1]
    scaled = logits / torch.where(temp > 0, temp, 1.0)[:, None]
    srt = torch.sort(scaled, dim=-1).values  # ascending
    kth = srt.gather(-1, (v - top_k).clamp(0, v - 1)[:, None])
    thresh = torch.where(top_k[:, None] > 0, kth, float("-inf"))
    return torch.where(scaled < thresh, float("-inf"), scaled)


def _row_sample(logits: torch.Tensor, temp: torch.Tensor,
                top_k: torch.Tensor, seed: torch.Tensor,
                draw: torch.Tensor) -> torch.Tensor:
    """Each row's token [B]: the argmax where its temperature is <= 0
    (the greedy engine's bits), else draw ``draw`` of its (seed) chain
    from the softmax of its masked logits."""
    greedy = torch.argmax(logits, dim=-1)
    masked = _mask_logits(logits, temp, top_k)
    sampled = torch.argmax(masked + _gumbel(seed, draw, logits.shape[-1]),
                           dim=-1)
    return torch.where(temp > 0, sampled, greedy)


class _Request:
    __slots__ = ("req_id", "slot", "remaining", "tokens", "prompt")

    def __init__(self, req_id: int, slot: int, remaining: int,
                 prompt: Optional[np.ndarray] = None):
        self.req_id = req_id
        self.slot = slot
        self.remaining = remaining
        self.tokens: List[int] = []
        self.prompt = prompt


class ContinuousBatcher:
    """Slot-based continuous batching engine around one model."""

    def __init__(self, params: Params, cfg: llama.LlamaConfig, *,
                 max_slots: int = 8, max_len: int = 512,
                 prefix_cache: Optional[PrefixKVCache] = None,
                 sampling: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        check_params_on(params, self.device)
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self._cache = G.init_cache(cfg, max_slots, max_len,
                                   device=self.device)
        self._free: List[int] = list(range(max_slots))
        self._active: Dict[int, _Request] = {}  # slot -> request
        self._cur = np.zeros(max_slots, np.int64)   # token AT pos, per slot
        self._pos = np.zeros(max_slots, np.int64)   # absolute position
        self._ids = itertools.count()
        self.decode_steps = 0   # batched forward steps run by _decode
        # prefix/KV reuse: retained pages of completed/cancelled slots
        self.prefix_cache = prefix_cache
        # sampling decode: per-slot temperature / top-k / seed and the
        # number of draws its chain has consumed
        self.sampling = bool(sampling)
        self._temp = np.zeros(max_slots, np.float32)
        self._topk = np.zeros(max_slots, np.int64)
        self._seed = np.zeros(max_slots, np.int64)
        self._draws = np.zeros(max_slots, np.int64)
        # set by every submit_ex: admission telemetry the engine reads
        # (cached_tokens, kv_restore_s and prefill_s feed the recorder)
        self.last_admission: Dict[str, Any] = {}

    def _rows(self, lo: int, hi: int) -> G.Cache:
        """Slots [lo, hi) of the shared cache, as views."""
        return {"k": self._cache["k"][:, lo:hi],
                "v": self._cache["v"][:, lo:hi]}

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- admission --------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               seed: int = 0) -> int:
        """Admit one request (prompt: int array [S]); returns req_id.
        Raises RuntimeError when no slot is free."""
        return self.submit_ex(prompt, max_new_tokens,
                              temperature=temperature, top_k=top_k,
                              seed=seed)[0]

    def submit_ex(self, prompt: np.ndarray, max_new_tokens: int, *,
                  temperature: float = 0.0, top_k: int = 0,
                  seed: int = 0) -> Tuple[int, int, bool]:
        """``submit`` plus the prefill's first token: returns (req_id,
        first_token, done).

        With a prefix cache attached, admission restores the longest
        cached chunk-aligned prefix into the slot and prefills ONLY the
        uncached suffix. Each position's K/V depends only on the tokens up
        to it, so warm output equals a cold prefill's token for token
        (``tests/test_torch_serving_kv.py``)."""
        if not self._free:
            raise RuntimeError("no free slots")
        prompt_arr = np.asarray(prompt, np.int64)
        s = len(prompt_arr)
        if s == 0:
            raise ValueError("empty prompt")
        if s + max_new_tokens + 1 > self.max_len:
            raise ValueError(f"prompt {s} + new {max_new_tokens} exceeds "
                             f"max_len {self.max_len}")
        if (temperature > 0 or top_k > 0) and not self.sampling:
            raise ValueError(
                "sampling request on a greedy engine: construct the "
                "batcher/engine with sampling=True")
        slot = self._free.pop()
        self._temp[slot] = temperature
        self._topk[slot] = top_k
        self._seed[slot] = seed
        self._draws[slot] = 0   # the first token is draw 0
        cached = 0
        kv_restore_s = 0.0
        try:
            t_kv0 = time.perf_counter()
            hit = (self.prefix_cache.lookup(prompt_arr)
                   if self.prefix_cache is not None else None)
            if hit is not None:
                cached, pk, pv = hit
                self._restore(slot, pk, pv)
                # the lookup + the page copy (on cuda: enqueued; its
                # transfer overlaps the prefill's launches)
                kv_restore_s = time.perf_counter() - t_kv0
            t_pf0 = time.perf_counter()
            toks = self._to_device(prompt_arr[cached:])[None, :]
            logits = G._forward_with_cache(self.params, toks, self.cfg,
                                           self._rows(slot, slot + 1),
                                           cached)[:, -1]
            first = (_row_sample(logits, *self._sample_state(slot, slot + 1))
                     if self.sampling else torch.argmax(logits, dim=-1))
            first_tok = int(first[0])   # the sync prefill_s ends at
            prefill_s = time.perf_counter() - t_pf0
        except BaseException:
            # a failed prefill must not leak the slot
            self._free.append(slot)
            raise
        req = _Request(next(self._ids), slot, max_new_tokens, prompt_arr)
        req.tokens.append(first_tok)
        req.remaining -= 1
        self._cur[slot] = first_tok
        self._pos[slot] = s
        self._draws[slot] = 1
        self.last_admission = {"cached_tokens": cached, "prompt_tokens": s,
                               "slot": slot, "kv_restore_s": kv_restore_s,
                               "prefill_s": prefill_s}
        done = req.remaining <= 0
        if done:
            self._capture(slot, req)
            self._free.append(slot)
        else:
            self._active[slot] = req
        return req.req_id, first_tok, done

    def _sample_state(self, lo: int, hi: int) -> Tuple[torch.Tensor, ...]:
        """Slots [lo, hi)'s (temperature, top-k, seed, draws made) on the
        device, the arguments of ``_row_sample``."""
        return tuple(self._to_device(a[lo:hi]) for a in (
            self._temp, self._topk, self._seed, self._draws))

    def _restore(self, slot: int, pk: torch.Tensor,
                 pv: torch.Tensor) -> None:
        """Copy cached pages [L, c, hkv, hd] into the slot's positions
        [0, c), one contiguous copy a layer (asynchronous from pinned
        pages on cuda)."""
        c = pk.shape[1]
        nb = self.device.type == "cuda"
        for name, pages in (("k", pk), ("v", pv)):
            rows = self._cache[name]
            for layer in range(rows.shape[0]):
                rows[layer, slot, :c].copy_(pages[layer], non_blocking=nb)

    def _pages(self, slot: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host copies [L, n, hkv, hd] of the slot's positions [0, n):
        pinned on cuda, where the copies are enqueued on the current
        stream (a later restore is ordered after them; a host reader
        syncs first)."""
        cuda = self.device.type == "cuda"
        out = []
        for name in ("k", "v"):
            rows = self._cache[name]
            dst = torch.empty((rows.shape[0], n) + tuple(rows.shape[3:]),
                              dtype=rows.dtype, pin_memory=cuda)
            for layer in range(rows.shape[0]):
                dst[layer].copy_(rows[layer, slot, :n], non_blocking=cuda)
            out.append(dst)
        return out[0], out[1]

    def _capture(self, slot: int, req: _Request) -> None:
        """Retain the freed slot's KV pages: the valid span is ``[0, pos)``,
        the prompt plus the generated tokens whose KV a decode step
        actually wrote (the final emitted token's KV is only written by the
        step that would produce its successor). Skipped when the aligned
        prefix is already resident (the common warm-hit case)."""
        cache = self.prefix_cache
        if cache is None or req.prompt is None:
            return
        pos = int(self._pos[slot])
        cap = cache.aligned(min(pos, self.max_len))
        if cap < cache.chunk:
            return
        gen_used = max(0, pos - len(req.prompt))
        tokens = req.prompt
        if gen_used:
            tokens = np.concatenate(
                [req.prompt, np.asarray(req.tokens[:gen_used], np.int64)])
        tokens = tokens[:cap]
        if cache.cached_len(tokens) >= cap:
            return
        cache.insert(tokens, *self._pages(slot, cap))

    # -- the engine tick --------------------------------------------------

    def step(self) -> List[Tuple[int, int, bool]]:
        """ONE decode step for every active slot; returns
        [(req_id, token, done)] for requests that produced a token."""
        return [(rid, toks[0], done)
                for rid, toks, done in self.step_many(1)]

    def _decode(self, lo: int, hi: int, cur: np.ndarray, pos: np.ndarray,
                k: int) -> np.ndarray:
        """``k`` steps of slots [lo, hi) from tokens ``cur`` at positions
        ``pos``; returns the [k, hi - lo] token block. A sampling engine
        picks every row's token by ``_row_sample`` (draws numbered from
        each slot's count), a greedy one by argmax."""
        rows = self._rows(lo, hi)
        tok = self._to_device(cur)
        p = self._to_device(pos)
        if self.sampling:
            temp, topk, seed, draw = self._sample_state(lo, hi)
        out = []
        for j in range(k):
            logits = G._forward_with_cache(self.params, tok[:, None],
                                           self.cfg, rows, p)[:, -1]
            tok = (_row_sample(logits, temp, topk, seed, draw + j)
                   if self.sampling else torch.argmax(logits, dim=-1))
            out.append(tok)
            p = p + 1
        self.decode_steps += k
        return torch.stack(out).cpu().numpy()

    def step_many(self, k: int = 1) -> List[Tuple[int, List[int], bool]]:
        """Up to ``k`` decode steps for every active slot in one tick;
        returns [(req_id, tokens, done)]. A request that finishes is
        captured into the prefix cache before its slot is freed."""
        if not self._active:
            return []
        slots = sorted(self._active)
        if len(slots) == 1:
            lo, hi = slots[0], slots[0] + 1
            cur, pos = self._cur[lo:hi], self._pos[lo:hi]
        else:
            # the full engine: free slots decode token 0 at position 0 of
            # their own rows, which their next admission overwrites
            lo, hi = 0, self.max_slots
            live = np.zeros(self.max_slots, bool)
            live[slots] = True
            cur = np.where(live, self._cur, 0)
            pos = np.where(live, self._pos, 0)
        toks = self._decode(lo, hi, cur, pos, k)
        out = []
        for slot in slots:
            req = self._active[slot]
            take = min(k, req.remaining)
            mine = [int(t) for t in toks[:take, slot - lo]]
            req.tokens.extend(mine)
            req.remaining -= take
            self._cur[slot] = mine[-1]
            self._pos[slot] += take
            self._draws[slot] += take
            done = req.remaining <= 0
            if done:
                self._capture(slot, req)
                del self._active[slot]
                self._free.append(slot)
            out.append((req.req_id, mine, done))
        return out

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def max_remaining(self) -> int:
        return max((r.remaining for r in self._active.values()), default=0)

    def warmup(self, prompt_lens: Tuple[int, ...] = (),
               strides: Tuple[int, ...] = (1,)) -> None:
        """Run every decode shape step_many uses (the {1, max_slots}
        buckets, for each tick stride; on a sampling engine through the
        sampling rule) and the prefills for the given prompt lengths once,
        BEFORE traffic arrives: the first call builds the CUDA kernels and
        sets up the GEMM libraries, which would otherwise stall the first
        request. Writes only free slots' rows, so it refuses to run while
        a request is active."""
        if self._active:
            raise RuntimeError("warmup writes slot rows: call it before "
                               "admitting requests")
        zeros = np.zeros(self.max_slots, np.int64)
        for k in sorted(set(strides)):
            for bucket in sorted({1, self.max_slots}):
                self._decode(0, bucket, zeros[:bucket], zeros[:bucket],
                             int(k))
        for s in prompt_lens:
            toks = torch.zeros((1, int(s)), dtype=torch.long,
                               device=self.device)
            G._forward_with_cache(self.params, toks, self.cfg,
                                  self._rows(0, 1), 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def cancel(self, req_id: int) -> bool:
        """Free a request's slot mid-flight (client disconnect). The slot's
        stale KV needs no scrub: the next admission prefills from 0. The
        written span is still retained in the prefix cache: a dropped
        multi-turn session's context stays warm for its next turn."""
        for slot, req in list(self._active.items()):
            if req.req_id == req_id:
                self._capture(slot, req)
                del self._active[slot]
                self._free.append(slot)
                return True
        return False

    def run_to_completion(self) -> Dict[int, List[int]]:
        """Drain all active requests; returns req_id -> generated tokens."""
        results: Dict[int, List[int]] = {
            r.req_id: r.tokens for r in self._active.values()}
        while self._active:
            reqs = {r.req_id: r for r in self._active.values()}
            for rid, _tok, _done in self.step():
                results.setdefault(rid, reqs[rid].tokens)
        return results


_STREAM_END = None  # sentinel a token stream's queue yields when done


class _EngineRequest:
    __slots__ = ("prompt", "max_new_tokens", "out", "on_token", "req_id",
                 "cancelled", "temperature", "top_k", "seed",
                 "cached_tokens", "t_submit", "obs_ctx")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 on_token: Optional[Callable[[List[Optional[int]]], None]]
                 = None, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, obs_ctx: Optional[Dict[str, str]] = None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.on_token = on_token
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.cached_tokens: Optional[int] = None  # set at admission
        self.t_submit = time.time()  # queue-wait starts here
        # a serve {request_id, span_id}: the recorder's request span is
        # parented on it
        self.obs_ctx = obs_ctx
        # at most max_new_tokens items + the end sentinel ever sit here
        self.out: Optional["_queue.Queue"] = (
            None if on_token is not None else _queue.Queue())
        self.req_id: Optional[int] = None  # assigned at admission
        self.cancelled = False

    def emit_many(self, toks: List[Optional[int]]) -> None:
        """Hand a tick's token burst to the consumer in ONE callback."""
        if self.on_token is not None:
            try:
                self.on_token(toks)
            except Exception:  # noqa: BLE001 — a consumer callback must
                pass           # never take the shared engine thread down
        else:
            for tok in toks:
                self.out.put(tok)


class ContinuousEngine:
    """The slot-admission loop that makes :class:`ContinuousBatcher` live.

    ONE background thread owns the model: it admits pending requests into
    free slots (per-request prefill, warm from the prefix cache when one
    is attached) and runs the decode tick across all active slots, pushing
    each token burst to the submitting request's queue or callback as soon
    as it is sampled. A request arriving while others decode joins the
    next tick. Every tick and request is stamped into the engine's flight
    recorder (``util/engine_recorder.py``).

    ``on_tick(active_slots, max_slots)`` fires after every decode tick.
    ``kv_cache_bytes`` > 0 attaches a :class:`PrefixKVCache` of that
    budget; 0 runs cold prefills only; None reads ``RT_KV_CACHE_BYTES``
    (default 0). ``recorder_sinks`` receive the recorder's drain (the JAX
    engine pushes the same into its cluster runtime).
    """

    def __init__(self, params: Params, cfg: llama.LlamaConfig, *,
                 max_slots: int = 8, max_len: int = 512,
                 decode_stride: int = 8,
                 on_tick: Optional[Callable[[int, int], None]] = None,
                 warmup: bool = True,
                 kv_cache_bytes: Optional[int] = None,
                 kv_label: str = "", sampling: bool = False,
                 recorder_sinks: Optional[Sinks] = None,
                 device: DeviceLike = None):
        # the chunk size is deliberately NOT a per-engine knob: the router
        # hashes request prefixes at the global RT_KV_CHUNK granularity
        if kv_cache_bytes is None:
            kv_cache_bytes = int(os.environ.get("RT_KV_CACHE_BYTES", "0"))
        cache = (PrefixKVCache(max_bytes=kv_cache_bytes, label=kv_label)
                 if kv_cache_bytes > 0 else None)
        self._batcher = ContinuousBatcher(params, cfg, max_slots=max_slots,
                                          max_len=max_len,
                                          prefix_cache=cache,
                                          sampling=sampling, device=device)
        self.decode_stride = max(1, int(decode_stride))
        if warmup:
            self._batcher.warmup(strides=(1, self.decode_stride))
        self.max_slots = max_slots
        self.max_len = max_len
        self._on_tick = on_tick
        self._pending: "deque[_EngineRequest]" = deque()  # rt: guarded-by(_work)
        self._live: Dict[int, _EngineRequest] = {}  # rt: guarded-by(_work)
        self._admitting: Optional[_EngineRequest] = None  # mid-prefill
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stopped = False
        self._dead: Optional[str] = None  # fatal engine error, if any
        self._steps = 0
        self._admitted = 0
        self._tokens_out = 0
        self._requests_completed = 0  # rt: guarded-by(_work)
        self._weight_swaps = 0  # rt: guarded-by(_work)
        # (new_params, waiters) queued by load_params; applied by the
        # engine thread once every active slot has drained
        self._pending_swap: Optional[Tuple] = None  # rt: guarded-by(_work)
        # flight recorder: the engine thread stamps tick/request records
        # into its bounded deques; its drain thread calls the sinks
        self._recorder = _rec.EngineRecorder(kv_label or "engine",
                                             max_slots=max_slots,
                                             sinks=recorder_sinks)
        # engine-thread-confined tick state: end of the previous decode
        # tick (the tick-gap anchor; None while the engine is idle) and
        # the wall spent applying a weight swap since the last record
        self._last_decode_end: Optional[float] = None
        self._tick_swap_s = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rtt-cb-engine")
        self._thread.start()

    # -- client side ------------------------------------------------------

    def submit_stream(self, prompt: np.ndarray, max_new_tokens: int, *,
                      temperature: float = 0.0, top_k: int = 0,
                      seed: int = 0, obs_ctx: Optional[Dict] = None
                      ) -> "_queue.Queue":
        """Queue one request; returns its token queue (ints, then the
        ``None`` end sentinel). ``temperature``/``top_k``/``seed`` select
        sampled decode (the engine must be built with ``sampling=True``);
        the default stays greedy. ``obs_ctx`` (a serve {request_id,
        span_id}) joins the request's recorder span to the serve span
        tree."""
        return self._submit(prompt, max_new_tokens, None,
                            temperature=temperature, top_k=top_k,
                            seed=seed, obs_ctx=obs_ctx).out

    def submit_cb(self, prompt: np.ndarray, max_new_tokens: int,
                  on_token: Callable[[List[Optional[int]]], None], *,
                  temperature: float = 0.0, top_k: int = 0,
                  seed: int = 0, obs_ctx: Optional[Dict] = None):
        """Callback form: ``on_token(burst)`` fires from the engine thread
        with each tick's token burst (a ``None`` element marks the end).
        Returns an opaque handle for :meth:`cancel`."""
        return self._submit(prompt, max_new_tokens, on_token,
                            temperature=temperature, top_k=top_k,
                            seed=seed, obs_ctx=obs_ctx)

    def _submit(self, prompt: np.ndarray, max_new_tokens: int,
                on_token, *, temperature: float = 0.0, top_k: int = 0,
                seed: int = 0,
                obs_ctx: Optional[Dict] = None) -> _EngineRequest:
        s = len(prompt)
        if s + max_new_tokens + 1 > self.max_len:
            raise ValueError(f"prompt {s} + new {max_new_tokens} exceeds "
                             f"max_len {self.max_len}")
        if (temperature > 0 or top_k > 0) and not self._batcher.sampling:
            raise ValueError("sampling request on a greedy engine: pass "
                             "sampling=True at engine construction")
        req = _EngineRequest(np.asarray(prompt, np.int64), max_new_tokens,
                             on_token, temperature=float(temperature),
                             top_k=int(top_k), seed=int(seed),
                             obs_ctx=obs_ctx)
        with self._work:
            if self._stopped:
                raise RuntimeError("engine is shut down")
            if self._dead is not None:
                raise RuntimeError(f"engine died: {self._dead}")
            self._pending.append(req)
            self._work.notify()
        return req

    def cancel(self, handle) -> None:
        """Drop a request: pending requests unqueue, active ones free their
        slot on the next tick. The stream still ends with the ``None``
        sentinel. ``handle`` is the queue ``submit_stream`` returned or
        the handle from ``submit_cb``."""
        with self._work:
            for req in list(self._pending):
                if req is handle or req.out is handle:
                    req.cancelled = True
                    self._pending.remove(req)
                    req.emit_many([_STREAM_END])
                    return
            admitting = self._admitting
            if admitting is not None and (admitting is handle
                                          or admitting.out is handle):
                # mid-prefill: the post-prefill bookkeeping frees the slot
                admitting.cancelled = True
                return
            for req in self._live.values():
                if req is handle or req.out is handle:
                    req.cancelled = True
                    self._work.notify()
                    return

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"active": len(self._live),
                   "pending": len(self._pending),
                   "max_slots": self.max_slots,
                   "steps": self._steps,
                   "admitted": self._admitted,
                   "tokens_out": self._tokens_out,
                   # monotonic counters for the engine's lifetime
                   "tokens_generated": self._tokens_out,
                   "requests_completed": self._requests_completed,
                   "weight_swaps": self._weight_swaps,
                   "decode_steps": self._batcher.decode_steps}
            if self._dead is not None:
                out["dead"] = self._dead
        cache = self._batcher.prefix_cache
        if cache is not None:
            out["kv"] = cache.stats()
        if self._recorder.enabled:
            # tick phases, tick gap, SLO attainment, goodput: computed off
            # the engine lock
            out["recorder"] = self._recorder.summary()
        return out

    def kv_stats(self) -> Optional[Dict[str, Any]]:
        """Prefix-cache counters WITHOUT touching the engine lock (the
        cache has its own)."""
        cache = self._batcher.prefix_cache
        return cache.stats() if cache is not None else None

    def kv_residency(self) -> List[str]:
        """Chunk digests of the prefixes this engine holds warm, for
        cache-affinity routing."""
        cache = self._batcher.prefix_cache
        return cache.digests() if cache is not None else []

    def _commit_params(self, params: Params) -> Params:
        """``params`` on the engine's device in its params' dtype: the
        port's params dict (each leaf moved, a no-op where it is already
        there), or a pytree of numpy leaves shaped like the JAX package's
        (through ``params_from_jax``)."""
        b = self._batcher
        dtype = b.params["embed"].dtype
        if isinstance(params.get("embed"), torch.Tensor):
            def move(t: torch.Tensor) -> torch.Tensor:
                return t.to(device=b.device, dtype=dtype)

            out = {name: ({k: move(w) for k, w in node.items()}
                          if isinstance(node, dict) else move(node))
                   for name, node in params.items()}
        else:
            out = params_from_jax(params, b.cfg, device=b.device,
                                  dtype=dtype)
        check_params_on(out, b.device)
        return out

    def load_params(self, params: Params,
                    timeout_s: float = 120.0) -> Dict[str, Any]:
        """Drain-barrier weight swap: queue ``params`` as the engine's
        next weights and block until the engine thread has applied them.

        The swap cannot be immediate: every active slot's KV was
        prefilled with the old weights. So the engine thread (a) stops
        admitting the moment a swap is queued (pending requests stay
        queued), (b) decodes the active slots to completion under the OLD
        weights, then (c) swaps, clears the prefix cache and resumes
        admission, so every later request runs under the NEW weights. A
        second ``load_params`` racing the first replaces the queued
        weights (latest wins; both callers unblock when it lands). The
        leaves move to the engine's device here, once, in the caller's
        thread.
        """
        state = {"event": threading.Event(), "applied": False,
                 "error": None}
        t0 = time.perf_counter()
        params = self._commit_params(params)
        with self._work:
            if self._stopped:
                raise RuntimeError("engine is shut down")
            if self._dead is not None:
                raise RuntimeError(f"engine died: {self._dead}")
            prev = self._pending_swap
            self._pending_swap = (params, [state])
            if prev is not None:
                # coalesce: the superseded swap's waiters ride this one
                self._pending_swap[1].extend(prev[1])
            self._work.notify()
        if not state["event"].wait(timeout_s):
            raise TimeoutError(
                f"weight swap did not drain within {timeout_s}s "
                f"(active requests still decoding)")
        if state["error"] is not None:
            raise RuntimeError(f"weight swap failed: {state['error']}")
        return {"drain_s": round(time.perf_counter() - t0, 4),
                "apply_s": round(state.get("apply_s", 0.0), 6),
                "weight_swaps": self._weight_swaps}

    def check_alive(self) -> None:
        """Raise if the engine thread died on a fatal decode error."""
        with self._lock:
            if self._dead is not None:
                raise RuntimeError(f"continuous engine died: {self._dead}")

    def stopped(self) -> bool:
        """True once the engine was shut down or its thread died."""
        with self._lock:
            return self._stopped or self._dead is not None

    def shutdown(self, timeout_s: float = 30.0) -> None:
        with self._work:
            self._stopped = True
            self._work.notify()
        self._thread.join(timeout=timeout_s)
        # stop the recorder's drain thread and drop its snapshot
        self._recorder.close()

    # -- the engine thread ------------------------------------------------

    def _admit_all(self) -> Dict[str, Any]:
        """Prefill pending requests into free slots; the prefill runs
        OUTSIDE the lock so submit/cancel/stats stay responsive.

        Returns the admission accounting for the recorder: {kv_restore,
        prefill, admitted}; the caller attributes its own wall minus these
        to the ``admission`` phase."""
        adm = {"kv_restore": 0.0, "prefill": 0.0, "admitted": 0}
        while True:
            with self._work:
                if self._stopped:
                    return adm
                if self._pending_swap is not None:
                    # drain barrier: a request admitted under the old
                    # weights would decode under the new ones after the swap
                    return adm
                if not (self._pending and self._batcher._free):
                    return adm
                req = self._pending.popleft()
                if req.cancelled:
                    continue
                self._admitting = req
            try:
                req_id, first_tok, done = self._batcher.submit_ex(
                    req.prompt, req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k,
                    seed=req.seed)
                la = self._batcher.last_admission
                req.cached_tokens = la.get("cached_tokens", 0)
            except Exception:  # noqa: BLE001 — ONE request's prefill
                # failing must fail that request, not the engine thread
                with self._work:
                    self._admitting = None
                req.emit_many([_STREAM_END])
                continue
            with self._work:
                self._admitting = None
                req.req_id = req_id
                cancelled = req.cancelled
                if cancelled:
                    if not done:
                        self._batcher.cancel(req_id)
                    req.emit_many([_STREAM_END])
                else:
                    self._admitted += 1
                    self._tokens_out += 1
                    req.emit_many([first_tok, _STREAM_END] if done
                                  else [first_tok])
                    if done:
                        self._requests_completed += 1
                    else:
                        self._live[req_id] = req
            # lifecycle record, OUTSIDE the engine lock: admission just
            # produced the first token, so this stamp is the TTFT stamp
            adm["kv_restore"] += la.get("kv_restore_s", 0.0)
            adm["prefill"] += la.get("prefill_s", 0.0)
            adm["admitted"] += 1
            now = time.time()
            self._recorder.request_admitted(
                req_id, t_submit=req.t_submit, t_admit=now,
                prompt_tokens=len(req.prompt),
                cached_tokens=req.cached_tokens or 0,
                prefill_s=la.get("prefill_s", 0.0),
                kv_restore_s=la.get("kv_restore_s", 0.0),
                slot=la.get("slot", -1), obs_ctx=req.obs_ctx)
            if cancelled:
                self._recorder.request_done(req_id, t=now,
                                            state="cancelled")
            elif done:
                self._recorder.request_done(req_id, t=now, state="done")

    def _maybe_swap_locked(self) -> None:
        """Apply a queued weight swap once the engine is fully drained
        (no active slots, no prefill in flight). Caller holds _work."""
        if (self._pending_swap is None or self._live
                or self._admitting is not None):
            return
        t_swap0 = time.perf_counter()
        params, waiters = self._pending_swap
        self._pending_swap = None
        self._batcher.params = params
        if self._batcher.prefix_cache is not None:
            # every retained page was computed under the OLD weights
            self._batcher.prefix_cache.clear()
        self._weight_swaps += 1
        apply_s = time.perf_counter() - t_swap0
        for st in waiters:
            st["apply_s"] = apply_s
            st["applied"] = True
            st["event"].set()
        # swap-barrier phase: the apply wall, consumed by the next
        # record_tick (engine-thread-confined accumulator)
        self._tick_swap_s += apply_s
        self._recorder.record_swap(apply_s)

    def _fail_swap_locked(self, reason: str) -> None:
        """Unblock load_params waiters when the engine stops or dies
        before their swap could land. Caller holds _work."""
        if self._pending_swap is None:
            return
        _, waiters = self._pending_swap
        self._pending_swap = None
        for st in waiters:
            st["error"] = reason
            st["event"].set()

    def _end_all_locked(self, reason: str) -> None:
        self._fail_swap_locked(reason)
        for req in list(self._live.values()):
            req.emit_many([_STREAM_END])
        self._live.clear()
        for req in list(self._pending):
            req.emit_many([_STREAM_END])
        self._pending.clear()

    def _run(self) -> None:
        # grad mode is per thread: decode in inference mode here too
        with torch.inference_mode():
            self._loop()

    def _loop(self) -> None:
        rec = self._recorder
        while True:
            t_tick0 = time.perf_counter()
            t_wall0 = time.time()
            with self._work:
                # reap cancellations before admitting into their slots
                doomed = [rid for rid, r in self._live.items()
                          if r.cancelled]
                for rid in doomed:
                    self._live.pop(rid).emit_many([_STREAM_END])
            # slot free + KV capture OUTSIDE the lock. Captures must land
            # BEFORE the swap check: a swap clears the cache, and a doomed
            # slot's pages are old-weight poison the moment it applies.
            for rid in doomed:
                self._batcher.cancel(rid)
                rec.request_done(rid, t=t_wall0, state="cancelled")
            with self._work:
                self._maybe_swap_locked()
            t_adm0 = time.perf_counter()
            adm = self._admit_all()
            # admission phase = this tick's admission wall minus the
            # batcher-attributed kv-restore/prefill shares
            adm_phase = max(0.0, (time.perf_counter() - t_adm0)
                            - adm["kv_restore"] - adm["prefill"])
            with self._work:
                if self._stopped:
                    self._end_all_locked("engine shut down mid-drain")
                    return
                if not self._live:
                    self._maybe_swap_locked()
                    swap_s = self._tick_swap_s
                    self._tick_swap_s = 0.0
                    if adm["admitted"] or swap_s > 0.0:
                        # admission-only tick (every admitted request
                        # finished at its first token, or a swap landed)
                        rec.record_tick(
                            t_start=t_wall0,
                            wall_s=time.perf_counter() - t_tick0,
                            phases={"admission": adm_phase,
                                    "kv_restore": adm["kv_restore"],
                                    "prefill": adm["prefill"],
                                    "swap_barrier": swap_s},
                            active=0, pending=len(self._pending),
                            bucket=0, k=0, tokens=adm["admitted"],
                            admitted=adm["admitted"], gap_s=None)
                    # engine going idle: the next decode tick starts a
                    # fresh gap baseline
                    self._last_decode_end = None
                    if self._pending or self._pending_swap is not None:
                        continue  # freshly unblocked work: no idle wait
                    self._work.wait(timeout=0.5)
                    continue
            # tick stride: fuse decode_stride steps while any active
            # request still wants that many, single steps for the tail
            k = (self.decode_stride
                 if self._batcher.max_remaining >= self.decode_stride
                 else 1)
            n_active = self._batcher.num_active
            bucket = 1 if n_active == 1 else self.max_slots
            t_dec0 = time.perf_counter()
            # tick gap: this tick's start minus the previous one's end
            # while slots stayed active, the starvation signal
            gap_s = (t_dec0 - self._last_decode_end
                     if self._last_decode_end is not None else None)
            try:
                emitted = self._batcher.step_many(k)
            except Exception as e:  # noqa: BLE001 — a failed decode step
                # poisons the shared cache: end every stream now and mark
                # the engine dead
                with self._work:
                    self._dead = f"{type(e).__name__}: {e}"[:300]
                    self._end_all_locked(self._dead)
                return
            t_dec1 = time.perf_counter()
            self._last_decode_end = t_dec1
            tick_tokens = adm["admitted"]
            tok_events: List[Tuple[int, int, bool]] = []
            with self._work:
                self._steps += 1
                for rid, toks, done in emitted:
                    req = self._live.get(rid)
                    if req is None:
                        continue  # cancelled between step and dispatch
                    burst: List[Optional[int]] = [int(t) for t in toks]
                    self._tokens_out += len(burst)
                    tick_tokens += len(burst)
                    tok_events.append((rid, len(burst), done))
                    if done:
                        burst.append(_STREAM_END)
                        del self._live[rid]
                        self._requests_completed += 1
                    req.emit_many(burst)
                tick, cap = len(self._live), self.max_slots
                pending_n = len(self._pending)
            t_emit1 = time.perf_counter()
            swap_s = self._tick_swap_s
            self._tick_swap_s = 0.0
            now = time.time()
            for rid, nburst, done in tok_events:
                rec.request_tokens(rid, nburst, now, done)
            rec.record_tick(
                t_start=t_wall0, wall_s=t_emit1 - t_tick0,
                phases={"admission": adm_phase,
                        "kv_restore": adm["kv_restore"],
                        "prefill": adm["prefill"],
                        "decode_step": t_dec1 - t_dec0,
                        "token_delivery": t_emit1 - t_dec1,
                        "swap_barrier": swap_s},
                active=n_active, pending=pending_n, bucket=bucket, k=k,
                tokens=tick_tokens, admitted=adm["admitted"], gap_s=gap_s)
            if self._on_tick is not None:
                try:
                    self._on_tick(tick, cap)
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
