"""Continuous batching for autoregressive serving (port of
``ray_tpu/models/serving.py``: ``ContinuousBatcher`` and
``ContinuousEngine``, greedy).

- ONE static KV cache [L, max_slots, max_len, hkv, hd]; a request occupies
  a SLOT for its lifetime. The cache is written in place (see
  ``generate``'s module docstring).
- Admission is a batch-1 prefill of the prompt into the slot's rows, which
  returns the first generated token. A reused slot's stale KV past the new
  prompt is never read: every position a row attends to was written after
  its admission, and the causal mask hides the rest.
- Every engine tick decodes the ACTIVE slots together, each row at its own
  position (per-row rope, cache write and attention offset). Two buckets,
  as in JAX: a lone active row decodes alone; otherwise every slot decodes,
  in slot order, so each layer's cache is read in place with no gather
  (JAX gathers the active rows instead). ``step_many(k)`` runs ``k`` steps
  per tick; a request finishing mid-tick has its surplus tokens dropped.
- Greedy decoding: each request's output is ``generate.generate`` on its
  own prompt, whatever else shares the batch.

Not ported yet (ROADMAP.md): the prefix KV cache, the flight recorder,
``load_params`` weight swaps and the sampling engine.
"""

from __future__ import annotations

import itertools
import queue as _queue
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, check_params_on, resolve_device
from ray_tpu_torch.models import generate as G
from ray_tpu_torch.models import llama

Params = Dict[str, Any]


class _Request:
    __slots__ = ("req_id", "slot", "remaining", "tokens")

    def __init__(self, req_id: int, slot: int, remaining: int):
        self.req_id = req_id
        self.slot = slot
        self.remaining = remaining
        self.tokens: List[int] = []


class ContinuousBatcher:
    """Slot-based continuous batching engine around one model."""

    def __init__(self, params: Params, cfg: llama.LlamaConfig, *,
                 max_slots: int = 8, max_len: int = 512,
                 device: DeviceLike = None):
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

    def _rows(self, lo: int, hi: int) -> G.Cache:
        """Slots [lo, hi) of the shared cache, as views."""
        return {"k": self._cache["k"][:, lo:hi],
                "v": self._cache["v"][:, lo:hi]}

    # -- admission --------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        """Admit one request (prompt: int array [S]); returns req_id.
        Raises RuntimeError when no slot is free."""
        return self.submit_ex(prompt, max_new_tokens)[0]

    def submit_ex(self, prompt: np.ndarray,
                  max_new_tokens: int) -> Tuple[int, int, bool]:
        """``submit`` plus the prefill's first token: returns (req_id,
        first_token, done)."""
        if not self._free:
            raise RuntimeError("no free slots")
        prompt_arr = np.asarray(prompt, np.int64)
        s = len(prompt_arr)
        if s == 0:
            raise ValueError("empty prompt")
        if s + max_new_tokens + 1 > self.max_len:
            raise ValueError(f"prompt {s} + new {max_new_tokens} exceeds "
                             f"max_len {self.max_len}")
        slot = self._free.pop()
        try:
            toks = torch.from_numpy(prompt_arr).to(self.device)[None, :]
            logits = G._forward_with_cache(self.params, toks, self.cfg,
                                           self._rows(slot, slot + 1), 0)
            first_tok = int(torch.argmax(logits[0, -1]))
        except BaseException:
            # a failed prefill must not leak the slot
            self._free.append(slot)
            raise
        req = _Request(next(self._ids), slot, max_new_tokens)
        req.tokens.append(first_tok)
        req.remaining -= 1
        self._cur[slot] = first_tok
        self._pos[slot] = s
        done = req.remaining <= 0
        if done:
            self._free.append(slot)
        else:
            self._active[slot] = req
        return req.req_id, first_tok, done

    # -- the engine tick --------------------------------------------------

    def step(self) -> List[Tuple[int, int, bool]]:
        """ONE decode step for every active slot; returns
        [(req_id, token, done)] for requests that produced a token."""
        return [(rid, toks[0], done)
                for rid, toks, done in self.step_many(1)]

    def _decode(self, lo: int, hi: int, cur: np.ndarray, pos: np.ndarray,
                k: int) -> np.ndarray:
        """``k`` greedy steps of slots [lo, hi) from tokens ``cur`` at
        positions ``pos``; returns the [k, hi - lo] token block."""
        rows = self._rows(lo, hi)
        tok = torch.from_numpy(cur).to(self.device)
        p = torch.from_numpy(pos).to(self.device)
        out = []
        for _ in range(k):
            logits = G._forward_with_cache(self.params, tok[:, None],
                                           self.cfg, rows, p)
            tok = torch.argmax(logits[:, -1], dim=-1)
            out.append(tok)
            p = p + 1
        self.decode_steps += k
        return torch.stack(out).cpu().numpy()

    def step_many(self, k: int = 1) -> List[Tuple[int, List[int], bool]]:
        """Up to ``k`` decode steps for every active slot in one tick;
        returns [(req_id, tokens, done)]."""
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
            done = req.remaining <= 0
            if done:
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
        buckets, for each tick stride) and the prefills for the given
        prompt lengths once, BEFORE traffic arrives: the first call builds
        the CUDA kernels and sets up the GEMM libraries, which would
        otherwise stall the first request. Writes only free slots' rows,
        so it refuses to run while a request is active."""
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
        stale KV needs no scrub: the next admission prefills from 0."""
        for slot, req in list(self._active.items()):
            if req.req_id == req_id:
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
                 "cancelled")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 on_token: Optional[Callable[[List[Optional[int]]], None]]
                 = None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.on_token = on_token
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
    free slots (per-request prefill) and runs the decode tick across all
    active slots, pushing each token burst to the submitting request's
    queue or callback as soon as it is sampled. A request arriving while
    others decode joins the next tick.
    """

    def __init__(self, params: Params, cfg: llama.LlamaConfig, *,
                 max_slots: int = 8, max_len: int = 512,
                 decode_stride: int = 8, warmup: bool = True,
                 device: DeviceLike = None):
        self._batcher = ContinuousBatcher(params, cfg, max_slots=max_slots,
                                          max_len=max_len, device=device)
        self.decode_stride = max(1, int(decode_stride))
        if warmup:
            self._batcher.warmup(strides=(1, self.decode_stride))
        self.max_slots = max_slots
        self.max_len = max_len
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
        self._requests_completed = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rtt-cb-engine")
        self._thread.start()

    # -- client side ------------------------------------------------------

    def submit_stream(self, prompt: np.ndarray,
                      max_new_tokens: int) -> "_queue.Queue":
        """Queue one request; returns its token queue (ints, then the
        ``None`` end sentinel)."""
        return self._submit(prompt, max_new_tokens, None).out

    def submit_cb(self, prompt: np.ndarray, max_new_tokens: int,
                  on_token: Callable[[List[Optional[int]]], None]):
        """Callback form: ``on_token(burst)`` fires from the engine thread
        with each tick's token burst (a ``None`` element marks the end).
        Returns an opaque handle for :meth:`cancel`."""
        return self._submit(prompt, max_new_tokens, on_token)

    def _submit(self, prompt: np.ndarray, max_new_tokens: int,
                on_token) -> _EngineRequest:
        s = len(prompt)
        if s + max_new_tokens + 1 > self.max_len:
            raise ValueError(f"prompt {s} + new {max_new_tokens} exceeds "
                             f"max_len {self.max_len}")
        req = _EngineRequest(np.asarray(prompt, np.int64), max_new_tokens,
                             on_token)
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
                   "requests_completed": self._requests_completed,
                   "decode_steps": self._batcher.decode_steps}
            if self._dead is not None:
                out["dead"] = self._dead
        return out

    def shutdown(self, timeout_s: float = 30.0) -> None:
        with self._work:
            self._stopped = True
            self._work.notify()
        self._thread.join(timeout=timeout_s)

    # -- the engine thread ------------------------------------------------

    def _admit_all(self) -> None:
        """Prefill pending requests into free slots; the prefill runs
        OUTSIDE the lock so submit/cancel/stats stay responsive."""
        while True:
            with self._work:
                if self._stopped:
                    return
                if not (self._pending and self._batcher._free):
                    return
                req = self._pending.popleft()
                if req.cancelled:
                    continue
                self._admitting = req
            try:
                req_id, first_tok, done = self._batcher.submit_ex(
                    req.prompt, req.max_new_tokens)
            except Exception:  # noqa: BLE001 — ONE request's prefill
                # failing must fail that request, not the engine thread
                with self._work:
                    self._admitting = None
                req.emit_many([_STREAM_END])
                continue
            with self._work:
                self._admitting = None
                req.req_id = req_id
                if req.cancelled:
                    if not done:
                        self._batcher.cancel(req_id)
                    req.emit_many([_STREAM_END])
                    continue
                self._admitted += 1
                self._tokens_out += 1
                req.emit_many([first_tok, _STREAM_END] if done
                              else [first_tok])
                if done:
                    self._requests_completed += 1
                else:
                    self._live[req_id] = req

    def _end_all_locked(self) -> None:
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
        while True:
            with self._work:
                # reap cancellations before admitting into their slots
                doomed = [rid for rid, r in self._live.items()
                          if r.cancelled]
                for rid in doomed:
                    self._live.pop(rid).emit_many([_STREAM_END])
            for rid in doomed:
                self._batcher.cancel(rid)
            self._admit_all()
            with self._work:
                if self._stopped:
                    self._end_all_locked()
                    return
                if not self._live:
                    if not self._pending:
                        self._work.wait(timeout=0.5)
                    continue
            # tick stride: fuse decode_stride steps while any active
            # request still wants that many, single steps for the tail
            k = (self.decode_stride
                 if self._batcher.max_remaining >= self.decode_stride
                 else 1)
            try:
                emitted = self._batcher.step_many(k)
            except Exception as e:  # noqa: BLE001 — a failed decode step
                # poisons the shared cache: end every stream now and mark
                # the engine dead
                with self._work:
                    self._dead = f"{type(e).__name__}: {e}"[:300]
                    self._end_all_locked()
                return
            with self._work:
                self._steps += 1
                for rid, toks, done in emitted:
                    req = self._live.get(rid)
                    if req is None:
                        continue  # cancelled between step and dispatch
                    burst: List[Optional[int]] = [int(t) for t in toks]
                    self._tokens_out += len(burst)
                    if done:
                        burst.append(_STREAM_END)
                        del self._live[rid]
                        self._requests_completed += 1
                    req.emit_many(burst)
