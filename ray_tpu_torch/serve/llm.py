"""Continuous-batching LLM serving (port of ``ray_tpu/serve/llm.py``): the
deployment class that makes :class:`ContinuousEngine` live, its
static-batch control, and the Poisson-arrival load driver.

- ``ContinuousLLM`` hosts ONE :class:`ContinuousEngine` per replica.
  ``__call__`` admits the request mid-flight and returns an async
  generator that yields each token the moment the engine samples it.
- ``StaticLLM`` is the control: the same model behind ``@batch``;
  requests wait for batch formation, decode in lockstep and respond only
  when the whole ``generate`` returns.
- ``poisson_load`` drives open-loop Poisson arrivals against either and
  reports throughput and latency percentiles.

Both classes build their preset with ``attn_impl="flash"``: the hand-
written CUDA kernels on the card, their plain versions on the CPU.

Where the JAX package writes to ``ray_tpu.serve.obs`` or its cluster (slot
occupancy, kv-cache counters, the request's kv span, the ``@memkv/``
snapshot push, batch formation), the port calls a :class:`ServeHooks`
object passed in; its methods do nothing by default. A hooks object is
pickled into the replica with the class's arguments, so it must be an
instance of a module-level class. The app builders (``continuous_llm_app``,
``static_llm_app``, ``cb_vs_static_load``) need a serve runtime and are
not ported.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import random
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import generate as G
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.serving import ContinuousEngine
from ray_tpu_torch.serve.batching import batch as _serve_batch

__all__ = ["ContinuousLLM", "StaticLLM", "ServeHooks", "poisson_load",
           "http_token_request"]


class ServeHooks:
    """Where the serving classes report; every method is a no-op here.

    Subclass it at module level (it is pickled into the replica) to bind
    the calls to a metrics and tracing backend."""

    def on_tick(self, name: str, active: int, slots: int) -> None:
        """After every engine decode tick: ``active`` of ``slots`` rows
        were live (JAX: the ``cb:<name>`` batch size and occupancy
        histograms and the ``rt_serve_cb_slots_active`` gauge)."""

    def kv_cache(self, name: str, hits: int, misses: int, evictions: int,
                 nbytes: int) -> None:
        """Prefix-cache counter increments since the last call and the
        bytes now held (JAX: the ``rt_serve_kv_cache_*`` series)."""

    def request_context(self) -> Optional[Dict[str, str]]:
        """The ambient serve request context ({request_id, span_id}) of
        the request being admitted, or None."""
        return None

    def kv_span(self, name: str, ctx: Dict[str, str], *, t_start: float,
                t_end: float, cached_tokens: int, prompt_tokens: int) -> None:
        """Once a request's first token is out: how many of its prompt
        tokens the prefix cache covered, as a span under ``ctx``."""

    def push_kv_snapshot(self) -> None:
        """Publish this process's retained KV pages (JAX: the ``@memkv/``
        snapshot); called from the replica's own push thread, never from
        the engine thread."""

    def on_batch(self, fn: str, size: int, max_size: int) -> None:
        """After every ``@batch`` flush of the static control."""


def _parse_request(request: Any) -> Dict[str, Any]:
    """Accept a request object with ``.json()`` (HTTP), a dict (handle
    call), or a JSON string; returns {"tokens": [...], ...}."""
    if hasattr(request, "json"):
        body = request.json()
    elif isinstance(request, (str, bytes)):
        body = json.loads(request)
    else:
        body = request
    if not isinstance(body, dict) or "tokens" not in body:
        raise ValueError("expected {'tokens': [...], 'max_new_tokens': n}")
    return body


def _preset(preset: str, seed: int, device: torch.device):
    """The preset's config with flash attention, and its params from a
    seeded generator on ``device``."""
    cfg = dataclasses.replace(llama.PRESETS[preset], attn_impl="flash")
    params = llama.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        device=device)
    return cfg, params


def _kv_push_loop(llm_ref: "weakref.ref[ContinuousLLM]",
                  period_s: float) -> None:
    """Throttled snapshot pushes (``RT_KV_PUSH_S`` apart; <= 0 disables)
    until the engine stops. The thread holds its replica weakly, so that
    dropping the replica frees its params and KV cache at once."""
    while True:
        time.sleep(period_s)
        llm = llm_ref()
        if llm is None or llm.engine.stopped():
            return
        try:
            llm.hooks.push_kv_snapshot()
        except Exception:  # noqa: BLE001 — telemetry best-effort
            pass
        del llm


class ContinuousLLM:
    """One continuous-batching engine per replica; streams token ids.

    Cache-aware by default: the engine keeps completed slots' KV pages in
    a bytes-budgeted prefix cache (``kv_cache_bytes``; 0 disables), so a
    shared-prefix admission prefills only the uncached suffix.
    ``kv_residency`` reports the warm prefixes for cache-affinity routing.
    """

    def __init__(self, preset: str = "debug", *, max_slots: int = 8,
                 max_len: int = 256, decode_stride: int = 8,
                 seed: int = 0, name: str = "",
                 kv_cache_bytes: int = 64 * 1024 * 1024,
                 sampling: bool = False, hooks: Optional[ServeHooks] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.preset = preset
        self._name = name or f"cb-{preset}"
        self.hooks = hooks if hooks is not None else ServeHooks()
        self.cfg, self.params = _preset(preset, seed, self.device)
        # the engine's kv counters are cumulative; the tick publishes
        # deltas so counters downstream advance
        self._kv_seen = {"hits": 0, "misses": 0, "evictions": 0}  # rt: guarded-by(_kv_pub_lock)
        self._kv_pub_lock = threading.Lock()

        def on_tick(active: int, slots: int) -> None:
            self.hooks.on_tick(self._name, active, slots)
            self._publish_kv()

        self.engine = ContinuousEngine(self.params, self.cfg,
                                       max_slots=max_slots, max_len=max_len,
                                       decode_stride=decode_stride,
                                       on_tick=on_tick,
                                       kv_cache_bytes=kv_cache_bytes,
                                       kv_label=self._name,
                                       sampling=sampling, device=self.device)
        push_s = float(os.environ.get("RT_KV_PUSH_S", "5"))
        if kv_cache_bytes and push_s > 0:
            # a push may block on a remote store: never on the engine
            # thread, where a stall freezes admission and decode for every
            # live slot
            threading.Thread(target=_kv_push_loop,
                             args=(weakref.ref(self), push_s),
                             name=f"kv-push:{self._name}",
                             daemon=True).start()

    def _publish_kv(self) -> None:
        """Engine-tick kv telemetry: counter deltas since the last tick
        and the bytes held."""
        kv = self.engine.kv_stats()
        if not kv:
            return
        with self._kv_pub_lock:
            deltas = {k: kv[k] - seen for k, seen in self._kv_seen.items()}
            self._kv_seen = {k: kv[k] for k in self._kv_seen}
        self.hooks.kv_cache(self._name, deltas["hits"], deltas["misses"],
                            deltas["evictions"], kv["bytes"])

    def engine_stats(self) -> Dict[str, Any]:
        """Slot occupancy and kv-cache stats for the replica's stats
        window."""
        return self.engine.stats()

    def kv_residency(self) -> List[str]:
        """The warm prefix digests the router matches prompts against."""
        return self.engine.kv_residency()

    def check_health(self) -> None:
        """A dead engine thread fails the replica's health check, so it is
        replaced instead of routed into."""
        self.engine.check_alive()

    async def __call__(self, request: Any):
        body = _parse_request(request)
        prompt = body["tokens"]
        n_new = int(body.get("max_new_tokens", 16))
        temperature = float(body.get("temperature", 0.0))
        top_k = int(body.get("top_k", 0))
        sample_seed = int(body.get("seed", 0))
        req_ctx = self.hooks.request_context()
        t_req = time.time()
        loop = asyncio.get_running_loop()
        aq: "asyncio.Queue" = asyncio.Queue()

        def deliver(burst):
            # one loop wakeup per engine tick (token burst), not per token
            for tok in burst:
                aq.put_nowait(tok)

        handle = self.engine.submit_cb(
            np.asarray(prompt, np.int64), n_new,
            lambda burst: loop.call_soon_threadsafe(deliver, burst),
            temperature=temperature, top_k=top_k, seed=sample_seed,
            obs_ctx=req_ctx)
        engine, hooks, name = self.engine, self.hooks, self._name

        async def stream():
            first = True
            try:
                while True:
                    tok = await aq.get()
                    if tok is None:
                        return
                    if first:
                        first = False
                        if req_ctx is not None:
                            hooks.kv_span(
                                name, req_ctx, t_start=t_req,
                                t_end=time.time(),
                                cached_tokens=int(handle.cached_tokens or 0),
                                prompt_tokens=len(prompt))
                    yield tok
            finally:
                # client gone mid-stream: free the slot for the next
                # admission instead of decoding into the void
                engine.cancel(handle)

        return stream()


class StaticLLM:
    """The ``@batch`` control: the same model, batch-boundary batching.

    Shapes are fixed (prompts right-padded to ``prompt_pad``, always
    ``max_new`` decode steps, ``max_batch`` rows): requests pay the
    batch-formation wait plus the whole ``generate`` of their batch. Pad
    tokens enter the shared forward, so per-request tokens are NOT those
    of ``generate`` on the bare prompt; this class is the throughput and
    latency control, not a correctness reference.
    """

    def __init__(self, preset: str = "debug", *, max_batch: int = 8,
                 prompt_pad: int = 16, max_new: int = 16,
                 batch_wait_timeout_s: float = 0.02, seed: int = 0,
                 hooks: Optional[ServeHooks] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.preset = preset
        self.hooks = hooks if hooks is not None else ServeHooks()
        self.cfg, self.params = _preset(preset, seed, self.device)
        self.prompt_pad = prompt_pad
        self.max_new = max_new
        self.max_batch = max_batch
        # a per-instance batched function: a decorated method would share
        # one batch config across every instance in the process
        self._gen_batch = _serve_batch(
            max_batch_size=max_batch,
            batch_wait_timeout_s=batch_wait_timeout_s,
            on_batch=self.hooks.on_batch)(self._generate_batch)

    async def __call__(self, request: Any) -> List[int]:
        body = _parse_request(request)
        n_new = min(int(body.get("max_new_tokens", 16)), self.max_new)
        toks = await self._gen_batch(
            (list(body["tokens"])[: self.prompt_pad], n_new))
        return toks[:n_new]

    async def _generate_batch(self, items: List[Any]) -> List[List[int]]:
        toks = np.zeros((self.max_batch, self.prompt_pad), dtype=np.int64)
        for i, (prompt, _) in enumerate(items):
            toks[i, : len(prompt)] = prompt
        out = G.generate(self.params, toks, self.cfg,
                         max_new_tokens=self.max_new, device=self.device)
        arr = out.cpu().numpy()
        return [arr[i].tolist() for i in range(len(items))]


# ---------------------------------------------------------------------------
# Poisson-arrival load driver
# ---------------------------------------------------------------------------


def http_token_request(url: str, prompt: List[int],
                       max_new_tokens: int,
                       timeout_s: float = 120.0) -> Callable[[], int]:
    """A request closure for :func:`poisson_load`: POSTs the prompt and
    reads the FULL response (streamed chunks or one JSON list); returns
    the number of generated tokens observed."""
    import urllib.request

    body = json.dumps({"tokens": prompt,
                       "max_new_tokens": max_new_tokens}).encode()

    def fire() -> int:
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            payload = r.read()
        text = payload.decode().strip()
        if not text:
            return 0
        if text.startswith("["):
            return len(json.loads(text))
        return len(text.splitlines())

    return fire


def poisson_load(request_fn: Callable[[], int], *, rps: float,
                 duration_s: float, seed: int = 0,
                 max_inflight: int = 64) -> Dict[str, Any]:
    """Open-loop Poisson arrivals: fire ``request_fn`` at exponentially
    spaced instants for ``duration_s`` and report wall latencies.

    Open loop: late requests keep arriving on schedule (up to
    ``max_inflight`` in flight; beyond that an arrival is counted as
    shed), so a slow server cannot hide its queueing by slowing the
    client down, and p99 is what an independent client population sees.

    ``request_fn`` returns the token count, or ``(token_count,
    ttft_seconds)``, surfaced as ``ttft_p50_ms``/``ttft_p99_ms``.
    """
    from concurrent.futures import ThreadPoolExecutor

    rng = random.Random(seed)
    t = 0.0
    arrivals: List[float] = []
    while t < duration_s:
        t += rng.expovariate(rps)
        if t < duration_s:
            arrivals.append(t)
    lat: List[float] = []
    ttfts: List[float] = []
    toks = [0]
    failed = [0]
    shed = [0]
    lock = threading.Lock()
    sem = threading.Semaphore(max_inflight)

    def one() -> None:
        t0 = time.perf_counter()
        try:
            n = request_fn()
        except Exception:  # noqa: BLE001 — failure is a data point
            with lock:
                failed[0] += 1
            return
        finally:
            sem.release()
        dt = time.perf_counter() - t0
        ttft = None
        if isinstance(n, tuple):
            n, ttft = n
        with lock:
            lat.append(dt)
            toks[0] += n
            if ttft is not None:
                ttfts.append(ttft)

    t_start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max_inflight + 4) as pool:
        for at in arrivals:
            delay = t_start + at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if not sem.acquire(blocking=False):
                shed[0] += 1
                continue
            pool.submit(one)
    wall = time.perf_counter() - t_start
    lat.sort()
    ttfts.sort()

    def pct(vals: List[float], q: float) -> float:
        if not vals:
            return 0.0
        return vals[min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))]

    out = {"offered": len(arrivals),
           "offered_rps": round(len(arrivals) / duration_s, 2),
           "completed": len(lat), "failed": failed[0], "shed": shed[0],
           "wall_s": round(wall, 3),
           "rps": round(len(lat) / wall, 2),
           "tok_s": round(toks[0] / wall, 1),
           "tokens": toks[0],
           "p50_ms": round(pct(lat, 0.50) * 1e3, 1),
           "p99_ms": round(pct(lat, 0.99) * 1e3, 1)}
    if ttfts:
        out["ttft_p50_ms"] = round(pct(ttfts, 0.50) * 1e3, 1)
        out["ttft_p99_ms"] = round(pct(ttfts, 0.99) * 1e3, 1)
    return out
