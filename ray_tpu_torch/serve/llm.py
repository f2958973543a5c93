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

The classes report (slot occupancy, kv-cache counters, the request's kv
span, the ``@memkv/`` snapshot push, batch formation) through a
:class:`ServeHooks` object. The default, :class:`ObsHooks`, writes the
port's own ``serve.obs`` series and spans and its cluster's KV, as the JAX
package's classes write theirs; a caller may pass another (the base class
does nothing). A hooks object is pickled into the replica with the class's
arguments, so it must be an instance of a module-level class.

The app functions (``continuous_llm_app``, ``static_llm_app``) deploy the
classes through ``ray_tpu_torch.serve``; on ``device="cuda"`` (the
default) each replica reserves one GPU. ``cb_vs_static_load`` drives both
under equal Poisson load over the proxy fleet.
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

__all__ = ["ContinuousLLM", "StaticLLM", "ServeHooks", "ObsHooks",
           "cb_vs_static_load", "continuous_llm_app", "static_llm_app",
           "poisson_load", "http_token_request"]


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


class ObsHooks(ServeHooks):
    """The default hooks: the port's ``serve.obs`` series and spans, and
    the ``@memkv/`` snapshot in its cluster's KV, written as the JAX
    package's ContinuousLLM writes its own (``ray_tpu/serve/llm.py``).
    ``@batch`` flushes reach ``serve.obs`` from the batcher itself."""

    def on_tick(self, name: str, active: int, slots: int) -> None:
        from ray_tpu_torch.serve import obs

        # the continuous-batching yardstick: fused rows per decode step
        # and the fraction of the slot budget they fill
        tags = {"fn": f"cb:{name}"}
        obs.batch_size_hist().observe(active, tags=tags)
        obs.batch_occupancy_hist().observe(active / max(1, slots), tags=tags)
        obs.cb_slots_gauge().set(active, tags={"deployment": name})

    def kv_cache(self, name: str, hits: int, misses: int, evictions: int,
                 nbytes: int) -> None:
        from ray_tpu_torch.serve import obs

        tags = {"deployment": name}
        for counter, n in ((obs.kv_cache_hits, hits),
                           (obs.kv_cache_misses, misses),
                           (obs.kv_cache_evictions, evictions)):
            if n > 0:
                counter().inc(n, tags=tags)
        obs.kv_cache_bytes().set(nbytes, tags=tags)

    def request_context(self) -> Optional[Dict[str, str]]:
        from ray_tpu_torch.serve import obs

        return obs.current_request_context()

    def kv_span(self, name: str, ctx: Dict[str, str], *, t_start: float,
                t_end: float, cached_tokens: int, prompt_tokens: int) -> None:
        from ray_tpu_torch.serve import obs

        # how much of this prompt's prefill the kv cache absorbed, on the
        # request's span tree beside the proxy's ttft phase
        span = obs.new_span_id()
        obs.emit_span(
            f"serve:{ctx['request_id']}:kv:{span[:8]}", f"kv:{name}",
            request_id=ctx["request_id"], span_id=span,
            parent_span_id=ctx.get("span_id"), t_start=t_start,
            t_end=t_end, phases={"cached_tokens": float(cached_tokens),
                                 "prompt_tokens": float(prompt_tokens)})

    def push_kv_snapshot(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.util import memory as rt_memory

        if ray_tpu_torch.is_initialized():
            rt_memory.publish_kv_snapshot(
                ray_tpu_torch.global_worker()._require_backend())


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
    if device.type == "cuda":
        # the float32 draws leave cached blocks behind (GBs at 7b): hand
        # them back, so that replicas sharing the card can use them
        torch.cuda.empty_cache()
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
        self.hooks = hooks if hooks is not None else ObsHooks()
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
        self.hooks = hooks if hooks is not None else ObsHooks()
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


def continuous_llm_app(preset: str = "debug", *, max_slots: int = 8,
                       max_len: int = 256, decode_stride: int = 8,
                       name: str = "CB",
                       max_ongoing_requests: Optional[int] = None,
                       autoscaling_config=None,
                       ray_actor_options: Optional[Dict] = None,
                       num_replicas: int = 1, seed: int = 0,
                       kv_cache_bytes: int = 64 * 1024 * 1024,
                       sampling: bool = False, device: str = "cuda"):
    """A ready-to-run continuous-batching Application. ``max_ongoing``
    defaults to 2x the slot count: the engine's pending queue absorbs a
    burst while slots drain, and the replica rejects beyond that.
    ``kv_cache_bytes=0`` disables prefix/KV reuse (the cold-prefill
    control the cache bench compares against). On ``device="cuda"`` each
    replica reserves one GPU unless ``ray_actor_options`` names
    ``num_gpus``; a replica that finds no GPU raises."""
    from ray_tpu_torch import serve

    dep = serve.deployment(ContinuousLLM).options(
        name=name,
        num_replicas=None if autoscaling_config else num_replicas,
        max_ongoing_requests=max_ongoing_requests or 2 * max_slots,
        autoscaling_config=autoscaling_config,
        ray_actor_options=_replica_options(ray_actor_options, device))
    return dep.bind(preset, max_slots=max_slots, max_len=max_len,
                    decode_stride=decode_stride, seed=seed, name=name,
                    kv_cache_bytes=kv_cache_bytes, sampling=sampling,
                    device=device)


def static_llm_app(preset: str = "debug", *, max_batch: int = 8,
                   prompt_pad: int = 16, max_new: int = 16,
                   batch_wait_timeout_s: float = 0.02, name: str = "Static",
                   max_ongoing_requests: int = 64, seed: int = 0,
                   ray_actor_options: Optional[Dict] = None,
                   device: str = "cuda"):
    """The static ``@serve.batch`` control Application (one GPU a replica
    on ``device="cuda"``, as ``continuous_llm_app``)."""
    from ray_tpu_torch import serve

    dep = serve.deployment(StaticLLM).options(
        name=name, max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=_replica_options(ray_actor_options, device))
    return dep.bind(preset, max_batch=max_batch, prompt_pad=prompt_pad,
                    max_new=max_new,
                    batch_wait_timeout_s=batch_wait_timeout_s, seed=seed,
                    device=device)


def _replica_options(ray_actor_options: Optional[Dict],
                     device: str) -> Dict:
    """A replica serving on cuda reserves one GPU, so the raylet pins it
    to one card (``CUDA_VISIBLE_DEVICES``); the caller's options win."""
    opts = dict(ray_actor_options or {})
    if torch.device(device).type == "cuda":
        opts.setdefault("num_gpus", 1)
    return opts


# ---------------------------------------------------------------------------
# Poisson-arrival load driver
# ---------------------------------------------------------------------------


def cb_vs_static_load(*, preset: str = "debug", slots: int = 8,
                      max_len: int = 384, decode_stride: int = 16,
                      prompt_len: int = 8, short_tokens: int = 2,
                      long_tokens: int = 256, long_frac: float = 0.05,
                      rps: float = 15.0, duration_s: float = 15.0,
                      num_proxies: int = 2, timeout_s: float = 240.0,
                      seed: int = 42, route_base: str = "cbvs",
                      device: str = "cuda") -> Dict[str, Dict[str, Any]]:
    """The continuous-vs-static comparison (JAX's twin): open-loop Poisson
    arrivals round-robined over the proxy fleet at equal offered load and
    a short/long decode-length mix, against (a) the continuous-batching
    app and (b) the ``@serve.batch`` control provisioned at
    ``max_new=long_tokens`` (a batch-boundary system decodes its longest
    admissible request every flush, the waste slot admission avoids).
    Each leg warms every (proxy, length) pair first, so replica spawn and
    the replica's CUDA context stay out of the timed window.

    Requires an initialized ray_tpu_torch; deploys and tears down its own
    apps (``<route_base>-continuous`` / ``<route_base>-static``). Returns
    {"continuous": poisson_result, "static": poisson_result}.
    """
    import itertools

    from ray_tpu_torch import serve

    prompt = list(range(1, prompt_len + 1))
    results: Dict[str, Dict[str, Any]] = {}
    for leg, app, route in (
        ("continuous",
         continuous_llm_app(preset, max_slots=slots, max_len=max_len,
                            decode_stride=decode_stride, name="CB",
                            max_ongoing_requests=4 * slots, device=device),
         f"/{route_base}-cb"),
        ("static",
         static_llm_app(preset, max_batch=slots, prompt_pad=prompt_len,
                        max_new=long_tokens, name="Static",
                        max_ongoing_requests=4 * slots, device=device),
         f"/{route_base}-static"),
    ):
        name = f"{route_base}-{leg}"
        serve.run(app, name=name, route_prefix=route,
                  http_options=serve.HTTPOptions(port=0,
                                                 num_proxies=num_proxies))
        ports = serve.proxy_ports()
        fires = {}
        for p in ports:
            for n in (short_tokens, long_tokens):
                fires[(p, n)] = http_token_request(
                    f"http://127.0.0.1:{p}{route}/", prompt, n,
                    timeout_s=timeout_s)
                # warmup: replica spawn, the CUDA context, kernel loads
                fires[(p, n)]()
        rr = itertools.cycle(ports)
        # deterministic length SCHEDULE, consumed by fire order: the two
        # legs see the same short/long multiset and near-identical
        # ordering (worker-thread scheduling and client sheds can still
        # skew tail placement — per-arrival determinism would need index
        # plumbing through poisson_load)
        mix_rng = random.Random(7)
        schedule = [long_tokens if mix_rng.random() < long_frac
                    else short_tokens
                    for _ in range(int(rps * duration_s * 4) + 64)]
        counter = itertools.count()
        lock = threading.Lock()

        def fire():
            with lock:
                i = next(counter)
                port = next(rr)
            n = schedule[min(i, len(schedule) - 1)]
            return fires[(port, n)]()

        results[leg] = poisson_load(fire, rps=rps, duration_s=duration_s,
                                    seed=seed)
        serve.delete(name)
    return results




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
