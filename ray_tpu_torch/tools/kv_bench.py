"""Cache-aware serving bench, leg 1: the engine TTFT A/B, warm vs cold
(the port's ``ray_tpu/scripts/kv_bench.py``).

    [RT_KV_BENCH_PRESET=7b] python -m ray_tpu_torch.tools.kv_bench
        [--device cpu]

Sequential requests straight into one ``ContinuousEngine``, timed submit
-> first token, against the SAME engine config with the prefix KV cache
off (cold, ``kv_cache_bytes=0``) and on (warm: JAX's 256 MiB, or the
pages of one prefix where they need more, as a 1,024-token prefix of the
7b preset does with 512 MiB): the TTFT-collapse number with no
serve-transport noise (a warm prefill touches only the uncached 4-token
suffix). Each leg warms its programs and seeds its cache with 2 untimed
requests, then times 24. The artifact (schema ``rt-kv-bench-1``) holds
JAX's ``engine_ttft`` keys, ``ttft_collapse_x`` and the warm cache's
hits, misses, bytes, pages and evictions; it goes to ``RT_KV_BENCH_OUT``
or stdout, never to a default file.

``--serve`` adds JAX's legs 2 and 3: the shared-prefix trace (95% of
requests share the prefix, a quarter of those continue a session; ids are
clamped into the preset's vocab, as JAX's embedding gather clamps) as
open-loop Poisson arrivals through serve deployment handles, against a
cold app (``kv_cache_bytes=0``) and a warm one at equal load (leg 2) and a
warm one at twice the load (leg 3), the warm caches sized as leg 1's, in interleaved rounds after an untimed
replay of each leg's schedule; per-leg stats are the median across
rounds. The three apps' replicas run at once on the port's cluster
(started here unless one is up); on cuda each reserves ``GPU_SHARE`` of a
GPU, so the three share one card.

Env knobs as JAX's: RT_KV_BENCH_{PRESET,PREFIX,SUFFIX,NEW,ENG_PREFIX,
SLOTS,STRIDE,RPS,SECS,ROUNDS,MAX_LEN,OUT}. The device is ``cuda`` unless
``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.tools._artifact import check_out, write_artifact
from ray_tpu_torch.util import prefix_hash as PH

PROG = "kv_bench"
#: timed requests a leg, after 2 warmups
REQUESTS = 24
#: the warm leg's prefix cache budget where one prefix fits, JAX's default
WARM_KV_BYTES = 256 << 20
#: leg 1's uncached tail: the TTFT-collapse ceiling is the cold-prefill
#: compute the cache removes, so the tail stays minimal
ENGINE_SUFFIX = 4
#: each serve leg's replica reserves this much of a GPU on cuda, so the
#: cold, warm and warm_2x replicas run at once on one card
GPU_SHARE = 0.25


def warm_kv_bytes(preset: str, prefix_len: int, suffix_len: int,
                  max_new: int) -> int:
    """The warm engine's prefix-cache budget: JAX's 256 MiB, or the K and
    V pages of the longest entry a request captures (its prompt and
    output, chunk-aligned) where those need more, so the warm leg always
    holds its prefix."""
    from ray_tpu_torch.models import llama

    cfg = llama.PRESETS[preset]
    tokens = PH.aligned_len(prefix_len + suffix_len + max_new)
    item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    return max(WARM_KV_BYTES, 2 * cfg.n_layers * tokens * cfg.n_kv_heads
               * cfg.head_dim * item)


def _engine_ttft_leg(preset: str, prefix_len: int, suffix_len: int,
                     max_new: int, slots: int, stride: int,
                     reqs: int = REQUESTS, *, device: DeviceLike = None,
                     observe: Optional[Callable[..., None]] = None
                     ) -> Dict[str, Any]:
    """Leg 1: median submit->first-token wall, warm vs cold, one engine
    each (the same programs warmed outside the timed window); the warm
    engine's prefix cache holds ``warm_kv_bytes``.
    ``observe(leg, prompt, first_token, params)`` sees each timed
    request's prompt and first token."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.serving import ContinuousEngine

    device = resolve_device(device)
    max_len = prefix_len + suffix_len + max_new + 8
    # attention through the flash kernels, as serve/llm.py builds presets
    cfg = dataclasses.replace(llama.PRESETS[preset], attn_impl="flash")
    warm_bytes = warm_kv_bytes(preset, prefix_len, suffix_len, max_new)
    params = llama.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    prefix = list(range(1, prefix_len + 1))
    rng = random.Random(3)
    # JAX's embedding gather clamps ids past the vocab; the port's would
    # fault, so the prompt is clamped here (at the 32000-vocab presets no
    # id of this trace reaches the vocab)
    top = cfg.vocab_size - 1

    def ttfts(engine, n: int, leg: str) -> List[float]:
        out: List[float] = []
        # one throwaway per distinct program (prefill shapes) + cache
        # seeding, outside the timed window
        for warmup in (True, False):
            rounds = 2 if warmup else n
            for _ in range(rounds):
                tail = [200 + rng.randrange(1000) for _ in range(suffix_len)]
                prompt = np.minimum(np.asarray(prefix + tail, np.int32),
                                    top)
                ev = threading.Event()
                first = [0.0, None]

                def on_token(burst, ev=ev, first=first):
                    if not ev.is_set() and burst:
                        first[0] = time.perf_counter()
                        first[1] = burst[0]
                        ev.set()

                t0 = time.perf_counter()
                engine.submit_cb(prompt, max_new, on_token)
                if not ev.wait(timeout=120):
                    raise TimeoutError(f"{leg}: no first token in 120 s")
                if first[1] is None:
                    raise RuntimeError(f"{leg}: a request ended without a "
                                       f"token: {engine.stats().get('dead')}")
                # drain to completion so the slot frees + pages capture
                while True:
                    st = engine.stats()
                    if st.get("dead"):
                        raise RuntimeError(f"{leg}: engine died: "
                                           f"{st['dead']}")
                    if st["active"] == 0 and st["pending"] == 0:
                        break
                    time.sleep(0.002)
                if not warmup:
                    out.append(first[0] - t0)
                    if observe is not None:
                        observe(leg, prompt, first[1], params)
        return out

    res: Dict[str, Any] = {"requests": reqs, "prefix_tokens": prefix_len,
                           "suffix_tokens": suffix_len}
    for leg, kv_bytes in (("cold", 0), ("warm", warm_bytes)):
        engine = ContinuousEngine(params, cfg, max_slots=slots,
                                  max_len=max_len, decode_stride=stride,
                                  kv_cache_bytes=kv_bytes, kv_label=leg,
                                  device=device)
        try:
            vals = sorted(ttfts(engine, reqs, leg))
            res[leg] = {
                "ttft_p50_ms": round(1e3 * vals[len(vals) // 2], 3),
                "ttft_mean_ms": round(1e3 * sum(vals) / len(vals), 3)}
            if kv_bytes > 0:
                st = engine.stats()["kv"]
                res[leg]["kv"] = {k: st[k] for k in
                                  ("hits", "misses", "bytes", "pages",
                                   "evictions")}
        finally:
            engine.shutdown()
    res["ttft_collapse_x"] = round(
        res["cold"]["ttft_p50_ms"] / max(res["warm"]["ttft_p50_ms"], 1e-6),
        2)
    return res


class _Trace:
    """The shared-prefix request mix: 95% system-prompt + unique tail,
    5% unrelated cold prompts, plus multi-turn session continuations.
    Deterministic per seed so warm and cold legs see the same multiset."""

    def __init__(self, prefix: List[int], suffix_len: int, max_new: int,
                 seed: int, shared_frac: float = 0.95,
                 session_frac: float = 0.25, max_sessions: int = 8,
                 max_ctx: int = 0, top: Optional[int] = None):
        self.top = top
        self.prefix = prefix
        self.suffix_len = suffix_len
        self.max_new = max_new
        self.shared_frac = shared_frac
        self.session_frac = session_frac
        self.max_ctx = max_ctx
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        self.sessions: List[List[int]] = [list(prefix)
                                          for _ in range(max_sessions)]

    def next_body(self) -> Dict[str, Any]:
        body = self._next_body()
        if self.top is not None:
            # JAX's embedding gather clamps ids past the vocab; the port's
            # would fault, so the trace clamps (at the 32000-vocab presets
            # no id of the trace reaches the vocab)
            body["tokens"] = [min(t, self.top) for t in body["tokens"]]
        return body

    def _next_body(self) -> Dict[str, Any]:
        with self.lock:
            r = self.rng.random()
            if r > self.shared_frac:
                # cold minority: unrelated prompt, no reuse possible
                toks = [5000 + self.rng.randrange(20000)
                        for _ in range(len(self.prefix) // 2)]
                return {"tokens": toks, "max_new_tokens": self.max_new}
            tail = [200 + self.rng.randrange(1000)
                    for _ in range(self.suffix_len)]
            if r < self.shared_frac * self.session_frac:
                # session replay: continue a growing context
                i = self.rng.randrange(len(self.sessions))
                ctx = self.sessions[i]
                if self.max_ctx and len(ctx) + self.suffix_len + \
                        self.max_new + 2 > self.max_ctx:
                    ctx = self.sessions[i] = list(self.prefix)
                prompt = ctx + tail
                return {"tokens": prompt, "max_new_tokens": self.max_new,
                        "_session": i}
            return {"tokens": self.prefix + tail,
                    "max_new_tokens": self.max_new}

    def record(self, body: Dict[str, Any], out: List[int]) -> None:
        i = body.get("_session")
        if i is None:
            return
        with self.lock:
            # next turn extends this turn's prompt + output
            self.sessions[i] = list(body["tokens"]) + list(out)


def _serve_leg(handle, trace: _Trace, rps: float, secs: float,
               seed: int) -> Dict[str, Any]:
    from ray_tpu_torch.serve.llm import poisson_load

    def fire():
        body = dict(trace.next_body())
        sess = body.pop("_session", None)
        if sess is not None:
            body["_session"] = sess  # record() needs it; replica ignores
        send = {k: v for k, v in body.items() if not k.startswith("_")}
        t0 = time.perf_counter()
        gen = handle.remote(send).result()
        toks = []
        ttft: Optional[float] = None
        for t in gen:
            if ttft is None:
                ttft = time.perf_counter() - t0
            toks.append(t)
        trace.record(body, toks)
        return (len(toks), ttft if ttft is not None else 0.0)

    return poisson_load(fire, rps=rps, duration_s=secs, seed=seed)


def _serve_legs(preset: str, prefix_len: int, suffix_len: int,
                max_new: int, slots: int, stride: int, rps: float,
                secs: float, rounds: int, max_len: int,
                device: torch.device) -> Dict[str, Any]:
    """Legs 2 and 3 (JAX's ``main``, after leg 1): returns the artifact's
    serve keys."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import continuous_llm_app

    top = llama.PRESETS[preset].vocab_size - 1
    opts = {"num_gpus": GPU_SHARE} if device.type == "cuda" else None
    started_here = not ray_tpu_torch.is_initialized()
    if started_here:
        ray_tpu_torch.init(num_cpus=4)
    out: Dict[str, Any] = {}
    try:
        def fresh_trace():
            return _Trace(list(range(1, prefix_len + 1)), suffix_len,
                          max_new, seed=17, max_ctx=max_len - 8, top=top)

        # interleaved rounds, not one sequential pass per leg: ambient
        # host load drifts on a tens-of-seconds scale, and cycling
        # cold/warm/warm_2x in short slices with the median across
        # rounds keeps the A/B at equal conditions
        # JAX's 256 MiB warm cache, or a budget that holds one captured
        # entry where that needs more (leg 1's rule: a 1,024-token 7b
        # prefix is 512 MiB of pages)
        warm = warm_kv_bytes(preset, prefix_len, suffix_len, max_new)
        legs_cfg = (("cold", 0, rps), ("warm", warm, rps),
                    ("warm_2x", warm, 2 * rps))
        # the three replicas start at once (each pays its process, its
        # CUDA context and its weights), then each leg warms up
        for leg, kv_bytes, _ in legs_cfg:
            app = continuous_llm_app(
                preset, max_slots=slots, max_len=max_len,
                decode_stride=stride, name="KV",
                max_ongoing_requests=4 * slots, kv_cache_bytes=kv_bytes,
                ray_actor_options=opts, device=str(device))
            serve.run(app, name=f"kvb-{leg}", route_prefix=None,
                      _blocking=False)
        controller = serve.api._get_controller()
        handles = {}
        for leg, _, leg_rps in legs_cfg:
            name = f"kvb-{leg}"
            ray_tpu_torch.get(controller.wait_healthy.remote(name, 180.0),
                              timeout=240)
            h = serve.get_deployment_handle("KV", name)
            # warmup: one boot request, then an untimed replay of the
            # leg's whole deterministic schedule, so every prefill and
            # restore shape is seen and the warm legs reach their steady
            # cache before the timed rounds
            list(h.remote({"tokens": [min(t, top) for t in
                                      range(1, prefix_len + 1)],
                           "max_new_tokens": 2}).result())
            _serve_leg(h, fresh_trace(), leg_rps, secs, seed=29)
            handles[leg] = (name, h, leg_rps)

        per_round: Dict[str, List[Dict[str, Any]]] = \
            {leg: [] for leg in handles}
        for rnd in range(rounds):
            for leg, (name, h, leg_rps) in handles.items():
                print(f"== round {rnd + 1}/{rounds} {leg} @ {leg_rps} "
                      f"rps x {secs}s ==", file=sys.stderr)
                r = _serve_leg(h, fresh_trace(), leg_rps, secs,
                               seed=101 + rnd)
                print(f"  {leg}: {r}", file=sys.stderr)
                per_round[leg].append(r)

        def med(vals: List[float]) -> float:
            vals = sorted(vals)
            return vals[len(vals) // 2]

        legs = {}
        for leg, (name, h, leg_rps) in handles.items():
            rs = per_round[leg]
            agg = {}
            for k in ("p50_ms", "p99_ms", "ttft_p50_ms", "ttft_p99_ms",
                      "rps", "tok_s"):
                # a fully shed round has no ttft_* keys: aggregate over
                # the rounds that have the series
                vals = [r[k] for r in rs if k in r]
                agg[k] = med(vals) if vals else None
            agg["offered"] = sum(r["offered"] for r in rs)
            agg["completed"] = sum(r["completed"] for r in rs)
            agg["failed"] = sum(r["failed"] for r in rs)
            agg["shed"] = sum(r["shed"] for r in rs)
            agg["rounds"] = rs
            st = serve.detailed_status()["applications"][name][
                "deployments"]["KV"]["stats"]
            for k in ("kv_hits", "kv_misses", "kv_hit_rate", "kv_bytes",
                      "kv_evictions"):
                if k in st:
                    agg[k] = st[k]
            legs[leg] = agg
            serve.delete(name)
        out["serve"] = legs
        out["serve_method"] = (
            f"{rounds} interleaved cold/warm/warm_2x rounds of {secs}s "
            "each; per-leg stats are the MEDIAN across rounds")
        cold, warm, warm2 = legs["cold"], legs["warm"], legs["warm_2x"]
        out["ttft_collapse_x_serve"] = round(
            (cold.get("ttft_p50_ms") or 0.0)
            / max(warm.get("ttft_p50_ms") or 1e-9, 1e-9), 2)
        out["hits_advancing"] = bool(warm.get("kv_hits", 0) > 0)
        shed_budget = cold["failed"] + cold["shed"]
        out["p99_held_at_2x"] = bool(
            warm2["p99_ms"] is not None and cold["p99_ms"] is not None
            and warm2["p99_ms"] <= max(cold["p99_ms"], 1.0)
            and warm2["failed"] + warm2["shed"] <= shed_budget)
    finally:
        try:
            serve.shutdown()
        except Exception:  # noqa: BLE001 — bench teardown
            pass
        if started_here:
            ray_tpu_torch.shutdown()
    return out


def main(argv: Optional[List[str]] = None, *,
         observe: Optional[Callable[..., None]] = None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--serve", action="store_true",
                    help="also legs 2 and 3 through serve deployment "
                         "handles on the port's cluster")
    args = ap.parse_args(argv)
    preset = env("RT_KV_BENCH_PRESET", "debug")
    out = env("RT_KV_BENCH_OUT")
    check_out(out, PROG)
    # the realistic shared-prefix regime is a LONG system prompt (RAG /
    # agent preambles run 1-2k tokens) with short per-request tails:
    # prefill dominates per-request engine cost, which is exactly the cost
    # the cache removes
    prefix_len = int(env("RT_KV_BENCH_PREFIX", "1024"))
    # suffix + max_new together make one chunk (64), so a session context
    # grows chunk-aligned turn over turn and the uncached suffix keeps one
    # shape
    suffix_len = int(env("RT_KV_BENCH_SUFFIX", "56"))
    max_new = int(env("RT_KV_BENCH_NEW", "8"))
    eng_prefix = int(env("RT_KV_BENCH_ENG_PREFIX",
                         str(max(512, prefix_len))))
    slots = int(env("RT_KV_BENCH_SLOTS", "8"))
    stride = int(env("RT_KV_BENCH_STRIDE", "4"))
    rps = float(env("RT_KV_BENCH_RPS", "5"))
    secs = float(env("RT_KV_BENCH_SECS", "12"))
    rounds = int(env("RT_KV_BENCH_ROUNDS", "3"))
    # session contexts grow turn over turn: room for a couple of turns
    max_len = int(env("RT_KV_BENCH_MAX_LEN",
                      str(prefix_len + 2 * (suffix_len + max_new) + 64)))
    device = resolve_device(args.device)

    artifact: Dict[str, Any] = {
        "schema": "rt-kv-bench-1", "preset": preset, "t": time.time(),
        "engine": {"prefix_tokens": eng_prefix,
                   "suffix_tokens": ENGINE_SUFFIX,
                   "warm_kv_bytes": warm_kv_bytes(preset, eng_prefix,
                                                  ENGINE_SUFFIX, max_new),
                   "max_new_tokens": max_new, "slots": slots,
                   "decode_stride": stride, "device": str(device)},
        "note": ("warm = prefix/KV cache on, cold = "
                 "kv_cache_bytes=0, SAME engine config; leg 1 is "
                 "engine-level TTFT (submit -> first token, no transport)"
                 + ("; legs 2/3 are open-loop Poisson through serve "
                    "handles (ttft = first streamed token at the client)"
                    if args.serve else "; --serve adds legs 2 and 3")),
    }
    if args.serve:
        artifact["trace"] = {"shared_prefix_frac": 0.95,
                             "session_frac": 0.25,
                             "prefix_tokens": prefix_len,
                             "suffix_tokens": suffix_len,
                             "max_new_tokens": max_new}
    print(f"== leg 1: engine TTFT A/B ({eng_prefix}+{ENGINE_SUFFIX} tok "
          f"prompts) ==", file=sys.stderr)
    artifact["engine_ttft"] = _engine_ttft_leg(
        preset, eng_prefix, ENGINE_SUFFIX, max_new, slots, stride,
        device=device, observe=observe)
    e = artifact["engine_ttft"]
    artifact["ttft_collapse_x_engine"] = e["ttft_collapse_x"]
    artifact["collapse_ge_5x"] = bool(e["ttft_collapse_x"] >= 5.0)
    print(f"cold p50 {e['cold']['ttft_p50_ms']}ms vs warm p50 "
          f"{e['warm']['ttft_p50_ms']}ms -> collapse x"
          f"{e['ttft_collapse_x']}", file=sys.stderr)
    if args.serve:
        artifact.update(_serve_legs(preset, prefix_len, suffix_len, max_new,
                                    slots, stride, rps, secs, rounds,
                                    max_len, device))
        print(f"serve collapse x{artifact['ttft_collapse_x_serve']}; hits "
              f"advancing: {artifact['hits_advancing']}; p99 held at 2x "
              f"load: {artifact['p99_held_at_2x']}", file=sys.stderr)
    write_artifact(artifact, out, PROG)
    return 0


if __name__ == "__main__":
    sys.exit(main())
