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

JAX's legs 2 and 3 (the shared-prefix trace through serve deployment
handles at equal and at twice the offered load) need the serve
deployment layer on the port's runtime (ROADMAP item R1): ``--serve``
asks for them and is refused.

Env knobs as JAX's: RT_KV_BENCH_{PRESET,PREFIX,NEW,ENG_PREFIX,SLOTS,
STRIDE,OUT}. The device is ``cuda`` unless ``--device`` says otherwise.
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
from ray_tpu_torch.tools._artifact import (check_out, refuse_runtime_legs,
                                           write_artifact)
from ray_tpu_torch.util import prefix_hash as PH

PROG = "kv_bench"
#: timed requests a leg, after 2 warmups
REQUESTS = 24
#: the warm leg's prefix cache budget where one prefix fits, JAX's default
WARM_KV_BYTES = 256 << 20
#: leg 1's uncached tail: the TTFT-collapse ceiling is the cold-prefill
#: compute the cache removes, so the tail stays minimal
ENGINE_SUFFIX = 4


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


def main(argv: Optional[List[str]] = None, *,
         observe: Optional[Callable[..., None]] = None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--serve", action="store_true",
                    help="legs 2 and 3 (refused: the cluster runtime)")
    args = ap.parse_args(argv)
    preset = env("RT_KV_BENCH_PRESET", "debug")
    out = env("RT_KV_BENCH_OUT")
    check_out(out, PROG)
    if args.serve:
        refuse_runtime_legs(PROG, "legs 2 and 3 (the trace through serve "
                                  "deployment handles)")
    # the realistic shared-prefix regime is a LONG system prompt (RAG /
    # agent preambles run 1-2k tokens) with short per-request tails:
    # prefill dominates per-request engine cost, which is exactly the cost
    # the cache removes
    prefix_len = int(env("RT_KV_BENCH_PREFIX", "1024"))
    max_new = int(env("RT_KV_BENCH_NEW", "8"))
    eng_prefix = int(env("RT_KV_BENCH_ENG_PREFIX",
                         str(max(512, prefix_len))))
    slots = int(env("RT_KV_BENCH_SLOTS", "8"))
    stride = int(env("RT_KV_BENCH_STRIDE", "4"))
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
                 "kv_cache_bytes=0, SAME engine config; leg 1 only: "
                 "engine-level TTFT (submit -> first token, no transport). "
                 "Legs 2/3 (serve) need the cluster runtime"),
    }
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
    write_artifact(artifact, out, PROG)
    return 0


if __name__ == "__main__":
    sys.exit(main())
