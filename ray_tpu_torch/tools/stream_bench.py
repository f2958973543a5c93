"""Streaming bench, leg 1: the raw engine's tokens/s with N concurrent
streams (the port's ``ray_tpu/scripts/stream_bench.py``).

    [RT_STREAM_BENCH_PRESET=7b] python -m ray_tpu_torch.tools.stream_bench
        [--device cpu]

N requests of the same 8-token prompt submitted at once straight into one
``ContinuousEngine`` (no serve layer): the ceiling JAX judges its stream
transports against. One warmup run, then the best of 2; every stream
must deliver exactly its token count. The artifact (schema
``rt-stream-bench-1``) holds ``raw_engine`` with JAX's keys; it goes to
``RT_STREAM_BENCH_OUT`` or stdout, never to a default file.

JAX's push and pull legs and its RPCs-per-request sweep measure the
stream transport of the port's runtime (ROADMAP item R1): ``--serve``
asks for them and is refused; ``max_len`` is sized for leg 1 alone (16 +
the token count).

Env knobs as JAX's: RT_STREAM_BENCH_{PRESET,STREAMS,TOKENS,SLOTS,STRIDE,
OUT}. The device is ``cuda`` unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.tools._artifact import (check_out, refuse_runtime_legs,
                                           write_artifact)

PROG = "stream_bench"


def _engine_leg(preset: str, slots: int, max_len: int, stride: int,
                streams: int, tokens: int, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The raw ceiling: N concurrent requests straight into one engine."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.serving import ContinuousEngine

    device = resolve_device(device)
    # attention through the flash kernels, as serve/llm.py builds presets
    cfg = dataclasses.replace(llama.PRESETS[preset], attn_impl="flash")
    params = llama.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    engine = ContinuousEngine(params, cfg, max_slots=slots,
                              max_len=max_len, decode_stride=stride,
                              device=device)
    prompt = list(range(1, 9))
    counts = [0] * streams
    events = [threading.Event() for _ in range(streams)]

    def run_once() -> float:
        for e in events:
            e.clear()
        for i in range(streams):
            counts[i] = 0

            def on_token(burst, i=i):
                for t in burst:
                    if t is None:
                        events[i].set()
                    else:
                        counts[i] += 1

            engine.submit_cb(prompt, tokens, on_token)
        t0 = time.perf_counter()
        for e in events:
            e.wait(timeout=600)
        wall = time.perf_counter() - t0
        if any(c != tokens for c in counts):
            raise RuntimeError(f"stream token counts {counts}, want "
                               f"{tokens} each")
        return streams * tokens / wall

    try:
        run_once()  # warmup (the engine warmed its decode programs)
        tok_s = max(run_once() for _ in range(2))
    finally:
        engine.shutdown()
    return {"tok_s": round(tok_s, 1), "streams": streams,
            "tokens_per_stream": tokens}


def main(argv: Optional[List[str]] = None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--serve", action="store_true",
                    help="the push/pull legs and the RPC sweep (refused: "
                         "the cluster runtime)")
    args = ap.parse_args(argv)
    preset = env("RT_STREAM_BENCH_PRESET", "debug")
    out = env("RT_STREAM_BENCH_OUT")
    check_out(out, PROG)
    if args.serve:
        refuse_runtime_legs(PROG, "the push and pull legs and the RPC "
                                  "sweep (the stream transport)")
    streams = int(env("RT_STREAM_BENCH_STREAMS", "64"))
    tokens = int(env("RT_STREAM_BENCH_TOKENS", "64"))
    slots = int(env("RT_STREAM_BENCH_SLOTS", "8"))
    stride = int(env("RT_STREAM_BENCH_STRIDE", "16"))
    max_len = 16 + tokens
    device = resolve_device(args.device)
    artifact: Dict[str, Any] = {
        "schema": "rt-stream-bench-1", "preset": preset,
        "t": time.time(),
        "engine": {"slots": slots, "decode_stride": stride,
                   "max_len": max_len, "device": str(device)},
        "note": ("raw engine only (leg 1): N concurrent streams into one "
                 "ContinuousEngine, one warmup run, best of 2. The "
                 "push/pull transports need the cluster runtime"),
    }
    print(f"== raw engine: {streams} streams x {tokens} tok ==",
          file=sys.stderr)
    artifact["raw_engine"] = _engine_leg(preset, slots, max_len,
                                         stride, streams, tokens,
                                         device=device)
    print(f"raw engine: {artifact['raw_engine']['tok_s']} tok/s",
          file=sys.stderr)
    write_artifact(artifact, out, PROG)
    return 0


if __name__ == "__main__":
    sys.exit(main())
