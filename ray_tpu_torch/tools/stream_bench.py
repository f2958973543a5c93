"""Stream-transport bench: the raw engine's tokens/s with N concurrent
streams, and push against pull through serve handles at equal offered
load (the port's ``ray_tpu/scripts/stream_bench.py``).

    [RT_STREAM_BENCH_PRESET=7b] python -m ray_tpu_torch.tools.stream_bench
        [--device cpu] [--serve]

1. **raw engine**: N requests of the same 8-token prompt submitted at
   once straight into one ``ContinuousEngine`` (no serve layer), the
   ceiling the transports are judged against. One warmup run, then the
   best of 2; every stream must deliver exactly its token count.
2. **push** (``--serve``): the default transport through a
   ``continuous_llm_app`` replica, one ``stream_subscribe`` RPC then
   one-way frames (``cluster/stream.py``).
3. **pull** (``--serve``): ``RT_STREAM_PULL=1``, one ``next_chunks``
   actor RPC per burst.

Plus, with ``--serve``, the RPCs-against-token-count sweep (constant on
push, growing on pull) and ``push_vs_raw_ratio``. The serve legs start
the port's cluster unless one is up; on cuda each replica reserves one
GPU. The artifact (schema ``rt-stream-bench-1``, JAX's keys) goes to
``RT_STREAM_BENCH_OUT`` or stdout, never to a default file.

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
from ray_tpu_torch.tools._artifact import check_out, write_artifact

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
    try:
        tok_s = engine_tok_s(engine, streams, tokens)
    finally:
        engine.shutdown()
    return {"tok_s": round(tok_s, 1), "streams": streams,
            "tokens_per_stream": tokens}


def engine_tok_s(engine, streams: int, tokens: int) -> float:
    """Tokens/s of ``streams`` concurrent requests of the same 8-token
    prompt into ``engine``: one warmup run, then the best of 2; every
    stream must deliver exactly ``tokens``."""
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

    run_once()  # warmup (the engine warmed its decode programs)
    return max(run_once() for _ in range(2))


def _serve_leg(handle, streams: int, tokens: int) -> Dict[str, Any]:
    """N concurrent streamed handle requests at equal offered load;
    reports tok/s plus the observed RPCs-per-request distribution."""
    from concurrent.futures import ThreadPoolExecutor

    body = {"tokens": list(range(1, 9)), "max_new_tokens": tokens}
    results: List[Dict[str, Any]] = []
    lock = threading.Lock()

    def one() -> None:
        gen = handle.remote(body).result()
        n = sum(1 for _ in gen)
        with lock:
            results.append({"tokens": n, "rpcs": gen._rpcs,
                            "transport": gen._transport})

    with ThreadPoolExecutor(max_workers=streams) as pool:
        # warmup request (replica boot + route) outside the timed window
        one()
        results.clear()
        t0 = time.perf_counter()
        futs = [pool.submit(one) for _ in range(streams)]
        for f in futs:
            f.result()
        wall = time.perf_counter() - t0
    total = sum(r["tokens"] for r in results)
    if any(r["tokens"] != tokens for r in results):
        raise RuntimeError(f"stream token counts "
                           f"{[r['tokens'] for r in results]}, want "
                           f"{tokens} each")
    rpcs = sorted(r["rpcs"] for r in results)
    return {"tok_s": round(total / wall, 1), "streams": streams,
            "tokens_per_stream": tokens,
            "transport": results[0]["transport"],
            "rpcs_per_request_mean": round(sum(rpcs) / len(rpcs), 2),
            "rpcs_per_request_max": rpcs[-1]}


def _rpc_scaling(handle, token_counts: List[int], per_n: int = 4
                 ) -> List[Dict[str, Any]]:
    """Mean RPCs per request as token count grows: constant on push,
    growing with the token count on pull."""
    out = []
    for n in token_counts:
        body = {"tokens": list(range(1, 9)), "max_new_tokens": n}
        rpcs = []
        for _ in range(per_n):
            gen = handle.remote(body).result()
            got = sum(1 for _ in gen)
            if got != n:
                raise RuntimeError(f"{got} tokens streamed, want {n}")
            rpcs.append(gen._rpcs)
        out.append({"tokens": n,
                    "rpcs_mean": round(sum(rpcs) / len(rpcs), 2)})
    return out


def transport_legs(handle, streams: int, tokens: int,
                   scaling_counts: List[int],
                   per_n: int = 4) -> Dict[str, Any]:
    """The push leg, then the pull leg (``RT_STREAM_PULL=1``, read by
    the consumer per stream), each with its RPC sweep (``per_n`` requests
    a token count), through one deployment ``handle``."""
    out: Dict[str, Any] = {}
    prev = os.environ.pop("RT_STREAM_PULL", None)
    try:
        for leg, pull in (("push", None), ("pull", "1")):
            if pull is None:
                os.environ.pop("RT_STREAM_PULL", None)
            else:
                os.environ["RT_STREAM_PULL"] = pull
            print(f"== serve leg: {leg} ==", file=sys.stderr)
            out[leg] = _serve_leg(handle, streams, tokens)
            out[leg]["rpc_scaling"] = _rpc_scaling(handle, scaling_counts,
                                                   per_n)
            print(f"{leg}: {out[leg]['tok_s']} tok/s, rpcs/request mean "
                  f"{out[leg]['rpcs_per_request_mean']} scaling "
                  f"{out[leg]['rpc_scaling']}", file=sys.stderr)
    finally:
        os.environ.pop("RT_STREAM_PULL", None)
        if prev is not None:
            os.environ["RT_STREAM_PULL"] = prev
    return out


def summarize(artifact: Dict[str, Any]) -> None:
    """JAX's verdict keys from the raw, push and pull legs."""
    raw = artifact["raw_engine"]["tok_s"]
    push = artifact["push"]["tok_s"]
    artifact["push_vs_raw_ratio"] = round(raw / max(push, 1e-9), 3)
    artifact["within_1p5x"] = bool(raw / max(push, 1e-9) <= 1.5)
    sc = artifact["push"]["rpc_scaling"]
    artifact["push_rpcs_constant"] = bool(
        max(s["rpcs_mean"] for s in sc)
        - min(s["rpcs_mean"] for s in sc) < 1.0)


def main(argv: Optional[List[str]] = None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--serve", action="store_true",
                    help="also the push and pull legs and the RPC sweep "
                         "through a serve deployment on the port's cluster")
    args = ap.parse_args(argv)
    preset = env("RT_STREAM_BENCH_PRESET", "debug")
    out = env("RT_STREAM_BENCH_OUT")
    check_out(out, PROG)
    streams = int(env("RT_STREAM_BENCH_STREAMS", "64"))
    tokens = int(env("RT_STREAM_BENCH_TOKENS", "64"))
    slots = int(env("RT_STREAM_BENCH_SLOTS", "8"))
    stride = int(env("RT_STREAM_BENCH_STRIDE", "16"))
    scaling_counts = [16, 64, 256]
    max_len = 16 + max([tokens] + (scaling_counts if args.serve else []))
    device = resolve_device(args.device)
    artifact: Dict[str, Any] = {
        "schema": "rt-stream-bench-1", "preset": preset,
        "t": time.time(),
        "engine": {"slots": slots, "decode_stride": stride,
                   "max_len": max_len, "device": str(device)},
        "note": ("push vs pull at equal offered load, one replica, "
                 "same engine config; raw engine is the ceiling (N "
                 "concurrent streams into one ContinuousEngine, one "
                 "warmup run, best of 2). rpcs_per_request counts "
                 "handle_request + transport RPCs observed by the "
                 "consumer." if args.serve else
                 "raw engine only (leg 1): N concurrent streams into one "
                 "ContinuousEngine, one warmup run, best of 2; --serve "
                 "adds the push and pull legs"),
    }
    print(f"== raw engine: {streams} streams x {tokens} tok ==",
          file=sys.stderr)
    artifact["raw_engine"] = _engine_leg(preset, slots, max_len,
                                         stride, streams, tokens,
                                         device=device)
    print(f"raw engine: {artifact['raw_engine']['tok_s']} tok/s",
          file=sys.stderr)
    if args.serve:
        artifact.update(_serve_legs(preset, slots, max_len, stride, streams,
                                    tokens, scaling_counts, device))
        summarize(artifact)
        print(f"push {artifact['push']['tok_s']} tok/s vs raw "
              f"{artifact['raw_engine']['tok_s']} tok/s "
              f"(x{artifact['push_vs_raw_ratio']} gap); push rpcs constant "
              f"in token count: {artifact['push_rpcs_constant']}",
              file=sys.stderr)
    write_artifact(artifact, out, PROG)
    return 0


def _serve_legs(preset: str, slots: int, max_len: int, stride: int,
                streams: int, tokens: int, scaling_counts: List[int],
                device: torch.device) -> Dict[str, Any]:
    """Deploy one ``continuous_llm_app`` replica on the port's cluster
    (started here unless one is up) and run both transports through it."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import continuous_llm_app

    started_here = not ray_tpu_torch.is_initialized()
    if started_here:
        ray_tpu_torch.init()
    try:
        app = continuous_llm_app(preset, max_slots=slots, max_len=max_len,
                                 decode_stride=stride, name="CB",
                                 max_ongoing_requests=2 * streams,
                                 device=str(device))
        serve.run(app, name="sb", route_prefix=None)
        return transport_legs(serve.get_deployment_handle("CB", "sb"),
                              streams, tokens, scaling_counts)
    finally:
        try:
            serve.shutdown()
        except Exception:  # noqa: BLE001 — bench teardown
            pass
        if started_here:
            ray_tpu_torch.shutdown()


if __name__ == "__main__":
    sys.exit(main())
