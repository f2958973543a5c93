#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel from ``ray_tpu_torch/csrc`` (nvcc, sm_90a), then:

1. environment: the card, its power limit, torch/CUDA versions, build time;
2. each kernel against its plain PyTorch version on the card, in bf16 at
   the shapes the serving path gives it (7b prefill, cached prefill,
   batched decode with per-row positions) and at small cases (head_dim 16
   and 64, unaligned s, GQA, non-causal, a fully masked offset, float32),
   with its time, the plain version's time, torch SDPA's time as a
   yardstick, and the least time the card could take (FLOPs at 989 TFLOP/s
   bf16 or 67 TFLOP/s fp32, bytes at 3.35 TB/s);
3. the 7b config cut to 2 layers: logits through the kernel
   (``attn_impl="flash"``) against plain-PyTorch attention (``"xla"``);
4. serving: the 7b preset at full width and 32 layers with random bf16
   weights from a seeded generator, behind ``ContinuousEngine`` (8 slots,
   max_len 1024, decode stride 8), answering 8 staggered streamed
   requests. Kernel launch counts are zeroed just before and read just
   after, and each request's first token is checked against ``generate``;
5. a ``kernels`` line, and last ``{"ok": true, "device": {...}}``.

Every phase prints one JSON line (``--jsonl PATH`` also appends them to a
file). Any failed check raises: the script then
exits non-zero and never prints the last line. Without a CUDA device, or
without the ``ray_tpu_torch`` package beside it, it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

DEV = "cuda"
JSONL = None   # --jsonl PATH: a copy of every phase line

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version: (atol, rtol) on o, atol on lse. bf16: the kernel
# rounds p to bf16 against its running max and the plain version against
# the final max, and both round o to bf16 (one ulp is 1.6e-2 at |o| in
# [2, 4)); fp32: only the summation order differs.
TOL = {"bfloat16": (2e-2, 2e-2, 1e-3), "float32": (1e-4, 0.0, 1e-4)}
# 2-layer 7b logits, kernel vs plain attention, both bf16: max |diff| over
# max |logit| (a few bf16 ulps of relative error through two layers)
LOGIT_REL_TOL = 2e-2

SERVE_PROMPT_LENS = (64, 512, 127, 384, 97, 250, 448, 190)
SERVE_NEW_TOKENS = 32


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if JSONL is not None:
        with JSONL.open("a") as f:
            f.write(line + "\n")


def time_ms(torch, fn, iters, warmup=2):
    """Eager time per call: CUDA events around ``iters`` calls. Includes
    the host's launch overhead wherever it outlasts the device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device time per call: ``iters`` calls captured in one CUDA graph
    and replayed between CUDA events, so the host's per-call overhead
    drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ phase 2

# name: (b, sq, sk, hq, hkv, d, causal, offset, dtype); offset None means
# per-row positions drawn in [sq, sk - 1], as the engine's decode rows.
KERNEL_CASES = {
    "prefill_7b": (1, 512, 512, 32, 32, 128, True, 0, "bfloat16"),
    "cached_prefill_7b": (1, 128, 1024, 32, 32, 128, True, 384, "bfloat16"),
    "decode_7b_b8": (8, 1, 1024, 32, 32, 128, True, None, "bfloat16"),
    "decode_7b_b1": (1, 1, 1024, 32, 32, 128, True, 700, "bfloat16"),
    "gqa_1b_d64": (1, 256, 256, 32, 4, 64, True, 0, "bfloat16"),
    "debug_d16_gqa": (2, 96, 96, 4, 2, 16, True, 0, "bfloat16"),
    "unaligned_s77_d64": (2, 77, 77, 4, 2, 64, True, 0, "bfloat16"),
    "noncausal_d128": (1, 200, 200, 8, 8, 128, False, 0, "bfloat16"),
    # query tiles of 10, 5 and 3 rows: warps idle, split keys 2 and 4 ways
    "ragged_s26_d128": (1, 26, 26, 8, 8, 128, True, 0, "bfloat16"),
    "short_s5_gqa_d64": (2, 5, 40, 8, 2, 64, True, 30, "bfloat16"),
    "short_s3_d16": (3, 3, 64, 4, 4, 16, True, 50, "bfloat16"),
    "masked_offset_-1000": (2, 96, 96, 4, 2, 16, True, -1000, "bfloat16"),
    "fp32_d16_offset40": (2, 96, 96, 4, 2, 16, True, 40, "float32"),
    "fp32_d128_decode": (4, 1, 300, 8, 8, 128, True, None, "float32"),
}
HEADLINE_CASE = "decode_7b_b8"   # the launch the serving path makes most
LIBRARY_CASES = ("prefill_7b", "cached_prefill_7b", "decode_7b_b8",
                 "decode_7b_b1")


def work(torch, b, sq, sk, hq, hkv, d, causal, offs, dtype):
    """(flops, bytes) the function needs on this run's inputs: every
    visible (query, key) pair costs 4*d FLOPs (QK and PV); q, o, lse and
    the offsets move once, and K/V once for each key some row sees."""
    es = torch.finfo(dtype).bits // 8
    if causal:
        rows = torch.arange(sq, device=offs.device)[None, :] + offs[:, None]
        vis = (rows + 1).clamp(min=0, max=sk)                     # [b, sq]
    else:
        vis = torch.full((b, sq), sk, device=offs.device)
    pairs = int(vis.sum()) * hq
    keys = int(vis.amax(dim=1).sum())
    flops = 4.0 * d * pairs
    nbytes = (2 * b * sq * hq * d * es + b * hq * sq * 4 + b * 4
              + 2 * keys * hkv * d * es)
    return flops, nbytes


def kernel_phase(torch, flash):
    import torch.nn.functional as F

    results = {}
    g = torch.Generator(device=DEV).manual_seed(1234)
    for name, (b, sq, sk, hq, hkv, d, causal, off, dt) in \
            KERNEL_CASES.items():
        dtype = getattr(torch, dt)
        q = torch.randn((b, sq, hq, d), generator=g, device=DEV).to(dtype)
        k = torch.randn((b, sk, hkv, d), generator=g, device=DEV).to(dtype)
        v = torch.randn((b, sk, hkv, d), generator=g, device=DEV).to(dtype)
        if off is None:
            offs = torch.randint(sq, sk, (b,), generator=g, device=DEV,
                                 dtype=torch.int32)
        else:
            offs = torch.full((b,), off, dtype=torch.int32, device=DEV)
        o, lse = flash.flash_fwd(q, k, v, offs, causal=causal)
        ro, rlse = flash.flash_fwd_reference(q, k, v, offs, causal=causal)
        torch.cuda.synchronize()
        atol, rtol, lse_tol = TOL[dt]
        err_o = float((o.float() - ro.float()).abs().max())
        excess = float(((o.float() - ro.float()).abs()
                        - (atol + rtol * ro.float().abs())).max())
        err_lse = float((lse - rlse).abs().max())
        ok = excess <= 0 and err_lse <= lse_tol and bool(
            torch.isfinite(o).all())
        if off == -1000:
            ok = ok and bool((o == 0).all()) and float(lse.max()) < -1e9
        iters = 20
        kernel = lambda: flash.flash_fwd(q, k, v, offs, causal=causal)
        kernel_ms = device_ms(torch, kernel, iters)
        eager_ms = time_ms(torch, kernel, iters)
        plain_ms = device_ms(torch, lambda: flash.flash_fwd_reference(
            q, k, v, offs, causal=causal), 5)
        library_ms = None
        if name in LIBRARY_CASES:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            pos = torch.arange(sq, device=DEV)[None, :] + offs[:, None]
            mask = (pos[:, None, :, None]
                    >= torch.arange(sk, device=DEV)[None, None, None, :])
            library_ms = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask), iters)
        flops, nbytes = work(torch, b, sq, sk, hq, hkv, d, causal, offs,
                             dtype)
        t_flops = flops / PEAK_FLOPS[dt] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "kernel", "kernel": "flash_fwd", "case": name,
               "shape": {"b": b, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv,
                         "d": d, "causal": causal,
                         "offsets": offs.tolist(), "dtype": dt},
               "max_abs_err_o": err_o, "tol_o": {"atol": atol, "rtol": rtol},
               "max_abs_err_lse": err_lse, "tol_lse": lse_tol,
               "ms": kernel_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(t_flops, t_bytes),
               "bound_by": "operations" if t_flops > t_bytes else "bytes",
               "flops": flops, "bytes": nbytes, "passed": ok}
        emit(rec)
        results[name] = rec
        check(ok, f"flash_fwd {name}: o err {err_o} (tol {atol}+{rtol}|o|),"
                  f" lse err {err_lse} (tol {lse_tol})")
    return results


# ------------------------------------------------------------ phase 3

def integration_phase(torch, tllama):
    base = dataclasses.replace(tllama.PRESETS["7b"], n_layers=2)
    gen = torch.Generator(device=DEV).manual_seed(7)
    params = tllama.init_params(base, generator=gen, device=DEV)
    tokens = torch.randint(0, base.vocab_size, (1, 512), device=DEV,
                           generator=gen)
    with torch.inference_mode():
        flash_logits = tllama.forward(
            params, tokens, dataclasses.replace(base, attn_impl="flash"))
        plain_logits = tllama.forward(
            params, tokens, dataclasses.replace(base, attn_impl="xla"))
    torch.cuda.synchronize()
    diff = float((flash_logits - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    argmax_match = float((flash_logits.argmax(-1)
                          == plain_logits.argmax(-1)).float().mean())
    rel = diff / scale
    finite = bool(torch.isfinite(flash_logits).all())
    emit({"phase": "integration", "config": "7b, n_layers=2, bf16",
          "tokens": list(tokens.shape), "max_abs_diff": diff,
          "max_abs_logit": scale, "rel_diff": rel,
          "rel_tol": LOGIT_REL_TOL, "argmax_match": argmax_match,
          "finite": finite})
    check(finite and rel <= LOGIT_REL_TOL,
          f"2-layer 7b logits: flash vs plain rel diff {rel} > "
          f"{LOGIT_REL_TOL}")
    del params, flash_logits, plain_logits
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4

def serve_phase(torch, np, tllama, TG, ContinuousEngine, flash):
    cfg = dataclasses.replace(tllama.PRESETS["7b"], attn_impl="flash")
    t0 = time.perf_counter()
    params = tllama.init_params(
        cfg, generator=torch.Generator(device=DEV).manual_seed(0),
        device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=s).astype(np.int64)
               for s in SERVE_PROMPT_LENS]
    torch.cuda.reset_peak_memory_stats()

    flash.flash_fwd.launches = 0
    t_start = time.perf_counter()
    eng = ContinuousEngine(params, cfg, max_slots=8, max_len=1024,
                           decode_stride=8, device=DEV)
    warm_s = time.perf_counter() - t_start
    t_submit, stamps, outs = {}, {}, {}

    def consume(i, q):
        toks, ts = [], []
        while True:
            t = q.get(timeout=600)
            if t is None:
                break
            toks.append(t)
            ts.append(time.perf_counter())
        outs[i], stamps[i] = toks, ts

    threads = []
    for i, p in enumerate(prompts):   # staggered admissions
        t_submit[i] = time.perf_counter()
        q = eng.submit_stream(p, SERVE_NEW_TOKENS)
        th = threading.Thread(target=consume, args=(i, q))
        th.start()
        threads.append(th)
        time.sleep(0.03)
    for th in threads:
        th.join(timeout=900)
    stats = eng.stats()
    eng.shutdown()
    launches = flash.flash_fwd.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(not any(th.is_alive() for th in threads) and
          not eng._thread.is_alive(), "engine or consumer threads hung")
    check("dead" not in stats, f"engine died: {stats.get('dead')}")

    for i in range(len(prompts)):
        toks = outs.get(i, [])
        check(len(toks) == SERVE_NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in toks),
              f"request {i}: {len(toks)} tokens, want {SERVE_NEW_TOKENS} "
              f"in-vocab")
    prefills = stats["admitted"]
    want_launches = cfg.n_layers * (prefills + stats["decode_steps"])
    check(launches >= want_launches and launches > 0,
          f"flash_fwd launched {launches} times, the path made "
          f"{want_launches} attention calls")

    ttft = [stamps[i][0] - t_submit[i] for i in range(len(prompts))]
    first_any = min(stamps[i][0] for i in stamps)
    last_any = max(stamps[i][-1] for i in stamps)
    decode_tokens = sum(len(outs[i]) - 1 for i in outs)

    # references after the counted run: batch-1 generate, same prompts
    first_match, seq_match = 0, 0
    for i, p in enumerate(prompts):
        ref = TG.generate(params, p[None, :], cfg, device=DEV,
                          max_new_tokens=SERVE_NEW_TOKENS)[0].tolist()
        first_match += int(ref[0] == outs[i][0])
        seq_match += sum(int(a == b) for a, b in zip(ref, outs[i]))
    total = len(prompts) * SERVE_NEW_TOKENS
    emit({"phase": "serve", "config": "7b, 32 layers, bf16, attn flash",
          "engine": {"max_slots": 8, "max_len": 1024, "decode_stride": 8},
          "requests": len(prompts), "prompt_lens": list(SERVE_PROMPT_LENS),
          "new_tokens": SERVE_NEW_TOKENS, "init_params_s": init_s,
          "engine_warmup_s": warm_s,
          "ttft_s": ttft, "ttft_median_s": float(np.median(ttft)),
          "decode_tok_per_s": decode_tokens / (last_any - first_any),
          "decode_tok_per_s_def": "tokens after each request's first, over "
                                  "first first-token to last token",
          "serve_wall_s": last_any - t_start,
          "peak_mem_bytes": peak, "engine_stats": stats,
          "flash_fwd_launches": launches,
          "attention_calls_expected": want_launches,
          "first_token_match": f"{first_match}/{len(prompts)}",
          "token_match_rate_vs_generate": seq_match / total})
    check(first_match == len(prompts),
          f"first tokens match generate for {first_match}/{len(prompts)}")
    step_breakdown(torch, params, cfg, prompts)
    return launches


def step_breakdown(torch, params, cfg, prompts):
    """Where a serving step's time goes, after the counted run: each
    prompt's batch-1 prefill and a full-engine decode tick (8 rows, k=8)
    on the host clock, then one profiled tick for the device's busy time
    by kernel (torch.profiler). Idle share = 1 - busy / unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.serving import ContinuousBatcher

    b = ContinuousBatcher(params, cfg, max_slots=8, max_len=1024,
                          device=DEV)
    prefill_ms = {}
    for p in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.submit(p, 64)
        prefill_ms[len(p)] = (time.perf_counter() - t0) * 1e3
    k, ticks = 8, 2
    b.step_many(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        b.step_many(k)
    step_ms = (time.perf_counter() - t0) * 1e3 / (ticks * k)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b.step_many(k)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's self device time repeats the
    # kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    per_kernel = {e.key: e.self_device_time_total / 1e3 / k
                  for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0}
    busy = sum(per_kernel.values())
    flash_ms = sum(t for name, t in per_kernel.items()
                   if "flash_fwd_kernel" in name)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "step_breakdown", "config": "7b, 32 layers, bf16",
          "prefill_ms_by_prompt_len": prefill_ms,
          "decode_rows": 8, "decode_step_ms": step_ms,
          "decode_tok_per_s_8_rows": 8 * 1e3 / step_ms,
          "device_busy_ms_per_step": busy if busy else "not measured",
          "device_idle_share": 1 - busy / step_ms if busy else
          "not measured",
          "flash_fwd_ms_per_step": flash_ms,
          "top_kernels_ms_per_step": [[n[:80], t] for n, t in top]})


def main(argv=None) -> int:
    global JSONL
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jsonl", type=Path, default=None,
                    help="also append every phase line to this file")
    JSONL = ap.parse_args(argv).jsonl
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        from ray_tpu_torch.models import generate as TG
        from ray_tpu_torch.models import llama as tllama
        from ray_tpu_torch.models.serving import ContinuousEngine
        from ray_tpu_torch.ops import _build, flash
    except ImportError as e:
        print(f"chip_smoke: the ray_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    if JSONL is not None:
        JSONL.parent.mkdir(parents=True, exist_ok=True)
        JSONL.write_text("")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_s = _build.build()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": build_s, "build_wall_s": time.perf_counter() - t0,
          "ptxas": {n: [ln for ln in log.splitlines() if "registers" in ln]
                    for n, log in _build.build_log.items()}})

    cases = kernel_phase(torch, flash)
    integration_phase(torch, tllama)
    launches = serve_phase(torch, np, tllama, TG, ContinuousEngine, flash)

    head = cases[HEADLINE_CASE]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/pallas/flash.py:41",
        "launches": launches,
        "max_abs_err": head["max_abs_err_o"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "headline_case": HEADLINE_CASE,
        "passed": all(c["passed"] for c in cases.values()),
        "cases": {n: {key: c[key] for key in (
            "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by",
            "max_abs_err_o", "max_abs_err_lse")}
            for n, c in cases.items()}}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
