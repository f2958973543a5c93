#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel from ``ray_tpu_torch/csrc`` (nvcc, sm_90a, one
process per source, all at once), then:

1. environment: the card, its power limit, torch/CUDA versions, build time;
2. the forward kernels (bf16: the split-KV decode kernel for single-row
   calls, the tensor cores from ``fwd_tiling``'s threshold of query rows
   up; float32: CUDA cores) against their plain PyTorch version on the
   card, in bf16 at the shapes the serving and training paths give them
   (7b prefill, cached prefill, batched decode with per-row positions at
   7b and at the 1b preset's GQA group, one 7b row over 4,096 keys, the 1b
   train step, 7b's d 128 at s 2048) and at small cases (head_dim 16 and
   64, unaligned s, GQA, non-causal, a fully masked offset, a dead decode
   row beside rows that see only the first key chunk, float32, cuts at the
   edges of the 64-row and 64-key tiles, one row below and at the
   threshold), the decode kernel also against the plain version of its
   split arithmetic, two launches checked to give the same bits, each
   record with its kernel and tiling, with its time, the plain version's
   time, torch SDPA's time as a yardstick (with the same mask, and with
   ``is_causal`` where the mask is the plain causal square), and the
   least time the card could take (FLOPs at 989 TFLOP/s bf16 or 67
   TFLOP/s fp32, bytes at 3.35 TB/s);
3. the two backward kernels (dq, dkv) against their plain versions the
   same way, at the 1b train step's shape (b 4, s 2048, 32/4 heads, d 64),
   at 7b's d 128 and at small cases cut at the edges of their tiles, with
   torch SDPA's backward as the yardstick at the two training shapes, two
   launches checked to give the same bits, each record with the kernels'
   tiling, and the dkv grid's modelled scheduling tail;
4. the 7b config cut to 2 layers: logits through the kernel
   (``attn_impl="flash"``) against plain-PyTorch attention (``"xla"``);
5. the 1b config cut to 2 layers: ``lm_loss`` and every gradient through
   the kernels against plain-PyTorch attention;
6. serving: the 7b preset at full width and 32 layers with random bf16
   weights from a seeded generator, behind ``ContinuousEngine`` (8 slots,
   max_len 1024, decode stride 8), answering 8 staggered streamed
   requests, each request's first token checked against ``generate``; the
   prefills go through the tensor-core forward, the decode steps through
   the split-KV decode kernel (both counted; a profiled decode tick must
   launch only the decode kernel);
7. training: the 1b preset at full width and 22 layers, fp32 master
   params from a seeded generator, bf16 compute, flash attention, remat,
   8 AdamW steps on a fixed [4, 2049] token batch; finite and falling loss,
   tokens/s, MFU, peak memory, per-step garbage-collector counts, SM clocks
   before and after, and a profiled step whose forward time must all be
   the tensor-core kernel's;
8. a ``kernels`` line, and last ``{"ok": true, "device": {...}}``.

Each path (serve, train) zeroes every kernel's launch count just before
it runs and reads them just after; a kernel of the paths that was not
launched fails the run (the float32 CUDA-core forward is on neither path:
its entry reports its launches, 0, and its cases).

Every phase prints one JSON line (``--jsonl PATH`` also appends them to a
file). Any failed check raises: the script then
exits non-zero and never prints the last line. ``--only`` runs a subset
of the phases and prints neither of the last two lines. Without a CUDA device, or
without the ``ray_tpu_torch`` package beside it, it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
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
# dec vs the plain version of its split arithmetic (same splits): (atol,
# rtol) on o, atol on lse. Both sides sum the same chunks and merge them
# in the same order in fp32, so their fp32 o differ by far less than a
# bf16 ulp, and the one rounding of o to bf16 leaves them at most one ulp
# apart (2**-7 of |o| at most); lse differs by a few fp32 ulps.
SPLIT_TOL = (1e-3, 8e-3, 1e-4)
# 2-layer 7b logits, kernel vs plain attention, both bf16: max |diff| over
# max |logit| (a few bf16 ulps of relative error through two layers)
LOGIT_REL_TOL = 2e-2
# backward kernels vs plain versions: max |g - plain| over max |plain|, per
# gradient. bf16: the kernels form p and ds in fp32 and round them to bf16
# (2**-9 of each term) as the operand of the dq, dk and dv products, whose
# sums are fp32; the plain version keeps p and ds in fp32. Each gradient is
# then rounded to bf16 once (one ulp is 2**-8 = 3.9e-3 of the element).
# fp32: only the order of up to sk * group terms differs.
BWD_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# 2-layer 1b gradients, flash vs plain attention, bf16 compute: max |diff|
# over max |grad| per leaf. The plain path rounds its softmax weights and
# its dp product to bf16 inside autograd, the kernels keep p, dp and ds in
# fp32: bf16 rounding (3.9e-3 a step) through a few chained products.
GRAD_REL_TOL = 5e-2
# first loss of the 1b train run: ln(32000) = 10.37 plus sigma^2 / 2 = 0.5
# for the unit-variance logits of a random head on rms-normed hiddens
FIRST_LOSS_MARGIN = 1.0
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8

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
# per-row positions drawn in [sq, sk - 1], as the engine's decode rows; a
# list gives each batch row its own position.
KERNEL_CASES = {
    "prefill_7b": (1, 512, 512, 32, 32, 128, True, 0, "bfloat16"),
    "cached_prefill_7b": (1, 128, 1024, 32, 32, 128, True, 384, "bfloat16"),
    "decode_7b_b8": (8, 1, 1024, 32, 32, 128, True, None, "bfloat16"),
    "decode_7b_b1": (1, 1, 1024, 32, 32, 128, True, 700, "bfloat16"),
    # the 1b preset's decode: a GQA group of 8 q heads in one 16-row tile
    "decode_1b_gqa_b8": (8, 1, 1024, 32, 4, 64, True, None, "bfloat16"),
    # one long row split across blocks
    "decode_7b_b1_s4096": (1, 1, 4096, 32, 32, 128, True, 4095, "bfloat16"),
    # a dead row, and rows whose later key chunks are all dead
    "decode_dead_and_first_chunk_d64": (4, 1, 1024, 8, 2, 64, True,
                                        [-1, 0, 63, 1023], "bfloat16"),
    "gqa_1b_d64": (1, 256, 256, 32, 4, 64, True, 0, "bfloat16"),
    "train_1b_d64_gqa": (4, 2048, 2048, 32, 4, 64, True, 0, "bfloat16"),
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
    # one short of and one past the tensor-core kernel's 64-row tiles
    "s63_d64": (2, 63, 63, 4, 2, 64, True, 0, "bfloat16"),
    "s65_d64": (2, 65, 65, 4, 2, 64, True, 0, "bfloat16"),
    "s129_d128": (1, 129, 129, 4, 2, 128, True, 0, "bfloat16"),
    "gqa8_d128": (1, 130, 130, 8, 1, 128, True, 0, "bfloat16"),
    "per_row_offsets_d128": (3, 100, 100, 8, 2, 128, True, [-30, 5, 64],
                             "bfloat16"),
    # the diagonal of every row cuts key tile 2 of [128, 192)
    "sq40_sk300_offset100_d64": (2, 40, 300, 8, 2, 64, True, 100,
                                 "bfloat16"),
    "train_7b_d128": (1, 2048, 2048, 32, 32, 128, True, 0, "bfloat16"),
}
# the launch each path makes most: train and prefill on the tensor-core
# kernel, decode on the split-KV one; float32 (on neither path) on the
# CUDA-core one
HEADLINE_CASES = {"tcb": "train_1b_d64_gqa", "dec": "decode_7b_b8",
                  "simt": "fp32_d128_decode"}
LIBRARY_CASES = ("prefill_7b", "cached_prefill_7b", "decode_7b_b8",
                 "decode_7b_b1", "decode_1b_gqa_b8", "decode_7b_b1_s4096",
                 "decode_dead_and_first_chunk_d64", "fp32_d128_decode",
                 "train_1b_d64_gqa", "train_7b_d128")
# the crossover cases: bf16, d 128, s_k 1024, the rows at the end of the
# keys, one row below and at fwd_tiling's threshold
THRESHOLD_SHAPE = (8, 1024, 32, 32, 128)   # b, sk, hq, hkv, d
# plain versions that hold GBs of fp32 scores: timed eagerly (device-bound
# there), not captured five times into one CUDA graph
EAGER_PLAIN_CASES = ("train_1b_d64_gqa", "train_7b_d128")


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


def threshold_cases(tc_min_sq):
    """Cases one row below and at the fewest bf16 rows that take the
    tensor-core kernel (at THRESHOLD_SHAPE)."""
    b, sk, hq, hkv, d = THRESHOLD_SHAPE
    return {f"sq{sq}_{where}_threshold_d128":
            (b, sq, sk, hq, hkv, d, True, sk - sq, "bfloat16")
            for sq, where in ((tc_min_sq - 1, "below"), (tc_min_sq, "at"))
            if sq >= 1}


def kernel_phase(torch, flash):
    import torch.nn.functional as F

    results = {}
    g = torch.Generator(device=DEV).manual_seed(1234)
    tc_min_sq = flash.fwd_tiling(torch.bfloat16, 128, 1)["tc_min_sq"]
    cases = {**KERNEL_CASES, **threshold_cases(tc_min_sq)}
    for name, (b, sq, sk, hq, hkv, d, causal, off, dt) in cases.items():
        dtype = getattr(torch, dt)
        q = torch.randn((b, sq, hq, d), generator=g, device=DEV).to(dtype)
        k = torch.randn((b, sk, hkv, d), generator=g, device=DEV).to(dtype)
        v = torch.randn((b, sk, hkv, d), generator=g, device=DEV).to(dtype)
        if off is None:
            offs = torch.randint(sq, sk, (b,), generator=g, device=DEV,
                                 dtype=torch.int32)
        elif isinstance(off, list):
            offs = torch.tensor(off, dtype=torch.int32, device=DEV)
        else:
            offs = torch.full((b,), off, dtype=torch.int32, device=DEV)
        tiling = flash.fwd_tiling(dtype, d, sq, hq // hkv, b=b, hkv=hkv,
                                  sk=sk)
        before = dict(flash.flash_fwd.launches_by_kernel)
        o, lse = flash.flash_fwd(q, k, v, offs, causal=causal)
        # a second launch must give the same bits: each row is summed in a
        # fixed order (decode: the splits merged in split order)
        o2, lse2 = flash.flash_fwd(q, k, v, offs, causal=causal)
        ran = {kern: n - before[kern]
               for kern, n in flash.flash_fwd.launches_by_kernel.items()}
        ro, rlse = flash.flash_fwd_reference(q, k, v, offs, causal=causal)
        torch.cuda.synchronize()
        bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
        del o2, lse2
        atol, rtol, lse_tol = TOL[dt]
        err_o = float((o.float() - ro.float()).abs().max())
        excess = float(((o.float() - ro.float()).abs()
                        - (atol + rtol * ro.float().abs())).max())
        err_lse = float((lse - rlse).abs().max())
        ok = (excess <= 0 and err_lse <= lse_tol and bitwise
              and bool(torch.isfinite(o).all())
              and ran[tiling["kernel"]] == 2)
        split_err = None
        if tiling["kernel"] == "dec":
            # the plain version of the split arithmetic, same splits
            so, slse = flash.flash_decode_reference(
                q, k, v, offs, tiling["splits"], causal=causal)
            s_atol, s_rtol, s_lse_tol = SPLIT_TOL
            split_err = {"o": float((o.float() - so.float()).abs().max()),
                         "lse": float((lse - slse).abs().max())}
            ok = ok and float(((o.float() - so.float()).abs()
                               - (s_atol + s_rtol * so.float().abs())).max()
                              ) <= 0 and split_err["lse"] <= s_lse_tol
            del so, slse
        if causal:
            # rows that see no key: o = 0, lse = NEG_INF
            dead = offs[:, None] + torch.arange(sq, device=DEV)[None] < 0
            ok = ok and bool((o[dead] == 0).all()) and bool(
                (lse.transpose(1, 2)[dead] < -1e9).all())
        iters = 20
        kernel = lambda: flash.flash_fwd(q, k, v, offs, causal=causal)
        kernel_ms = device_ms(torch, kernel, iters)
        eager_ms = time_ms(torch, kernel, iters)
        plain = lambda: flash.flash_fwd_reference(q, k, v, offs,
                                                  causal=causal)
        plain_ms = (time_ms(torch, plain, 3, warmup=1)
                    if name in EAGER_PLAIN_CASES else
                    device_ms(torch, plain, 5))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = library_causal_ms = None
        if name in LIBRARY_CASES:
            pos = torch.arange(sq, device=DEV)[None, :] + offs[:, None]
            mask = (pos[:, None, :, None]
                    >= torch.arange(sk, device=DEV)[None, None, None, :])
            library_ms = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=hq != hkv), iters)
        if causal and off == 0 and sq == sk:
            # the plain causal square: SDPA's own causal kernels, the call
            # the backward's yardstick makes too
            library_causal_ms = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=hq != hkv), iters)
        flops, nbytes = work(torch, b, sq, sk, hq, hkv, d, causal, offs,
                             dtype)
        t_flops = flops / PEAK_FLOPS[dt] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "kernel", "kernel": "flash_fwd", "case": name,
               "shape": {"b": b, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv,
                         "d": d, "causal": causal,
                         "offsets": offs.tolist(), "dtype": dt},
               "fwd_kernel": tiling["kernel"], "tiling": tiling,
               "max_abs_err_o": err_o, "tol_o": {"atol": atol, "rtol": rtol},
               "max_abs_err_lse": err_lse, "tol_lse": lse_tol,
               "max_abs_err_vs_split_plain": split_err,
               "tol_vs_split_plain": SPLIT_TOL if split_err else None,
               "bitwise_repeat": bitwise,
               "ms": kernel_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_causal_ms": library_causal_ms,
               "tflops_per_s": flops / kernel_ms / 1e9,
               "bound_ms": max(t_flops, t_bytes),
               "bound_by": "operations" if t_flops > t_bytes else "bytes",
               "flops": flops, "bytes": nbytes, "passed": ok}
        emit(rec)
        results[name] = rec
        check(ok, f"flash_fwd {name}: o err {err_o} (tol {atol}+{rtol}|o|),"
                  f" lse err {err_lse} (tol {lse_tol}), bitwise {bitwise},"
                  f" vs split plain {split_err} (tol {SPLIT_TOL}),"
                  f" launched {ran}, want 2 on {tiling['kernel']}")
        del q, k, v, o, lse, ro, rlse, qt, kt, vt
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ phase 3

# name: (b, sq, sk, hq, hkv, d, causal, offset, dtype); a list offset gives
# each batch row its own position.
BWD_CASES = {
    "train_1b_d64_gqa": (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 4, 64, True,
                         0, "bfloat16"),
    "train_7b_d128": (1, 2048, 2048, 32, 32, 128, True, 0, "bfloat16"),
    "unaligned_s77_d64": (2, 77, 77, 4, 2, 64, True, 0, "bfloat16"),
    "noncausal_d128": (1, 200, 200, 8, 8, 128, False, 0, "bfloat16"),
    "debug_d16_gqa": (2, 96, 96, 4, 2, 16, True, 0, "bfloat16"),
    "offset40_d64": (2, 96, 96, 4, 2, 64, True, 40, "bfloat16"),
    "sq40_sk100_offset60_d64": (2, 40, 100, 8, 2, 64, True, 60, "bfloat16"),
    "masked_offset_-1000": (2, 96, 96, 4, 2, 16, True, -1000, "bfloat16"),
    "per_row_offsets_d64": (3, 64, 64, 8, 2, 64, True, [0, 17, -5],
                            "bfloat16"),
    # one past and one short of the bf16 kernels' 64-row tiles
    "s65_d64": (2, 65, 65, 4, 2, 64, True, 0, "bfloat16"),
    "s63_d64": (2, 63, 63, 4, 2, 64, True, 0, "bfloat16"),
    "s129_d128": (1, 129, 129, 4, 2, 128, True, 0, "bfloat16"),
    "s127_d16": (2, 127, 127, 4, 2, 16, True, 0, "bfloat16"),
    "sq20_d64": (2, 20, 20, 4, 2, 64, True, 0, "bfloat16"),
    # the diagonal of every row cuts key tile 2 of [128, 192)
    "sq40_sk300_offset100_d64": (2, 40, 300, 8, 2, 64, True, 100,
                                 "bfloat16"),
    "gqa8_d128": (1, 130, 130, 8, 1, 128, True, 0, "bfloat16"),
    "per_row_offsets_d128": (3, 100, 100, 8, 2, 128, True, [-30, 5, 64],
                             "bfloat16"),
    "train_1b_cut_b1_s512": (1, 512, 512, 32, 4, 64, True, 0, "bfloat16"),
    "fp32_d16": (2, 96, 96, 4, 2, 16, True, 0, "float32"),
    "fp32_d128": (1, 130, 130, 4, 2, 128, True, 0, "float32"),
}
BWD_HEADLINE_CASE = "train_1b_d64_gqa"   # the shape the train path gives
BWD_LIBRARY_CASES = ("train_1b_d64_gqa", "train_7b_d128")


def bwd_work(torch, b, sq, sk, hq, hkv, d, causal, offs, dtype):
    """(pairs, bytes) of the backward on this run's inputs: visible (query,
    key) pairs over all q heads, and the bytes of each input read once and
    each output written once, per kernel and for the whole backward."""
    es = torch.finfo(dtype).bits // 8
    if causal:
        rows = torch.arange(sq, device=offs.device)[None, :] + offs[:, None]
        vis = (rows + 1).clamp(min=0, max=sk)
    else:
        vis = torch.full((b, sq), sk, device=offs.device)
    pairs = int(vis.sum()) * hq
    keys = int(vis.amax(dim=1).sum())          # keys some row sees
    qrow = b * sq * hq * d * es                # q, o, do, dq: one each
    kv = keys * hkv * d * es                   # k or v as read
    kv_out = b * sk * hkv * d * es             # dk or dv as written
    row_f32 = b * hq * sq * 4                  # lse, delta
    return pairs, {
        "dq": 3 * qrow + 2 * kv + row_f32 + qrow + row_f32,
        "dkv": 2 * qrow + 2 * kv + 2 * row_f32 + 2 * kv_out,
        "bwd": 3 * qrow + 2 * kv + row_f32 + qrow + 2 * kv_out,
    }


def dkv_tail(b, sq, sk, hq, hkv, causal, offs, tiling, sms):
    """The dkv grid's scheduling tail, modelled: each block's work in
    streamed query tiles (its GQA group times the tiles from the first
    query that sees its keys), blocks taken in launch order by the first
    of (SMs x blocks per SM) slots to come free. Tail share = 1 - mean
    slot load / the last slot's finish."""
    import heapq

    rows, tile = tiling["block_rows"], tiling["stream_tile"]
    slots = [0] * (sms * tiling["blocks_per_sm"])
    work = []
    for kt in range((sk + rows - 1) // rows):       # grid.y, slowest
        for bi in range(b):                         # grid.x: batch * kv head
            start = max(0, kt * rows - int(offs[bi])) if causal else 0
            work += [hq // hkv * -(-max(sq - start, 0) // tile)] * hkv
    for w in work:
        heapq.heappush(slots, heapq.heappop(slots) + w)
    makespan = max(slots)
    mean = sum(work) / len(slots)
    return {"blocks": len(work), "slots": len(slots),
            "makespan_tiles": makespan, "mean_slot_tiles": mean,
            "tail_share": 1 - mean / makespan if makespan else 0.0}


def bwd_kernel_phase(torch, flash):
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    results = {}
    tilings = {}
    g = torch.Generator(device=DEV).manual_seed(4321)
    for name, (b, sq, sk, hq, hkv, d, causal, off, dt) in BWD_CASES.items():
        dtype = getattr(torch, dt)
        rnd = lambda *shape: torch.randn(shape, generator=g,
                                         device=DEV).to(dtype)
        q, k, v = rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
        do = rnd(b, sq, hq, d)
        offs = (torch.tensor(off, dtype=torch.int32, device=DEV)
                if isinstance(off, list) else
                torch.full((b,), off, dtype=torch.int32, device=DEV))
        kw = dict(causal=causal)
        o, lse = flash.flash_fwd(q, k, v, offs, **kw)
        dq, delta = flash.flash_dq(q, k, v, o, lse, do, offs, **kw)
        dk, dv = flash.flash_dkv(q, k, v, lse, delta, do, offs, **kw)
        rdq, rdelta = flash.flash_dq_reference(q, k, v, o, lse, do, offs,
                                               **kw)
        rdk, rdv = flash.flash_dkv_reference(q, k, v, lse, rdelta, do, offs,
                                             **kw)
        # a second launch must give the same bits: every output element is
        # summed by one block in a fixed order
        dq2, delta2 = flash.flash_dq(q, k, v, o, lse, do, offs, **kw)
        dk2, dv2 = flash.flash_dkv(q, k, v, lse, delta2, do, offs, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(x, y) for x, y in (
            (dq, dq2), (dk, dk2), (dv, dv2), (delta, delta2)))
        del dq2, dk2, dv2, delta2
        check(bitwise or name != BWD_HEADLINE_CASE,
              f"flash backward {name}: two launches differ")
        if (dtype, d) not in tilings:
            tilings[dtype, d] = flash.bwd_tiling(dtype, d)
        tiling = tilings[dtype, d]
        rel = {}
        for gname, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                                 ("dv", dv, rdv)):
            scale = float(want.float().abs().max())
            diff = float((got.float() - want.float()).abs().max())
            rel[gname] = diff / scale if scale else diff
        err_delta = float((delta - rdelta).abs().max())
        tol = BWD_REL_TOL[dt]
        ok = (all(r <= tol for r in rel.values()) and bitwise
              and all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)))
        if off == -1000:
            ok = ok and all(bool((x == 0).all()) for x in (dq, dk, dv))
        big = name in EAGER_PLAIN_CASES
        iters = 10 if big else 20
        run_dq = lambda: flash.flash_dq(q, k, v, o, lse, do, offs, **kw)
        run_dkv = lambda: flash.flash_dkv(q, k, v, lse, delta, do, offs, **kw)
        ms = {"dq": device_ms(torch, run_dq, iters),
              "dkv": device_ms(torch, run_dkv, iters)}
        eager_ms = {"dq": time_ms(torch, run_dq, iters),
                    "dkv": time_ms(torch, run_dkv, iters)}
        plain_dq = lambda: flash.flash_dq_reference(q, k, v, o, lse, do,
                                                    offs, **kw)
        plain_dkv = lambda: flash.flash_dkv_reference(q, k, v, lse, rdelta,
                                                      do, offs, **kw)
        timer = ((lambda fn: time_ms(torch, fn, 3, warmup=1)) if big else
                 (lambda fn: device_ms(torch, fn, 5)))
        plain_ms = {"dq": timer(plain_dq), "dkv": timer(plain_dkv)}
        library_ms = library_eager_ms = None
        if name in BWD_LIBRARY_CASES:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=hq != hkv)
            dot = do.transpose(1, 2)
            lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                              retain_graph=True)
            library_eager_ms = time_ms(torch, lib, iters)
            # autograd's backward does not capture into a graph from here:
            # its device time is the sum of the kernels it launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    lib()
                torch.cuda.synchronize()
            library_ms = sum(device_kernel_ms(torch, prof,
                                              iters).values()) or None
            del qt, kt, vt, out
        pairs, nbytes = bwd_work(torch, b, sq, sk, hq, hkv, d, causal, offs,
                                 dtype)
        bounds = {}
        for part, per_pair in (("dq", 6), ("dkv", 8), ("bwd", 10)):
            t_flops = per_pair * d * pairs / PEAK_FLOPS[dt] * 1e3
            t_bytes = nbytes[part] / HBM_BYTES_PER_S * 1e3
            bounds[part] = {"bound_ms": max(t_flops, t_bytes),
                            "bound_by": ("operations" if t_flops > t_bytes
                                         else "bytes"),
                            "flops": per_pair * d * pairs,
                            "bytes": nbytes[part]}
        rec = {"phase": "bwd_kernel", "case": name,
               "shape": {"b": b, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv,
                         "d": d, "causal": causal,
                         "offsets": offs.tolist(), "dtype": dt},
               "rel_err": rel, "rel_tol": tol,
               "max_abs_err_delta": err_delta,
               "bitwise_repeat": bitwise, "tiling": tiling,
               "dkv_schedule": dkv_tail(
                   b, sq, sk, hq, hkv, causal, offs.tolist(), tiling["dkv"],
                   torch.cuda.get_device_properties(0).multi_processor_count),
               "max_abs_err": max(float((x.float() - y.float()).abs().max())
                                  for x, y in ((dq, rdq), (dk, rdk),
                                               (dv, rdv))),
               "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
               "plain_timer": "eager" if big else "graph",
               "library_ms": library_ms, "library_eager_ms": library_eager_ms,
               "library": "SDPA backward (dq, dk, dv), kernel device time"
               if library_ms is not None else None,
               "bound": bounds, "pairs": pairs,
               "kernel_flops": 14 * d * pairs,
               "tflops_per_s": {"dq": 6 * d * pairs / ms["dq"] / 1e9,
                                "dkv": 8 * d * pairs / ms["dkv"] / 1e9},
               "passed": ok}
        emit(rec)
        results[name] = rec
        check(ok, f"flash backward {name}: rel err {rel} (tol {tol})")
        del q, k, v, do, o, lse, dq, dk, dv, rdq, rdk, rdv, delta, rdelta
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ phase 4

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


# ------------------------------------------------------------ phase 5

def grad_check_phase(torch, tllama, tts):
    """The 1b config cut to 2 layers, fp32 masters, bf16 compute: lm_loss
    and every gradient through the flash kernels against plain-PyTorch
    attention, on the train phase's batch shape."""
    base = dataclasses.replace(tllama.PRESETS["1b"], n_layers=2)
    gen = torch.Generator(device=DEV).manual_seed(11)
    params = tllama.init_params(base, generator=gen, device=DEV,
                                dtype=torch.float32)
    tokens = torch.randint(0, base.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           device=DEV, generator=gen)
    leaves = tts._leaves(params)
    out = {}
    for impl in ("flash", "xla"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        for t in leaves.values():
            t.requires_grad_(True)
        loss = tllama.lm_loss(params, {"tokens": tokens}, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for t in leaves.values():
            t.requires_grad_(False)
        out[impl] = (float(loss), dict(zip(leaves, grads)))
    torch.cuda.synchronize()
    rel = {}
    for name, ref in out["xla"][1].items():
        got = out["flash"][1][name]
        rel[name] = float((got - ref).abs().max() / ref.abs().max())
    finite = all(bool(torch.isfinite(gr).all())
                 for gr in out["flash"][1].values())
    worst = max(rel.values())
    emit({"phase": "grad_check", "config": "1b, n_layers=2, fp32 params, "
                                           "bf16 compute",
          "tokens": list(tokens.shape), "loss_flash": out["flash"][0],
          "loss_xla": out["xla"][0], "rel_diff_by_leaf": rel,
          "rel_tol": GRAD_REL_TOL, "finite": finite})
    check(finite and worst <= GRAD_REL_TOL,
          f"2-layer 1b grads: flash vs plain rel diff {worst} > "
          f"{GRAD_REL_TOL}")
    del params, out
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 6

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

    zero_launches(flash)
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
    launches = read_launches(flash)
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
    check(launches["flash_fwd"] >= want_launches and want_launches > 0,
          f"flash_fwd launched {launches['flash_fwd']} times, the path made "
          f"{want_launches} attention calls")
    # prefills of at least tc_min_sq rows take the tensor-core kernel, the
    # decode steps (one row) the split-KV decode kernel; none the
    # float32 CUDA-core one
    group = cfg.n_heads // cfg.n_kv_heads
    tc_min_sq = flash.fwd_tiling(torch.bfloat16, cfg.head_dim, 1,
                                 group)["tc_min_sq"]
    want_by_kernel = {
        "tcb": cfg.n_layers * sum(s >= tc_min_sq for s in SERVE_PROMPT_LENS),
        "dec": cfg.n_layers * (stats["decode_steps"] + sum(
            s < tc_min_sq for s in SERVE_PROMPT_LENS))}
    for kern, want in want_by_kernel.items():
        got = launches[f"flash_fwd_{kern}"]
        check(got >= want and got > 0,
              f"the {kern} forward kernel launched {got} times, the path "
              f"made {want} calls of its shapes")
    check(launches["flash_fwd_simt"] == 0,
          f"the float32 forward kernel ran in bf16 serving: {launches}")

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
          "launches": launches,
          "attention_calls_expected": want_launches,
          "fwd_launches_expected_by_kernel": want_by_kernel,
          "fwd_tc_min_sq": tc_min_sq,
          "first_token_match": f"{first_match}/{len(prompts)}",
          "token_match_rate_vs_generate": seq_match / total})
    check(first_match == len(prompts),
          f"first tokens match generate for {first_match}/{len(prompts)}")
    step_breakdown(torch, params, cfg, prompts, flash)
    del params
    torch.cuda.empty_cache()
    return launches


def step_breakdown(torch, params, cfg, prompts, flash):
    """Where a serving step's time goes, after the counted run: each
    prompt's batch-1 prefill and a full-engine decode tick (8 rows, k=8)
    on the host clock, then one profiled tick for the device's busy time
    by kernel (torch.profiler). Idle share = 1 - busy / unprofiled wall.
    Every attention call of the profiled tick must launch the split-KV
    decode kernel, and the forward's device time must all be its."""
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
    fwd0 = dict(flash.flash_fwd.launches_by_kernel)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b.step_many(k)
        torch.cuda.synchronize()
    fwd_launches = {kern: n - fwd0[kern] for kern, n in
                    flash.flash_fwd.launches_by_kernel.items()}
    per_kernel = device_kernel_ms(torch, prof, k)
    busy = sum(per_kernel.values())
    flash_ms = fwd_ms_by_kernel(per_kernel)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "step_breakdown", "config": "7b, 32 layers, bf16",
          "prefill_ms_by_prompt_len": prefill_ms,
          "decode_rows": 8, "decode_step_ms": step_ms,
          "decode_tok_per_s_8_rows": 8 * 1e3 / step_ms,
          "device_busy_ms_per_step": busy if busy else "not measured",
          "device_idle_share": 1 - busy / step_ms if busy else
          "not measured",
          "flash_fwd_ms_per_step": sum(flash_ms.values()),
          "flash_fwd_ms_per_step_by_kernel": flash_ms,
          "flash_fwd_launches_by_kernel": fwd_launches,
          "top_kernels_ms_per_step": [[n[:80], t] for n, t in top]})
    want = dict.fromkeys(fwd_launches, 0)
    want["dec"] = k * cfg.n_layers
    check(fwd_launches == want and (not busy or (
        flash_ms["dec"] > 0 and flash_ms["dec"] == sum(flash_ms.values()))),
          f"decode tick: forward launches {fwd_launches} (want {want}), "
          f"device ms by kernel {flash_ms}")


# ------------------------------------------------------------ phase 7

LAUNCH_COUNTERS = ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd")


def zero_launches(flash):
    for name in LAUNCH_COUNTERS:
        getattr(flash, name).launches = 0
    counts = flash.flash_fwd.launches_by_kernel
    for kern in counts:
        counts[kern] = 0


def read_launches(flash):
    """Each wrapper's count, and the forward's split by kernel as
    ``flash_fwd_tcb``, ``flash_fwd_dec`` and ``flash_fwd_simt``."""
    out = {name: getattr(flash, name).launches for name in LAUNCH_COUNTERS}
    out.update({f"flash_fwd_{kern}": n for kern, n in
                flash.flash_fwd.launches_by_kernel.items()})
    return out


def fwd_ms_by_kernel(per_kernel):
    """Device ms of the forward by kernel namespace, from profiler names
    such as ``void (anonymous namespace)::tcb::flash_fwd_kernel<64>(...)``;
    dec's includes its merge, ``dec::flash_fwd_combine_kernel``."""
    return {kern: sum(t for n, t in per_kernel.items()
                      if f"{kern}::flash_fwd_" in n)
            for kern in ("tcb", "dec", "simt")}


def nvidia_smi_clocks():
    """SM clock, its maximum, power draw and temperature, as nvidia-smi
    reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def device_kernel_ms(torch, prof, per):
    """Device time by kernel name, divided by ``per``: device-side events
    only, since a CPU op's self device time repeats the kernels it
    launched."""
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.self_device_time_total / 1e3 / per
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0}


def train_phase(torch, np, tllama, tts, tflops, flash):
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(tllama.PRESETS["1b"], attn_impl="flash")
    opt = tts.default_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params, state = tts.init_state(cfg, opt, generator=gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": tokens}
    step = tts.make_train_step(cfg, opt, device=DEV)
    torch.cuda.reset_peak_memory_stats()

    alloc_keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    alloc_now = lambda: [torch.cuda.memory_stats().get(k, 0)
                         for k in alloc_keys]
    # the garbage collector's work in each step: gc.get_count() deltas and
    # the collections it ran, by generation
    gc_now = lambda: (list(gc.get_count()),
                      [s["collections"] for s in gc.get_stats()])
    clocks_before = nvidia_smi_clocks()
    zero_launches(flash)
    losses, norms, step_ms, events, allocs = [], [], [], [], []
    gc_counts, gc_collections = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        a0, (c0, n0) = alloc_now(), gc_now()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        params, state, m = step(params, state, batch)
        ev[1].record()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        events.append(ev)
        allocs.append([b - a for a, b in zip(a0, alloc_now())])
        c1, n1 = gc_now()
        gc_counts.append([b - a for a, b in zip(c0, c1)])
        gc_collections.append([b - a for a, b in zip(n0, n1)])
    launches = read_launches(flash)
    clocks_after = nvidia_smi_clocks()
    # first event to last on the device's clock: device work plus the gaps
    # where it waited for the host
    step_device_ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated()

    fwd0 = dict(flash.flash_fwd.launches_by_kernel)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    fwd_launches = {kern: n - fwd0[kern] for kern, n in
                    flash.flash_fwd.launches_by_kernel.items()}
    per_kernel = device_kernel_ms(torch, prof, 1)
    busy = sum(per_kernel.values())
    flash_ms = {kind: sum(t for n, t in per_kernel.items() if kind in n)
                for kind in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                             "flash_bwd_dkv_kernel")}
    fwd_ms = fwd_ms_by_kernel(per_kernel)
    gemm_ms = sum(t for n, t in per_kernel.items()
                  if "gemm" in n.lower() or "nvjet" in n.lower())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]

    steady = step_ms[2:]
    med_ms = float(np.median(steady))
    tokens_per_step, seq = tts._batch_tokens(batch)
    step_flops = tokens_per_step * tflops.train_flops_per_token(cfg, seq)
    emit({"phase": "train", "config": "1b, 22 layers, fp32 params, bf16 "
                                      "compute, attn flash, remat",
          "optimizer": dataclasses.asdict(opt),
          "batch": [TRAIN_BATCH, TRAIN_SEQ + 1],
          "init_state_s": init_s, "losses": losses, "grad_norms": norms,
          "step_ms": step_ms, "step_event_ms": step_device_ms,
          "step_allocator": {k: [a[i] for a in allocs]
                             for i, k in enumerate(alloc_keys)},
          "step_gc_count_delta": gc_counts,
          "step_gc_collections": gc_collections,
          "nvidia_smi_clocks": {
              "query": "clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
              "before_loop": clocks_before, "after_loop": clocks_after},
          "median_step_ms_steps_3_to_8": med_ms,
          "tokens_per_s": tokens_per_step * 1e3 / med_ms,
          "step_flops": step_flops,
          "mfu": tflops.mfu(step_flops, med_ms / 1e3),
          "mfu_peak": "989e12 bf16 dense (H100 SXM)",
          "peak_mem_bytes": peak, "launches": launches,
          "profiled_step": {
              "device_busy_ms": busy if busy else "not measured",
              "device_idle_share": 1 - busy / med_ms if busy else
              "not measured",
              "flash_ms": flash_ms,
              "flash_fwd_ms_by_kernel": fwd_ms,
              "flash_fwd_launches_by_kernel": fwd_launches,
              "flash_share_of_busy": (sum(flash_ms.values()) / busy
                                      if busy else "not measured"),
              "gemm_ms": gemm_ms,
              "top_kernels_ms": [[n[:80], t] for n, t in top]}})
    n_layers = cfg.n_layers
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(abs(losses[0] - np.log(cfg.vocab_size)) <= FIRST_LOSS_MARGIN,
          f"first loss {losses[0]} not within {FIRST_LOSS_MARGIN} of "
          f"ln {cfg.vocab_size}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name, per_step in (("flash_fwd", 2 * n_layers),
                           ("flash_fwd_tcb", 2 * n_layers),
                           ("flash_dq", n_layers), ("flash_dkv", n_layers),
                           ("flash_bwd", n_layers)):
        check(launches[name] >= per_step * TRAIN_STEPS,
              f"{name} launched {launches[name]} times in {TRAIN_STEPS} "
              f"steps, want >= {per_step} a step")
    # the forward's device time is all the tensor-core kernel's
    check(launches["flash_fwd_simt"] == launches["flash_fwd_dec"] == 0
          and fwd_launches == {"tcb": 2 * n_layers, "simt": 0, "dec": 0}
          and (not busy or (fwd_ms["tcb"] > 0 and fwd_ms["simt"] == 0
                            and fwd_ms["dec"] == 0)),
          f"a forward kernel other than tcb ran in training: launches "
          f"{launches}, profiled step {fwd_launches}, device ms {fwd_ms}")
    del params, state
    torch.cuda.empty_cache()
    return launches


PHASES = ("kernel", "bwd", "integration", "grad", "serve", "train")


def kernel_entry(name, source, replaces, launches, head, part=None,
                 counter=None):
    """One entry of the ``kernels`` line from a headline case record; its
    launches are the paths' counts under ``counter`` (default ``name``)."""
    pick = (lambda key: head[key]) if part is None else \
        (lambda key: head[key][part])
    bound = head["bound"][part] if part else head
    counter = counter or name
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[counter] for c in launches.values()),
            "launches_by_path": {path: c[counter]
                                 for path, c in launches.items()},
            "max_abs_err": head["max_abs_err_o"] if part is None else
            head["max_abs_err"],
            "ms": pick("ms"), "plain_ms": pick("plain_ms"),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": head["library_ms"]}


def main(argv=None) -> int:
    global JSONL
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jsonl", type=Path, default=None,
                    help="also append every phase line to this file")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(PHASES)
                    + "; prints no kernels line and no result line")
    args = ap.parse_args(argv)
    JSONL = args.jsonl
    only = set(PHASES if args.only is None else args.only.split(","))
    if only - set(PHASES):
        ap.error(f"unknown phases {sorted(only - set(PHASES))}")
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
        from ray_tpu_torch.parallel import train_step as tts
        from ray_tpu_torch.util import flops as tflops
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
    ptxas = {n: _build.ptxas_summary(log)
             for n, log in _build.build_log.items()}
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "build_s": build_s, "build_wall_s": time.perf_counter() - t0,
          "ptxas": ptxas})
    spills = {k: v for lib in ptxas.values() for k, v in lib.items()
              if v["spill_bytes"]}
    check(not spills, f"ptxas spills registers in {spills}")

    cases = kernel_phase(torch, flash) if "kernel" in only else None
    bwd_cases = bwd_kernel_phase(torch, flash) if "bwd" in only else None
    if "integration" in only:
        integration_phase(torch, tllama)
    if "grad" in only:
        grad_check_phase(torch, tllama, tts)
    launches = {}
    if "serve" in only:
        launches["serve"] = serve_phase(torch, np, tllama, TG,
                                        ContinuousEngine, flash)
    if "train" in only:
        launches["train"] = train_phase(torch, np, tllama, tts, tflops,
                                        flash)
    if args.only is not None:
        print(json.dumps({"partial_run": sorted(only)}), flush=True)
        return 0

    # the forward's three kernels, one entry each, all behind the flash_fwd
    # wrapper: flash_fwd is the tensor-core kernel (train, prefill),
    # flash_fwd_decode the split-KV one (decode), flash_fwd_simt the
    # CUDA-core one (float32, on neither path)
    entries = []
    for name, kern in (("flash_fwd", "tcb"), ("flash_fwd_decode", "dec"),
                       ("flash_fwd_simt", "simt")):
        head = cases[HEADLINE_CASES[kern]]
        e = kernel_entry(name, "ray_tpu_torch/csrc/flash_fwd.cu",
                         "ray_tpu/ops/pallas/flash.py:41", launches, head,
                         counter=f"flash_fwd_{kern}")
        e.update({"kernel": f"{kern}::flash_fwd_kernel",
                  "wrapper": "ray_tpu_torch/ops/flash.py:flash_fwd",
                  "headline_case": HEADLINE_CASES[kern],
                  "tiling": head["tiling"],
                  "on_main_path": kern != "simt",
                  "library_causal_ms": head["library_causal_ms"],
                  "passed": all(c["passed"] for c in cases.values()
                                if c["fwd_kernel"] == kern),
                  "cases": {n: {key: c[key] for key in (
                      "ms", "eager_ms", "plain_ms", "library_ms",
                      "library_causal_ms", "bound_ms", "bound_by",
                      "max_abs_err_o", "max_abs_err_lse",
                      "max_abs_err_vs_split_plain", "bitwise_repeat")}
                      for n, c in cases.items() if c["fwd_kernel"] == kern}})
        entries.append(e)
    bhead = bwd_cases[BWD_HEADLINE_CASE]
    for name, part, line in (("flash_dq", "dq", 138), ("flash_dkv", "dkv", 174)):
        e = kernel_entry(name, "ray_tpu_torch/csrc/flash_bwd.cu",
                         f"ray_tpu/ops/pallas/flash.py:{line}", launches,
                         bhead, part)
        e.update({"headline_case": BWD_HEADLINE_CASE,
                  "tiling": bhead["tiling"][part],
                  "library_scope": "SDPA backward: dq, dk and dv together",
                  "passed": all(c["passed"] for c in bwd_cases.values()),
                  "cases": {n: {"ms": c["ms"][part],
                                "eager_ms": c["eager_ms"][part],
                                "plain_ms": c["plain_ms"][part],
                                "bound_ms": c["bound"][part]["bound_ms"],
                                "bound_by": c["bound"][part]["bound_by"],
                                "library_ms": c["library_ms"],
                                "rel_err": c["rel_err"],
                                "bitwise_repeat": c["bitwise_repeat"]}
                            for n, c in bwd_cases.items()}})
        entries.append(e)
    for e in entries:
        check(e["launches"] > 0 or not e.get("on_main_path", True),
              f"{e['name']} never launched on the path")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
