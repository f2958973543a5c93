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
   train step, 7b's d 128 at s 2048, speculative decode's 5-row verify at
   7b, the 8x410m MoE preset's decode, prefill and train step, the RLHF
   update's 255-row forward at 1b) and at
   small cases (head_dim 16 and
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
   at 8x410m's (16/16 heads of 64), at the RLHF update's (b 8, s 255,
   32/4 heads of 64), at 7b's d 128 and at small cases cut at the edges of their tiles, with
   torch SDPA's backward as the yardstick at the training shapes, two
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
   launch only the decode kernel); then, with the same params, the kv
   sub-phase: sampling engines (rows 4-7 at temperature 0.8, top-k 50),
   a primer request that seeds a 4 GiB prefix KV cache with a 256-token
   shared prefix, 8 prompts (that prefix + suffixes of 64 to 250 tokens)
   through an engine with the cache off, then warm through the kv engine
   (every admission must restore 256 tokens; greedy first tokens must
   equal the cold ones wherever the cold top-2 margin exceeds
   ``WARM_MARGIN_REL_TOL``), a sampled request alone twice with one seed
   (same tokens), and a ``load_params`` of a cloned param set mid-wave
   (in-flight streams finish, one swap, every resident page invalidated,
   the next shared-prefix admission cold); its launches are counted as a
   path of their own up to there (every admission one tensor-core launch
   a layer, exactly); then, outside the count, a bare batcher on the same
   cache (restored rows equal the pages bit for bit; a restore and a
   capture timed); TTFT warm and cold, restore and prefill seconds, host
   page bytes and the recorder's summary are reported;
7. the serving front end (``llm``): ``ContinuousLLM("7b")`` (8 slots,
   max_len 1024, stride 8, other arguments at their defaults) and its
   ``StaticLLM`` control (8 rows, prompts padded to 512, 32 new tokens),
   each driven by ``poisson_load`` at 4 requests/s for 40 s (seed 0, 16
   in flight) with prompts of the serve lengths and 32 new tokens, through
   ``__call__`` on an asyncio loop thread; no request may fail, each
   stream has 32 in-vocab tokens and its first equals batch-1
   ``generate``, launches exactly as the admissions, decode steps and
   batches give; rps, tok/s, latency and TTFT p50/p99, shed, peak memory
   and the prefix-cache captures' copy time for both;
8. speculative decode (``spec``): the 7b target with itself and with the
   1b preset as the draft (k 4; b 1, and b 4 for the 1b draft; 256-token
   prompts, 64 new): rounds, acceptance, ms a token against plain
   ``generate`` at the same b; every emitted token of every row equals
   the argmax of one teacher-forced target forward over the prompt and
   the run's own output wherever that forward's top-2 margin is at least
   ``WARM_MARGIN_REL_TOL``, and the launches exactly as the rounds give;
9. the MoE family (``moe``): the ``8x410m`` preset at full width and 24
   layers, greedy ``generate`` at b 4 (256-token prompts, 32 new) and a
   ``ContinuousEngine`` answering 8 staggered requests; first tokens
   against the drop-free full forward (margin rule) and batch-1
   ``generate`` (exact); prefill and decode-step times, device busy
   against host wall for a profiled 8-row tick, the MoE FFN's share and
   the decode weight-read bound;
10. training: the 1b preset at full width and 22 layers, fp32 master
   params from a seeded generator, bf16 compute, flash attention, remat,
   8 AdamW steps on a fixed [4, 2049] token batch; finite and falling loss,
   tokens/s, MFU, peak memory, per-step garbage-collector counts, SM clocks
   before and after, and a profiled step whose forward time must all be
   the tensor-core kernel's;
11. the training fast path (``driver``) at 1b, 22 layers: a seeded numpy
   token stream of 10 batches [4, 2049] through ``iter_device_batches``
   (stack 4, prefetch 2) into ``StepDriver(steps_per_launch=4)`` with the
   step profiler and the train recorder on (2 fused launches and a tail
   of 2 single steps) and an async ``save_pytree`` of (params,
   opt_state) after the first launch; the same init and batches through
   a plain loop of ``make_train_step``; a second run of 4 batches; the
   checkpoint loaded and the last 6 batches run through a fresh driver.
   Losses and params equal the plain loop's, and the resumed run's the
   uninterrupted run's, within ``DRIVER_REL_TOL``; steps, launches and
   ``compile_count``; each leg's launches exactly 2L tensor-core
   forwards, L dq and L dkv a step; the recorder's device-done stamps
   against CUDA events; step ms, tokens/s and MFU against the plain loop,
   the recorder's phases and waterfall, the feed's verdict, the
   profiler's summary, the checkpoint's times and rates, peak memory;
12. MoE training (``moe_train``): the ``8x410m`` preset at full width and
   24 layers, its 2-layer gradients against plain attention, then a
   ``StepDriver(steps_per_launch=4)`` over 8 seeded batches [4, 2049]:
   finite and falling loss, the first near ln 32000 plus the router's aux
   term, launches exactly 48/24/24 a step; step ms, tokens/s, MFU on
   active params, a profiled step's idle share and the MoE FFN's and
   AdamW's shares, peak memory;
13. RLHF (``rlhf``): ``RLHFPipeline`` on the 1b preset at full width and
   22 layers (fp32 masters, bf16 compute, flash, remat; the generator's
   engine in bf16, 8 slots, stride 8), 8 prompts of 128 tokens, 128 new,
   2 epochs, 3 iterations; iteration 1's KL exactly 0 and iteration 2's
   not, the reference's params bit-unchanged, every sync's version
   decoded by the next generate (staleness 0), the generator's greedy
   continuation of a prompt after the last sync equal to batch-1
   ``generate`` on the learner's params cast to bf16 for 8 tokens, finite
   losses, and each role phase's launches exactly as its work gives
   (``rlhf_expected_launches``); per-phase seconds, tok/s, update
   tokens/s and MFU, sync bytes and seconds, the recorder's bubble and
   coverage, peak memory;
14. the fused PPO iteration (``anakin``): ``AnakinConfig()`` (64 envs x
   32 steps), 50 iterations; ``compile_count()`` 1, finite metrics, the
   same operator count in each of 5 iterations (``op_counter``), no
   flash launch; device kernels of 5 profiled iterations, env-steps/s and
   episodes over the first and last 10;
15. ViT (``vit``): ``b16`` at 224 px, batch 64, fp32 masters, bf16
   compute, remat, 10 constant-Adam steps at 1e-3 on the toy task of
   ``tests/test_model_vit.py``; the loss falls, no flash launch; step ms
   on CUDA events, images/s, MFU, peak memory;
16. multi-GPU placement on one card (``mesh``): NCCL with world 1 through
   a ``file://`` store, ``auto_mesh(1)``, ``init_sharded_state`` of the
   1b preset at full width and depth (every leaf a DTensor with the
   rules' placements), 8 steps of ``make_train_step(mesh=...)`` on the
   train phase's batch against 8 plain steps from a copy of the same
   params (loss and grad_norm within ``MESH_REL_TOL`` a step, the first
   near ln 32000), 4 more through ``StepDriver(mesh=...,
   steps_per_launch=4)`` against the same plain loop, launches exactly
   2L/L/L a step, a sharded checkpoint of the state round-tripped
   bit-equal, each op of the collective group API once on a one-member
   NCCL group, and the process group torn down; mesh and plain step ms
   (the DTensor host cost), the device busy share, peak memory and MFU;
17. a ``kernels`` line, and last ``{"ok": true, "device": {...}}``.

Each path (serve, serve_kv, llm, spec, moe, train, driver, moe_train,
rlhf, mesh)
zeroes every kernel's launch count
just before it runs and reads them just after; a kernel of the paths that
was not launched fails the run (the float32 CUDA-core forward is on no
path: its entry reports its launches, 0, and its cases).

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
import queue
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
# the kv sub-phase: a shared prefix of 16 chunks of 16 tokens (a power of
# two, so a warm lookup restores all of it), 8 distinct suffixes, a primer
# request whose capture seeds the cache, rows 4-7 sampled
SERVE_KV_PREFIX = 256
SERVE_KV_SUFFIX_LENS = (64, 250, 127, 190, 97, 222, 160, 80)
SERVE_KV_PRIMER_SUFFIX = 100
SERVE_KV_SAMPLED = {"temperature": 0.8, "top_k": 50}
SERVE_KV_BYTES = 4 << 30
SERVE_KV_SWAP_LENS = (300, 200, 350)   # the swap wave's fresh prompts
# warm against cold first tokens (greedy rows): a warm prefill runs the
# suffix's rows alone over restored pages, a cold one all rows, so their
# GEMMs differ in M and bf16 sums may round apart by a few ulps through
# the 32 layers. A token must agree wherever the cold top-2 logit margin
# exceeds this share of the row's largest |logit| (LOGIT_REL_TOL's share,
# which bounds flash against plain logits through two layers).
WARM_MARGIN_REL_TOL = 2e-2


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
    # speculative decode's verify: the target's current token and 4
    # drafts, 5 rows at an offset over a 1,024-key cache
    "verify_7b_k4": (1, 5, 1024, 32, 32, 128, True, 700, "bfloat16"),
    # the 8x410m MoE preset: 16/16 heads of 64, engine decode and prefill
    "decode_8x410m_b8": (8, 1, 1024, 16, 16, 64, True, None, "bfloat16"),
    "prefill_8x410m": (1, 512, 512, 16, 16, 64, True, 0, "bfloat16"),
    # the 8x410m MoE preset's train step: 16/16 heads of 64 at s 2048
    "train_8x410m": (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 64, True, 0,
                     "bfloat16"),
    # the RLHF update's forward at 1b: 8 sequences of 128 + 128 tokens,
    # the last one dropped (255 = 128 + 128 - 1 rows: a ragged tile)
    "rlhf_1b_s255": (8, 255, 255, 32, 4, 64, True, 0, "bfloat16"),
}
# the launch each path makes most: train and prefill on the tensor-core
# kernel, decode on the split-KV one; float32 (on neither path) on the
# CUDA-core one
HEADLINE_CASES = {"tcb": "train_1b_d64_gqa", "dec": "decode_7b_b8",
                  "simt": "fp32_d128_decode"}
LIBRARY_CASES = ("prefill_7b", "cached_prefill_7b", "decode_7b_b8",
                 "decode_7b_b1", "decode_1b_gqa_b8", "decode_7b_b1_s4096",
                 "decode_dead_and_first_chunk_d64", "fp32_d128_decode",
                 "train_1b_d64_gqa", "train_7b_d128", "verify_7b_k4",
                 "decode_8x410m_b8", "prefill_8x410m", "train_8x410m",
                 "rlhf_1b_s255")
# the crossover cases: bf16, d 128, s_k 1024, the rows at the end of the
# keys, one row below and at fwd_tiling's threshold
THRESHOLD_SHAPE = (8, 1024, 32, 32, 128)   # b, sk, hq, hkv, d
# plain versions that hold GBs of fp32 scores: timed eagerly (device-bound
# there), not captured five times into one CUDA graph
EAGER_PLAIN_CASES = ("train_1b_d64_gqa", "train_7b_d128", "train_8x410m")


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
    "train_8x410m": (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 64, True, 0,
                     "bfloat16"),
    "rlhf_1b_s255": (8, 255, 255, 32, 4, 64, True, 0, "bfloat16"),
}
BWD_HEADLINE_CASE = "train_1b_d64_gqa"   # the shape the train path gives
BWD_LIBRARY_CASES = ("train_1b_d64_gqa", "train_7b_d128", "train_8x410m",
                     "rlhf_1b_s255")


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
    wave = Wave(eng, "serve", SERVE_NEW_TOKENS)
    for p in prompts:   # staggered admissions
        wave.submit(p)
        time.sleep(0.03)
    threads = wave.join()
    stats = eng.stats()
    eng.shutdown()
    launches = read_launches(flash)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(not any(th.is_alive() for th in threads) and
          not eng._thread.is_alive(), "engine or consumer threads hung")
    outs, stamps, t_submit = wave.outs, wave.stamps, wave.t_submit
    check("dead" not in stats, f"engine died: {stats.get('dead')}")
    del eng, wave   # its KV cache: the kv sub-phase needs the room

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
    torch.cuda.empty_cache()
    kv_launches = serve_kv_phase(torch, np, cfg, params, flash)
    del params
    torch.cuda.empty_cache()
    return launches, kv_launches


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


class Wave:
    """Streams submitted to one engine, one consumer thread each: each
    request's tokens, each token's arrival on the host clock
    (``perf_counter``), and its first token's wall time (``time.time``,
    the recorder's clock)."""

    def __init__(self, eng, tag, n_new):
        self.eng, self.tag, self.n_new = eng, tag, n_new
        self.t_submit, self.outs, self.stamps, self.first_wall = {}, {}, {}, {}
        self.threads = []

    def submit(self, prompt, kw=None):
        i = len(self.threads)
        self.t_submit[i] = time.perf_counter()
        q = self.eng.submit_stream(
            prompt, self.n_new, obs_ctx={"request_id": f"{self.tag}-{i}",
                                         "span_id": self.tag}, **(kw or {}))
        th = threading.Thread(target=self._consume, args=(i, q))
        th.start()
        self.threads.append(th)

    def _consume(self, i, q):
        toks, ts = [], []
        while True:
            t = q.get(timeout=600)
            if t is None:
                break
            if not toks:
                self.first_wall[i] = time.time()
            toks.append(t)
            ts.append(time.perf_counter())
        self.outs[i], self.stamps[i] = toks, ts

    def join(self):
        for th in self.threads:
            th.join(timeout=900)
        return self.threads

    def tokens(self):
        return [self.outs.get(i, []) for i in range(len(self.threads))]

    def ttft(self):
        """Submit to the first token's arrival, per request."""
        return [self.stamps[i][0] - self.t_submit[i] if self.stamps.get(i)
                else None for i in range(len(self.threads))]

    def records(self):
        """The recorder's request record of each."""
        recs = {r.get("request_id"): r for r in self.eng._recorder.requests()}
        return [recs.get(f"{self.tag}-{i}", {})
                for i in range(len(self.threads))]


def run_wave(eng, prompts, kws, tag, n_new, gap_s=0.03):
    """Submit ``prompts`` ``gap_s`` apart and wait for them all; returns
    tokens, TTFT and the recorder's request record of each."""
    wave = Wave(eng, tag, n_new)
    for p, kw in zip(prompts, kws):
        wave.submit(p, kw)
        time.sleep(gap_s)
    check(not any(th.is_alive() for th in wave.join()), f"{tag} wave hung")
    return wave.tokens(), wave.ttft(), wave.records()


def sync_s(torch, fn):
    """Host seconds of ``fn`` between two device syncs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def serve_kv_phase(torch, np, cfg, params, flash):
    """The prefix KV cache, sampling and a weight swap at 7b: a primer
    request seeds the cache with a 256-token shared prefix; 8 prompts
    (that prefix + distinct suffixes, rows 4-7 sampled) go through an
    engine with the cache off (cold), then through the kv engine (warm,
    every admission restores 256 tokens); a swap wave calls
    ``load_params`` mid-flight. The path's launches are read there; then a
    bare batcher on the same cache checks the restored rows bit for bit,
    times a capture and a restore, and takes the greedy rows' cold top-2
    margins."""
    from ray_tpu_torch.models import generate as TG
    from ray_tpu_torch.models.serving import (ContinuousBatcher,
                                              ContinuousEngine)

    rng = np.random.default_rng(1)
    vocab = cfg.vocab_size
    draw = lambda n: rng.integers(0, vocab, size=n).astype(np.int64)
    prefix = draw(SERVE_KV_PREFIX)
    prompts = [np.concatenate([prefix, draw(n)])
               for n in SERVE_KV_SUFFIX_LENS]
    primer = np.concatenate([prefix, draw(SERVE_KV_PRIMER_SUFFIX)])
    kws = [{} if i < 4 else dict(SERVE_KV_SAMPLED, seed=1000 + i)
           for i in range(len(prompts))]
    n_new = SERVE_NEW_TOKENS
    eng_kw = dict(max_slots=8, max_len=1024, decode_stride=8, sampling=True,
                  device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches(flash)
    t0 = time.perf_counter()
    kv = ContinuousEngine(params, cfg, kv_cache_bytes=SERVE_KV_BYTES,
                          kv_label="kv", **eng_kw)
    warmup_s = time.perf_counter() - t0
    cache = kv._batcher.prefix_cache
    primer_toks, _, primer_rec = run_wave(kv, [primer], [{}], "primer",
                                          n_new)
    after_primer = cache.stats()
    cold = ContinuousEngine(params, cfg, kv_cache_bytes=0, kv_label="cold",
                            **eng_kw)
    cold_toks, cold_ttft, cold_rec = run_wave(cold, prompts, kws, "cold",
                                              n_new)
    cold_stats = cold.stats()
    cold.shutdown()
    del cold
    t_warm0 = time.time()
    warm_toks, warm_ttft, warm_rec = run_wave(kv, prompts, kws, "warm",
                                              n_new)
    t_warm1 = time.time()
    after_warm = cache.stats()
    # a sampled request alone, twice, same seed
    alone = [run_wave(kv, [prompts[4]], [kws[4]], f"alone{j}", n_new)[0][0]
             for j in range(2)]

    # the swap wave: two fresh prompts in flight, load_params of a clone,
    # then a fresh prompt and a shared-prefix one held at the barrier
    swap_prompts = [draw(n) for n in SERVE_KV_SWAP_LENS] + [prompts[1]]
    clone = {k: ({kk: vv.clone() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in params.items()}
    st0 = cache.stats()
    swap_wave = Wave(kv, "swap", n_new)
    for i in range(2):
        swap_wave.submit(swap_prompts[i])
        time.sleep(0.03)
    t_wait = time.perf_counter() + 300
    while len(swap_wave.first_wall) < 2 and time.perf_counter() < t_wait:
        time.sleep(0.005)
    swap_res = {}

    def swap():
        swap_res["out"] = kv.load_params(clone, timeout_s=600)
        swap_res["stats"] = cache.stats()

    swapper = threading.Thread(target=swap)
    swapper.start()
    while kv._pending_swap is None and swapper.is_alive():
        time.sleep(0.001)
    for i in (2, 3):
        swap_wave.submit(swap_prompts[i])
    swapper.join(timeout=900)
    workers = swap_wave.join()
    check(not swapper.is_alive() and not any(th.is_alive() for th in workers)
          and "out" in swap_res, f"swap wave hung: {swap_res}")
    swap_out, swap_firsts = swap_wave.tokens(), swap_wave.first_wall
    swap_recs = swap_wave.records()
    kv_stats = kv.stats()
    # the swap's own stamp, taken inside the barrier before the held
    # requests were admitted
    swap_res["t"] = kv_stats["recorder"]["last_swap"]["t"]
    warm_window = kv._recorder.window_summary(t_warm0, t_warm1)
    kv.shutdown()
    del kv, swap_wave, clone
    launches = read_launches(flash)

    # after the path's launches are read: a bare batcher on the same cache
    # (the swap wave's shared-prefix request left the prefix's pages there)
    b = ContinuousBatcher(params, cfg, max_slots=1, max_len=1024,
                          prefix_cache=cache, sampling=True, device=DEV)
    rid, _, _ = b.submit_ex(prompts[0], 2)
    bare_cached = b.last_admission["cached_tokens"]
    c, pk, pv = cache.lookup(prompts[0])
    restored_equal = (c == bare_cached == SERVE_KV_PREFIX
                      and torch.equal(b._cache["k"][:, 0, :c].cpu(), pk)
                      and torch.equal(b._cache["v"][:, 0, :c].cpu(), pv))
    b.cancel(rid)
    restore_s = [sync_s(torch, lambda: b._restore(0, pk, pv))[0]
                 for _ in range(2)]
    page_bytes = 2 * pk.numel() * pk.element_size()
    # a capture of one slot: a fresh 512-token prompt cancelled at once
    # (its pages' pinned allocation included, which may reuse a block the
    # swap's invalidated pages returned to the host allocator), then the
    # page copy alone with the allocator's block reused
    fresh_id = b.submit(draw(512), 8)
    capture_s, _ = sync_s(torch, lambda: b.cancel(fresh_id))
    pages = b._pages(0, 512)
    capture_bytes = sum(t.numel() * t.element_size() for t in pages)
    del pages
    copy_s, _ = sync_s(torch, lambda: b._pages(0, 512))
    # cold top-2 margins of the greedy rows' last prompt position
    margins = []
    with torch.inference_mode():
        for i in range(4):
            toks = torch.from_numpy(prompts[i]).to(DEV)[None, :]
            logits = TG._forward_with_cache(params, toks, cfg, b._rows(0, 1),
                                            0)[0, -1]
            top = torch.topk(logits, 2).values
            margins.append({"argmax": int(logits.argmax()),
                            "margin": float(top[0] - top[1]),
                            "max_abs_logit": float(logits.abs().max())})
    del b

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # -- checks ---------------------------------------------------------
    check("dead" not in kv_stats and "dead" not in cold_stats,
          f"an engine died: {kv_stats.get('dead')} {cold_stats.get('dead')}")
    for tag, outs in (("primer", primer_toks), ("cold", cold_toks),
                      ("warm", warm_toks), ("alone", alone),
                      ("swap", swap_out)):
        for i, toks in enumerate(outs):
            check(len(toks) == n_new and all(0 <= t < vocab for t in toks),
                  f"{tag} request {i}: {len(toks)} tokens, want {n_new} "
                  f"in-vocab")
    warm_cached = [r.get("cached_tokens") for r in warm_rec]
    check(all(cc == SERVE_KV_PREFIX for cc in warm_cached),
          f"warm admissions restored {warm_cached} tokens, want "
          f"{SERVE_KV_PREFIX} each")
    check(restored_equal, "the bare batcher's restored rows [0, 256) differ "
                          "from the cached pages")
    first_cmp = []
    for i, m in enumerate(margins):
        rel = m["margin"] / m["max_abs_logit"]
        row = {"row": i, "cold": cold_toks[i][0], "warm": warm_toks[i][0],
               "cold_argmax_solo": m["argmax"], "margin": m["margin"],
               "margin_rel": rel, "checked": rel > WARM_MARGIN_REL_TOL}
        first_cmp.append(row)
        if row["cold"] != row["warm"]:
            print(f"warm/cold first-token mismatch, row {i}: {row}",
                  flush=True)
    check(any(r["checked"] for r in first_cmp),
          f"no greedy row's cold top-2 margin exceeds {WARM_MARGIN_REL_TOL}: "
          f"the warm/cold first-token check compared nothing: {first_cmp}")
    bad = [r for r in first_cmp if r["checked"] and r["cold"] != r["warm"]]
    check(not bad, f"warm first tokens differ from cold above the margin "
                   f"tolerance {WARM_MARGIN_REL_TOL}: {bad}")
    check(alone[0] == alone[1], f"a sampled request alone, same seed, gave "
                                f"{alone[0]} then {alone[1]}")
    admitted = cold_stats["admitted"] + kv_stats["admitted"]
    decode_steps = cold_stats["decode_steps"] + kv_stats["decode_steps"]
    # every admission's prefill (whole prompt or uncached suffix, at least
    # 64 rows) is one tcb launch a layer, and the engines warm no prefill;
    # the decode steps launch dec, and so does the engines' warmup
    want_by_kernel = {"tcb": cfg.n_layers * admitted,
                      "dec": cfg.n_layers * decode_steps}
    got = {kern: launches[f"flash_fwd_{kern}"] for kern in want_by_kernel}
    check(got["tcb"] == want_by_kernel["tcb"] > 0,
          f"kv sub-phase: tcb launched {got['tcb']} times, the path's "
          f"{admitted} prefills make {want_by_kernel['tcb']}")
    check(got["dec"] >= want_by_kernel["dec"] > 0,
          f"kv sub-phase: dec launched {got['dec']} times, want >= "
          f"{want_by_kernel['dec']}")
    check(launches["flash_fwd_simt"] == 0,
          f"the float32 forward kernel ran in bf16 serving: {launches}")
    st1 = swap_res["stats"]
    resident = st0["pages"] + st1["inserts"] - st0["inserts"]
    check(swap_res["out"]["weight_swaps"] == kv_stats["weight_swaps"] == 1,
          f"weight_swaps {swap_res['out']} {kv_stats['weight_swaps']}")
    check(st1["evictions"] == st0["evictions"] and
          st1["invalidations"] - st0["invalidations"] == resident,
          f"swap invalidated {st1['invalidations'] - st0['invalidations']} "
          f"pages, {resident} were resident (before {st0}, after {st1})")
    check(all(swap_firsts[i] < swap_res["t"] for i in (0, 1)) and
          all(r.get("t_admit", 0) > swap_res["t"] for r in swap_recs[2:]),
          f"swap order: first tokens {swap_firsts}, swap at "
          f"{swap_res['t']}, held admissions {swap_recs[2:]}")
    check(swap_recs[3].get("cached_tokens") == 0,
          f"the first shared-prefix admission after the swap restored "
          f"{swap_recs[3].get('cached_tokens')} tokens")

    med = lambda xs: float(np.median(xs))
    summ = kv_stats["recorder"]
    pick = ("decode_efficiency", "overhead_frac", "tick_gap_p50_s",
            "tick_gap_p99_s", "tick_gap_max_s", "phase_s", "phase_sum_ratio",
            "ttft_p50_s", "tpot_p50_s", "window_ticks")
    emit({"phase": "serve_kv", "config": "7b, 32 layers, bf16, attn flash, "
                                         "prefix cache, sampling",
          "engine": dict({k: v for k, v in eng_kw.items() if k != "device"},
                         kv_cache_bytes=SERVE_KV_BYTES),
          "prefix_tokens": SERVE_KV_PREFIX,
          "suffix_lens": list(SERVE_KV_SUFFIX_LENS), "new_tokens": n_new,
          "sampled_rows": {"rows": [4, 5, 6, 7], **SERVE_KV_SAMPLED},
          "engine_warmup_s": warmup_s,
          "ttft_cold_s": cold_ttft, "ttft_warm_s": warm_ttft,
          "ttft_median_cold_s": med(cold_ttft),
          "ttft_median_warm_s": med(warm_ttft),
          "warm_cached_tokens": warm_cached,
          "kv_restore_s_warm": [r.get("kv_restore_s") for r in warm_rec],
          "prefill_s_warm": [r.get("prefill_s") for r in warm_rec],
          "prefill_s_cold": [r.get("prefill_s") for r in cold_rec],
          "primer": {"cached_tokens": primer_rec[0].get("cached_tokens"),
                     "prefill_s": primer_rec[0].get("prefill_s")},
          "restore_direct_s": restore_s, "restore_bytes": page_bytes,
          "restore_gb_per_s": page_bytes / min(restore_s) / 1e9,
          "capture_direct_s": capture_s, "capture_copy_s": copy_s,
          "capture_bytes": capture_bytes,
          "capture_gb_per_s": capture_bytes / copy_s / 1e9,
          "host_page_bytes": {"after_primer": after_primer["bytes"],
                              "after_warm": after_warm["bytes"],
                              "pages_after_warm": after_warm["pages"]},
          "first_tokens_warm_vs_cold": first_cmp,
          "margin_rel_tol": WARM_MARGIN_REL_TOL,
          "sampled_alone_repeat_equal": alone[0] == alone[1],
          "sampled_alone_equals_warm_wave": alone[0] == warm_toks[4],
          "swap": {"load_params": swap_res["out"],
                   "pages_before": st0["pages"], "stats_after": st1,
                   "held_cached_tokens": [r.get("cached_tokens")
                                          for r in swap_recs[2:]]},
          "kv_stats": kv_stats["kv"],
          "recorder": {k: summ.get(k) for k in pick},
          "recorder_warm_wave": {k: warm_window.get(k) for k in pick},
          "recorder_cold": {k: cold_stats["recorder"].get(k) for k in pick},
          "peak_mem_bytes": peak, "launches": launches,
          "fwd_launches_expected_by_kernel": want_by_kernel})
    return launches


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


# ------------------------------------------------------------ phases 8-10

LLM_RPS, LLM_DURATION_S, LLM_MAX_INFLIGHT = 4.0, 40.0, 16
SPEC_K, SPEC_PROMPT, SPEC_NEW = 4, 256, 64
MOE_PRESET, MOE_BATCH, MOE_PROMPT, MOE_NEW = "8x410m", 4, 256, 32


class LoopThread:
    """An asyncio loop on a thread of its own, where the serving classes'
    ``__call__`` runs; ``run(coro)`` waits for one coroutine from any
    thread."""

    def __init__(self):
        import asyncio

        self.asyncio = asyncio
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=600):
        return self.asyncio.run_coroutine_threadsafe(
            coro, self.loop).result(timeout)

    def close(self):
        async def cancel_rest():   # e.g. the @batch flush loop
            rest = [t for t in self.asyncio.all_tasks()
                    if t is not self.asyncio.current_task()]
            for t in rest:
                t.cancel()
            await self.asyncio.gather(*rest, return_exceptions=True)

        self.run(cancel_rest(), timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=60)
        self.loop.close()


def time_captures(torch, batcher):
    """Time every prefix-cache capture of ``batcher`` (the device-to-host
    copy of a finished slot's KV and its insert), synchronised on both
    sides; returns the record it fills: calls, total and largest ms."""
    rec = {"calls": 0, "total_ms": 0.0, "max_ms": 0.0}
    capture = batcher._capture

    def timed(slot, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        capture(slot, req)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec["calls"] += 1
        rec["total_ms"] += ms
        rec["max_ms"] = max(rec["max_ms"], ms)

    batcher._capture = timed
    return rec


def llm_leg(torch, llm, prompts, loop, streaming, n_new):
    """``poisson_load`` at LLM_RPS for LLM_DURATION_S against ``llm``: each
    request the next prompt, ``n_new`` tokens; returns the load's report
    (plus peak memory) and each request's tokens by index."""
    from ray_tpu_torch.serve.llm import poisson_load

    lock = threading.Lock()
    count = [0]
    outs = {}

    def fire():
        with lock:
            i = count[0]
            count[0] += 1
        body = {"tokens": prompts[i % len(prompts)].tolist(),
                "max_new_tokens": n_new}
        t0 = time.perf_counter()

        async def go():
            if not streaming:   # one response when the batch is done
                toks = await llm(body)
                return toks, time.perf_counter() - t0
            gen = await llm(body)
            toks, ttft = [], None
            async for tok in gen:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.append(int(tok))
            return toks, ttft

        toks, ttft = loop.run(go())
        outs[i] = toks
        return len(toks), ttft

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = poisson_load(fire, rps=LLM_RPS, duration_s=LLM_DURATION_S, seed=0,
                       max_inflight=LLM_MAX_INFLIGHT)
    torch.cuda.synchronize()
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return res, outs


def llm_phase(torch, np, TG, flash):
    """The serving front end at 7b: ``ContinuousLLM`` (8 slots, max_len
    1024, stride 8) and its ``StaticLLM`` control (8 rows, prompts padded
    to 512, 32 new tokens), each under ``poisson_load`` at 4 requests/s
    for 40 s (seed 0, 16 in flight), prompts of SERVE_PROMPT_LENS, 32 new
    tokens each, ``__call__`` on an asyncio loop thread. The continuous
    leg runs the default 64 MiB prefix cache: at 7b a request's KV is 512
    KiB a token, so most captures are copied to the host and then refused
    as oversize; their copies are timed (synchronised) and reported."""
    from ray_tpu_torch.serve.llm import ContinuousLLM, ServeHooks, StaticLLM

    class Hooks(ServeHooks):
        def __init__(self):
            self.ticks, self.batches = [], []

        def on_tick(self, name, active, slots):
            self.ticks.append((active, slots))

        def on_batch(self, fn, size, max_size):
            self.batches.append(size)

    n_new = SERVE_NEW_TOKENS
    rng = np.random.default_rng(4)
    n_prompts = int(LLM_RPS * LLM_DURATION_S * 2) + 16
    prompts = [rng.integers(0, 32000, size=SERVE_PROMPT_LENS[
        i % len(SERVE_PROMPT_LENS)]).astype(np.int64)
        for i in range(n_prompts)]
    loop = LoopThread()
    hooks = Hooks()

    zero_launches(flash)
    t0 = time.perf_counter()
    llm = ContinuousLLM("7b", max_slots=8, max_len=1024, decode_stride=8,
                        hooks=hooks, device=DEV)
    cb_init_s = time.perf_counter() - t0
    captures = time_captures(torch, llm.engine._batcher)
    cb, cb_outs = llm_leg(torch, llm, prompts, loop, True, n_new)
    cb_stats = llm.engine_stats()
    llm.engine.shutdown()
    cb_launches = read_launches(flash)
    check(llm.cfg.vocab_size == 32000 and llm.cfg.attn_impl == "flash",
          f"the 7b preset: {llm.cfg}")
    # each stream's first token against batch-1 generate on llm.params,
    # outside the count
    first_match = sum(
        int(TG.generate(llm.params, prompts[i % n_prompts][None, :], llm.cfg,
                        max_new_tokens=1, device=DEV)[0, 0]) == toks[0]
        for i, toks in cb_outs.items() if toks)
    n_layers = llm.cfg.n_layers
    del llm
    gc.collect()   # the engine's tick callback refers back to llm
    torch.cuda.empty_cache()

    zero_launches(flash)
    t0 = time.perf_counter()
    static = StaticLLM("7b", max_batch=8, prompt_pad=512, max_new=n_new,
                       hooks=hooks, device=DEV)
    st_init_s = time.perf_counter() - t0
    st, st_outs = llm_leg(torch, static, prompts, loop, False, n_new)
    st_launches = read_launches(flash)
    loop.close()
    del static
    gc.collect()   # its @batch wrapper refers back to it
    torch.cuda.empty_cache()
    launches = {key: cb_launches[key] + st_launches[key]
                for key in cb_launches}

    emit({"phase": "llm", "config": "7b, 32 layers, bf16, attn flash",
          "load": {"rps": LLM_RPS, "duration_s": LLM_DURATION_S, "seed": 0,
                   "max_inflight": LLM_MAX_INFLIGHT, "new_tokens": n_new,
                   "prompt_lens": list(SERVE_PROMPT_LENS)},
          "continuous": dict(cb, init_s=cb_init_s,
                             engine={"max_slots": 8, "max_len": 1024,
                                     "decode_stride": 8},
                             engine_stats=cb_stats,
                             ticks=len(hooks.ticks),
                             max_active_at_tick=max(
                                 (a for a, _ in hooks.ticks), default=0),
                             first_token_match=f"{first_match}/"
                                               f"{len(cb_outs)}",
                             captures=captures,
                             launches=cb_launches),
          "static": dict(st, init_s=st_init_s,
                         config={"max_batch": 8, "prompt_pad": 512,
                                 "max_new": n_new},
                         batch_sizes=hooks.batches, launches=st_launches),
          "launches": launches})
    check(cb["failed"] == 0 and cb["completed"] > 0,
          f"continuous leg: {cb['failed']} failed, {cb['completed']} done")
    check(st["failed"] == 0 and st["completed"] > 0,
          f"static leg: {st['failed']} failed, {st['completed']} done")
    for tag, outs in (("continuous", cb_outs), ("static", st_outs)):
        bad = [i for i, toks in outs.items()
               if len(toks) != n_new or not all(0 <= t < 32000 for t in toks)]
        check(not bad, f"{tag} leg: requests {bad} lack {n_new} in-vocab "
                       f"tokens")
    check(first_match == len(cb_outs),
          f"continuous leg: first tokens match batch-1 generate for "
          f"{first_match}/{len(cb_outs)}")
    check(cb_stats["max_slots"] == 8 and "dead" not in cb_stats,
          f"engine stats {cb_stats}")
    check(any(a > 0 and s == 8 for a, s in hooks.ticks),
          f"the tick hook never saw a live row: {hooks.ticks[:8]}")
    # a prefill a layer for every admission and static batch; a decode
    # step a layer for every engine step and each static batch's n_new - 1.
    # The engine's decode_steps include its warmup: strides 1 and 8 over
    # buckets 1 and 8, 18 steps
    check(cb_stats["decode_steps"] >= 18, f"engine stats {cb_stats}")
    want = {"tcb": n_layers * (cb_stats["admitted"] + len(hooks.batches)),
            "dec": n_layers * (cb_stats["decode_steps"]
                               + len(hooks.batches) * (n_new - 1))}
    for kern, w in want.items():
        check(launches[f"flash_fwd_{kern}"] == w > 0,
              f"llm: {kern} launched {launches[f'flash_fwd_{kern}']} times, "
              f"the path made {w} calls of its shapes")
    check(launches["flash_fwd_simt"] == 0, f"llm: simt ran: {launches}")
    return launches


def teacher_forced(torch, TG, params, cfg, prompt, toks):
    """The greedy choice and its top-2 margin (over max |logit|) at every
    position of ``toks`` given ``prompt`` and the tokens of ``toks``
    before it, from one cached forward over both: ([B, n] argmax, [B, n]
    margins), on the host."""
    seq = torch.cat([prompt, toks[:, :-1]], dim=1)
    cache = TG.init_cache(cfg, seq.shape[0], seq.shape[1], device=DEV)
    logits = TG._forward_with_cache(params, seq, cfg, cache, 0,
                                    last_only=False)[:, prompt.shape[1] - 1:]
    top = logits.topk(2, dim=-1)
    margins = ((top.values[..., 0] - top.values[..., 1])
               / logits.abs().amax(-1))
    return top.indices[..., 0].cpu(), margins.cpu()


def spec_phase(torch, np, tllama, TG, flash):
    """Greedy speculative decode with the 7b target: the target drafting
    for itself (k 4, b 1) and the 1b preset drafting (k 4, b 1 and b 4);
    prompts of 256 tokens, 64 new. Rounds, acceptance and ms per token
    against plain ``generate`` at the same b. Exactness by teacher
    forcing: one target forward over each run's prompt and output gives
    the greedy choice after every emitted prefix, and every emitted token
    must equal it wherever its top-2 margin is at least
    WARM_MARGIN_REL_TOL (the verify runs ``tcb`` on 5 rows, the forward
    ``tcb`` on 320, so bf16 bits may differ at near ties); every row must
    have such positions. How far each run equals plain ``generate`` is
    reported, not held: after a near tie the two may go apart."""
    cfg = dataclasses.replace(tllama.PRESETS["7b"], attn_impl="flash")
    dcfg = dataclasses.replace(tllama.PRESETS["1b"], attn_impl="flash")
    params = tllama.init_params(
        cfg, generator=torch.Generator(device=DEV).manual_seed(0),
        device=DEV)
    dparams = tllama.init_params(
        dcfg, generator=torch.Generator(device=DEV).manual_seed(1),
        device=DEV)
    check(dcfg.vocab_size == cfg.vocab_size, "draft and target vocabularies")
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(4, SPEC_PROMPT))).to(DEV)
    runs = (("self_b1", params, cfg, 1), ("1b_b1", dparams, dcfg, 1),
            ("1b_b4", dparams, dcfg, 4))

    def spec(dp, dc, b, n=SPEC_NEW):
        return TG.generate_speculative(
            params, dp, prompts[:b], cfg, dc, max_new_tokens=n,
            speculate_k=SPEC_K, return_stats=True, device=DEV)

    for dp, dc in ((params, cfg), (dparams, dcfg)):   # first calls of
        spec(dp, dc, 1, 8)                             # these shapes
    zero_launches(flash)
    recs = {}
    for name, dp, dc, b in runs:
        before = read_launches(flash)
        wall, (out, stats) = sync_s(torch, lambda: spec(dp, dc, b))
        ran = {k: v - before[k] for k, v in read_launches(flash).items()}
        want = {"tcb": cfg.n_layers * (1 + stats["rounds"]) + dc.n_layers,
                "dec": dc.n_layers * SPEC_K * stats["rounds"]}
        recs[name] = {"b": b, "draft": "7b" if dc is cfg else "1b",
                      "out": out, "stats": stats, "wall_s": wall,
                      "launches": ran, "want": want}
    launches = read_launches(flash)
    # plain generate at each b: the yardstick
    plain = {}
    for b in (1, 4):
        wall, ref = sync_s(torch, lambda: TG.generate(
            params, prompts[:b], cfg, max_new_tokens=SPEC_NEW, device=DEV))
        plain[b] = {"out": ref.cpu(), "wall_s": wall}
    out_recs = {}
    for name, r in recs.items():
        p = plain[r["b"]]
        best, margins = teacher_forced(torch, TG, params, cfg,
                                       prompts[:r["b"]], r["out"])
        got = r["out"].cpu()
        held = margins >= WARM_MARGIN_REL_TOL
        wrong = (got != best) & held
        equal_to = [next((j for j in range(SPEC_NEW)
                          if got[i, j] != p["out"][i, j]), SPEC_NEW)
                    for i in range(r["b"])]
        n_tok = r["b"] * SPEC_NEW
        out_recs[name] = {
            "b": r["b"], "draft": r["draft"], "k": SPEC_K, **r["stats"],
            "ms_per_token": r["wall_s"] * 1e3 / n_tok,
            "plain_ms_per_token": p["wall_s"] * 1e3 / n_tok,
            "speedup_vs_plain": p["wall_s"] / r["wall_s"],
            "equal_to_generate_up_to": equal_to,
            "teacher_forced_checked": held.sum(1).tolist(),
            "teacher_forced_wrong": [row.nonzero().flatten().tolist()
                                     for row in wrong],
            "teacher_forced_below_margin": [
                [j for j in range(SPEC_NEW) if not held[i, j]
                 and got[i, j] != best[i, j]] for i in range(r["b"])],
            "launches": r["launches"], "launches_expected": r["want"]}
    emit({"phase": "spec", "config": "target 7b, 32 layers, bf16, attn "
                                     "flash; draft 7b itself or 1b",
          "prompt_len": SPEC_PROMPT, "new_tokens": SPEC_NEW,
          "margin_rel_tol": WARM_MARGIN_REL_TOL, "runs": out_recs,
          "launches": launches})
    for name, r in out_recs.items():
        for kern in ("tcb", "dec"):
            check(r["launches"][f"flash_fwd_{kern}"]
                  == r["launches_expected"][kern] > 0,
                  f"spec {name}: {kern} launched "
                  f"{r['launches'][f'flash_fwd_{kern}']} times, the run's "
                  f"{r['rounds']} rounds make {r['launches_expected'][kern]}")
        check(not any(r["teacher_forced_wrong"]),
              f"spec {name}: emitted tokens differ from the target's "
              f"greedy choice at positions {r['teacher_forced_wrong']} "
              f"(margins >= {WARM_MARGIN_REL_TOL})")
        check(all(n > 0 for n in r["teacher_forced_checked"]),
              f"spec {name}: rows with no position whose margin is at "
              f"least {WARM_MARGIN_REL_TOL}: {r['teacher_forced_checked']}")
    check(launches["flash_fwd_simt"] == 0, f"spec: simt ran: {launches}")
    del params, dparams, recs, plain
    torch.cuda.empty_cache()
    return launches


def moe_phase(torch, np, TG, flash):
    """The MoE family at full width and depth: ``8x410m`` (24 layers, 8
    experts, top 2), random bf16 weights. Greedy ``generate`` at b 4 over
    256-token prompts, 32 new tokens; a ``ContinuousEngine`` (8 slots,
    max_len 1024, stride 8) answering 8 staggered requests of
    SERVE_PROMPT_LENS; then, outside the count, the checks' references, a
    timed prefill, an 8-row decode tick on the host clock and one
    profiled tick (device busy, the MoE FFN's share)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ray_tpu_torch.models import moe as tmoe
    from ray_tpu_torch.models.serving import (ContinuousBatcher,
                                              ContinuousEngine)

    cfg = dataclasses.replace(tmoe.PRESETS[MOE_PRESET], attn_impl="flash")
    t0 = time.perf_counter()
    params = tmoe.init_params(
        cfg, generator=torch.Generator(device=DEV).manual_seed(0),
        device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in
                      (params["embed"], params["final_norm"],
                       params["lm_head"], *params["layers"].values()))
    rng = np.random.default_rng(6)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(MOE_BATCH, MOE_PROMPT))).to(DEV)
    eng_prompts = [rng.integers(0, cfg.vocab_size, size=s).astype(np.int64)
                   for s in SERVE_PROMPT_LENS]
    TG.generate(params, prompts[:, :16], cfg, max_new_tokens=2, device=DEV)
    torch.cuda.reset_peak_memory_stats()

    zero_launches(flash)
    gen_s, out = sync_s(torch, lambda: TG.generate(
        params, prompts, cfg, max_new_tokens=MOE_NEW, device=DEV))
    eng = ContinuousEngine(params, cfg, max_slots=8, max_len=1024,
                           decode_stride=8, device=DEV)
    wave = Wave(eng, "moe", MOE_NEW)
    for p in eng_prompts:
        wave.submit(p)
        time.sleep(0.03)
    threads = wave.join()
    stats = eng.stats()
    eng.shutdown()
    launches = read_launches(flash)
    check(not any(th.is_alive() for th in threads), "moe engine wave hung")
    eng_outs = wave.tokens()
    del eng, wave
    peak = torch.cuda.max_memory_allocated()

    # references: the drop-free full forward's argmax and margin at the
    # last prompt position, and each engine prompt's batch-1 generate
    free = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    with torch.inference_mode():
        last = tmoe.forward(params, prompts, free)[:, -1]
    top = last.topk(2, dim=-1).values
    rel = ((top[:, 0] - top[:, 1]) / last.abs().amax(-1)).tolist()
    ref_first = last.argmax(-1).tolist()
    first_cmp = [{"row": i, "generate": int(out[i, 0]), "forward": ref_first[i],
                  "margin_rel": rel[i], "checked": rel[i] > WARM_MARGIN_REL_TOL}
                 for i in range(MOE_BATCH)]
    eng_first = [int(TG.generate(params, p[None, :], cfg, max_new_tokens=1,
                                 device=DEV)[0, 0]) for p in eng_prompts]

    # timing, outside the count: the b 4 prefill, the engine's b 1
    # prefills, an 8-row tick of k = 8 steps, and one profiled tick
    cache = TG.init_cache(cfg, MOE_BATCH, MOE_PROMPT + MOE_NEW, device=DEV)
    prefill_ms = [sync_s(torch, lambda: TG._forward_with_cache(
        params, prompts, cfg, cache, 0))[0] * 1e3 for _ in range(3)]
    b = ContinuousBatcher(params, cfg, max_slots=8, max_len=1024, device=DEV)
    prefill_b1_ms = {}
    for p in eng_prompts:
        prefill_b1_ms[len(p)] = sync_s(torch, lambda: b.submit(p, 64))[0] * 1e3
    k, ticks = 8, 2
    b.step_many(k)
    tick_s, _ = sync_s(torch, lambda: [b.step_many(k) for _ in range(ticks)])
    step_ms = tick_s * 1e3 / (ticks * k)
    moe_ffn = tmoe._moe_ffn

    def traced_ffn(*a, **kw):
        with record_function("moe_ffn"):
            return moe_ffn(*a, **kw)

    tmoe._moe_ffn = traced_ffn
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            b.step_many(k)
            torch.cuda.synchronize()
    finally:
        tmoe._moe_ffn = moe_ffn
    del b
    cuda = torch.autograd.DeviceType.CUDA
    per_kernel = {e.key: e.self_device_time_total / 1e3 / k
                  for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0
                  and e.key != "moe_ffn"}
    busy = sum(per_kernel.values())
    ffn_ms = sum(e.device_time_total / 1e3 / k for e in prof.key_averages()
                 if e.key == "moe_ffn" and e.device_type != cuda)
    flash_ms = fwd_ms_by_kernel(per_kernel)
    top_k = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    # a decode step reads every weight but the embedding table (8 rows)
    step_bytes = (param_bytes - params["embed"].numel()
                  * params["embed"].element_size())
    emit({"phase": "moe", "config": f"{MOE_PRESET}, {cfg.n_layers} layers, "
                                    f"{cfg.n_experts} experts top "
                                    f"{cfg.top_k}, bf16, attn flash",
          "params": cfg.num_params(), "active_params": cfg.active_params(),
          "param_bytes": param_bytes, "init_params_s": init_s,
          "generate": {"b": MOE_BATCH, "prompt_len": MOE_PROMPT,
                       "new_tokens": MOE_NEW, "wall_s": gen_s,
                       "tok_per_s": MOE_BATCH * MOE_NEW / gen_s},
          "first_tokens_vs_dropfree_forward": first_cmp,
          "margin_rel_tol": WARM_MARGIN_REL_TOL,
          "engine": {"max_slots": 8, "max_len": 1024, "decode_stride": 8,
                     "prompt_lens": list(SERVE_PROMPT_LENS), "stats": stats,
                     "first_token_match": sum(
                         int(o[:1] == [f]) for o, f in
                         zip(eng_outs, eng_first))},
          "prefill_b4_s256_ms": prefill_ms,
          "prefill_b1_ms_by_prompt_len": prefill_b1_ms,
          "decode_rows": 8, "decode_step_ms": step_ms,
          "decode_tok_per_s_8_rows": 8 * 1e3 / step_ms,
          "decode_weight_read_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
          "profiled_tick": {
              "device_busy_ms_per_step": busy if busy else "not measured",
              "host_wall_ms_per_step": step_ms,
              "device_idle_share": 1 - busy / step_ms if busy else
              "not measured",
              "moe_ffn_ms_per_step": ffn_ms if ffn_ms else "not measured",
              "moe_ffn_share_of_busy": ffn_ms / busy if ffn_ms and busy
              else "not measured",
              "flash_fwd_ms_per_step_by_kernel": flash_ms,
              "top_kernels_ms_per_step": [[n[:80], t] for n, t in top_k]},
          "peak_mem_bytes": peak, "launches": launches})
    check(all(len(t) == MOE_NEW and all(0 <= x < cfg.vocab_size for x in t)
              for t in out.tolist() + eng_outs),
          "moe: a stream lacks 32 in-vocab tokens")
    check(any(r["checked"] for r in first_cmp),
          f"moe: no row's top-2 margin exceeds {WARM_MARGIN_REL_TOL}: "
          f"{first_cmp}")
    bad = [r for r in first_cmp if r["checked"]
           and r["generate"] != r["forward"]]
    check(not bad, f"moe: generate's first tokens differ from the drop-free "
                   f"forward's argmax above the margin: {bad}")
    check([o[0] for o in eng_outs] == eng_first,
          f"moe: engine first tokens {[o[0] for o in eng_outs]} against "
          f"batch-1 generate {eng_first}")
    check("dead" not in stats, f"moe engine died: {stats.get('dead')}")
    want = {"tcb": cfg.n_layers * (1 + stats["admitted"]),
            "dec": cfg.n_layers * (MOE_NEW - 1 + stats["decode_steps"])}
    for kern, w in want.items():
        check(launches[f"flash_fwd_{kern}"] >= w > 0,
              f"moe: {kern} launched {launches[f'flash_fwd_{kern}']} times, "
              f"the path made {w} calls of its shapes")
    check(launches["flash_fwd_tcb"] == want["tcb"],
          f"moe: tcb launched {launches['flash_fwd_tcb']} times, one a "
          f"layer for each of the path's prefills is {want['tcb']}")
    check(launches["flash_fwd_simt"] == 0, f"moe: simt ran: {launches}")
    del params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phases 11-12

# the second run is 2 fused launches, unprofiled: the second is queued
# while the first runs, so a done stamp that waited for the whole device
# (a synchronize) would land at the second's end
DRIVER_K, DRIVER_BATCHES, DRIVER_SECOND = 4, 10, 8
# the recorder's device-done stamps against the device clock: a launch's
# done time (host clock, from its run's first launch's start) must match
# its CUDA event's (device clock) within this share of the event time or
# this many seconds, whichever is larger: the watcher's wake-up and the
# interpreter lock's switch interval (5 ms) on the host side. In the
# profiled run the profiler fences each launch on the step thread, which
# aligns any watcher's stamps; only the unprofiled second run tests them
DONE_ALIGN_REL, DONE_ALIGN_ABS_S = 0.02, 0.010
# device sleeps (cycles, ~0.1 s and ~0.5 s) of the queued-ahead check
QUEUED_SLEEP_CYCLES = (200_000_000, 1_000_000_000)
# the driver's losses and params against the plain loop's, and the resumed
# run's against the uninterrupted one's: the same kernels in the same
# order, so only a non-deterministic kernel could part them
DRIVER_REL_TOL = 1e-5
MOE_TRAIN_PRESET, MOE_TRAIN_BATCHES = "8x410m", 8


class LaunchEvents:
    """Wraps a step function: a CUDA event before and after each call, and
    the host's clock at the first event (a launch whose device was idle
    starts on both clocks at once). Launches made through the wrapper
    are the path's own; nothing here launches a kernel."""

    def __init__(self, torch, fn):
        self.calls = []
        self.shadow = None     # a SyncShadow while one is attached

        def run(*args):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t_host = time.time()
            ev0.record()
            out = fn(*args)
            ev1.record()
            self.calls.append((t_host, ev0, ev1))
            if self.shadow is not None:
                self.shadow.watch(len(self.calls) - 1)
            return out

        run._signatures = fn._signatures   # what compile_count reads
        self.run = run

    def device_ms(self):
        """Each call's first event to its last, on the device clock."""
        return [a.elapsed_time(b) for _, a, b in self.calls]


class SyncShadow:
    """What a watcher built on ``torch.cuda.synchronize()`` would stamp: a
    thread that takes each launch as it is queued, synchronizes the device
    and stamps the host clock. Held beside the recorder's stamps, it shows
    whether a run can tell the two apart. It launches nothing."""

    def __init__(self, torch):
        self.stamps = {}
        self._q = queue.Queue()
        device = torch.cuda.current_device()

        def loop():
            torch.cuda.set_device(device)
            while (i := self._q.get()) is not None:
                torch.cuda.synchronize()
                self.stamps[i] = time.time()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def watch(self, i):
        self._q.put(i)

    def close(self):
        self._q.put(None)
        self._thread.join()


def rel_diff(torch, got, want):
    """max |got - want| / max |want| over paired tensors (dicts by name)."""
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        scale = float(w.float().abs().max()) or 1.0
        worst = max(worst, float((g.float() - w.float()).abs().max())
                    / scale)
    return worst


def flat_losses(metrics):
    """Per-step losses from on_launch metrics: [K] for a fused launch, a
    0-d tensor for a single step."""
    return [float(x) for m in metrics for x in m["loss"].reshape(-1)]


def wait_recorder(rec, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and rec.summary()["in_flight"]:
        time.sleep(0.005)
    return rec.summary()


def done_alignment(rec_launches, calls, shadow=None, first=0):
    """Each fused launch's recorder done stamp against its CUDA events
    (``LaunchEvents.calls[first:]``): host seconds and device seconds from
    the run's first launch's start; with a ``SyncShadow``, its stamp too."""
    t_base, ev_base, _ = calls[first]
    out = []
    for i, (r, (_, _, ev1)) in enumerate(zip(rec_launches, calls[first:]),
                                         first):
        dev_s = ev_base.elapsed_time(ev1) / 1e3
        margin = max(DONE_ALIGN_ABS_S, DONE_ALIGN_REL * dev_s)
        a = {"seq": r["seq"], "recorder_done_s": r["t_done"] - t_base,
             "event_done_s": dev_s, "margin_s": margin,
             "recorder_device_s": r["phases"].get("dispatch", 0.0)
             + r["phases"].get("device_compute", 0.0)
             + r["phases"].get("compile", 0.0),
             "device_compute_s": r["phases"].get("device_compute", 0.0)}
        if shadow is not None:
            sync_s = shadow.stamps[i] - t_base
            a.update(sync_watcher_done_s=sync_s,
                     sync_watcher_within_margin=abs(sync_s - dev_s)
                     <= margin)
        out.append(a)
    return out


def check_launches(launches, leg, n_layers, steps):
    want = {"flash_fwd_tcb": 2 * n_layers * steps,
            "flash_dq": n_layers * steps, "flash_dkv": n_layers * steps,
            "flash_fwd_dec": 0, "flash_fwd_simt": 0}
    got = {k: launches[k] for k in want}
    check(got == want, f"{leg}: launches {got}, want {want} ({steps} steps "
                       f"of {n_layers} layers)")


def queued_ahead_alignment(torch):
    """The recorder's done stamp where the next launch is queued before a
    watcher could wait: launch 1 a ~0.1 s device sleep, launch 2 a ~0.5 s
    one queued right behind it, and only then the ``SyncShadow`` handed
    launch 1. The recorder must stamp launch 1 at its own end; the shadow
    stamps it at launch 2's end. A 1b launch cannot show this: the host
    stays less than a launch ahead of the device (the second run's shadow
    agrees with the events). Launches no kernel of the path."""
    from ray_tpu_torch.util.train_recorder import TrainRecorder

    rec = TrainRecorder("queued_ahead", enabled=True, n_devices=1)
    shadow = SyncShadow(torch)
    try:
        x = torch.ones(1, device=DEV)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.time()
        ev[0].record()
        torch.cuda._sleep(QUEUED_SLEEP_CYCLES[0])
        ev[1].record()
        t1 = time.time()
        seq = rec.record_launch(t_start=t0, data_wait_s=0.0, h2d_s=0.0,
                                dispatch_s=t1 - t0, t_dispatch_end=t1)
        rec.watch_outputs(seq, {"loss": x})
        torch.cuda._sleep(QUEUED_SLEEP_CYCLES[1])
        ev[2].record()
        shadow.watch(0)
        wait_recorder(rec)
        ev[2].synchronize()
        [launch] = rec.launches()
    finally:
        shadow.close()
        rec.close()
    dev_s = ev[0].elapsed_time(ev[1]) / 1e3
    return {"recorder_done_s": launch["t_done"] - t0, "event_done_s": dev_s,
            "next_event_done_s": ev[0].elapsed_time(ev[2]) / 1e3,
            "sync_watcher_done_s": shadow.stamps[0] - t0,
            "margin_s": max(DONE_ALIGN_ABS_S, DONE_ALIGN_REL * dev_s),
            "device_compute_s": launch["phases"].get("device_compute",
                                                     0.0)}


def driver_phase(torch, np, tllama, tts, tflops, flash):
    """The training fast path at 1b (22 layers): a seeded numpy token
    stream through ``iter_device_batches(stack=4, prefetch_batches=2)``
    into ``StepDriver(steps_per_launch=4)`` with the step profiler and the
    train recorder on (2 fused launches, a tail of 2 single steps), an
    async checkpoint of (params, opt_state) after the first fused launch;
    the same init and batches through a plain loop of ``make_train_step``;
    a second run of 4 batches (profiler off); the checkpoint loaded and the
    last 6 batches run through a fresh driver."""
    import shutil
    import tempfile

    from ray_tpu_torch.data.iterator import iter_device_batches
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.driver import StepDriver
    from ray_tpu_torch.util import step_profiler as SP

    # the collector's older objects (what the earlier phases left) are
    # frozen for the phase: a full collection over them stalls every host
    # thread (the watchers' too) for longer than a launch's done-stamp
    # margin (0.43 s in one full run of this script on an H100)
    gc.collect()
    gc.freeze()
    cfg = dataclasses.replace(tllama.PRESETS["1b"], attn_impl="flash")
    L = cfg.n_layers
    opt = tts.default_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)
    stream = np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(DRIVER_BATCHES + DRIVER_SECOND,
                                 TRAIN_BATCH, TRAIN_SEQ + 1))

    def host(lo, hi):
        return ({"tokens": stream[i]} for i in range(lo, hi))

    def init():
        return tts.init_state(
            cfg, opt, generator=torch.Generator(device=DEV).manual_seed(0),
            device=DEV)

    def feed(lo, hi):
        return iter_device_batches(host(lo, hi), stack=DRIVER_K,
                                   prefetch_batches=2, device=DEV)

    def driver():
        drv = StepDriver(cfg, opt, steps_per_launch=DRIVER_K, device=DEV)
        events = LaunchEvents(torch, drv._multi)
        drv._multi = events.run
        return drv, events

    # 1. the plain loop: the reference
    params, state = init()
    step = tts.make_train_step(cfg, opt, device=DEV)
    torch.cuda.synchronize()
    zero_launches(flash)
    ref_losses, ref_events = [], []
    t0 = time.perf_counter()
    for i in range(DRIVER_BATCHES):
        params, state, m = step(params, state, {"tokens": stream[i]})
        ref_losses.append(m["loss"])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ref_events.append(ev)
    torch.cuda.synchronize()
    ref_wall_s = time.perf_counter() - t0
    ref_launches = read_launches(flash)
    ref_losses = [float(x) for x in ref_losses]
    ref_steady_ms = ref_events[1].elapsed_time(ref_events[-1]) \
        / (DRIVER_BATCHES - 2)
    ref_params = tts._leaves(params)
    del state, step, m
    torch.cuda.empty_cache()

    # 2. the driver, profiled, with an async checkpoint after launch 1
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    disk_free = shutil.disk_usage(ckpt_dir).free
    try:
        params, state = init()
        drv, events = driver()
        ckpt = Checkpoint.from_directory(ckpt_dir)
        metrics, save = [], {}

        def on_launch(m):
            metrics.append(m)
            if drv.launches == 1:
                t = time.perf_counter()
                ckpt.save_pytree(drv.state, blocking=False)
                save["call_s"] = time.perf_counter() - t

        f = feed(0, DRIVER_BATCHES)
        SP.reset()
        SP.enable()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(flash)
        try:
            t0 = time.perf_counter()
            params, state, _ = drv.run(params, state, f, on_launch=on_launch)
            torch.cuda.synchronize()
            drv_wall_s = time.perf_counter() - t0
        finally:
            SP.disable()
        drv_launches = read_launches(flash)
        peak = torch.cuda.max_memory_allocated()
        drv_losses = flat_losses(metrics)
        rec_summary = wait_recorder(drv.recorder)
        rec_launches = drv.recorder.launches()
        align = done_alignment(rec_launches, events.calls)
        prof = SP.summary("train")
        counts = (drv.steps, drv.launches, drv.compile_count())
        drv_report = drv.report()
        feed_report, feed_verdict = f.report(), f.verdict()
        drv_launch_ms = events.device_ms()
        drv_steady_ms = drv_launch_ms[1] / DRIVER_K
        final = {k: t.clone() for k, t in tts._leaves(params).items()}
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(drv_losses, ref_losses))
        param_rel = rel_diff(torch, final, ref_params)
        del ref_params

        # 3. a second run of 8 batches, profiler off: no new signature;
        # 2 fused launches back to back, the recorder's done stamps and a
        # synchronize-based shadow watcher's against CUDA events
        n_rec, n_calls = len(rec_launches), len(events.calls)
        shadow = SyncShadow(torch)
        events.shadow = shadow
        zero_launches(flash)
        # what can hold the host while a launch runs: the collector's
        # passes and the allocator's device frees (each a device sync)
        gc_pauses, gc_t0 = [], {}

        def on_gc(phase, info):
            if phase == "start":
                gc_t0["t"] = time.perf_counter()
            elif "t" in gc_t0:
                gc_pauses.append([info["generation"],
                                  time.perf_counter() - gc_t0.pop("t")])

        alloc_keys = ("num_device_alloc", "num_device_free",
                      "num_alloc_retries", "num_sync_all_streams")
        alloc0 = [torch.cuda.memory_stats().get(k, 0) for k in alloc_keys]
        gc.callbacks.append(on_gc)
        try:
            params, state, _ = drv.run(params, state,
                                       feed(DRIVER_BATCHES,
                                            DRIVER_BATCHES + DRIVER_SECOND))
            torch.cuda.synchronize()
        finally:
            gc.callbacks.remove(on_gc)
            events.shadow = None
            shadow.close()
        second_host = {
            "gc_pauses_generation_s": gc_pauses,
            "allocator_delta": {k: torch.cuda.memory_stats().get(k, 0) - a
                                for k, a in zip(alloc_keys, alloc0)}}
        second_launches = read_launches(flash)
        wait_recorder(drv.recorder)
        second = drv.recorder.launches()[n_rec:]
        align_second = done_alignment(second, events.calls, shadow, n_calls)
        second_counts = (drv.steps, drv.launches, drv.compile_count())
        second_ms = events.device_ms()[-1] / DRIVER_K
        queued = queued_ahead_alignment(torch)
        drv.recorder.close()
        del params, state, drv, events, f

        # 4. the checkpoint: written off the step path; load and resume
        t = time.perf_counter()
        ckpt.wait_pending()
        wait_s = time.perf_counter() - t
        written = dict(ckpt.last_save)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        params, state = ckpt.load_pytree(device=DEV)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        loaded_count = state["count"]
        drv2, _ = driver()
        metrics = []
        zero_launches(flash)
        params, state, _ = drv2.run(params, state, feed(DRIVER_K,
                                                        DRIVER_BATCHES),
                                    on_launch=metrics.append)
        torch.cuda.synchronize()
        resume_launches = read_launches(flash)
        resume_losses = flat_losses(metrics)
        resume_loss_rel = max(abs(a - b) / abs(b) for a, b in
                              zip(resume_losses, drv_losses[DRIVER_K:]))
        resume_param_rel = rel_diff(torch, tts._leaves(params), final)
        resume_counts = (drv2.steps, drv2.launches)
        drv2.recorder.close()
        del params, state, drv2, final
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    tokens_per_step, seq = TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ
    step_flops = tokens_per_step * tflops.train_flops_per_token(cfg, seq)
    speed = lambda ms: {"step_ms": ms,
                        "tokens_per_s": tokens_per_step * 1e3 / ms,
                        "mfu": tflops.mfu(step_flops, ms / 1e3)}
    emit({"phase": "driver", "config": "1b, 22 layers, fp32 params, bf16 "
                                       "compute, attn flash, remat",
          "optimizer": dataclasses.asdict(opt),
          "feed": {"batches": DRIVER_BATCHES, "batch": [TRAIN_BATCH,
                                                        TRAIN_SEQ + 1],
                   "stack": DRIVER_K, "prefetch_batches": 2,
                   "report": feed_report, "verdict": feed_verdict},
          "losses": {"plain_loop": ref_losses, "driver": drv_losses,
                     "resumed": resume_losses},
          "loss_max_rel_diff_vs_plain": loss_rel,
          "param_max_rel_diff_vs_plain": param_rel,
          "resumed_loss_max_rel_diff": resume_loss_rel,
          "resumed_param_max_rel_diff": resume_param_rel,
          "bitwise_equal": {"driver_vs_plain": loss_rel == param_rel == 0,
                            "resumed_vs_uninterrupted":
                                resume_loss_rel == resume_param_rel == 0},
          "rel_tol": DRIVER_REL_TOL,
          "steps_launches_compile_count": counts,
          "second_run": {"steps_launches_compile_count": second_counts,
                         "launches": second_launches,
                         "recorder_done_vs_events": align_second,
                         "sync_watcher_misses_launch_1": not align_second[
                             0]["sync_watcher_within_margin"]
                         if align_second else None,
                         "host": second_host, **speed(second_ms)},
          "resume": {"checkpoint_count": loaded_count,
                     "steps_launches": resume_counts,
                     "launches": resume_launches},
          "plain_loop": {"wall_s": ref_wall_s,
                         "wall_ms_per_step": ref_wall_s * 1e3
                         / DRIVER_BATCHES, **speed(ref_steady_ms),
                         "steady": "device clock, steps 3-10"},
          "driver_run": {"wall_s": drv_wall_s,
                         "wall_ms_per_step": drv_wall_s * 1e3
                         / DRIVER_BATCHES, **speed(drv_steady_ms),
                         "steady": "device clock, fused launch 2",
                         "launch_device_ms": drv_launch_ms},
          "mfu_peak": "989e12 bf16 dense (H100 SXM)",
          "driver_report": drv_report,
          "recorder_summary": rec_summary,
          "recorder_done_vs_events": align,
          "recorder_done_vs_events_note": "profiled: the profiler fences "
                                          "each launch, which aligns any "
                                          "watcher; the second run's test",
          "queued_ahead": queued,
          "step_profiler_summary": prof,
          "checkpoint": {"save_call_s_on_step_path": save.get("call_s"),
                         "fence_wait_s": wait_s,
                         "writer_s": written.get("write_s"),
                         "bytes": written.get("bytes"),
                         "writer_gb_per_s": written["bytes"]
                         / written["write_s"] / 1e9 if written else None,
                         "load_s": load_s,
                         "load_gb_per_s": written["bytes"] / load_s / 1e9
                         if written else None,
                         "snapshot": "device clone on the compute stream",
                         "disk_free_bytes": disk_free},
          "peak_mem_bytes": peak,
          "launches": {"plain_loop": ref_launches, "driver": drv_launches,
                       "second_run": second_launches,
                       "resume": resume_launches}})
    finite = all(np.isfinite(x) for x in ref_losses + drv_losses
                 + resume_losses)
    check(finite, f"driver: non-finite loss {drv_losses} {resume_losses}")
    check(abs(ref_losses[0] - np.log(cfg.vocab_size)) <= FIRST_LOSS_MARGIN,
          f"driver: first loss {ref_losses[0]} not within "
          f"{FIRST_LOSS_MARGIN} of ln {cfg.vocab_size}")
    check(len(drv_losses) == DRIVER_BATCHES and loss_rel <= DRIVER_REL_TOL
          and param_rel <= DRIVER_REL_TOL,
          f"driver vs plain loop: losses {loss_rel}, params {param_rel} "
          f"(tol {DRIVER_REL_TOL})")
    check(len(resume_losses) == DRIVER_BATCHES - DRIVER_K
          and loaded_count == DRIVER_K
          and resume_loss_rel <= DRIVER_REL_TOL
          and resume_param_rel <= DRIVER_REL_TOL,
          f"resumed vs uninterrupted: count {loaded_count}, losses "
          f"{resume_loss_rel}, params {resume_param_rel}")
    check(counts == (DRIVER_BATCHES, 4, 1),
          f"driver (steps, launches, compile_count) {counts}, want (10, 4, 1)")
    check(second_counts == (DRIVER_BATCHES + DRIVER_SECOND,
                            4 + DRIVER_SECOND // DRIVER_K, 1),
          f"second run (steps, launches, compile_count) {second_counts}")
    check(resume_counts == (DRIVER_BATCHES - DRIVER_K, 3),
          f"resumed driver (steps, launches) {resume_counts}")
    for leg, got, steps in (("plain loop", ref_launches, DRIVER_BATCHES),
                            ("driver", drv_launches, DRIVER_BATCHES),
                            ("second run", second_launches, DRIVER_SECOND),
                            ("resume", resume_launches,
                             DRIVER_BATCHES - DRIVER_K)):
        check_launches(got, f"driver {leg}", L, steps)
    fused = rec_summary["launches_total"]
    check(fused == 2 and len(rec_launches) == 2
          and len(second) == DRIVER_SECOND // DRIVER_K,
          f"recorder: {fused} then {len(second)} fused launches recorded, "
          f"want 2 then {DRIVER_SECOND // DRIVER_K}")
    for a in align + align_second:
        check(a["device_compute_s"] > 0 and abs(
            a["recorder_done_s"] - a["event_done_s"]) <= a["margin_s"],
              f"recorder done stamp vs CUDA events: {a}")
    check(queued["device_compute_s"] > 0
          and abs(queued["recorder_done_s"] - queued["event_done_s"])
          <= queued["margin_s"]
          and abs(queued["sync_watcher_done_s"] - queued["event_done_s"])
          > queued["margin_s"],
          f"queued ahead: the recorder must stamp launch 1 at its own end "
          f"and a synchronize-based watcher must not: {queued}")
    check(prof.get("launch_source") == "recorder" and prof["launches"] == 2,
          f"step profiler's train launches do not join the recorder's: "
          f"{prof}")
    gc.unfreeze()
    return drv_launches


def moe_train_phase(torch, np, tts, tflops, flash):
    """MoE training at full width and depth: ``8x410m`` (24 layers, 8
    experts, top 2), fp32 params, bf16 compute, flash, remat, the driver
    phase's optimizer; first the 2-layer gradients against plain
    attention, then ``StepDriver(steps_per_launch=4)`` over 8 seeded
    batches [4, 2049] through the device feed, then, outside the count, one
    profiled step (device busy, the MoE FFN's and AdamW's shares).

    The gradient check routes the flash run's tokens to the experts the
    plain run chose (``moe._route`` recorded, then replayed call by call):
    a bf16 rounding of attention's output flips a near-tied top-2 choice
    for some tokens, and a flipped token changes its own hidden state, and
    the lm_head and embedding rows it alone touches, by O(1). The free
    run's differences and flips are reported beside it, and a free run in
    fp32 compute, where attention's rounding flips few or no choices."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ray_tpu_torch.data.iterator import iter_device_batches
    from ray_tpu_torch.models import moe as tmoe
    from ray_tpu_torch.train.driver import StepDriver

    cfg = dataclasses.replace(tmoe.PRESETS[MOE_TRAIN_PRESET],
                              attn_impl="flash")
    L = cfg.n_layers
    opt = tts.default_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)

    # the 2-layer gradient check, flash against plain attention: free, and
    # with the flash run's expert choices pinned to the plain run's
    base = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device=DEV).manual_seed(12)
    params = tmoe.init_params(base, generator=gen, device=DEV,
                              dtype=torch.float32)
    tokens = torch.randint(0, base.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           device=DEV, generator=gen)
    leaves = tts._leaves(params)
    route = tmoe._route
    choices = {}

    def grads_of(impl, record=None, replay=None, dtype=None):
        calls = []

        def routed(cfg_, toks, layer):
            probs, idx = route(cfg_, toks, layer)
            if replay is not None:
                idx = replay[len(calls)]
            calls.append(idx)
            return probs, idx

        tmoe._route = routed
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            loss = tmoe.lm_loss(params, {"tokens": tokens},
                                dataclasses.replace(
                                    base, attn_impl=impl, compute_dtype=dtype
                                    or base.compute_dtype))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            tmoe._route = route
            for t in leaves.values():
                t.requires_grad_(False)
        if record is not None:
            choices[record] = calls
        return float(loss), dict(zip(leaves, grads))

    # the free run again in fp32 compute, where attention's rounding is too
    # small to flip a choice: what the bf16 free gap owes to re-routing
    f32 = torch.float32
    runs = {"plain": grads_of("xla", record="plain"),
            "flash_free": grads_of("flash", record="flash"),
            "flash_pinned": grads_of("flash", replay=choices["plain"]),
            "plain_fp32": grads_of("xla", record="plain_fp32", dtype=f32),
            "flash_free_fp32": grads_of("flash", record="flash_fp32",
                                        dtype=f32)}
    against = {"flash_free": "plain", "flash_pinned": "plain",
               "flash_free_fp32": "plain_fp32"}
    grad_rel = {run: {name: float((runs[run][1][name] - r).abs().max()
                                  / r.abs().max())
                      for name, r in runs[ref][1].items()}
                for run, ref in against.items()}
    # token selections that differ, per routing call (forward and remat
    # recompute of each layer) of each free run
    flips = {run: [int((a != b).any(-1).sum()) for a, b in
                   zip(choices[run], choices[ref])]
             for run, ref in (("flash", "plain"),
                              ("flash_fp32", "plain_fp32"))}
    grad_finite = all(bool(torch.isfinite(g).all())
                      for _, gs in runs.values() for g in gs.values())
    grad_loss = {run: loss for run, (loss, _) in runs.items()}
    del params, leaves, runs, choices
    torch.cuda.empty_cache()

    # the driver at full depth
    params, state = tts.init_state(
        cfg, opt, generator=torch.Generator(device=DEV).manual_seed(0),
        device=DEV)
    stream = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(MOE_TRAIN_BATCHES, TRAIN_BATCH,
                                 TRAIN_SEQ + 1))
    drv = StepDriver(cfg, opt, steps_per_launch=DRIVER_K, device=DEV)
    events = LaunchEvents(torch, drv._multi)
    drv._multi = events.run
    f = iter_device_batches(({"tokens": b} for b in stream), stack=DRIVER_K,
                            prefetch_batches=2, device=DEV)
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(flash)
    t0 = time.perf_counter()
    params, state, _ = drv.run(params, state, f, on_launch=metrics.append)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches(flash)
    peak = torch.cuda.max_memory_allocated()
    losses = flat_losses(metrics)
    counts = (drv.steps, drv.launches, drv.compile_count())
    launch_ms = events.device_ms()
    step_ms = launch_ms[-1] / DRIVER_K
    rec_summary = wait_recorder(drv.recorder)
    drv.recorder.close()

    # one profiled step, outside the count
    step = tts.make_train_step(cfg, opt, device=DEV)
    moe_ffn, update = tmoe._moe_ffn, tts.AdamW.update

    def traced_ffn(*a, **kw):
        with record_function("moe_ffn"):
            return moe_ffn(*a, **kw)

    def traced_update(self, *a, **kw):
        with record_function("adamw"):
            return update(self, *a, **kw)

    tmoe._moe_ffn, tts.AdamW.update = traced_ffn, traced_update
    try:
        step(params, state, {"tokens": stream[0]})
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            step(params, state, {"tokens": stream[1]})
            ev[1].record()
            torch.cuda.synchronize()
        profiled_ms = ev[0].elapsed_time(ev[1])
    finally:
        tmoe._moe_ffn, tts.AdamW.update = moe_ffn, update
    cuda = torch.autograd.DeviceType.CUDA
    per_kernel = {e.key: e.self_device_time_total / 1e3
                  for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0
                  and e.key not in ("moe_ffn", "adamw")}
    busy = sum(per_kernel.values())
    ranges = {name: sum(e.device_time_total / 1e3 for e in prof.key_averages()
                        if e.key == name and e.device_type != cuda)
              for name in ("moe_ffn", "adamw")}
    flash_ms = {kind: sum(t for n, t in per_kernel.items() if kind in n)
                for kind in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                             "flash_bwd_dkv_kernel")}
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    del params, state, drv, events, f, step
    torch.cuda.empty_cache()

    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    step_flops = tokens_per_step * tflops.train_flops_per_token(
        cfg, TRAIN_SEQ)
    # at uniform routing the aux loss E * sum_e(f_e * p_e) is 1 a layer
    want_first = float(np.log(cfg.vocab_size)) + cfg.router_aux_coef
    emit({"phase": "moe_train",
          "config": f"{MOE_TRAIN_PRESET}, {L} layers, {cfg.n_experts} "
                    f"experts top {cfg.top_k}, fp32 params, bf16 compute, "
                    f"attn flash, remat",
          "params": cfg.num_params(), "active_params": cfg.active_params(),
          "optimizer": dataclasses.asdict(opt),
          "grad_check": {"config": "8x410m, n_layers=2, fp32 params, "
                                   "bf16 compute (the _fp32 runs: fp32)",
                         "loss": grad_loss, "rel_diff_by_leaf": grad_rel,
                         "routing_flips_by_call": flips,
                         "tokens_per_call": TRAIN_BATCH * TRAIN_SEQ,
                         "checked": "flash_pinned",
                         "rel_tol": GRAD_REL_TOL, "finite": grad_finite},
          "batches": MOE_TRAIN_BATCHES, "batch": [TRAIN_BATCH,
                                                  TRAIN_SEQ + 1],
          "losses": losses, "first_loss_expected": want_first,
          "steps_launches_compile_count": counts,
          "wall_s": wall_s, "launch_device_ms": launch_ms,
          "step_ms": step_ms, "steady": "device clock, last fused launch",
          "tokens_per_s": tokens_per_step * 1e3 / step_ms,
          "step_flops_active": step_flops,
          "mfu_active": tflops.mfu(step_flops, step_ms / 1e3),
          "mfu_peak": "989e12 bf16 dense (H100 SXM)",
          "recorder_summary": rec_summary,
          "profiled_step": {
              "device_busy_ms": busy if busy else "not measured",
              "device_clock_ms": profiled_ms,
              "device_idle_share": 1 - busy / profiled_ms if busy
              else "not measured",
              "moe_ffn_ms": ranges["moe_ffn"] or "not measured",
              "moe_ffn_share_of_busy": ranges["moe_ffn"] / busy
              if busy and ranges["moe_ffn"] else "not measured",
              "adamw_ms": ranges["adamw"] or "not measured",
              "adamw_share_of_busy": ranges["adamw"] / busy
              if busy and ranges["adamw"] else "not measured",
              "flash_ms": flash_ms,
              "top_kernels_ms": [[n[:80], t] for n, t in top]},
          "peak_mem_bytes": peak, "launches": launches})
    pinned = max(grad_rel["flash_pinned"].values())
    check(grad_finite and pinned <= GRAD_REL_TOL,
          f"2-layer 8x410m grads, routing pinned: flash vs plain rel diff "
          f"{pinned} > {GRAD_REL_TOL}")
    check(len(losses) == MOE_TRAIN_BATCHES and all(np.isfinite(losses)),
          f"moe_train: losses {losses}")
    check(abs(losses[0] - want_first) <= FIRST_LOSS_MARGIN,
          f"moe_train: first loss {losses[0]} not within "
          f"{FIRST_LOSS_MARGIN} of ln {cfg.vocab_size} + "
          f"{cfg.router_aux_coef}")
    check(losses[-1] < losses[0], f"moe_train: loss did not fall: {losses}")
    check(counts == (MOE_TRAIN_BATCHES, 2, 1),
          f"moe_train (steps, launches, compile_count) {counts}")
    check_launches(launches, "moe_train", L, MOE_TRAIN_BATCHES)
    return launches


# ------------------------------------------------------------ phases 13-15

RLHF_PRESET = "1b"
RLHF_CFG = {"num_prompts": 8, "prompt_len": 128, "max_new_tokens": 128,
            "max_slots": 8, "decode_stride": 8, "num_epochs": 2}
RLHF_ITERS = 3
RLHF_CHECK_TOKENS = 8
RLHF_ROLE_METHODS = (("generator", "generate", "generate"),
                     ("reward", "score", "score_reward"),
                     ("reference", "logprobs", "score_ref"),
                     ("learner", "update", "update"),
                     ("learner", "ship_weights", "ship"),
                     ("generator", "sync_weights", "sync_swap"))


def rlhf_expected_launches(n_layers, epochs, admitted, decode_steps):
    """Each role phase's launches by kernel in one iteration: a batch-1
    prefill a prompt and a decode kernel a layer a decode step; one forward
    a layer for each scoring model; the learner's old-logprob forward,
    then per epoch a forward and its remat recompute a layer and one dq
    and dkv a layer; nothing while the weights move."""
    L = n_layers
    zero = {"flash_fwd_tcb": 0, "flash_fwd_dec": 0, "flash_fwd_simt": 0,
            "flash_dq": 0, "flash_dkv": 0, "flash_bwd": 0}
    want = {phase: dict(zero) for _, _, phase in RLHF_ROLE_METHODS}
    want["generate"].update(flash_fwd_tcb=L * admitted,
                            flash_fwd_dec=L * decode_steps)
    want["score_reward"]["flash_fwd_tcb"] = L
    want["score_ref"]["flash_fwd_tcb"] = L
    want["update"].update(flash_fwd_tcb=L + 2 * L * epochs,
                          flash_dq=L * epochs, flash_dkv=L * epochs,
                          flash_bwd=L * epochs)
    for phase in want.values():
        phase["flash_fwd"] = sum(phase[f"flash_fwd_{k}"]
                                 for k in ("tcb", "dec", "simt"))
    return want


def rlhf_phase(torch, np, tllama, TG, tts, tflops, flash):
    """The RLHF pipeline at 1b, full width and depth: three iterations of
    generate, score, update and sync on one card, each role phase's
    launches counted by kernel."""
    from ray_tpu_torch.rl.rlhf import pipeline as tpipe

    cfg = dataclasses.replace(tllama.PRESETS[RLHF_PRESET], attn_impl="flash")
    rc = tpipe.RLHFConfig(preset=cfg, **RLHF_CFG)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = tpipe.RLHFPipeline(rc, device=DEV)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mem_built = torch.cuda.memory_allocated()
    ref_before = {k: t.clone() for k, t in
                  tts._leaves(pipe.reference._params).items()}
    roles = {"generator": pipe.generator, "reward": pipe.reward,
             "reference": pipe.reference, "learner": pipe.learner}
    by_phase = {}

    def counted(fn, phase):
        def run(*a, **kw):
            before = read_launches(flash)
            out = fn(*a, **kw)
            after = read_launches(flash)
            by_phase[phase] = {k: after[k] - before[k] for k in after}
            return out
        return run

    for role, method, phase in RLHF_ROLE_METHODS:
        setattr(roles[role], method, counted(getattr(roles[role], method),
                                             phase))
    results, phase_launches, want_launches, engine_steps = [], [], [], []
    zero_launches(flash)
    try:
        for _ in range(RLHF_ITERS):
            e0 = pipe.generator.engine.stats()
            by_phase.clear()
            results.append(pipe.run_iteration())
            e1 = pipe.generator.engine.stats()
            steps = e1["decode_steps"] - e0["decode_steps"]
            admitted = e1["admitted"] - e0["admitted"]
            engine_steps.append({"decode_steps": steps,
                                 "admitted": admitted})
            phase_launches.append(dict(by_phase))
            want_launches.append(rlhf_expected_launches(
                cfg.n_layers, rc.num_epochs, admitted, steps))
        launches = read_launches(flash)
        peak = torch.cuda.max_memory_allocated()
        for role, method, _ in RLHF_ROLE_METHODS:
            delattr(roles[role], method)
        ref_unchanged = all(torch.equal(t, ref_before[k]) for k, t in
                            tts._leaves(pipe.reference._params).items())
        del ref_before
        # the generator's greedy continuation of one prompt against
        # batch-1 generate on the learner's params cast to bf16
        prompt = np.random.default_rng(1).integers(
            1, cfg.vocab_size, rc.prompt_len).astype(np.int64)
        check_out = pipe.generator.generate([list(prompt)],
                                            RLHF_CHECK_TOKENS)
        engine_toks = [int(t) for t in
                       check_out["sequences"][0][rc.prompt_len:]]
        bf16 = tpipe._copy_tree(pipe.learner.get_params(),
                                torch.device(DEV), cfg.compute_dtype)
        # the engine's cache length, so the decode kernel splits its keys
        # as the engine's does
        ref_toks = TG.generate(bf16, prompt[None], cfg,
                               max_new_tokens=RLHF_CHECK_TOKENS,
                               max_len=rc.max_len, device=DEV)[0].tolist()
        del bf16
        summary = pipe.stats()["recorder"]
    finally:
        pipe.shutdown()
    seq = rc.prompt_len + rc.max_new_tokens - 1
    epoch_flops = tflops.train_step_flops(cfg, rc.num_prompts, seq)
    # the old-logprob forward is a third of a train step (2N of 6N, and
    # the attention term's forward third)
    update_flops = (rc.num_epochs + 1.0 / 3.0) * epoch_flops
    per_iter = []
    for r, steps in zip(results, engine_steps):
        upd_s = r["phases_actor_s"]["update"]
        per_iter.append({
            "iteration": r["iteration"], "loss": r["loss"],
            "kl_mean": r["kl_mean"], "reward_mean": r["reward_mean"],
            "phases_s": r["phases_s"], "phases_actor_s": r["phases_actor_s"],
            "tokens_generated": r["tokens_generated"],
            "generate_tok_s": r["generate_tok_s"], **steps,
            "update_tokens_per_s": rc.num_epochs * rc.num_prompts * seq
            / upd_s,
            "update_mfu": tflops.mfu(update_flops, upd_s),
            "sync_bytes": r["sync_bytes"], "sync_s": r["sync_s"],
            "swap_drain_s": r["swap_drain_s"], "receipt": r["receipt"],
            "weights_version": r["weights_version"],
            "decoded_version": r["decoded_version"],
            "staleness": r["staleness"],
            "bubble_fraction": r.get("bubble_fraction"),
            "coverage": r.get("coverage")})
    emit({"phase": "rlhf", "config": f"{RLHF_PRESET}, {cfg.n_layers} "
                                     "layers, fp32 masters, bf16 compute, "
                                     "attn flash, remat; generator bf16",
          "rlhf_config": {**RLHF_CFG, "iterations": RLHF_ITERS,
                          "lr": rc.lr, "kl_coeff": rc.kl_coeff,
                          "clip_param": rc.clip_param},
          "build_s": build_s, "mem_after_build_bytes": mem_built,
          "peak_mem_bytes": peak, "iterations": per_iter,
          "update_flops": update_flops,
          "mfu_peak": "989e12 bf16 dense (H100 SXM)",
          "recorder": {k: summary.get(k) for k in (
              "bubble_fraction", "coverage", "role_busy_frac",
              "role_idle_frac", "actor_s", "driver_s", "tax_s",
              "staleness", "overhead_frac", "receipt_last")},
          "launches": launches, "launches_by_iteration": phase_launches,
          "reference_bit_unchanged": ref_unchanged,
          "greedy_check": {"engine": engine_toks, "generate": ref_toks,
                           "weights_version":
                           check_out["weights_version"]}})
    losses = [r["loss"] for r in results]
    check(all(np.isfinite(losses)), f"non-finite RLHF loss: {losses}")
    check(results[0]["kl_mean"] == 0.0,
          f"iteration 1 kl_mean {results[0]['kl_mean']}, want exactly 0 "
          f"(reference and learner hold the same weights)")
    check(results[1]["kl_mean"] != 0.0,
          "iteration 2 kl_mean is 0: the reference tracks the learner")
    check(ref_unchanged, "the reference's params changed")
    for a, b in zip(results, results[1:]):
        check(a["weights_version"] == b["decoded_version"],
              f"iteration {b['iteration']} decoded version "
              f"{b['decoded_version']}, the sync before it shipped "
              f"{a['weights_version']}")
    check(all(r["staleness"] == 0 for r in results),
          f"staleness {[r['staleness'] for r in results]}")
    check(check_out["weights_version"] == results[-1]["weights_version"],
          "the check prompt did not decode under the last sync's weights")
    check(engine_toks == ref_toks,
          f"generator {engine_toks} != generate on the learner's params "
          f"{ref_toks}")
    for i, (got, want) in enumerate(zip(phase_launches, want_launches)):
        for phase, w in want.items():
            g = {k: got[phase][k] for k in w}
            check(g == w, f"iteration {i + 1} {phase}: launches {g}, "
                          f"want {w}")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches


ANAKIN_ITERS, ANAKIN_PROFILED = 50, 5


def op_counter(torch):
    """A dispatch mode counting every operator call beneath autograd (the
    backward's included): each one launches the device's kernels for it,
    so an iteration with a fixed program calls the same number."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return OpCount()


def anakin_phase(torch, np, flash):
    """The fused PPO iteration (AnakinConfig's defaults): 50 iterations,
    each metric read back between iterations; then operator calls counted
    in each of a few iterations, and device kernels under the profiler."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.rl.anakin import AnakinConfig, AnakinRunner

    cfg = AnakinConfig()
    runner = AnakinRunner(cfg, device=DEV)
    zero_launches(flash)
    runner.train(1)                       # warm: builds the GEMM plans
    runner.block()
    t0 = time.perf_counter()
    metrics = [runner.train(1) for _ in range(ANAKIN_ITERS)]
    runner.block()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner.train(10)                      # no host read between these
    runner.block()
    fused_s = time.perf_counter() - t0
    ops = []
    for _ in range(ANAKIN_PROFILED):
        with op_counter(torch) as count:
            runner.train(1)
        ops.append(count.n)
    runner.block()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = []
    for _ in range(ANAKIN_PROFILED):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            runner.train(1)
            runner.block()
        kernels.append(Counter(e.name for e in prof.events()
                               if e.device_type == cuda))
    launches = read_launches(flash)
    episodes = [m["episodes_done"] for m in metrics]
    last = kernels[-1]
    emit({"phase": "anakin", "config": dataclasses.asdict(cfg),
          "iterations": ANAKIN_ITERS,
          "env_steps_per_s_read_each_iteration":
          ANAKIN_ITERS * cfg.env_steps_per_iter / loop_s,
          "env_steps_per_s_10_unread": 10 * cfg.env_steps_per_iter / fused_s,
          "iteration_ms": loop_s * 1e3 / ANAKIN_ITERS,
          "ops_per_iteration": ops,
          "device_kernels_per_iteration": [sum(k.values())
                                           for k in kernels],
          # by name, where a profiled iteration's kernels differ from the
          # last one's
          "device_kernel_diffs": [
              {n: k[n] - last[n] for n in set(k) | set(last)
               if k[n] != last[n]} for k in kernels[:-1]],
          "episodes_done_first_10": episodes[:10],
          "episodes_done_last_10": episodes[-10:],
          "last_metrics": metrics[-1],
          "compile_count": runner.compile_count(),
          "flash_launches": launches})
    check(runner.compile_count() == 1,
          f"compile_count {runner.compile_count()}, want 1")
    check(all(np.isfinite(v) for m in metrics for v in m.values()),
          "non-finite Anakin metric")
    check(len(set(ops)) == 1 and ops[0] > 0,
          f"operator calls per iteration differ: {ops}")
    check(all(sum(k.values()) > 0 for k in kernels),
          "no device kernel in a profiled iteration")
    check(all(v == 0 for v in launches.values()),
          f"a flash kernel launched in the fused PPO iteration: {launches}")


VIT_PRESET, VIT_BATCH, VIT_STEPS, VIT_LR = "b16", 64, 10, 1e-3


def vit_toy_images(np, n, size, seed=0):
    """tests/test_model_vit.py's 2-class toy at ``size``: the class is
    which half of the image is brighter."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.int32)
    imgs[labels == 1, :size // 2] += 1.0
    imgs[labels == 0, size // 2:] += 1.0
    return imgs, labels


def vit_phase(torch, np, tts, tflops, flash):
    """ViT-B/16 at 224 px: 10 constant-Adam steps on the toy task, then a
    profiled one."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import vit as tvit

    cfg = tvit.PRESETS[VIT_PRESET]
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = tvit.init_params(cfg, generator=gen, device=DEV)
    opt = tts.Adam(VIT_LR)
    state = opt.init(params)
    imgs, labels = vit_toy_images(np, VIT_BATCH, cfg.image_size)
    batch = {"images": torch.from_numpy(imgs).to(DEV),
             "labels": torch.from_numpy(labels).to(DEV)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(flash)
    losses, events = [], []
    for _ in range(VIT_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss, grads = tts.value_and_grad(
            lambda p: tvit.cls_loss(p, batch, cfg), params)
        opt.update(params, grads, state)
        del grads
        ev[1].record()
        losses.append(float(loss))
        events.append(ev)
    launches = read_launches(flash)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in events]
    med_ms = float(np.median(step_ms[2:]))
    flops = tflops.vit_step_flops(cfg, VIT_BATCH)
    # where a step's device time goes: one more step under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, grads = tts.value_and_grad(
            lambda p: tvit.cls_loss(p, batch, cfg), params)
        opt.update(params, grads, state)
        del grads
        torch.cuda.synchronize()
    per_kernel = device_kernel_ms(torch, prof, 1)
    busy = sum(per_kernel.values())
    gemm_ms = sum(t for n, t in per_kernel.items()
                  if "gemm" in n.lower() or "nvjet" in n.lower())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "vit", "config": f"{VIT_PRESET} ({cfg.num_params()} "
                                    f"params), {cfg.image_size} px, fp32 "
                                    "masters, bf16 compute, remat, "
                                    "constant Adam",
          "batch": VIT_BATCH, "lr": VIT_LR, "losses": losses,
          "step_event_ms": step_ms, "median_step_ms_steps_3_to_10": med_ms,
          "images_per_s": VIT_BATCH * 1e3 / med_ms, "step_flops": flops,
          "mfu": tflops.mfu(flops, med_ms / 1e3),
          "mfu_peak": "989e12 bf16 dense (H100 SXM)",
          "peak_mem_bytes": peak, "flash_launches": launches,
          "profiled_step": {
              "device_busy_ms": busy if busy else "not measured",
              "device_idle_share": 1 - busy / med_ms if busy else
              "not measured",
              "gemm_ms": gemm_ms, "device_kernels": sum(
                  1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
              "top_kernels_ms": [[n[:80], t] for n, t in top]}})
    check(all(np.isfinite(losses)), f"non-finite ViT loss: {losses}")
    check(losses[-1] < losses[0], f"ViT loss did not fall: {losses}")
    check(all(v == 0 for v in launches.values()),
          f"a flash kernel launched in ViT: {launches}")
    del params, state, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- mesh

MESH_STEPS, MESH_DRIVER_K = 8, 4
MESH_REL_TOL = 1e-5   # loss and grad_norm, mesh step against plain step


def timed_steps(torch, step, params, state, batch, n):
    """``n`` steps: losses, grad norms, host ms a step (to the loss's read)
    and device ms a step (CUDA events around the call)."""
    losses, norms, host_ms, events = [], [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        params, state, m = step(params, state, batch)
        ev[1].record()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events.append(ev)
    torch.cuda.synchronize()
    return (params, state, losses, norms, host_ms,
            [a.elapsed_time(b) for a, b in events])


def mesh_phase(torch, np, tllama, tts, tflops, flash, smi):
    """The 1b train step through a one-rank mesh (``mesh``): NCCL with
    world 1 through a ``file://`` store, ``auto_mesh(1)``,
    ``init_sharded_state`` at full width and depth (every leaf a DTensor
    with the rules' placements), 8 steps of ``make_train_step(mesh=...)``
    on the train phase's seeded [4, 2049] batch against 8 plain steps
    from a copy of the same params, 4 steps through
    ``StepDriver(mesh=..., steps_per_launch=4)`` from the same init, a
    sharded checkpoint of the state round-tripped bit-equal, each op of
    the collective group API once, and the process group torn down."""
    import shutil
    import tempfile

    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.driver import StepDriver

    cfg = dataclasses.replace(tllama.PRESETS["1b"], attn_impl="flash")
    L = cfg.n_layers
    opt = tts.default_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {"phase": "mesh", "nvidia_smi": smi,
           "config": "1b, 22 layers, fp32 params, bf16 compute, attn "
                     "flash, remat; one-rank mesh",
           "batch": [TRAIN_BATCH, TRAIN_SEQ + 1]}
    try:
        col.bootstrap_torch_distributed(
            1, 0, "mesh", "nccl" if DEV == "cuda" else "gloo",
            timeout_s=300, init_method=f"file://{tmp}/store")
        mesh, _ = tts.auto_mesh(1, device_type=DEV)
        plan = tts.compile_plan(cfg, mesh)

        def init():
            gen = torch.Generator(device=DEV).manual_seed(0)
            params, state = tts.init_sharded_state(cfg, mesh, opt,
                                                   generator=gen)
            # the train phase's batch: the same generator after the init
            tokens = torch.randint(0, cfg.vocab_size,
                                   (TRAIN_BATCH, TRAIN_SEQ + 1),
                                   generator=gen, device=DEV)
            return params, state, {"tokens": tokens}

        t0 = time.perf_counter()
        params, state, batch = init()
        torch.cuda.synchronize()
        out["init_sharded_state_s"] = time.perf_counter() - t0
        rules = tllama.sharding_rules()
        cm = plan.compute_mesh
        misplaced = [k for k, v in tts._leaves(params).items()
                     if not isinstance(v, DTensor) or v.placements !=
                     sharding.placements(rules.spec_for(k), cm, v.ndim)]
        misplaced += [f"mu/{k}" for k, v in state["mu"].items()
                      if v.placements != tts._leaves(params)[k].placements]
        out["compute_mesh"] = str(cm)
        out["placements"] = {k: str(v.placements) for k, v in
                             tts._leaves(params).items()}
        check(not misplaced, f"leaves off the rules' placements: "
                             f"{misplaced}")

        # the reference: plain steps from a copy of the same params
        plain = tllama._unflatten({k: v.to_local().clone() for k, v in
                                   tts._leaves(params).items()})
        (_, _, ref_losses, ref_norms, plain_ms,
         plain_dev_ms) = timed_steps(torch, tts.make_train_step(
             cfg, opt, device=DEV), plain, opt.init(plain), batch,
             MESH_STEPS)
        del plain
        torch.cuda.empty_cache()

        # the path: 8 mesh steps, then 4 through the driver, counted
        step = tts.make_train_step(cfg, opt, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        zero_launches(flash)
        (params, state, losses, norms, mesh_ms,
         mesh_dev_ms) = timed_steps(torch, step, params, state, batch,
                                    MESH_STEPS)
        step_launches = read_launches(flash)
        peak = torch.cuda.max_memory_allocated()
        del params, state
        torch.cuda.empty_cache()
        params, state, batch = init()
        drv = StepDriver(cfg, opt, mesh=mesh, steps_per_launch=MESH_DRIVER_K)
        drv_metrics = []
        params, state, _ = drv.run(params, state,
                                   iter([batch] * MESH_DRIVER_K),
                                   on_launch=drv_metrics.append)
        torch.cuda.synchronize()
        launches = read_launches(flash)
        drv.recorder.close()
        drv_losses = flat_losses(drv_metrics)

        # outside the count: one profiled mesh step (device busy share)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            float(m["loss"])
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(device_kernel_ms(torch, prof, 1).values())

        # a sharded checkpoint of the 1b state, round-tripped
        ckpt = Checkpoint(f"{tmp}/ckpt")
        tree = {"params": params, "mu": state["mu"], "nu": state["nu"],
                "count": state["count"]}
        t0 = time.perf_counter()
        ckpt.save_pytree(tree, "state")
        save_s = time.perf_counter() - t0
        where = {"params": {k: v.placements for k, v in
                            tts._leaves(params).items()},
                 "mu": {k: v.placements for k, v in state["mu"].items()},
                 "nu": {k: v.placements for k, v in state["nu"].items()}}
        t0 = time.perf_counter()
        back = ckpt.load_pytree("state", where, mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        unequal = []
        for part in ("params", "mu", "nu"):
            got = tts._leaves(back[part])
            unequal += [f"{part}/{k}" for k, v in
                        tts._leaves(tree[part]).items()
                        if not (isinstance(got[k], DTensor) and torch.equal(
                            got[k].to_local(), v.to_local()))]
        check(not unequal and back["count"] == tree["count"],
              f"checkpoint round trip differs: {unequal}")
        nbytes = ckpt.last_save["bytes"]
        del back, tree

        # each op of the group API once, on a one-member NCCL group
        col.init_collective_group(1, 0, "smoke")
        x = torch.arange(6.0, device=DEV)
        got = {"allreduce": col.allreduce(x, "smoke", "max"),
               "reducescatter": col.reducescatter(x, "smoke"),
               "allgather": col.allgather(x, "smoke")[0],
               "broadcast": col.broadcast(x, 0, "smoke")}
        col.barrier("smoke")
        try:
            col.send(x, 0, "smoke")
            self_send = "sent"
        except ValueError as e:
            self_send = str(e)
        stats = col.group_stats("smoke")
        col.destroy_collective_group("smoke")
        check(all(torch.equal(v, x) and v.data_ptr() != x.data_ptr()
                  for v in got.values()) and self_send ==
              "cannot send to self",
              f"collectives on one member: {got}, self send {self_send}")
        del params, state
    finally:
        col.clear_rendezvous("mesh")
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

    rel = lambda a, b: abs(a - b) / abs(b)
    gap = max(max(rel(a, b) for a, b in zip(losses, ref_losses)),
              max(rel(a, b) for a, b in zip(norms, ref_norms)))
    drv_gap = max(rel(a, b) for a, b in zip(drv_losses, ref_losses))
    tokens_per_step, seq = tts._batch_tokens(batch)
    step_flops = tokens_per_step * tflops.train_flops_per_token(cfg, seq)
    med = lambda xs: float(np.median(xs[2:]))
    out.update({
        "losses": losses, "grad_norms": norms,
        "plain_losses": ref_losses, "plain_grad_norms": ref_norms,
        "max_rel_gap_vs_plain": gap, "bit_equal_to_plain":
            losses == ref_losses and norms == ref_norms,
        "driver_losses": drv_losses, "driver_max_rel_gap": drv_gap,
        "driver_counts": [drv.steps, drv.launches],
        "mesh_step_ms": mesh_ms, "plain_step_ms": plain_ms,
        "mesh_step_event_ms": mesh_dev_ms, "plain_step_event_ms":
            plain_dev_ms,
        "median_step_ms_steps_3_to_8": {"mesh": med(mesh_ms),
                                        "plain": med(plain_ms)},
        "mesh_host_cost_ms": med(mesh_ms) - med(plain_ms),
        "mfu": {"mesh": tflops.mfu(step_flops, med(mesh_ms) / 1e3),
                "plain": tflops.mfu(step_flops, med(plain_ms) / 1e3)},
        "mfu_peak": "989e12 bf16 dense (H100 SXM)",
        "profiled_mesh_step": {
            "wall_ms": prof_wall_ms,
            "device_busy_ms": busy if busy else "not measured",
            "device_busy_share": busy / prof_wall_ms if busy else
            "not measured"},
        "peak_mem_bytes": peak,
        "checkpoint": {"bytes": nbytes, "save_s": save_s, "load_s": load_s},
        "collectives": {"self_send": self_send, "stats": stats},
        "launches_mesh_steps": step_launches, "launches": launches})
    emit(out)
    check(gap <= MESH_REL_TOL and drv_gap <= MESH_REL_TOL,
          f"mesh step off the plain step: loss/grad_norm gap {gap}, "
          f"driver {drv_gap} (tolerance {MESH_REL_TOL})")
    check(abs(ref_losses[0] - np.log(cfg.vocab_size)) <= FIRST_LOSS_MARGIN,
          f"first loss {ref_losses[0]} not within {FIRST_LOSS_MARGIN} of "
          f"ln {cfg.vocab_size}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"mesh losses not finite and falling: {losses}")
    check([drv.steps, drv.launches] == [MESH_DRIVER_K, 1],
          f"driver ran {drv.steps} steps in {drv.launches} launches")
    for name, per_step in (("flash_fwd_tcb", 2 * L), ("flash_dq", L),
                           ("flash_dkv", L)):
        check(step_launches[name] == per_step * MESH_STEPS
              and launches[name] == per_step * (MESH_STEPS + MESH_DRIVER_K),
              f"{name}: {step_launches[name]} launches in {MESH_STEPS} mesh "
              f"steps, {launches[name]} with the driver's {MESH_DRIVER_K}; "
              f"want exactly {per_step} a step")
    return launches


PHASES = ("kernel", "bwd", "integration", "grad", "serve", "llm", "spec",
          "moe", "train", "driver", "moe_train", "rlhf", "anakin", "vit",
          "mesh")


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
        launches["serve"], launches["serve_kv"] = serve_phase(
            torch, np, tllama, TG, ContinuousEngine, flash)
    if "llm" in only:
        launches["llm"] = llm_phase(torch, np, TG, flash)
    if "spec" in only:
        launches["spec"] = spec_phase(torch, np, tllama, TG, flash)
    if "moe" in only:
        launches["moe"] = moe_phase(torch, np, TG, flash)
    if "train" in only:
        launches["train"] = train_phase(torch, np, tllama, tts, tflops,
                                        flash)
    if "driver" in only:
        launches["driver"] = driver_phase(torch, np, tllama, tts, tflops,
                                          flash)
    if "moe_train" in only:
        launches["moe_train"] = moe_train_phase(torch, np, tts, tflops,
                                                flash)
    if "rlhf" in only:
        launches["rlhf"] = rlhf_phase(torch, np, tllama, TG, tts, tflops,
                                      flash)
    if "anakin" in only:
        anakin_phase(torch, np, flash)
    if "vit" in only:
        vit_phase(torch, np, tts, tflops, flash)
    if "mesh" in only:
        launches["mesh"] = mesh_phase(torch, np, tllama, tts, tflops, flash,
                                      smi)
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
