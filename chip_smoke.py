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
   update's 255-row forward at 1b, a pipeline's one-row microbatch of the
   1b train batch, and the ring's 512-row chunks of it at offsets 512 and
   -512) and at
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
   TFLOP/s fp32, bytes at 3.35 TB/s), which no time may be under;
3. the two backward kernels (dq, dkv) against their plain versions the
   same way, at the 1b train step's shape (b 4, s 2048, 32/4 heads, d 64),
   at 8x410m's (16/16 heads of 64), at the RLHF update's (b 8, s 255,
   32/4 heads of 64), at 7b's d 128, at a pipeline's one-row microbatch
   of the 1b train batch, at two ring chunks of it handed their queries'
   global (o, lse) (one fully masked: zero shares; one fully seen) and
   at small cases cut at
   the edges of their tiles, with
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
   each driven by ``poisson_load`` at 4 requests/s for 6 s (seed 0, 16
   in flight) with prompts of the serve lengths and 32 new tokens, through
   ``__call__`` on an asyncio loop thread; no request may fail, each
   stream has 32 in-vocab tokens and its first equals batch-1
   ``generate``, launches exactly as the admissions, decode steps and
   batches give; rps, tok/s, latency and TTFT p50/p99, shed, peak memory
   and the prefix-cache captures' copy time for both;
8. speculative decode (``spec``): the 7b target with itself and with the
   1b preset as the draft (k 4; b 1, and b 4 for the 1b draft; 256-token
   prompts, 32 new): rounds, acceptance, ms a token against plain
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
   2 epochs, one iteration (``RLHF_ITERS``; the actors phase carries the
   depth: with one iteration the checks across iterations run there);
   iteration 1's KL exactly 0 (and iteration 2's
   not), the reference's params bit-unchanged, every sync's version
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
15. the on-policy RL stack (``rl``), one process on the card: the
   ``cartpole-ppo`` tuned example's config and stop values (2 runners x 8
   envs x 64 steps, up to 60 iterations, stop at a return of 150)
   through ``run_train``, whose best ``episode_return_mean`` must exceed
   100 (JAX's ``tests/test_rl.py:150``), with seconds an iteration split
   into sampling and updates and env-steps/s; ``cartpole-impala`` and
   ``cartpole-pg`` 10 iterations, A2C, APPO and PPO on Pendulum 5 each:
   env steps an iteration exact, metrics finite, params (Pendulum's
   ``log_std`` too) moved; a PPO update of the Catalog's Nature CNN
   (84x84x4, 6 actions, 256 frames): loss and gradients against the CPU
   within ``RL_CNN_REL_TOL``, the median of 10 updates and peak memory;
   ``bench_fused_vs_host()`` at its defaults and the device busy share
   of one profiled iteration of each leg; the off-policy, multi-agent,
   model-based, search, population, sequence, slate, bandit and pixel
   families; PPO on ``external://0`` through the policy server, fed by a
   CartPole simulator thread over HTTP (two iterations, JAX's checks,
   the ms of a ``get_action`` round trip); no flash launch;
16. ViT (``vit``): ``b16`` at 224 px, batch 64, fp32 masters, bf16
   compute, remat, 10 constant-Adam steps at 1e-3 on the toy task of
   ``tests/test_model_vit.py``; the loss falls, no flash launch; step ms
   on CUDA events, images/s, MFU, peak memory;
17. multi-GPU placement on one card (``mesh``): NCCL with world 1 through
   a ``file://`` store, ``auto_mesh(1)``, ``init_sharded_state`` of the
   1b preset at full width and depth (every leaf a DTensor with the
   rules' placements), 8 steps of ``make_train_step(mesh=...)`` on the
   train phase's batch against 8 plain steps from a copy of the same
   params (loss and grad_norm within ``MESH_REL_TOL`` a step, the first
   near ln 32000), 4 more through ``StepDriver(mesh=...,
   steps_per_launch=4)`` against the same plain loop, launches exactly
   2L/L/L a step, a sharded checkpoint of the state round-tripped
   bit-equal, each op of the collective group API once on a one-member
   NCCL group, a PPO minibatch through ``Learner(mesh=...)`` against the
   plain ``Learner`` (within ``RL_MESH_TOL``), and the process group torn
   down; mesh and plain step ms
   (the DTensor host cost), the device busy share, peak memory and MFU;
18. sequence and pipeline parallelism on one card (``seqpipe``): the
   ring's loops (``context.ring_forward`` and ``ring_backward``) with
   the 1b train shape's sequence in 4 chunk-ranks rotated in memory, 16
   ``tcb`` and 16 ``flash_vjp_chunk`` calls against one whole-sequence
   forward and backward (``TOL``, ``BWD_REL_TOL``), the 6 dead chunks
   zero, both forms timed; then 1b at full width and depth through a
   one-rank NCCL mesh: 8 ``attn_impl="ring"`` and 3 ``"ulysses"`` steps
   against plain flash steps from the same init (``MESH_REL_TOL``), 4
   GPipe and 4 1F1B steps (``pipeline_axis="pp"``, pp 1, 4
   microbatches) against them (``BWD_REL_TOL``: the microbatches' GEMMs
   round differently), 4 batches of 1F1B through ``StepDriver
   (steps_per_launch=4)``, which runs single steps bit-equal to the 1F1B
   loop; launches exactly as ``seqpipe_launches`` gives, step ms (each
   median leaves out step 1, which warms up), busy share, MFU and peak
   memory of each against the plain step;
19. the tools (``tools``), each tool's ``main`` called in process:
   ``rt profile`` on 1b training ([4, 2048], 5 steps, then 8 at K = 4)
   and on 7b generate, speculative and stream (JAX's defaults), record
   kinds and counts exact, steady MFU in (0, 1], the JSON artifact's
   keys, two ``--torch-trace`` device traces naming the flash kernels, a
   timeline step span a record; kv_bench's leg 1 at 7b (warm hits, first
   tokens against a cold forward wherever the margin clears
   ``WARM_MARGIN_REL_TOL``, cold and warm TTFT p50) and stream_bench's
   leg 1 at 7b (16 streams of 64 tokens, counts exact, tok/s); launches
   exact where the work fixes them;
20. the port's runtime (``cluster``): ``ray_tpu_torch.init()`` with no
   arguments must find one GPU; a ``num_gpus=1`` task sees
   ``CUDA_VISIBLE_DEVICES`` and one device while a CPU task beside it
   imports no torch; the 7b embedding (32000 x 4096 bf16) as a CUDA
   tensor put from here, through a GPU actor and back, bit-equal, timed
   cold and warm; then ``TorchTrainer`` with one GPU worker
   (``FailureConfig(max_failures=1)``, K = 4 from ``FastPathConfig``)
   trains the 1b preset at full width and depth for 12 steps: a
   checkpoint of (params, opt_state) through the session at step 4, one
   ``os._exit`` in the first attempt, the restart resuming at step 4 and
   making two launches, the second warm; after ``shutdown()`` the same
   loop runs here, and the worker's losses must equal it within
   ``CLUSTER_REL_TOL``, its launches exactly 2L/L/L a step (counted in
   the worker, reported with its metrics), its warm step within
   ``CLUSTER_WARM_RATIO`` of the warm step here; cluster start, gang
   start to first report, step ms in the worker and here (cold and
   warm), the report round trip, the checkpoint save and death to first
   report;
21. the serve deployment layer (``deploy``): the port's cluster with its
   one GPU; a streaming GPU task yielding bf16 CUDA tensors, bit-equal to
   the same seeded draws here, and an endless one closed early (the GPU
   it held then takes the next task); ``continuous_llm_app("7b")`` on a
   one-GPU replica (``CUDA_VISIBLE_DEVICES`` pinned) serving
   ``SERVE_PROMPT_LENS`` greedily one at a time through the handle (push,
   then pull) and through HTTP, every token equal to an in-process
   ``ContinuousEngine`` of the same config fed the same way; ``tcb`` and
   ``dec`` counted in the replica; stream_bench's push and pull legs with
   the RPC sweep on that replica against its raw engine leg here, and
   kv_bench's legs 2 and 3 (cuts in ``DEPLOY_CUTS``); cluster start,
   replica start to ready, TTFT p50/p99 through the handle and HTTP,
   ``push_vs_raw_ratio``, RPCs a request by token count, warm against
   cold TTFT;
22. RL on the port's actors (``actors``): the port's cluster with its
   one GPU and a session store sized for one 1b shipment
   (``ACTORS_STORE_BYTES``: each frame is freed once decoded); PPO at ``RL_TUNED_PPO`` on 2 CPU runner
   actors with a ``LearnerGroup`` of 2 learner actors at half a GPU each
   (the gloo host plane): the members bit-equal after every update, the
   first update against two in-process learners on the same shards
   averaging their gradients (``RL_CNN_REL_TOL``); IMPALA at
   cartpole-impala's config on 2 runner actors; then ``RLHFPipeline`` at
   ``RLHF_PRESET`` and ``RLHF_CFG`` with its four roles as GPU actors (a
   quarter of the card each) for 2 iterations: the first iteration's
   sequences exact and its scores, logprobs and learner metrics within
   ``ACTORS_RLHF_REL_TOL`` of the in-process pipeline's (the rlhf
   phase's first iteration), KL exactly 0 then not, staleness 0, every
   sync by push with oid leaves, each role phase's launches counted in
   the role's process and held exactly to ``rlhf_expected_launches``;
   a 1b bf16 tree shipped from the learner's process to the
   generator's by push and by the fallback under chaos ``rpc.drop``,
   leaf-exact on the generator's card; the store's and /dev/shm's used
   bytes back at their level after each of the 4 syncs and no spill
   (every frame freed); cluster start, build and
   iteration seconds, role start, sync bytes and seconds;
23. a ``kernels`` line, and last ``{"ok": true, "device": {...}}``.

Each path (serve, serve_kv, llm, spec, moe, train, driver, moe_train,
rlhf, mesh, seqpipe, tools, cluster, deploy, actors)
zeroes every kernel's launch count
just before it runs and reads them just after (cluster: in its worker;
deploy: in its replica, as the difference of two reads around the path;
actors: in each RLHF role's process around each role phase, summed);
a kernel of the paths that
was not launched fails the run (the float32 CUDA-core forward is on no
path: its entry reports its launches, 0, and its cases).

Every phase prints one JSON line (``rl`` one for each of its parts;
``--jsonl PATH`` also appends them to a file). Any failed check raises:
the script then exits non-zero and never prints the last line.
``--only`` runs a subset of the phases and prints neither of the last
two lines. Without a CUDA device, or
without the ``ray_tpu_torch`` package beside it, it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import json
import os
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


#: the script's start on the host clock; every phase line carries its
#: seconds since (``script_s``), which is how the phases' share of the time
#: limit is read
T_START = time.perf_counter()


def emit(obj):
    line = json.dumps(dict(obj, script_s=time.perf_counter() - T_START))
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
    # a pipeline microbatch of the 1b train batch (4 microbatches of 1 row)
    "pipe_microbatch_1b_b1_s2048": (1, 2048, 2048, 32, 4, 64, True, 0,
                                    "bfloat16"),
    # ring chunks of the 1b train shape cut in 4: one whose keys the
    # queries all see, and one they see none of
    "ring_chunk_1b_offset512": (TRAIN_BATCH, 512, 512, 32, 4, 64, True, 512,
                                "bfloat16"),
    "ring_dead_chunk_1b": (TRAIN_BATCH, 512, 512, 32, 4, 64, True, -512,
                           "bfloat16"),
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
                 "rlhf_1b_s255", "pipe_microbatch_1b_b1_s2048",
                 "ring_chunk_1b_offset512")
# the crossover cases: bf16, d 128, s_k 1024, the rows at the end of the
# keys, one row below and at fwd_tiling's threshold
THRESHOLD_SHAPE = (8, 1024, 32, 32, 128)   # b, sk, hq, hkv, d
# plain versions that hold GBs of fp32 scores: timed eagerly (device-bound
# there), not captured five times into one CUDA graph
EAGER_PLAIN_CASES = ("train_1b_d64_gqa", "train_7b_d128", "train_8x410m",
                     "pipe_microbatch_1b_b1_s2048")


def work(torch, b, sq, sk, hq, hkv, d, causal, offs, dtype):
    """(flops, bytes) the function needs on this run's inputs: every
    visible (query, key) pair costs 4*d FLOPs (QK and PV); o, lse and the
    offsets move once, q once for each row that sees a key, and K/V once
    for each key some row sees."""
    es = torch.finfo(dtype).bits // 8
    if causal:
        rows = torch.arange(sq, device=offs.device)[None, :] + offs[:, None]
        vis = (rows + 1).clamp(min=0, max=sk)                     # [b, sq]
    else:
        vis = torch.full((b, sq), sk, device=offs.device)
    pairs = int(vis.sum()) * hq
    keys = int(vis.amax(dim=1).sum())
    live = int((vis > 0).sum())         # query rows that see a key
    flops = 4.0 * d * pairs
    nbytes = ((live + b * sq) * hq * d * es + b * hq * sq * 4 + b * 4
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
        # a time under the least the card could take means a wrong bound
        check(kernel_ms >= rec["bound_ms"],
              f"flash_fwd {name}: {kernel_ms} ms under its bound "
              f"{rec['bound_ms']}")
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
    # ring steps' chunks at the 1b train shape cut in 4, each with the
    # global (o, lse) of its queries (``ring_global``): one after the
    # queries' own chunk, fully masked at its offset while the lse is
    # finite, so every share must be zero; one before it, every key seen
    "ring_dead_chunk_global_lse": (TRAIN_BATCH, 512, 512, 32, 4, 64, True,
                                   -512, "bfloat16"),
    "ring_live_chunk_global_lse": (TRAIN_BATCH, 512, 512, 32, 4, 64, True,
                                   512, "bfloat16"),
    # a pipeline microbatch of the 1b train batch (4 microbatches of 1 row)
    "pipe_microbatch_1b_b1_s2048": (1, 2048, 2048, 32, 4, 64, True, 0,
                                    "bfloat16"),
}
# cases whose (o, lse) are their queries' global ones, not their own
GLOBAL_LSE_CASES = ("ring_dead_chunk_global_lse",
                    "ring_live_chunk_global_lse")
BWD_HEADLINE_CASE = "train_1b_d64_gqa"   # the shape the train path gives
BWD_LIBRARY_CASES = ("train_1b_d64_gqa", "train_7b_d128", "train_8x410m",
                     "rlhf_1b_s255", "pipe_microbatch_1b_b1_s2048")


def ring_global(torch, flash, q, k, v, off, rnd, causal):
    """(o, lse) of the queries ``q`` of a two-chunk ring whose other chunk
    is (``k``, ``v``) at the relative offset ``off`` (+-sq): over both
    chunks in position order, the queries' own chunk drawn by ``rnd`` and
    seen on its diagonal."""
    k2, v2 = rnd(*k.shape), rnd(*v.shape)
    keys, vals = ((k2, k), (v2, v)) if off < 0 else ((k, k2), (v, v2))
    return flash.flash_fwd(q, torch.cat(keys, 1), torch.cat(vals, 1),
                           max(off, 0), causal=causal)


def bwd_work(torch, b, sq, sk, hq, hkv, d, causal, offs, dtype):
    """(pairs, bytes) of the backward on this run's inputs: visible (query,
    key) pairs over all q heads, and the bytes of each input read once and
    each output written once, per kernel and for the whole backward. A
    query row that sees no key needs none of its inputs but what its
    outputs are made of: dq writes its zero dq and its delta (read from
    o and do); dkv and the whole backward need nothing of it."""
    es = torch.finfo(dtype).bits // 8
    if causal:
        rows = torch.arange(sq, device=offs.device)[None, :] + offs[:, None]
        vis = (rows + 1).clamp(min=0, max=sk)
    else:
        vis = torch.full((b, sq), sk, device=offs.device)
    pairs = int(vis.sum()) * hq
    keys = int(vis.amax(dim=1).sum())          # keys some row sees
    live = int((vis > 0).sum())                # query rows that see a key
    qrow = b * sq * hq * d * es                # o, do, dq: one each
    qlive = live * hq * d * es                 # q, o or do of live rows
    kv = keys * hkv * d * es                   # k or v as read
    kv_out = b * sk * hkv * d * es             # dk or dv as written
    row_f32 = b * hq * sq * 4                  # delta as written
    live_f32 = live * hq * 4                   # lse or delta as read
    return pairs, {
        "dq": qlive + 2 * qrow + 2 * kv + live_f32 + qrow + row_f32,
        "dkv": 2 * qlive + 2 * kv + 2 * live_f32 + 2 * kv_out,
        "bwd": 3 * qlive + 2 * kv + live_f32 + qrow + 2 * kv_out,
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
        o, lse = (ring_global(torch, flash, q, k, v, off, rnd, causal)
                  if name in GLOBAL_LSE_CASES else
                  flash.flash_fwd(q, k, v, offs, **kw))
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
        if bool((offs <= -sq).all()):     # no row sees a key
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
        # a time under the least the card could take means a wrong bound
        check(all(ms[p] >= bounds[p]["bound_ms"] for p in ("dq", "dkv")),
              f"flash backward {name}: {ms} ms under its bounds {bounds}")
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

LLM_RPS, LLM_DURATION_S, LLM_MAX_INFLIGHT = 4.0, 6.0, 16
SPEC_K, SPEC_PROMPT, SPEC_NEW = 4, 256, 32
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
    for 6 s (seed 0, 16 in flight), prompts of SERVE_PROMPT_LENS, 32 new
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
    prompts of 256 tokens, 32 new. Rounds, acceptance and ms per token
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
RLHF_ITERS = 1   # the actors phase carries the depth (2 iterations)
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
    """The RLHF pipeline at 1b, full width and depth: ``RLHF_ITERS``
    iterations of generate, score, update and sync on one card, each
    role phase's launches counted by kernel; the first iteration's
    outputs kept in ``RLHF_FIRST`` for the actors phase."""
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

    outputs = {}

    def counted(fn, phase):
        def run(*a, **kw):
            before = read_launches(flash)
            out = fn(*a, **kw)
            after = read_launches(flash)
            by_phase[phase] = {k: after[k] - before[k] for k in after}
            outputs.setdefault(phase, out)   # the first iteration's
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
        RLHF_FIRST.update(rlhf_first_record(outputs))
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
    if len(results) > 1:   # else the actors phase checks it
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


# ------------------------------------------------------------------ rl

# ray_tpu_torch/rl/tuned_examples/cartpole-ppo.yaml (a copy of JAX's),
# written out so the card needs no PyYAML
RL_TUNED_PPO = {"num_env_runners": 2, "num_envs_per_runner": 8,
                "rollout_fragment_length": 64, "minibatch_size": 128,
                "num_epochs": 4, "lr": 0.0003, "entropy_coeff": 0.01,
                "num_cpus_per_runner": 0.4}
RL_TUNED_PPO_STOP = {"episode_return_mean": 150, "training_iteration": 60}
# the learning threshold of JAX's own PPO test (tests/test_rl.py:150)
RL_LEARN_THRESHOLD = 100.0
# cartpole-impala.yaml and cartpole-pg.yaml; A2C, APPO and PPO on
# Pendulum at their default configs. (name, run, env, config, iterations,
# env steps an iteration)
RL_OTHERS = (
    ("cartpole-impala", "IMPALA", "CartPole-v1",
     {"num_env_runners": 2, "num_envs_per_runner": 8,
      "rollout_fragment_length": 64, "lr": 0.0005, "entropy_coeff": 0.01,
      "num_cpus_per_runner": 0.4}, 10, 2 * 8 * 64),
    ("cartpole-pg", "PG", "CartPole-v1",
     {"num_env_runners": 2, "num_envs_per_runner": 8,
      "rollout_fragment_length": 128, "entropy_coeff": 0.005,
      "num_cpus_per_runner": 0.4}, 10, 2 * 8 * 128),
    ("cartpole-a2c", "A2C", "CartPole-v1", {}, 5, 1 * 8 * 64),
    ("cartpole-appo", "APPO", "CartPole-v1", {}, 5, 2 * 8 * 64),
    ("pendulum-ppo", "PPO", "Pendulum-v1", {}, 5, 1 * 8 * 64))
RL_CNN_BATCH, RL_CNN_UPDATES = 256, 10
# the Nature CNN's loss and gradients on the card against the CPU, max
# |diff| over max |value| per leaf (the contract of the CPU parity tests),
# fp32 with TF32 off: cuDNN's algorithms and the CPU's sum in other
# orders, and a conv weight's gradient sums over every output position of
# the batch (256 x 9 x 9 = 20,736 terms for the second conv)
RL_CNN_REL_TOL = 1e-4


class RLClock:
    """Patches the RL classes while entered: for each ``train()`` call of
    any algorithm (R2D2's and the in-process trainables' too), the host
    seconds spent sampling (``EnvRunner.sample``, the trainables' own
    collection methods), in updates (the Learner's, and each trainable's
    own update method) and in MBMPO's ensemble fit (each timed call ends
    with a device sync, so queued work is charged to the call that
    launched it), the count of updates, the iteration's seconds and its
    result; the first algorithm trained and its params before its first
    iteration. ``outer`` (a class and method) is timed as the iteration
    in place of ``train()``, for loops that call ``step()`` as JAX's
    tests do."""

    def __init__(self, torch, outer=None):
        from ray_tpu_torch.models.convert import params_to_numpy
        from ray_tpu_torch.rl import multi_agent
        from ray_tpu_torch.rl.algorithms import (alphazero, dreamer, es, lc0,
                                                 maddpg, maml, mbmpo, qmix,
                                                 slateq)
        from ray_tpu_torch.rl.algorithms.r2d2 import R2D2
        from ray_tpu_torch.rl.env_runner import EnvRunner
        from ray_tpu_torch.rl.learner import Learner
        from ray_tpu_torch.tune.trainable import Trainable

        self.torch, self.to_numpy = torch, params_to_numpy
        self.iters, self.algo, self.initial = [], None, None
        self._busy = False
        # (class, method, seconds key or None for train(), counts updates)
        self._targets = [(*(outer or (Trainable, "train")), None, False),
                         (EnvRunner, "sample", "sample_s", False),
                         (R2D2, "_collect", "sample_s", False),
                         (multi_agent.MultiAgentPPO, "_rollout", "sample_s",
                          False),
                         (qmix.QMIX, "_collect", "sample_s", False),
                         (maddpg.MADDPG, "_collect", "sample_s", False),
                         (maml.MAML, "_rollout", "sample_s", False),
                         (mbmpo.MBMPO, "_collect_real", "sample_s", False),
                         (dreamer.DreamerV3, "_collect", "sample_s", False),
                         (es._ESWorker, "evaluate", "sample_s", False),
                         (alphazero.AlphaZero, "_self_play_game",
                          "sample_s", False),
                         (lc0.SelfPlayWorker, "play", "sample_s", False),
                         (slateq.SlateQ, "_collect", "sample_s", False),
                         (Learner, "update", "update_s", False),
                         (Learner, "update_minibatch", "update_s", True),
                         (maddpg.MADDPG, "_update_targets", "update_s",
                          False),
                         (maml.MAML, "_meta_update", "update_s", True),
                         (mbmpo.MBMPO, "_meta_step", "update_s", True),
                         (mbmpo.MBMPO, "_fit_ensemble", "fit_s", False),
                         (dreamer.DreamerV3, "_train_step", "update_s",
                          True)]
        self._saved = []

    def _wrap(self, orig, key, counts):
        clock = self

        def timed(obj, *args, **kwargs):
            if key is None:
                if clock.algo is None:
                    clock.algo = obj
                    clock.initial = clock.to_numpy(obj.get_params())
                rec = {"sample_s": 0.0, "update_s": 0.0, "fit_s": 0.0,
                       "updates": 0}
                clock.iters.append(rec)
                t0 = time.perf_counter()
                rec["result"] = orig(obj, *args, **kwargs)
                clock.torch.cuda.synchronize()
                rec["iteration_s"] = time.perf_counter() - t0
                return rec["result"]
            if counts and clock.iters:
                clock.iters[-1]["updates"] += 1
            if clock._busy or not clock.iters:
                return orig(obj, *args, **kwargs)
            clock._busy = True
            t0 = time.perf_counter()
            try:
                return orig(obj, *args, **kwargs)
            finally:
                clock.torch.cuda.synchronize()
                clock.iters[-1][key] += time.perf_counter() - t0
                clock._busy = False

        return timed

    def __enter__(self):
        for cls, name, key, counts in self._targets:
            self._saved.append((cls, name, cls.__dict__.get(name)))
            setattr(cls, name, self._wrap(getattr(cls, name), key, counts))
        return self

    def __exit__(self, *exc):
        for cls, name, own in reversed(self._saved):
            if own is None:
                delattr(cls, name)
            else:
                setattr(cls, name, own)
        self._saved = []


def rl_run(torch, np, rltrain, run, env, config, iters, stop_reward=None):
    """``run_train`` on the card under an ``RLClock``: the clock, the last
    result and the printed log."""
    import io

    out = io.StringIO()
    with RLClock(torch) as clock:
        last = rltrain.run_train(run, env=env, config_json=json.dumps(config),
                                 stop_iters=iters, stop_reward=stop_reward,
                                 out=out, device=DEV)
    return clock, last, out.getvalue()


def rl_summary(np, clock, steps_per_iteration=None):
    """Seconds an iteration split into sampling and updates, env steps/s
    (from the result's ``env_steps_total``, else ``steps_per_iteration``
    an iteration) and the returns."""
    its = clock.iters
    total_s = sum(r["iteration_s"] for r in its)
    if steps_per_iteration is not None:
        steps = steps_per_iteration * len(its)
    else:
        steps = its[-1]["result"]["env_steps_total"] if its else 0
    return {"iterations": len(its),
            "iteration_s": [r["iteration_s"] for r in its],
            "sample_s": [r["sample_s"] for r in its],
            "update_s": [r["update_s"] for r in its],
            "updates": [r["updates"] for r in its],
            "median_iteration_s": float(np.median(
                [r["iteration_s"] for r in its])),
            "median_sample_s": float(np.median([r["sample_s"] for r in its])),
            "median_update_s": float(np.median([r["update_s"] for r in its])),
            "env_steps_total": steps,
            "env_steps_per_s": steps / total_s if total_s else None,
            "episode_return_mean": [r["result"].get("episode_return_mean")
                                    for r in its]}


class FixedDraws:
    """While entered, ``models.normal``, ``models.uniform`` and
    ``models.gumbel`` record their draws (from a CPU generator seeded 0)
    on the first pass and return the recorded draws, moved to ``device``,
    on the ``replay`` pass: the card's update sees the CPU's noise and
    categorical draws."""

    def __init__(self, torch, rlm):
        self.torch, self.rlm, self.draws = torch, rlm, []
        self.gen = torch.Generator().manual_seed(0)
        self._saved = None
        self._replay = None

    def replay(self, device):
        self._replay = (iter(self.draws), device)

    def _take(self, make):
        if self._replay is None:
            d = make()
            self.draws.append(d)
            return d
        it, device = self._replay
        return next(it).to(device)

    def __enter__(self):
        rlm, gen = self.rlm, self.gen
        self._saved = (rlm.normal, rlm.uniform, rlm.gumbel)
        normal, uniform, gumbel = self._saved
        rlm.normal = lambda g, shape: self._take(lambda: normal(gen, shape))
        rlm.uniform = lambda g, shape, low, high: self._take(
            lambda: uniform(gen, shape, low, high))
        rlm.gumbel = lambda g, shape, dtype=None: self._take(
            lambda: gumbel(gen, shape))
        return self

    def __exit__(self, *exc):
        self.rlm.normal, self.rlm.uniform, self.rlm.gumbel = self._saved


def rl_update_vs_cpu(torch, np, name, loss_fn, params, batch):
    """One update's loss and gradients of ``loss_fn`` on the card against
    the CPU on the same params, batch and noise (fp32, TF32 off): max
    |diff| over max |value| per leaf, within RL_CNN_REL_TOL."""
    from ray_tpu_torch.parallel.train_step import value_and_grad
    from ray_tpu_torch.rl import models as rlm

    grads, losses = {}, {}
    with FixedDraws(torch, rlm) as draws:
        for dev in ("cpu", DEV):
            if dev != "cpu":
                draws.replay(torch.device(dev))
            p = rlm.tree_map(lambda t: t.detach().to(dev, copy=True),
                             params)
            b = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in batch.items()}
            (loss, _), g = value_and_grad(lambda q: loss_fn(q, b, None), p,
                                          has_aux=True)
            grads[dev] = {k: v.cpu() for k, v in g.items()}
            losses[dev] = float(loss)
    rel = {k: float((grads[DEV][k] - want).abs().max()
                    / (want.abs().max() + 1e-12)) if want.any()
           else float(grads[DEV][k].abs().max())
           for k, want in grads["cpu"].items()}
    out = {"loss_cpu": losses["cpu"], "loss_device": losses[DEV],
           "noise_draws": len(draws.draws),
           "grad_rel_err_max": max(rel.values()), "grad_rel_err": rel}
    check(abs(losses[DEV] - losses["cpu"])
          <= RL_CNN_REL_TOL * max(1.0, abs(losses["cpu"])),
          f"{name} loss on {DEV} {losses[DEV]} against cpu {losses['cpu']}")
    bad = {k: v for k, v in rel.items() if not v <= RL_CNN_REL_TOL}
    check(not bad, f"{name} gradients on {DEV} against cpu: {bad}")
    return out


def rl_cnn_update(torch, np):
    """A PPO update of the Catalog's Nature CNN module (84x84x4 frames, 6
    actions) on a seeded batch: loss and gradients on the card against
    the same inputs on the CPU, then the median of RL_CNN_UPDATES timed
    ``update_minibatch`` calls and the peak memory."""
    from ray_tpu_torch.parallel.train_step import _leaves
    from ray_tpu_torch.rl import models as rlm
    from ray_tpu_torch.rl.algorithms.ppo import make_ppo_loss
    from ray_tpu_torch.rl.env import EnvSpec
    from ray_tpu_torch.rl.learner import Learner
    from ray_tpu_torch.rl.rl_module import Catalog

    spec = EnvSpec(obs_shape=(84, 84, 4), num_actions=6)
    params = Catalog.build_params(spec, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    n = RL_CNN_BATCH
    batch = {"obs": rng.uniform(0, 1, (n, 84, 84, 4)).astype(np.float32),
             "actions": rng.integers(0, 6, n).astype(np.int32),
             "logp": rng.normal(-1.8, 0.1, n).astype(np.float32),
             "advantages": rng.normal(size=n).astype(np.float32),
             "value_targets": rng.normal(size=n).astype(np.float32)}
    loss_fn = make_ppo_loss(spec, 0.2, 0.5, 0.01)
    vs_cpu = rl_update_vs_cpu(torch, np, "CNN", loss_fn, params, batch)
    learner = Learner(params, loss_fn, 3e-4, grad_clip=0.5, device=DEV)
    dev_batch = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    learner.update_minibatch(dev_batch)          # warm: cuDNN's plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(RL_CNN_UPDATES):
        t0 = time.perf_counter()
        m = learner.update_minibatch(dev_batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"config": "Catalog cnn (Nature stack, 512 features), PPO loss, "
                     "Adam lr 3e-4, clip 0.5, fp32, TF32 off",
           "obs_shape": list(spec.obs_shape), "num_actions": 6, "batch": n,
           "num_params": rlm.num_params(params), **vs_cpu, "update_ms": ms,
           "median_update_ms": float(np.median(ms)),
           "frames_per_s": n * 1e3 / float(np.median(ms)),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "last_loss": float(m["loss"])}
    check(set(_leaves(params)) == set(vs_cpu["grad_rel_err"]),
          "a CNN leaf has no gradient")
    return out


def rl_busy_share(torch, iteration):
    """One profiled ``iteration()`` (after two warm ones): device kernel ms
    against the profiled wall, and against the mean wall of three
    unprofiled iterations (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        iteration()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        iteration()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iteration()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_kernel_ms(torch, prof, 1)
    busy = sum(per_kernel.values())
    cuda = torch.autograd.DeviceType.CUDA
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"iteration_ms_unprofiled": plain_ms,
            "iteration_ms_profiled": wall_ms,
            "device_busy_ms": busy if busy else "not measured",
            "device_busy_share_of_profiled": busy / wall_ms if busy else
            "not measured",
            "device_busy_share_of_unprofiled": busy / plain_ms if busy else
            "not measured",
            "device_kernels": sum(1 for e in prof.events()
                                  if e.device_type == cuda),
            "top_kernels_ms": [[n[:80], t] for n, t in top]}


# the off-policy tuned examples (copies of JAX's yamls under
# ray_tpu_torch/rl/tuned_examples/), written out so the card needs no
# PyYAML. cartpole-dqn runs to its own stop values.
RL_TUNED_DQN = {"num_env_runners": 1, "num_envs_per_runner": 8,
                "rollout_fragment_length": 32, "lr": 0.001,
                "learning_starts": 500, "epsilon_decay_steps": 5000,
                "prioritized_replay": True, "target_update_freq": 200}
RL_TUNED_DQN_STOP = {"episode_return_mean": 130, "training_iteration": 80}
# Neither package learns cartpole-dqn.yaml within its 80 iterations on the
# CPU (seed 0: JAX's best return 17.17, the port's 19.4, both a random
# policy's), so the learning gate is JAX's own DQN test config
# (tests/test_rl_connectors_ope.py:191: up to 40 iterations, stop past
# 120). On the CPU, seed 0, JAX's run reached 129.6 at iteration 32 and
# the port's 123.0 at iteration 38 (both passed 80 by iteration 29). The
# card's exploration draws are neither's, so the gate is 80, below both
# runs and four times a random policy's return (about 20).
RL_DQN_GATE = {"num_env_runners": 2, "num_envs_per_runner": 8,
               "rollout_fragment_length": 32, "lr": 0.0005,
               "minibatch_size": 64, "buffer_size": 50_000,
               "learning_starts": 500, "target_update_freq": 200,
               "epsilon_decay_steps": 8_000, "double_q": True,
               "updates_per_iter": 64, "seed": 0}
RL_DQN_GATE_STOP = {"episode_return_mean": 120, "training_iteration": 40}
RL_DQN_LEARN_THRESHOLD = 80.0
# (name, run, env, config, iterations, env steps an iteration): each runs
# past learning_starts and then at least 5 updating iterations; R2D2's
# buffer reaches its 500 sequences at iteration 15 (CPU, seed 0) and its
# 200th update (the first target sync) comes 13 updating iterations later
RL_OFF_POLICY = (
    ("cartpole-apex-dqn", "APEXDQN", "CartPole-v1",
     {"num_env_runners": 2, "num_cpus_per_runner": 0.4,
      "num_envs_per_runner": 8, "rollout_fragment_length": 64,
      "learning_starts": 500, "updates_per_iter": 32, "minibatch_size": 64,
      "target_update_freq": 100, "lr": 0.001}, 6, 2 * 8 * 64),
    ("pendulum-sac", "SAC", "Pendulum-v1",
     {"num_env_runners": 1, "num_envs_per_runner": 8,
      "rollout_fragment_length": 32, "connectors": ["mean_std_filter"],
      "learning_starts": 1000, "minibatch_size": 256, "lr": 0.001},
     9, 8 * 32),
    ("pendulum-ddpg", "DDPG", "Pendulum-v1",
     {"num_env_runners": 1, "num_envs_per_runner": 8,
      "rollout_fragment_length": 32, "connectors": ["mean_std_filter"],
      "learning_starts": 1000, "minibatch_size": 256,
      "exploration_noise": 0.2}, 9, 8 * 32),
    ("pendulum-td3", "TD3", "Pendulum-v1",
     {"num_env_runners": 1, "num_envs_per_runner": 8,
      "rollout_fragment_length": 32, "connectors": ["mean_std_filter"],
      "learning_starts": 1000, "minibatch_size": 256,
      "exploration_noise": 0.2}, 9, 8 * 32),
    ("pendulum-apex-ddpg", "APEXDDPG", "Pendulum-v1",
     {"num_env_runners": 4, "num_envs_per_runner": 4,
      "rollout_fragment_length": 32, "learning_starts": 1000,
      "minibatch_size": 256, "updates_per_iter": 16,
      "apex_sigma_base": 0.4, "apex_sigma_alpha": 3.0}, 7, 4 * 4 * 32),
    ("masked-cartpole-r2d2", "R2D2", "CartPoleNoVel-v0",
     {"num_env_runners": 1, "num_envs_per_runner": 8, "seq_len": 20,
      "burn_in": 5, "learning_starts": 500, "updates_per_iter": 16},
     29, 8 * 64))
RL_OFFLINE_ITERS = 3
# CQL's probe: tests/test_rl_extras.py:174's one-step dataset and its
# training (2 iterations of 200 updates, cql_alpha 10)
RL_CQL_PROBE = {"updates_per_iter": 200, "minibatch_size": 256,
                "cql_alpha": 10.0}


def target_pairs(params):
    """(online, target) names of an algorithm's params tree."""
    pairs = [(k, f"{k}_target") for k in params if f"{k}_target" in params]
    return pairs + ([("q", "target")] if "target" in params else [])


def rl_off_policy_checks(np, clock, per_iter, updating_min=None):
    """The checks of one run: env steps an iteration as configured, every
    metric finite, online params moved, every target moved (polyak or
    sync) and sharing no storage with its online net; with
    ``updating_min``, at least that many iterations updated."""
    from ray_tpu_torch.parallel.train_step import _leaves

    totals = [r["result"]["env_steps_total"] for r in clock.iters]
    steps = [b - a for a, b in zip([0] + totals, totals)]
    finite = all(np.isfinite(v) for r in clock.iters
                 for k, v in r["result"].items()
                 if isinstance(v, float) and k != "episode_return_mean")
    params = clock.algo.get_params()
    before, after = _leaves(clock.initial), _leaves(
        clock.to_numpy(params))
    pairs = target_pairs(params)
    targets = {t for _, t in pairs}
    moved = {"params": any(np.any(after[k] != before[k]) for k in after
                           if k.split("/")[0] not in targets)}
    shared = []
    for online, tgt in pairs:
        moved[tgt] = any(np.any(after[k] != before[k]) for k in after
                         if k.split("/")[0] == tgt)
        on, tg = _leaves(params[online]), _leaves(params[tgt])
        shared += [f"{tgt}/{k}" for k in on
                   if on[k].untyped_storage().data_ptr()
                   == tg[k].untyped_storage().data_ptr()]
    updating = sum(1 for r in clock.iters if "loss" in r["result"]
                   or "td_abs_mean" in r["result"])
    out = {"env_steps_per_iteration": steps, "all_metrics_finite": finite,
           "params_moved": moved, "target_storage_shared": shared,
           "updating_iterations": updating}
    name = type(clock.algo).__name__
    if per_iter is not None:
        check(steps == [per_iter] * len(steps),
              f"{name}: env steps per iteration {steps}, want {per_iter}")
    check(finite, f"{name}: a non-finite metric")
    check(all(moved.values()), f"{name}: params did not move {moved}")
    check(not shared, f"{name}: a target shares storage: {shared}")
    if updating_min is not None:
        check(updating >= updating_min,
              f"{name}: {updating} updating iterations, want "
              f">= {updating_min}")
    return out


def rl_update_ms(clock):
    """Host ms a minibatch update (its launches and the reads that wait on
    it, synced at the end of each timed call) over the whole run."""
    n = sum(r["updates"] for r in clock.iters)
    return sum(r["update_s"] for r in clock.iters) * 1e3 / n if n else None


def rl_json_data(np, data):
    """A dataset as the JSON lists ``run_train``'s config takes."""
    return {k: np.asarray(v).tolist() for k, v in data.items()}


def rl_off_policy(torch, np, rltrain, smi):
    """The off-policy families on the card through ``run_train``: the
    tuned DQN to its stop values and JAX's DQN gate config until it
    learns, the other six tuned examples, the offline family on the DQN
    and SAC runs' transitions, CQL's out-of-distribution probe, and one
    update of each new loss against the CPU."""
    from ray_tpu_torch.rl.algorithms.dqn import replay_minibatch

    t_part = time.perf_counter()
    algos = {}
    # 1. cartpole-dqn to its stop values, then the learning gate
    for part, config, stop in (("tuned_dqn", RL_TUNED_DQN, RL_TUNED_DQN_STOP),
                               ("dqn_gate", RL_DQN_GATE, RL_DQN_GATE_STOP)):
        clock, last, log = rl_run(torch, np, rltrain, "DQN", "CartPole-v1",
                                  config, stop["training_iteration"],
                                  stop["episode_return_mean"])
        summary = rl_summary(np, clock)
        returns = [r for r in summary["episode_return_mean"]
                   if r is not None and np.isfinite(r)]
        best = max(returns) if returns else float("nan")
        per_iter = (max(1, config["num_env_runners"])
                    * config["num_envs_per_runner"]
                    * config["rollout_fragment_length"])
        rec = {"phase": "rl", "part": part, "nvidia_smi": smi,
               "config": config, "stop": stop,
               "best_episode_return_mean": best,
               "update_ms": rl_update_ms(clock), **summary,
               **rl_off_policy_checks(np, clock, per_iter),
               "last_result": last, "log_tail": log[-400:]}
        if part == "tuned_dqn":
            rec["source"] = "ray_tpu_torch/rl/tuned_examples/cartpole-dqn.yaml"
            algos["DQN"] = clock.algo
            # the busy share of one updating iteration of a fresh run
            busy = rltrain.get_algorithm_config("DQN").update_from_dict(
                dict(config)).build(device=DEV)
            for _ in range(2):   # 512 steps: past learning_starts
                busy.train()
            rec["iteration_profiled"] = rl_busy_share(torch, busy.train)
            busy.stop()
        else:
            rec["source"] = "tests/test_rl_connectors_ope.py:191"
            rec["learn_threshold"] = RL_DQN_LEARN_THRESHOLD
        emit(rec)
        if part == "dqn_gate":
            check(best > RL_DQN_LEARN_THRESHOLD,
                  f"DQN did not learn CartPole: best return {best} <= "
                  f"{RL_DQN_LEARN_THRESHOLD}")
    # 2. the other tuned examples
    for name, run, env, config, iters, per_iter in RL_OFF_POLICY:
        clock, last, _ = rl_run(torch, np, rltrain, run, env, config, iters)
        algos[run] = clock.algo
        emit({"phase": "rl", "part": name, "nvidia_smi": smi, "run": run,
              "env": env, "config": config, "update_ms": rl_update_ms(clock),
              **rl_summary(np, clock),
              **rl_off_policy_checks(np, clock, per_iter, updating_min=5),
              "last_result": last})
    # 3. the offline family on the transitions the card's runs made
    dqn_buf, sac_buf = algos["DQN"].buffer, algos["SAC"].buffer
    n = len(dqn_buf)
    cartpole = {k: v[:n] for k, v in dqn_buf._storage.items()}
    # the runner's rows are t-major over 8 envs: row i is env i % 8
    cartpole["env_ids"] = np.arange(n) % RL_TUNED_DQN["num_envs_per_runner"]
    n = len(sac_buf)
    pendulum = {k: v[:n] for k, v in sac_buf._storage.items()}
    for run, env, data in (("BC", "CartPole-v1", cartpole),
                           ("MARWIL", "CartPole-v1", cartpole),
                           ("CQL", "Pendulum-v1", pendulum),
                           ("CRR", "Pendulum-v1", pendulum)):
        t0 = time.perf_counter()
        clock, last, _ = rl_run(torch, np, rltrain, run, env,
                                {"offline_data": rl_json_data(np, data)},
                                RL_OFFLINE_ITERS)
        algos[run] = clock.algo
        emit({"phase": "rl", "part": f"offline_{run.lower()}",
              "nvidia_smi": smi, "run": run, "env": env,
              "rows": len(data["rewards"]), "wall_s": time.perf_counter() - t0,
              **rl_summary(np, clock),
              **rl_off_policy_checks(np, clock, None), "last_result": last})
    # CQL's Q on the SAC run's own actions against uniform random ones
    # (recorded, not gated), then the probe of JAX's test
    rng = np.random.default_rng(0)
    cql = algos["CQL"]
    sac_probe = {"q_dataset_actions": float(cql.q_value(
        pendulum["obs"], pendulum["actions"]).mean()),
        "q_uniform_actions": float(cql.q_value(
            pendulum["obs"], rng.uniform(-2, 2, pendulum["actions"].shape)
            .astype(np.float32)).mean())}
    obs = rng.uniform(-1, 1, size=(4000, 3)).astype(np.float32)
    opt = np.tanh(obs[:, :1])
    acts = (opt + 0.1 * rng.standard_normal((4000, 1))).astype(np.float32)
    probe_data = {"obs": obs, "actions": acts,
                  "rewards": -np.square(acts - opt).sum(-1).astype(
                      np.float32),
                  "next_obs": obs, "dones": np.ones(4000, bool)}
    probe = rltrain.get_algorithm_config("CQL").update_from_dict(
        dict(RL_CQL_PROBE, offline_data=probe_data)).build(device=DEV)
    for _ in range(2):
        m = probe.train()
    pobs = rng.uniform(-1, 1, size=(256, 3)).astype(np.float32)
    in_dist = np.tanh(pobs[:, :1])
    q_in = float(probe.q_value(pobs, in_dist).mean())
    q_ood = float(probe.q_value(pobs, np.full_like(in_dist, 1.9)).mean())
    q_rand = float(probe.q_value(pobs, rng.uniform(
        -2, 2, in_dist.shape).astype(np.float32)).mean())
    emit({"phase": "rl", "part": "cql_probe", "nvidia_smi": smi,
          "source": "tests/test_rl_extras.py:187", "config": RL_CQL_PROBE,
          "q_dataset_actions": q_in, "q_edge_actions": q_ood,
          "q_uniform_actions": q_rand, "last_result": m,
          "on_sac_transitions": sac_probe})
    check(np.isfinite(m["bellman_loss"]), "CQL probe: non-finite loss")
    check(q_in > q_ood and q_in > q_rand,
          f"CQL probe: Q on dataset actions {q_in} not above edge {q_ood} "
          f"and uniform {q_rand} actions")
    # 4. one update of each new loss on the card against the CPU
    grads = {}
    for run in ("DQN", "DDPG", "TD3", "SAC", "R2D2", "MARWIL", "CQL",
                "CRR"):
        algo = algos[run]
        if run in ("DQN", "DDPG", "TD3", "SAC"):
            batch, _ = replay_minibatch(algo.buffer, algo.config)
            if run in ("DDPG", "TD3"):
                batch["do_actor"] = np.ones(1, np.float32)
        elif run == "R2D2":
            batch = algo.buffer.sample(algo.config.minibatch_size)
        elif run == "MARWIL":
            batch = {k: v[:algo.config.minibatch_size]
                     for k, v in algo._data.items()}
        else:
            batch = algo._minibatch(algo.config.minibatch_size)
        grads[run] = rl_update_vs_cpu(
            torch, np, run, algo.learner._loss_fn, algo.get_params(), batch)
    emit({"phase": "rl", "part": "off_policy_losses_vs_cpu",
          "nvidia_smi": smi, "tolerance": RL_CNN_REL_TOL, "losses": grads,
          "off_policy_part_s": time.perf_counter() - t_part})


# ---- the multi-agent and model-based families, JAX's own configs and
# seeds as they are. IPPO: tests/test_multi_agent.py:14-24, until reward
# per step passes 0.6 (:41-47, up to 26 iterations)
RL_IPPO = {"env": "coordination", "num_envs_per_runner": 16,
           "rollout_fragment_length": 64, "lr": 3e-3, "num_epochs": 4,
           "minibatch_size": 256}
RL_IPPO_ITERS, RL_IPPO_THRESHOLD = 26, 0.6
# QMIX: tests/test_rl_new_algos.py:129-148 (seed 3, up to 20 iterations,
# best reward per step above 0.5)
RL_QMIX_GATE = {"num_envs_per_runner": 16, "rollout_fragment_length": 32,
                "learning_starts": 256, "epsilon_decay_steps": 3_000,
                "updates_per_iter": 48, "hidden": [64], "seed": 3}
RL_QMIX_ITERS, RL_QMIX_THRESHOLD = 20, 0.5
# the tuned examples (copies of JAX's yamls under
# ray_tpu_torch/rl/tuned_examples/), written out so the card needs no
# PyYAML. coordination-qmix: 128 rows an iteration, updates from the 4th
# (512 >= 500), 5 updating iterations in 8
RL_QMIX_YAML = {"num_envs_per_runner": 8, "rollout_fragment_length": 16,
                "learning_starts": 500, "updates_per_iter": 32}
RL_QMIX_YAML_ITERS = 8
# spread-maddpg: 400 rows an iteration, so every iteration updates
RL_MADDPG_YAML = {"num_envs_per_runner": 16, "rollout_fragment_length": 25,
                  "learning_starts": 400, "minibatch_size": 128,
                  "updates_per_iter": 64, "noise_decay_steps": 4000}
RL_MADDPG_ITERS = 4   # the yaml runs 10; cut for the script's time limit
# MAML: the default config (seed 0), tests/test_pg_maml.py:72-89
RL_MAML_ITERS, RL_MAML_GAIN = 30, 0.05
RL_MBMPO_YAML = {"ensemble_size": 5, "real_steps_per_iter": 400,
                 "model_epochs": 5, "imag_horizon": 16,
                 "meta_steps_per_iter": 8}
RL_MBMPO_ITERS = 3
# cartpole-dreamerv3 at its full widths: 128 steps an iteration, updates
# from the 8th (1,024 >= 1,000): 3 updating iterations in 10 (cut from 17
# for the script's time limit)
RL_DREAMER_YAML = {"num_envs_per_runner": 8, "rollout_fragment_length": 16,
                   "learning_starts": 1000, "updates_per_iter": 8}
RL_DREAMER_ITERS = 10
# tests/test_dreamer.py:9-20 and :37-54, the world-model check: rew_loss
# below 0.2x its first value, cont_loss and recon_loss below theirs
RL_DREAMER_SMALL = {"num_envs_per_runner": 4, "rollout_fragment_length": 16,
                    "learning_starts": 128, "updates_per_iter": 8,
                    "batch_seqs": 4, "deter_dim": 64, "embed_dim": 64,
                    "hidden": [64]}
RL_DREAMER_SMALL_ITERS, RL_DREAMER_REW_RATIO = 30, 0.2


def rl_finite_moved(np, clock):
    """Every float metric of the run finite (episode returns aside) and
    the params moved from their values before the first iteration."""
    from ray_tpu_torch.parallel.train_step import _leaves

    finite = all(np.isfinite(v) for r in clock.iters
                 for k, v in r["result"].items()
                 if isinstance(v, float) and k != "episode_return_mean")
    before = _leaves(clock.initial)
    after = _leaves(clock.to_numpy(clock.algo.get_params()))
    moved = any(np.any(after[k] != before[k]) for k in after)
    name = type(clock.algo).__name__
    check(finite, f"{name}: a non-finite metric")
    check(moved, f"{name}: params did not move")
    return {"all_metrics_finite": finite, "params_moved": moved}


def rl_targets_moved(np, clock, pairs, expect_moved=True):
    """Each (online, target) pair of the run's params: the target moved
    (or, with ``expect_moved`` false, did not: no sync yet) and shares no
    storage with its online net."""
    from ray_tpu_torch.parallel.train_step import _leaves

    before = _leaves(clock.initial)
    params = clock.algo.get_params()
    after = _leaves(clock.to_numpy(params))
    out = {}
    for online, tgt in pairs:
        on, tg = _leaves(params[online]), _leaves(params[tgt])
        out[tgt] = {
            "moved": any(np.any(after[k] != before[k]) for k in after
                         if k.split("/")[0] == tgt),
            "shared": [k for k in on if on[k].untyped_storage().data_ptr()
                       == tg[k].untyped_storage().data_ptr()]}
        check(out[tgt]["moved"] == expect_moved,
              f"{tgt} moved {out[tgt]['moved']}, want {expect_moved}")
        check(not out[tgt]["shared"],
              f"{tgt} shares storage: {out[tgt]['shared']}")
    return out


def rl_part(np, clock, last, smi, name, launches, **extra):
    """One part's record: timing split, ms an update, env steps/s, the
    run's last result and the flash launches it made."""
    rec = {"phase": "rl", "part": name, "nvidia_smi": smi,
           "update_ms": rl_update_ms(clock),
           **rl_summary(np, clock, extra.pop("steps_per_iteration", None)),
           **extra, "last_result": last, "flash_launches": launches}
    check(all(v == 0 for v in launches.values()),
          f"{name}: a flash kernel launched {launches}")
    emit(rec)
    return rec


def launch_delta_since(flash, before):
    now = read_launches(flash)
    return {k: now[k] - before[k] for k in now}


def tree_batch(np, prefix, tree):
    """A params tree as batch columns ``prefix/<leaf path>`` (numpy)."""
    from ray_tpu_torch.parallel.train_step import _leaves

    return {f"{prefix}/{k}": v.detach().cpu().numpy()
            for k, v in _leaves(tree).items()}


def tree_of(b, prefix, like):
    """The tree ``tree_batch`` wrote, nested as ``like``, on the batch's
    device."""
    from ray_tpu_torch.parallel.train_step import _unflatten_like

    n = len(prefix) + 1
    return _unflatten_like(like, {k[n:]: v for k, v in b.items()
                                  if k.startswith(prefix + "/")})


def rl_new_losses_vs_cpu(torch, np, algos):
    """Each new loss's value and gradients on the card against the CPU on
    the same inputs and draws (``rl_update_vs_cpu``): QMIX's, MADDPG's,
    MAML's and MBMPO's second-order meta-gradients, MBMPO's ensemble
    loss, and Dreamer's world-model, actor and critic losses."""
    from ray_tpu_torch.rl.algorithms import maml as tmaml
    from ray_tpu_torch.rl.algorithms import mbmpo as tmbmpo
    from ray_tpu_torch.rl.algorithms.maml import PointGoal

    out = {}
    qmix = algos["QMIX"]
    arrays = {k: np.concatenate(v) for k, v in qmix._buf.items()}
    out["QMIX"] = rl_update_vs_cpu(
        torch, np, "QMIX", qmix.learner._loss_fn, qmix.get_params(),
        qmix._sample_batch(arrays, qmix.config.minibatch_size))
    maddpg = algos["MADDPG"]
    out["MADDPG"] = rl_update_vs_cpu(
        torch, np, "MADDPG", maddpg.learner._loss_fn, maddpg.get_params(),
        maddpg.buffer.sample(maddpg.config.minibatch_size))
    # MAML: two fresh tasks' batches from the card, the meta-gradient
    # through both inner steps
    maml = algos["MAML"]
    cfg = maml.config
    batch = {}
    for i in range(2):
        env = PointGoal(maml._sample_task(), cfg.num_envs_per_runner,
                        cfg.horizon, seed=int(maml._rng.integers(1 << 31)))
        pre, post, _, _ = maml._task_rollouts(env)
        batch.update({f"pre{i}/{k}": v.cpu().numpy() for k, v in pre.items()})
        batch.update({f"post{i}/{k}": v.cpu().numpy()
                      for k, v in post.items()})

    def maml_loss(q, b, _):
        pick = lambda tag: {k.split("/")[1]: v for k, v in b.items()  # noqa
                            if k.startswith(tag + "/")}
        return tmaml.meta_loss(q, [pick("pre0"), pick("pre1")],
                               [pick("post0"), pick("post1")], cfg.inner_lr,
                               cfg.inner_steps), {}

    out["MAML_meta"] = rl_update_vs_cpu(torch, np, "MAML meta-gradient",
                                        maml_loss, maml.params, batch)
    # MBMPO: the meta-gradient over the fitted ensemble, and one ensemble
    # update's loss on bootstrap minibatches of its dataset
    mb = algos["MBMPO"]
    pool = np.concatenate(mb._buf["obs"])
    batch = {"start": pool[mb._rng.integers(0, len(pool),
                                            mb.config.imag_envs)],
             **{f"norm/{k}": v for k, v in mb._norm.items()},
             **tree_batch(np, "mp", mb.model_params)}

    def mbmpo_meta(q, b, _):
        norm = {k[5:]: v for k, v in b.items() if k.startswith("norm/")}
        loss, _ = mb.meta_loss(q, tree_of(b, "mp", mb.model_params), norm,
                               b["start"])
        return loss, {}

    out["MBMPO_meta"] = rl_update_vs_cpu(torch, np, "MBMPO meta-gradient",
                                         mbmpo_meta, mb.params, batch)
    x, y = mb._dataset()
    xn = (x - mb._norm["x_mean"]) / mb._norm["x_std"]
    yn = (y - mb._norm["y_mean"]) / mb._norm["y_std"]
    idx = mb._rng.choice(len(xn), size=(mb.config.ensemble_size,
                                        mb.config.model_batch))
    out["MBMPO_ensemble"] = rl_update_vs_cpu(
        torch, np, "MBMPO ensemble",
        lambda q, b, _: (tmbmpo.member_losses(q, b["xs"], b["ys"]).sum(),
                         {}), mb.model_params, {"xs": xn[idx], "ys": yn[idx]})
    # Dreamer: the three losses on one replayed batch, the actor's from the
    # world model's states and the critic's on the actor's rollout
    dr = algos["DREAMERV3"]
    fns = dr._fns
    batch = dr._sample_batch()
    out["DREAMERV3_wm"] = rl_update_vs_cpu(
        torch, np, "Dreamer world model",
        lambda q, b, _: fns.wm_loss(q, b, None), dr.wm, batch)
    dev_batch = {k: torch.as_tensor(v, device=DEV) for k, v in batch.items()}
    with torch.no_grad():
        _, aux = fns.wm_loss(dr.wm, dev_batch, dr._gen)
        h0, z0 = aux["states"]
        _, act_aux = fns.actor_loss(dr.actor, dr.critic, dr.wm, h0, z0,
                                    dr._gen, dr._ret_scale)
    ret_scale = dr._ret_scale
    out["DREAMERV3_actor"] = rl_update_vs_cpu(
        torch, np, "Dreamer actor",
        lambda q, b, _: fns.actor_loss(
            q, tree_of(b, "c", dr.critic), tree_of(b, "w", dr.wm), b["h0"],
            b["z0"], None, ret_scale),
        dr.actor, {"h0": h0.cpu().numpy(), "z0": z0.cpu().numpy(),
                   **tree_batch(np, "c", dr.critic),
                   **tree_batch(np, "w", dr.wm)})
    out["DREAMERV3_critic"] = rl_update_vs_cpu(
        torch, np, "Dreamer critic",
        lambda q, b, _: (fns.critic_loss(q, b["fts"], b["rets"]), {}),
        dr.critic, {"fts": act_aux["fts"].cpu().numpy(),
                    "rets": act_aux["rets"].cpu().numpy()})
    return out


def rl_multi_agent_model_based(torch, np, rltrain, flash, smi):
    """The multi-agent and model-based families on the card: IPPO until it
    coordinates and one shared-mapping iteration, JAX's QMIX test config
    until it coordinates and coordination-qmix, spread-maddpg, MAML over
    30 iterations with its adaptation gain, pendulum-mbmpo, and
    cartpole-dreamerv3 at its full widths (with the busy share of one
    updating iteration) and JAX's world-model check, then each new loss
    against the CPU. Every part reads its flash launches (0)."""
    from ray_tpu_torch import rl

    t_part = time.perf_counter()
    algos = {}
    # 1. independent PPO until it coordinates, then the shared mapping
    before = read_launches(flash)
    ippo = rl.AlgorithmConfig(algo_class=rl.MultiAgentPPO).update_from_dict(
        dict(RL_IPPO)).build(device=DEV)
    rewards = []
    with RLClock(torch) as clock:
        for _ in range(RL_IPPO_ITERS):
            rewards.append(ippo.train()["reward_mean_per_step"])
            if rewards[-1] > RL_IPPO_THRESHOLD:
                break
    shared = rl.AlgorithmConfig(algo_class=rl.MultiAgentPPO).update_from_dict(
        dict(RL_IPPO)).multi_agent(
        policy_mapping_fn=lambda agent: "shared").build(device=DEV)
    m_shared = shared.train()
    rl_part(np, clock, clock.iters[-1]["result"], smi, "ippo_coordination",
            launch_delta_since(flash, before), source=(
                "tests/test_multi_agent.py:14-24, :41-47"),
            config=RL_IPPO, reward_mean_per_step=rewards,
            threshold=RL_IPPO_THRESHOLD,
            steps_per_iteration=RL_IPPO["num_envs_per_runner"]
            * RL_IPPO["rollout_fragment_length"],
            **rl_finite_moved(np, clock), shared_mapping={
                "learners": list(shared.learners), "result": m_shared})
    check(rewards[-1] > RL_IPPO_THRESHOLD,
          f"IPPO did not coordinate: reward per step {rewards}")
    check(list(shared.learners) == ["shared"]
          and np.isfinite(m_shared["shared/policy_loss"]),
          f"IPPO shared mapping: {list(shared.learners)} {m_shared}")
    # 2. QMIX: JAX's test config until it coordinates (the test's loop,
    # which stops there), then coordination-qmix through run_train
    for part, config, iters in (("qmix_gate", RL_QMIX_GATE, RL_QMIX_ITERS),
                                ("coordination_qmix", RL_QMIX_YAML,
                                 RL_QMIX_YAML_ITERS)):
        before = read_launches(flash)
        if part == "qmix_gate":
            algo = rltrain.get_algorithm_config("QMIX").update_from_dict(
                dict(config)).build(device=DEV)
            with RLClock(torch) as clock:
                for _ in range(iters):
                    last = algo.train()
                    if last["reward_mean_per_step"] > RL_QMIX_THRESHOLD:
                        break
        else:
            clock, last, _ = rl_run(torch, np, rltrain, "QMIX",
                                    "coordination", config, iters)
        per_step = [r["result"]["reward_mean_per_step"] for r in clock.iters]
        updating = sum(1 for r in clock.iters if "loss" in r["result"])
        extra = {}
        if part == "qmix_gate":
            algos["QMIX"] = clock.algo
            synced = clock.algo._grad_updates >= config.get(
                "target_update_freq", 200)
            extra = {"source": "tests/test_rl_new_algos.py:129-148",
                     "threshold": RL_QMIX_THRESHOLD,
                     "grad_updates": clock.algo._grad_updates,
                     "targets": rl_targets_moved(
                         np, clock, [("agent", "target_agent"),
                                     ("mixer", "target_mixer")], synced)}
        else:
            extra = {"source": "ray_tpu_torch/rl/tuned_examples/"
                               "coordination-qmix.yaml"}
        rl_part(np, clock, last, smi, part, launch_delta_since(flash, before),
                config=config, reward_mean_per_step=per_step,
                updating_iterations=updating, **rl_finite_moved(np, clock),
                **extra)
        if part == "qmix_gate":
            check(per_step[-1] > RL_QMIX_THRESHOLD,
                  f"QMIX did not coordinate: best reward per step "
                  f"{max(per_step)}")
        else:
            check(updating == 5, f"coordination-qmix: {updating} updating "
                                 "iterations, want 5")
    # 3. spread-maddpg: targets move by polyak, never alias
    before = read_launches(flash)
    clock, last, _ = rl_run(torch, np, rltrain, "MADDPG", "spread",
                            RL_MADDPG_YAML, RL_MADDPG_ITERS)
    algos["MADDPG"] = clock.algo
    updating = sum(1 for r in clock.iters if "loss" in r["result"])
    rl_part(np, clock, last, smi, "spread_maddpg",
            launch_delta_since(flash, before),
            source="ray_tpu_torch/rl/tuned_examples/spread-maddpg.yaml",
            config=RL_MADDPG_YAML, updating_iterations=updating,
            **rl_finite_moved(np, clock), targets=rl_targets_moved(
                np, clock, [("actors", "actors_t"),
                            ("critics", "critics_t")]))
    check(updating == RL_MADDPG_ITERS,
          f"spread-maddpg: {updating} updating iterations")
    # 4. MAML: the adaptation gain on fresh tasks before and after 30
    # meta-iterations (evaluate leaves the training state as it was, so a
    # fresh build's is the run's before it trains)
    before = read_launches(flash)
    maml_cfg = {"seed": 0}
    ev_before = rltrain.get_algorithm_config("MAML").update_from_dict(
        dict(maml_cfg)).build(device=DEV).evaluate(num_tasks=8)
    clock, last, _ = rl_run(torch, np, rltrain, "MAML", None, maml_cfg,
                            RL_MAML_ITERS)
    algos["MAML"] = clock.algo
    ev_after = clock.algo.evaluate(num_tasks=8)
    rl_part(np, clock, last, smi, "maml", launch_delta_since(flash, before),
            source="tests/test_pg_maml.py:72-89", config=maml_cfg,
            evaluate_before=ev_before, evaluate_after=ev_after,
            gain_threshold=RL_MAML_GAIN,
            post_adapt_reward=[r["result"]["post_adapt_reward"]
                               for r in clock.iters],
            **rl_finite_moved(np, clock))
    check(ev_after["post_adapt_reward"] > ev_before["post_adapt_reward"],
          f"MAML: post-adaptation reward {ev_before} -> {ev_after}")
    check(ev_after["adaptation_gain"] > RL_MAML_GAIN,
          f"MAML: adaptation gain {ev_after['adaptation_gain']}")
    # 5. pendulum-mbmpo: the ensemble's validation loss falls
    before = read_launches(flash)
    clock, last, _ = rl_run(torch, np, rltrain, "MBMPO", "Pendulum-v1",
                            RL_MBMPO_YAML, RL_MBMPO_ITERS)
    algos["MBMPO"] = clock.algo
    val = [r["result"]["model_val_loss"] for r in clock.iters]
    rl_part(np, clock, last, smi, "pendulum_mbmpo",
            launch_delta_since(flash, before),
            source="ray_tpu_torch/rl/tuned_examples/pendulum-mbmpo.yaml",
            config=RL_MBMPO_YAML, model_val_loss=val,
            fit_s=[r["fit_s"] for r in clock.iters],
            meta_loss=[r["result"]["meta_loss"] for r in clock.iters],
            **rl_finite_moved(np, clock))
    check(val[-1] < val[0], f"MBMPO: validation loss {val} did not fall")
    # 6. cartpole-dreamerv3 at full widths, its busy share, then JAX's
    # world-model check
    before = read_launches(flash)
    clock, last, _ = rl_run(torch, np, rltrain, "DREAMERV3", "CartPole-v1",
                            RL_DREAMER_YAML, RL_DREAMER_ITERS)
    dreamer = clock.algo
    algos["DREAMERV3"] = dreamer
    updating = sum(1 for r in clock.iters if "wm_loss" in r["result"])
    summary = rl_finite_moved(np, clock)
    rl_part(np, clock, last, smi, "cartpole_dreamerv3",
            launch_delta_since(flash, before),
            source="ray_tpu_torch/rl/tuned_examples/cartpole-dreamerv3.yaml",
            config=RL_DREAMER_YAML, updating_iterations=updating,
            widths={"deter": dreamer.config.deter_dim,
                    "stoch": [dreamer.config.stoch_groups,
                              dreamer.config.stoch_classes],
                    "embed": dreamer.config.embed_dim,
                    "hidden": list(dreamer.config.hidden)},
            num_params={k: rl.models.num_params(v)
                        for k, v in dreamer.get_params().items()},
            iteration_profiled=rl_busy_share(torch, dreamer.train),
            **summary)
    check(updating == RL_DREAMER_ITERS - 7,
          f"cartpole-dreamerv3: {updating} updating iterations, want "
          f"{RL_DREAMER_ITERS - 7}")
    before = read_launches(flash)
    clock, last, _ = rl_run(torch, np, rltrain, "DREAMERV3", "CartPole-v1",
                            RL_DREAMER_SMALL, RL_DREAMER_SMALL_ITERS)
    losses = [r["result"] for r in clock.iters if "rew_loss" in r["result"]]
    first, final = losses[0], losses[-1]
    wm = {k: [first[k], final[k]] for k in ("rew_loss", "cont_loss",
                                             "recon_loss")}
    rl_part(np, clock, last, smi, "dreamer_world_model",
            launch_delta_since(flash, before),
            source="tests/test_dreamer.py:9-20, :37-54",
            config=RL_DREAMER_SMALL, first_and_last=wm,
            rew_ratio=final["rew_loss"] / first["rew_loss"],
            **rl_finite_moved(np, clock))
    check(final["rew_loss"] < RL_DREAMER_REW_RATIO * first["rew_loss"],
          f"Dreamer rew_loss {wm['rew_loss']}")
    check(final["cont_loss"] < first["cont_loss"]
          and final["recon_loss"] < first["recon_loss"],
          f"Dreamer world model did not learn: {wm}")
    # 7. each new loss on the card against the CPU
    before = read_launches(flash)
    emit({"phase": "rl", "part": "multi_agent_model_based_losses_vs_cpu",
          "nvidia_smi": smi, "tolerance": RL_CNN_REL_TOL,
          "losses": rl_new_losses_vs_cpu(torch, np, algos),
          "flash_launches": launch_delta_since(flash, before),
          "multi_agent_model_based_part_s": time.perf_counter() - t_part})


# ---- the last RL families, JAX's own configs and seeds as they are.
# Pixels: tests/test_rl_extras.py:73-98 (slow on the CPU in JAX; here
# the pixel path's learning gate), up to 80 iterations until the best
# windowed return reaches 0.2
RL_PIXELS = {"env": "CatchPixels-v0", "env_config": {"size": 12},
             "num_env_runners": 1, "num_envs_per_runner": 32,
             "rollout_fragment_length": 22, "lr": 2e-3, "num_epochs": 4,
             "minibatch_size": 176, "entropy_coeff": 0.02}
RL_PIXELS_ITERS, RL_PIXELS_THRESHOLD = 80, 0.2
# bandits: test_rl_extras.py:150-176 (2 iterations, then 15 more; late
# regret per step under 0.6x the early one, every arm's cosine over 0.9)
RL_BANDIT = {"num_envs_per_runner": 16, "steps_per_iter": 16}
RL_BANDIT_RATIO, RL_BANDIT_COS = 0.6, 0.9
# ES: test_rl_extras.py:130-144, ARS: tests/test_rl_new_algos.py:25-41
# (first iteration, then 12: best mean return over max(40, first))
RL_ES_GATE = {"num_env_runners": 2, "num_perturbations": 8,
              "episodes_per_perturbation": 1, "max_episode_len": 200,
              "hidden": [32]}
RL_ARS_GATE = dict(RL_ES_GATE, top_directions=4)
RL_ES_ITERS, RL_ES_FLOOR = 13, 40.0
# cartpole-es.yaml (a copy of JAX's), to its stop values
RL_ES_YAML = {"num_env_runners": 2, "num_perturbations": 16,
              "num_cpus_per_runner": 0.4}
RL_ES_YAML_STOP = {"episode_return_mean": 100, "training_iteration": 40}
# AlphaZero: tests/test_rl_new_algos.py:271-285, scored as that test's
# _play_vs_random (:210-234) scores it
RL_AZ = {"num_simulations": 24, "games_per_iter": 24, "hidden": [64, 64],
         "seed": 0}
RL_AZ_ITERS, RL_AZ_FIRST, RL_AZ_SECOND = 12, 0.9, 0.7
# LC0: tests/test_lc0.py:57-80 for 2 steps, then connect4-lc0.yaml
RL_LC0_TEST = {"num_workers": 2, "games_per_iter": 4, "num_simulations": 12,
               "updates_per_iter": 4, "minibatch_size": 32, "seed": 0}
RL_LC0_YAML = {"num_workers": 2, "games_per_iter": 8, "num_simulations": 32,
               "updates_per_iter": 16, "minibatch_size": 128}
RL_LC0_YAML_ITERS = 3
# DT: tests/test_rl_offline_seq.py:134-153 on its scripted dataset
# (:109-131): action accuracy over 0.75 after 2 iterations, a return
# over 40 conditioned on 200
RL_DT = {"env": "CartPole-v1", "context_len": 10, "d_model": 48,
         "n_layers": 2, "lr": 1e-3, "updates_per_iter": 120,
         "minibatch_size": 64, "target_return": 200.0, "max_ep_len": 200}
RL_DT_ITERS, RL_DT_ACC, RL_DT_RETURN = 2, 0.75, 40.0
# SlateQ: tests/test_slateq.py:40-77 (greedy slates over 1.15x the random
# baseline, evaluated every 10 iterations, within 40), then
# recsim-slateq.yaml: 320 rows an iteration, updates from the 2nd
# (640 >= 500), 5 updating iterations in 6
RL_SLATEQ_GATE = {"num_envs_per_runner": 16, "rollout_fragment_length": 20,
                  "learning_starts": 500, "updates_per_iter": 32,
                  "epsilon_decay_steps": 4000, "seed": 0}
RL_SLATEQ_ITERS, RL_SLATEQ_GAIN = 40, 1.15
RL_SLATEQ_YAML = {"num_envs_per_runner": 16, "rollout_fragment_length": 20,
                  "learning_starts": 500, "updates_per_iter": 32,
                  "epsilon_decay_steps": 4000}
RL_SLATEQ_YAML_ITERS = 6


def tree_leaves(tree):
    from ray_tpu_torch.parallel.train_step import _leaves

    return list(_leaves(tree).values())


def rl_clocked(torch, algo, iters, until=None, method="train"):
    """``algo.train()`` (or ``method``) up to ``iters`` times under an
    ``RLClock``, or until ``until(result)``; the clock and the results."""
    results = []
    outer = None if method == "train" else (type(algo), method)
    with RLClock(torch, outer) as clock:
        for _ in range(iters):
            results.append(getattr(algo, method)())
            if until is not None and until(results[-1]):
                break
    return clock, results


def az_vs_random(np, algo, games, seed, az_first):
    """AlphaZero's score against a uniform-random opponent in [0, 1]
    (win 1, draw 0.5): tests/test_rl_new_algos.py:210-234."""
    rng = np.random.default_rng(seed)
    game, score = algo.game, 0.0
    for _ in range(games):
        state, az_turn = game.initial_state(), az_first
        while True:
            tv = game.terminal_value(state)
            if tv is not None:
                val = -tv if not az_turn else tv
                score += {1.0: 1.0, 0.0: 0.5, -1.0: 0.0}[val]
                break
            if az_turn:
                a = algo.policy_action(state, greedy=True)
            else:
                a = int(rng.choice(np.nonzero(game.legal_actions(state))[0]))
            state = game.next_state(state, a)
            az_turn = not az_turn
    return score / games


def dt_scripted_cartpole(np, num_steps=3000, seed=0):
    """JAX's DT test dataset (tests/test_rl_offline_seq.py:109-131): a
    stabilising controller with 10% flips over 4 CartPole streams."""
    from ray_tpu_torch.rl.env import make_env

    env = make_env("CartPole-v1", 4, {})
    rng = np.random.default_rng(seed)
    obs = env.reset()
    rows = {"obs": [], "actions": [], "rewards": [], "dones": [],
            "env_ids": []}
    for _ in range(num_steps // 4):
        act = (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)
        act = np.where(rng.random(len(act)) < 0.1, 1 - act, act)
        nobs, rew, done = env.step(act)
        for e in range(4):
            rows["obs"].append(obs[e])
            rows["actions"].append(act[e])
            rows["rewards"].append(rew[e])
            rows["dones"].append(done[e])
            rows["env_ids"].append(e)
        obs = nobs
    return {k: np.asarray(v) for k, v in rows.items()}


def slate_random_baseline(np, cfg):
    """tests/test_slateq.py:49-62: random slates on RecSlateEnv(16, seed
    99) for 80 steps, the mean finished-episode return."""
    from ray_tpu_torch.rl.algorithms.slateq import RecSlateEnv

    env = RecSlateEnv(num_envs=16, num_docs=cfg.num_docs,
                      slate_size=cfg.slate_size, horizon=20, seed=99)
    env.reset()
    rng = np.random.default_rng(99)
    returns, ep = [], np.zeros(16)
    for _ in range(80):
        slates = np.stack([rng.choice(cfg.num_docs, cfg.slate_size,
                                      replace=False) for _ in range(16)])
        _, rew, dones, _ = env.step(slates)
        ep += rew
        for i in np.nonzero(dones)[0]:
            returns.append(ep[i])
            ep[i] = 0.0
    return float(np.mean(returns))


def rl_last_losses_vs_cpu(torch, np, algos):
    """Each new loss on the card against the CPU on the same inputs
    (``rl_update_vs_cpu``): PPO's through the small CNN on a fragment of
    the pixel run, AlphaZero's, LC0's importance-weighted one, DT's
    discrete and continuous ones, SlateQ's."""
    from ray_tpu_torch import rl

    out = {}
    ppo = algos["PPO_pixels"]
    frag = ppo.runners[0].sample(ppo.get_params())
    n = len(frag["rewards"])
    out["PPO_small_cnn"] = rl_update_vs_cpu(
        torch, np, "PPO small CNN", ppo.learner._loss_fn, ppo.get_params(),
        {k: v for k, v in frag.items() if len(v) == n})
    az = algos["ALPHAZERO"]
    buf = az._buf[-az.config.minibatch_size:]
    out["ALPHAZERO"] = rl_update_vs_cpu(
        torch, np, "AlphaZero", az.learner._loss_fn, az.get_params(),
        {"obs": np.stack([e[0] for e in buf]),
         "pi": np.stack([e[1] for e in buf]),
         "z": np.asarray([e[2] for e in buf], dtype=np.float32)})
    lc0 = algos["LEELACHESSZERO"]
    mb, _, weights = lc0.buffer.sample(lc0.config.minibatch_size)
    out["LEELACHESSZERO"] = rl_update_vs_cpu(
        torch, np, "LC0", lc0.learner._loss_fn, lc0.get_params(),
        dict(mb, weights=weights))
    dt = algos["DT"]
    out["DT_discrete"] = rl_update_vs_cpu(
        torch, np, "DT discrete", dt.learner._loss_fn, dt.get_params(),
        dt._minibatch(dt.config.minibatch_size))
    # a continuous DT at the same widths on random Pendulum rows
    rng = np.random.default_rng(0)
    n = 400
    data = {"obs": rng.normal(size=(n, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": (np.arange(n) % 100 == 99)}
    cont = rl.DTConfig().training(**dict(RL_DT, env="Pendulum-v1"),
                                  offline_data=data).build(device=DEV)
    out["DT_continuous"] = rl_update_vs_cpu(
        torch, np, "DT continuous", cont.learner._loss_fn,
        cont.get_params(), cont._minibatch(cont.config.minibatch_size))
    sq = algos["SLATEQ"]
    out["SLATEQ"] = rl_update_vs_cpu(
        torch, np, "SlateQ", sq.learner._loss_fn, sq.get_params(),
        sq.buffer.sample(sq.config.minibatch_size))
    return out


def rl_search_population_sequence_slate(torch, np, rltrain, flash, smi):
    """The last RL families on the card, JAX's test configs and seeds as
    they are: PPO on pixels through the small CNN until it catches, both
    bandits' regret and arms, ES and ARS until they improve and
    cartpole-es to its stop, AlphaZero against random, LC0's test and
    connect4-lc0, DT's accuracy and conditioned return, SlateQ against
    random slates with its target copies and recsim-slateq, then each new
    loss against the CPU. Every part reads its flash launches (0)."""
    from ray_tpu_torch import rl

    t_part = time.perf_counter()
    algos = {}
    # 1. PPO on pixels through the Catalog's small CNN
    before = read_launches(flash)
    algo = rltrain.get_algorithm_config("PPO").update_from_dict(
        dict(RL_PIXELS)).build(device=DEV)
    best = [-1.0]

    def caught(m):
        r = m.get("episode_return_mean", float("nan"))
        if m.get("episodes_this_iter", 0) and np.isfinite(r):
            best[0] = max(best[0], r)
        return best[0] >= RL_PIXELS_THRESHOLD

    # cuDNN's default convolution backward adds with atomics, so two runs
    # of one seed part ways: on one H100, seed 0 first reached 0.2 at
    # iteration 77 here and at 65 and 74 in ray_tpu_torch.tools.
    # rl_gate_spread, near the gate's 80; with cuDNN's deterministic
    # algorithms the run repeats (66 both times there)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        clock, results = rl_clocked(torch, algo, RL_PIXELS_ITERS, caught)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rl_part(np, clock, results[-1], smi, "catch_pixels_ppo",
            launch_delta_since(flash, before),
            source="tests/test_rl_extras.py:73-98", config=RL_PIXELS,
            obs_shape=list(algo.spec.obs_shape),
            convs=[list(c["w"].shape) for c in
                   algo.get_params()["enc"]["convs"]],
            best_episode_return_mean=best[0],
            threshold=RL_PIXELS_THRESHOLD, cudnn_deterministic=True,
            **rl_finite_moved(np, clock))
    check(best[0] >= RL_PIXELS_THRESHOLD,
          f"pixel PPO plateaued at {best[0]}")
    algos["PPO_pixels"] = algo
    # 2. the bandits: regret falls, the arms point at the true weights
    for run in ("BANDITLINUCB", "BANDITLINTS"):
        before = read_launches(flash)
        algo = rltrain.get_algorithm_config(run).update_from_dict(
            dict(RL_BANDIT)).build(device=DEV)
        clock, results = rl_clocked(torch, algo, 17)
        early, late = (results[1]["regret_per_step"],
                       results[-1]["regret_per_step"])
        theta, true = algo._theta_hat(), algo._env.theta
        cos = (np.sum(theta * true, axis=1)
               / (np.linalg.norm(theta, axis=1)
                  * np.linalg.norm(true, axis=1) + 1e-9))
        rl_part(np, clock, results[-1], smi, run.lower(),
                launch_delta_since(flash, before),
                source="tests/test_rl_extras.py:150-176", config=RL_BANDIT,
                early_regret_per_step=early, late_regret_per_step=late,
                ratio=late / early, arm_cosines=cos.tolist(),
                **rl_finite_moved(np, clock))
        check(late < RL_BANDIT_RATIO * early,
              f"{run}: regret per step {early} -> {late}")
        check(bool((cos > RL_BANDIT_COS).all()), f"{run}: cosines {cos}")
    # 3. ES and ARS until they improve, then cartpole-es to its stop
    for run, config in (("ES", RL_ES_GATE), ("ARS", RL_ARS_GATE)):
        before = read_launches(flash)
        algo = rltrain.get_algorithm_config(run).update_from_dict(
            dict(config)).build(device=DEV)
        clock, results = rl_clocked(torch, algo, RL_ES_ITERS)
        means = [r["mean_return"] for r in results]
        extra = ({"filter_count": algo._f_count} if run == "ARS" else {})
        rl_part(np, clock, results[-1], smi, f"{run.lower()}_gate",
                launch_delta_since(flash, before), source={
                    "ES": "tests/test_rl_extras.py:130-144",
                    "ARS": "tests/test_rl_new_algos.py:25-41"}[run],
                config=config, mean_return=means,
                floor=max(RL_ES_FLOOR, means[0]),
                **rl_finite_moved(np, clock), **extra)
        check(max(means[1:]) > max(RL_ES_FLOOR, means[0]),
              f"{run} did not improve: {means}")
    before = read_launches(flash)
    clock, last, _ = rl_run(torch, np, rltrain, "ES", "CartPole-v1",
                            RL_ES_YAML,
                            RL_ES_YAML_STOP["training_iteration"],
                            RL_ES_YAML_STOP["episode_return_mean"])
    means = [r["result"]["mean_return"] for r in clock.iters]
    rl_part(np, clock, last, smi, "cartpole_es",
            launch_delta_since(flash, before),
            source="ray_tpu_torch/rl/tuned_examples/cartpole-es.yaml",
            config=RL_ES_YAML, stop=RL_ES_YAML_STOP, mean_return=means,
            **rl_finite_moved(np, clock))
    check(means[-1] >= RL_ES_YAML_STOP["episode_return_mean"]
          or len(means) == RL_ES_YAML_STOP["training_iteration"],
          f"cartpole-es stopped early at {means}")
    # 4. AlphaZero against random, moving first and second
    before = read_launches(flash)
    cfg = rltrain.get_algorithm_config("ALPHAZERO").update_from_dict(
        dict(RL_AZ))
    az = rl.AlphaZero({"__algo_config": cfg}, device=DEV)
    # step(), as the test calls it: every update seeded cfg.seed + 0
    clock, results = rl_clocked(torch, az, RL_AZ_ITERS, method="step")
    algos["ALPHAZERO"] = az
    t0 = time.perf_counter()
    first = az_vs_random(np, az, 20, 1, True)
    second = az_vs_random(np, az, 20, 2, False)
    moves = results[-1]["env_steps_total"]
    rl_part(np, clock, results[-1], smi, "alphazero_tictactoe",
            launch_delta_since(flash, before),
            source="tests/test_rl_new_algos.py:271-285", config=RL_AZ,
            score_first=first, score_second=second,
            scoring_s=time.perf_counter() - t0, moves_total=moves,
            moves_per_s=moves / sum(r["iteration_s"] for r in clock.iters),
            simulations_per_s=moves * RL_AZ["num_simulations"]
            / sum(r["sample_s"] for r in clock.iters),
            **rl_finite_moved(np, clock))
    check(first >= RL_AZ_FIRST and second >= RL_AZ_SECOND,
          f"AlphaZero against random: {first} first, {second} second")
    # 5. LC0: JAX's test for 2 steps, then connect4-lc0
    before = read_launches(flash)
    lc0 = rltrain.get_algorithm_config("LEELACHESSZERO").update_from_dict(
        dict(RL_LC0_TEST)).build(device=DEV)
    clock, results = rl_clocked(torch, lc0, 2)
    m1, m2 = results
    base = lc0.buffer._leaf_base
    leaves = lc0.buffer._tree[base:base + len(lc0.buffer)]
    ev = lc0.evaluate(num_episodes=4)
    rl_part(np, clock, m2, smi, "lc0_test", launch_delta_since(flash, before),
            source="tests/test_lc0.py:57-80", config=RL_LC0_TEST,
            buffer_sizes=[m1["buffer_size"], m2["buffer_size"]],
            priority_range=[float(leaves.min()), float(leaves.max())],
            evaluate=ev, workers=len(lc0.workers),
            **rl_finite_moved(np, clock))
    check(m2["buffer_size"] > m1["buffer_size"] >= 7 * 4 / 2,
          f"LC0 buffer {m1['buffer_size']} -> {m2['buffer_size']}")
    check(np.isfinite(m2["loss"]) and leaves.max() > leaves.min(),
          f"LC0 loss {m2['loss']}, priorities {leaves.min()}..{leaves.max()}")
    check(0.0 <= ev["episode_return_mean"] <= 1.0, f"LC0 evaluate {ev}")
    lc0.stop()
    before = read_launches(flash)
    clock, last, _ = rl_run(torch, np, rltrain, "LEELACHESSZERO",
                            "connect4", RL_LC0_YAML, RL_LC0_YAML_ITERS)
    algos["LEELACHESSZERO"] = clock.algo
    moves = last["env_steps_total"]
    rl_part(np, clock, last, smi, "connect4_lc0",
            launch_delta_since(flash, before),
            source="ray_tpu_torch/rl/tuned_examples/connect4-lc0.yaml",
            config=RL_LC0_YAML, moves_total=moves,
            moves_per_s=moves / sum(r["iteration_s"] for r in clock.iters),
            simulations_per_s=moves * RL_LC0_YAML["num_simulations"]
            / sum(r["sample_s"] for r in clock.iters),
            **rl_finite_moved(np, clock))
    check(len(clock.iters) == RL_LC0_YAML_ITERS
          and clock.iters[-1]["updates"] == RL_LC0_YAML["updates_per_iter"],
          f"connect4-lc0: {len(clock.iters)} iterations")
    # 6. DT on the scripted CartPole dataset
    before = read_launches(flash)
    dt = rl.DTConfig().training(**RL_DT, offline_data=dt_scripted_cartpole(
        np)).build(device=DEV)
    clock, results = rl_clocked(torch, dt, RL_DT_ITERS)
    algos["DT"] = dt
    t0 = time.perf_counter()
    ev = dt.evaluate(num_episodes=3)
    acc = results[-1]["action_acc"]
    rl_part(np, clock, results[-1], smi, "dt_scripted_cartpole",
            launch_delta_since(flash, before),
            source="tests/test_rl_offline_seq.py:109-153", config=RL_DT,
            action_acc=[r["action_acc"] for r in results], evaluate=ev,
            evaluate_s=time.perf_counter() - t0,
            num_params=rl.models.num_params(dt.get_params()),
            **rl_finite_moved(np, clock))
    check(acc > RL_DT_ACC, f"DT action accuracy {acc}")
    check(ev["episode_return_mean"] > RL_DT_RETURN, f"DT evaluate {ev}")
    # 7. SlateQ against random slates, its target copies, recsim-slateq
    before = read_launches(flash)
    sq = rltrain.get_algorithm_config("SLATEQ").update_from_dict(
        dict(RL_SLATEQ_GATE)).build(device=DEV)
    baseline = slate_random_baseline(np, sq.config)
    evals, best = [], [-np.inf]
    seen = {"target": tree_leaves(sq.get_params()["target"]), "updates": 0}
    per_iteration = []

    def scored(m):
        # the target between iterations: changed exactly where a copy fell
        now = tree_leaves(sq.get_params()["target"])
        freq = sq.config.target_update_freq
        per_iteration.append({
            "updates": sq._updates,
            "copied": sq._updates // freq > seen["updates"] // freq,
            "target_unchanged": all(torch.equal(a, b) for a, b in
                                    zip(now, seen["target"]))})
        seen.update(target=[t.clone() for t in now], updates=sq._updates)
        if len(per_iteration) % 10 == 0:
            evals.append(sq.evaluate(num_episodes=16)["episode_return_mean"])
            best[0] = max(best[0], evals[-1])
        return best[0] > baseline * RL_SLATEQ_GAIN

    # each target copy: right after it the target equals q, unshared
    copies, sync = [], type(sq)._sync_target

    def recorded(obj):
        sync(obj)
        pairs = list(zip(tree_leaves(obj.learner.params["q"]),
                         tree_leaves(obj.learner.params["target"])))
        copies.append({
            "update": obj._updates,
            "equal": all(torch.equal(a, b) for a, b in pairs),
            "shared": any(a.untyped_storage().data_ptr()
                          == b.untyped_storage().data_ptr()
                          for a, b in pairs)})

    type(sq)._sync_target = recorded
    try:
        clock, results = rl_clocked(torch, sq, RL_SLATEQ_ITERS, scored)
    finally:
        type(sq)._sync_target = sync
    algos["SLATEQ"] = sq
    rl_part(np, clock, results[-1], smi, "slateq_gate",
            launch_delta_since(flash, before),
            source="tests/test_slateq.py:40-77", config=RL_SLATEQ_GATE,
            random_baseline=baseline, evaluations=evals, best=best[0],
            gain=RL_SLATEQ_GAIN, target_copies=copies,
            target_per_iteration=per_iteration,
            **rl_finite_moved(np, clock))
    check(best[0] > baseline * RL_SLATEQ_GAIN,
          f"SlateQ {best[0]} against random {baseline}")
    check(np.isfinite(results[-1]["td_abs_mean"]), "SlateQ td not finite")
    check(copies and all(c["equal"] and not c["shared"] for c in copies),
          f"SlateQ target copies {copies}")
    check(all(u["target_unchanged"] != u["copied"] for u in per_iteration),
          f"SlateQ target moved between copies: {per_iteration}")
    before = read_launches(flash)
    clock, last, _ = rl_run(torch, np, rltrain, "SLATEQ", "recsim",
                            RL_SLATEQ_YAML, RL_SLATEQ_YAML_ITERS)
    updating = sum(1 for r in clock.iters if "loss" in r["result"])
    rl_part(np, clock, last, smi, "recsim_slateq",
            launch_delta_since(flash, before),
            source="ray_tpu_torch/rl/tuned_examples/recsim-slateq.yaml",
            config=RL_SLATEQ_YAML, updating_iterations=updating,
            **rl_finite_moved(np, clock))
    check(updating == 5, f"recsim-slateq: {updating} updating iterations")
    # 8. each new loss on the card against the CPU
    before = read_launches(flash)
    emit({"phase": "rl", "part": "search_population_sequence_slate_losses"
                                 "_vs_cpu",
          "nvidia_smi": smi, "tolerance": RL_CNN_REL_TOL,
          "losses": rl_last_losses_vs_cpu(torch, np, algos),
          "flash_launches": launch_delta_since(flash, before),
          "search_population_sequence_slate_part_s":
              time.perf_counter() - t_part})



# JAX's external-env test (tests/test_rl_extras.py:210-250): PPO on
# external://0 fed by a CartPole simulator thread over HTTP
RL_EXTERNAL = {"spec": {"obs_dim": 4, "num_actions": 2},
               "rollout_fragment_length": 64, "num_epochs": 2,
               "minibatch_size": 64, "iterations": 2}


def rl_external(torch, np, smi):
    """``PPOConfig`` with ``env = "external://0"``: the port's policy
    server in this process, a simulator thread driving CartPole through
    the port's ``PolicyClient`` (each ``get_action`` round trip timed),
    two iterations held to JAX's assertions."""
    import threading

    import ray_tpu_torch.rl as trl
    from ray_tpu_torch.rl.env import CartPole

    c = RL_EXTERNAL
    cfg = trl.PPOConfig()
    cfg.env = "external://0"
    cfg.env_config = {"spec": dict(c["spec"])}
    cfg.env_runners(num_env_runners=1, num_envs_per_runner=1,
                    rollout_fragment_length=c["rollout_fragment_length"])
    cfg.num_epochs = c["num_epochs"]
    cfg.minibatch_size = c["minibatch_size"]
    algo = cfg.build(device=DEV)
    # a broken server fails the phase instead of hanging the script:
    # stopping the algorithm ends a waiting sample with a RuntimeError
    watchdog = threading.Timer(300.0, algo.stop)
    watchdog.start()
    port = algo.server_ports[0]
    stop = threading.Event()
    round_trips, errors = [], []

    def simulator():
        try:
            client = trl.PolicyClient(f"http://127.0.0.1:{port}")
            env = CartPole(1, seed=3)
            while not stop.is_set():
                eid = client.start_episode()
                obs = env.reset()
                for _ in range(100):
                    t0 = time.perf_counter()
                    a = client.get_action(eid, obs[0])
                    round_trips.append(time.perf_counter() - t0)
                    obs, r, d = env.step(np.array([a]))
                    client.log_returns(eid, float(r[0]))
                    if d[0] or stop.is_set():
                        break
                client.end_episode(eid)
        except Exception as e:  # noqa: BLE001 — reported by the check
            errors.append(repr(e))

    sim = threading.Thread(target=simulator, daemon=True)
    sim.start()
    results, iter_s = [], []
    try:
        for _ in range(c["iterations"]):
            t0 = time.perf_counter()
            results.append(algo.step())
            iter_s.append(time.perf_counter() - t0)
    finally:
        stop.set()
        watchdog.cancel()
        sim.join(timeout=30)
        algo.stop()
    # the first round trips wait for the first params (503 retries)
    rt = np.asarray(round_trips[10:]) * 1e3
    m1, m2 = results
    stats = {**m1, **m2}
    rec = {"phase": "rl", "part": "external_env", "nvidia_smi": smi,
           "config": c, "iteration_s": iter_s,
           "policy_loss": [m1["policy_loss"], m2["policy_loss"]],
           "env_steps_total": stats["env_steps_total"],
           "get_action_round_trips": len(round_trips),
           "get_action_ms": {"median": float(np.median(rt)),
                             "p90": float(np.percentile(rt, 90)),
                             "mean": float(rt.mean())},
           "simulator_errors": errors, "simulator_alive": sim.is_alive()}
    emit(rec)
    print(f"policy server: get_action round trip median "
          f"{rec['get_action_ms']['median']:.3f} ms", flush=True)
    check(not errors and not sim.is_alive(),
          f"external env: simulator {errors}, alive {sim.is_alive()}")
    check(np.isfinite(m1["policy_loss"]) and np.isfinite(m2["policy_loss"]),
          f"external env: policy losses {rec['policy_loss']}")
    check(stats["env_steps_total"] >= 128,
          f"external env: env_steps_total {stats['env_steps_total']}")
    return rec


# Learner(mesh=) against the plain Learner on the one-rank mesh: a PPO
# minibatch of CartPole-shaped rows (the tuned example's widths), and a
# SAC minibatch of Pendulum-shaped rows (its loss draws noise)
RL_MESH_ROWS, RL_MESH_TOL = 512, 1e-5


def rl_learner_mesh(torch, np, mesh):
    """One PPO minibatch update through ``Learner(mesh=mesh)`` (the
    minibatch a DTensor on ``dp``, params replicated) against the plain
    ``Learner`` from the same params: params and metrics within
    ``RL_MESH_TOL``; then 20 more updates of each, timed. Then one SAC
    update of each (its noise drawn on the mesh as replicated DTensors),
    held to the same tolerance."""
    from ray_tpu_torch.parallel.train_step import _leaves
    from ray_tpu_torch.rl import models
    from ray_tpu_torch.rl.algorithms import sac
    from ray_tpu_torch.rl.algorithms.ppo import make_ppo_loss
    from ray_tpu_torch.rl.env import EnvSpec
    from ray_tpu_torch.rl.learner import Learner

    spec = EnvSpec(obs_dim=4, num_actions=2)
    params = models.init_policy(
        torch.Generator(device=DEV).manual_seed(0), spec, (64, 64))
    rng = np.random.default_rng(0)
    n = RL_MESH_ROWS
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n),
             "logp": (-0.69 + 0.1 * rng.standard_normal(n)).astype(
                 np.float32),
             "advantages": (rng.standard_normal(n) * np.repeat(
                 [1.0, 10.0], n // 2)).astype(np.float32),
             "value_targets": rng.standard_normal(n).astype(np.float32)}
    loss = make_ppo_loss(spec, 0.2, 0.5, 0.01)
    plain = Learner(params, loss, 3e-4, grad_clip=0.5, device=DEV)
    on_mesh = Learner(params, loss, 3e-4, grad_clip=0.5, mesh=mesh)
    mp = {k: float(v) for k, v in plain.update_minibatch(batch).items()}
    mm = {k: float(v) for k, v in on_mesh.update_minibatch(batch).items()}
    a, b = _leaves(plain.get_params()), _leaves(on_mesh.get_params())
    gap = max(float((a[k] - b[k]).abs().max()) for k in a)
    metric_gap = max(abs(mp[k] - mm[k]) for k in mp)
    ms = {}
    for name, lrn in (("plain", plain), ("mesh", on_mesh)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            m = lrn.update_minibatch(batch)
        float(m["loss"])
        ms[name] = (time.perf_counter() - t0) * 1e3 / 20
    out = {"rows": n, "params_max_abs_gap": gap,
           "metrics_max_abs_gap": metric_gap, "metrics_plain": mp,
           "metrics_mesh": mm, "update_ms": ms, "tolerance": RL_MESH_TOL}
    check(gap <= RL_MESH_TOL and metric_gap <= RL_MESH_TOL,
          f"Learner(mesh=) off the plain learner: {out}")

    cspec = EnvSpec(obs_dim=3, action_dim=1, action_low=-2.0,
                    action_high=2.0)
    cfg = sac.SACConfig()
    params = sac.init_soft_actor_critic(
        torch.Generator(device=DEV).manual_seed(0), cspec, cfg)
    batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
             "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
             "rewards": rng.standard_normal(n).astype(np.float32),
             "next_obs": rng.standard_normal((n, 3)).astype(np.float32),
             "dones": rng.random(n) < 0.2}
    loss = sac.make_sac_loss(cspec, cfg)
    plain = Learner(params, loss, cfg.lr, device=DEV)
    on_mesh = Learner(params, loss, cfg.lr, mesh=mesh)
    mp = {k: float(v) for k, v in plain.update_minibatch(batch).items()}
    mm = {k: float(v) for k, v in on_mesh.update_minibatch(batch).items()}
    a, b = _leaves(plain.get_params()), _leaves(on_mesh.get_params())
    out["sac"] = {"params_max_abs_gap": max(float((a[k] - b[k]).abs().max())
                                            for k in a),
                  "metrics_max_abs_gap": max(abs(mp[k] - mm[k]) for k in mp),
                  "same_generator": bool(torch.equal(
                      plain._gen.get_state(), on_mesh._gen.get_state()))}
    check(out["sac"]["params_max_abs_gap"] <= RL_MESH_TOL
          and out["sac"]["metrics_max_abs_gap"] <= RL_MESH_TOL
          and out["sac"]["same_generator"],
          f"Learner(mesh=) SAC off the plain learner: {out['sac']}")
    return out


def rl_phase(torch, np, flash, smi):
    """The RL stack on the card in one process: the tuned PPO example
    through ``run_train`` until it learns, the other on-policy configs, a
    Nature-CNN PPO update against the CPU, the fused iteration against
    the host loop, the off-policy families (``rl_off_policy``), the
    multi-agent and model-based ones (``rl_multi_agent_model_based``),
    the search, population, sequence, slate, bandit and pixel ones
    (``rl_search_population_sequence_slate``) and PPO on an external env
    through the policy server (``rl_external``). No flash kernel may
    launch."""
    from ray_tpu_torch.parallel.train_step import _leaves
    from ray_tpu_torch.rl import anakin
    from ray_tpu_torch.rl import train as rltrain

    zero_launches(flash)
    # 1. tuned PPO until the yaml's stop values
    clock, last, log = rl_run(torch, np, rltrain, "PPO", "CartPole-v1",
                              RL_TUNED_PPO,
                              RL_TUNED_PPO_STOP["training_iteration"],
                              RL_TUNED_PPO_STOP["episode_return_mean"])
    summary = rl_summary(np, clock)
    returns = [r for r in summary["episode_return_mean"]
               if r is not None and np.isfinite(r)]
    best = max(returns) if returns else float("nan")
    emit({"phase": "rl", "part": "tuned_ppo", "nvidia_smi": smi,
          "source": "ray_tpu_torch/rl/tuned_examples/cartpole-ppo.yaml",
          "config": RL_TUNED_PPO, "stop": RL_TUNED_PPO_STOP,
          "best_episode_return_mean": best, **summary,
          "last_result": last, "log_tail": log[-400:]})
    check(best > RL_LEARN_THRESHOLD,
          f"tuned PPO did not learn CartPole: best return {best} "
          f"<= {RL_LEARN_THRESHOLD}")
    # 2. the other on-policy configs
    for name, run, env, config, iters, per_iter in RL_OTHERS:
        clock, last, _ = rl_run(torch, np, rltrain, run, env, config, iters)
        summary = rl_summary(np, clock)
        totals = [r["result"]["env_steps_total"] for r in clock.iters]
        steps = [b - a for a, b in zip([0] + totals, totals)]
        finite = all(np.isfinite(v) for r in clock.iters
                     for k, v in r["result"].items()
                     if isinstance(v, float) and k != "episode_return_mean")
        before = _leaves(clock.initial)
        after = _leaves(clock.to_numpy(clock.algo.get_params()))
        moved = {"params": any(np.any(after[k] != before[k])
                               for k in after)}
        if "log_std" in after:
            moved["log_std"] = bool(np.any(after["log_std"]
                                           != before["log_std"]))
        emit({"phase": "rl", "part": name, "nvidia_smi": smi, "run": run,
              "env": env, "config": config, "env_steps_per_iteration": steps,
              "params_moved": moved, "all_metrics_finite": finite,
              **summary, "last_result": last})
        check(steps == [per_iter] * iters,
              f"{name}: env steps per iteration {steps}, want {per_iter}")
        check(finite, f"{name}: a non-finite metric")
        check(all(moved.values()), f"{name}: params did not move {moved}")
    # 3. the Nature CNN update
    emit({"phase": "rl", "part": "nature_cnn_update", "nvidia_smi": smi,
          **rl_cnn_update(torch, np)})
    # 4. fused against host loop
    bench = anakin.bench_fused_vs_host(device=DEV)
    fused = anakin.AnakinRunner(anakin.AnakinConfig(), device=DEV)
    emit({"phase": "rl", "part": "fused_vs_host", "nvidia_smi": smi,
          **bench, "host_leg_profiled": rl_busy_share(
              torch, anakin.make_host_leg(anakin.AnakinConfig(), DEV)),
          "fused_leg_profiled": rl_busy_share(torch,
                                              lambda: fused.train(1))})
    check(bench["fused_compile_count"] == 1,
          f"fused compile_count {bench['fused_compile_count']}")
    # 5. the off-policy families
    rl_off_policy(torch, np, rltrain, smi)
    # 6. the multi-agent and model-based families
    rl_multi_agent_model_based(torch, np, rltrain, flash, smi)
    # 7. pixels, bandits, ES/ARS, AlphaZero/LC0, DT and SlateQ
    rl_search_population_sequence_slate(torch, np, rltrain, flash, smi)
    # 8. PPO on an external env through the policy server
    rl_external(torch, np, smi)
    # 9. nothing on the RL path reaches flash attention
    launches = read_launches(flash)
    emit({"phase": "rl", "part": "launches", "nvidia_smi": smi,
          "flash_launches": launches})
    check(all(v == 0 for v in launches.values()),
          f"a flash kernel launched on the RL path: {launches}")
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
    the collective group API once, a PPO minibatch through
    ``Learner(mesh=...)`` against the plain ``Learner``
    (``rl_learner_mesh``), and the process group torn down."""
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
        torch.cuda.empty_cache()
        # the RL learner on the same mesh (no flash kernel)
        out["rl_learner_mesh"] = rl_learner_mesh(torch, np, mesh)
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


# ------------------------------------------------------------ phase 17

# the ring's arithmetic at the 1b train shape: the sequence in this many
# chunk-"ranks", rotated in memory on one card
SEQPIPE_CHUNKS = 4
SEQPIPE_RING_STEPS, SEQPIPE_ULYSSES_STEPS, SEQPIPE_PIPE_STEPS = 8, 3, 4
SEQPIPE_MICROBATCHES, SEQPIPE_DRIVER_K = 4, 4


def seqpipe_launches(schedule, m, n_layers):
    """(tcb, dq, dkv) launches of one train step of a one-stage (pp 1)
    pipeline or a one-rank sp group, flash attention with remat. gpipe
    (remat: each stage's inputs only): m forwards without gradients, then
    in the backward each microbatch's stage again with them and its
    backward. 1f1b: no separate forward on the last (here the only)
    stage, whose output goes nowhere; each backward's recompute and its
    backward. ring, ulysses, flash: each block's forward, its remat
    recompute, its backward."""
    if schedule == "gpipe":
        return 2 * m * n_layers, m * n_layers, m * n_layers
    if schedule == "1f1b":
        return m * n_layers, m * n_layers, m * n_layers
    return 2 * n_layers, n_layers, n_layers


def launch_delta(flash, before):
    """Each counter's launches since ``before`` (a ``read_launches``)."""
    return {k: n - before[k] for k, n in read_launches(flash).items()}


def ring_arithmetic(torch, flash, context):
    """The port's ring loops (``context.ring_forward``, ``ring_backward``)
    at the 1b train shape on one card, every rank of a ring of
    ``SEQPIPE_CHUNKS`` held in memory (``context.memory_rotation``):
    against one whole-sequence ``flash_fwd`` and one ``flash_dq`` +
    ``flash_dkv``; the dead chunks' shares checked zero, the launches
    counted exactly, both forms timed (eager, CUDA events)."""
    from ray_tpu_torch.ops.attention import NEG_INF

    n = SEQPIPE_CHUNKS
    b, s, hq, hkv, d = TRAIN_BATCH, TRAIN_SEQ, 32, 4, 64
    g = torch.Generator(device=DEV).manual_seed(2024)
    rnd = lambda *shape: torch.randn(shape, generator=g,
                                     device=DEV).to(torch.bfloat16)
    q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), \
        rnd(b, s, hq, d)
    chunks = lambda x, dim=1: [c.contiguous() for c in x.chunk(n, dim)]
    qs, ks, vs, dos = chunks(q), chunks(k), chunks(v), chunks(do)
    ranks = list(range(n))
    rot = context.memory_rotation
    o, lse = flash.flash_fwd(q, k, v, 0, causal=True)
    dq, delta = flash.flash_dq(q, k, v, o, lse, do, 0, causal=True)
    dk, dv = flash.flash_dkv(q, k, v, lse, delta, do, 0, causal=True)

    # the loops' own kernel calls, recorded where a chunk is fully masked
    dead = {"fwd": [], "bwd": []}
    fwd_fn, vjp_fn = context.flash_attention_with_lse, context.flash_vjp_chunk

    def fwd_rec(q_, k_, v_, **kw):
        o_, lse_ = fwd_fn(q_, k_, v_, **kw)
        if kw["q_offset"] <= -q_.shape[1]:
            dead["fwd"].append([bool((o_ == 0).all()),
                                bool((lse_ <= NEG_INF / 2).all()),
                                bool((lse_ == NEG_INF).all())])
        return o_, lse_

    def vjp_rec(*args, **kw):
        out = vjp_fn(*args, **kw)
        if kw["q_offset"] <= -args[0].shape[1]:
            dead["bwd"].append([bool((x == 0).all()) for x in out])
        return out

    zero_launches(flash)
    context.flash_attention_with_lse, context.flash_vjp_chunk = \
        fwd_rec, vjp_rec
    try:
        outs = context.ring_forward(qs, ks, vs, ranks, n, rot)
        fwd_launches = read_launches(flash)
        grads = context.ring_backward(
            qs, ks, vs, [x[0] for x in outs], dos, [x[1] for x in outs],
            ranks, n, rot)
        torch.cuda.synchronize()
    finally:
        context.flash_attention_with_lse, context.flash_vjp_chunk = \
            fwd_fn, vjp_fn
    launches = read_launches(flash)
    ring_o = torch.cat([x[0] for x in outs], 1)
    ring_lse = torch.cat([x[1] for x in outs], 2)
    atol, rtol, lse_tol = TOL["bfloat16"]
    o_gap = float((ring_o.float() - o.float()).abs().max())
    o_ok = bool(torch.allclose(ring_o.float(), o.float(), atol=atol,
                               rtol=rtol))
    lse_gap = float((ring_lse - lse).abs().max())
    rel = {}
    for name, i, want in (("dq", 0, dq), ("dk", 1, dk), ("dv", 2, dv)):
        got = torch.cat([x[i] for x in grads], 1)
        rel[name] = float((got.float() - want.float()).abs().max()
                          / want.float().abs().max())
    del outs, grads

    # both forms timed as the ring runs them (eager, with the merges)
    iters = 10
    ring_fwd_ms = time_ms(torch, lambda: context.ring_forward(
        qs, ks, vs, ranks, n, rot), iters)
    os_, lses = zip(*context.ring_forward(qs, ks, vs, ranks, n, rot))
    ring_bwd_ms = time_ms(torch, lambda: context.ring_backward(
        qs, ks, vs, list(os_), dos, list(lses), ranks, n, rot), iters)
    whole_fwd_ms = time_ms(torch, lambda: flash.flash_fwd(
        q, k, v, 0, causal=True), iters)
    whole_bwd_ms = time_ms(torch, lambda: flash.flash_dkv(
        q, k, v, lse, flash.flash_dq(q, k, v, o, lse, do, 0)[1], do, 0),
        iters)
    n_dead = n * (n - 1) // 2
    rec = {"shape": {"b": b, "s": s, "hq": hq, "hkv": hkv, "d": d,
                     "chunks": n, "chunk_len": s // n, "dtype": "bfloat16"},
           "max_abs_gap_o": o_gap, "max_abs_gap_lse": lse_gap,
           "rel_gap": rel, "tol": {"o": [atol, rtol], "lse": lse_tol,
                                   "grads": BWD_REL_TOL["bfloat16"]},
           "dead_chunks": {"fwd": dead["fwd"], "bwd": dead["bwd"]},
           "launches": {"forward": {k_: fwd_launches[k_] for k_ in (
               "flash_fwd_tcb", "flash_dq", "flash_dkv")},
               "backward": {k_: launches[k_] - fwd_launches[k_] for k_ in (
                   "flash_fwd_tcb", "flash_dq", "flash_dkv")}},
           "eager_ms": {"ring_forward": ring_fwd_ms,
                        "whole_forward": whole_fwd_ms,
                        "ring_backward": ring_bwd_ms,
                        "whole_backward": whole_bwd_ms}}
    check(o_ok and lse_gap <= lse_tol and all(
        r <= BWD_REL_TOL["bfloat16"] for r in rel.values()),
        f"chunked ring off the whole-sequence kernels: o {o_gap}, lse "
        f"{lse_gap}, grads {rel}")
    check(len(dead["fwd"]) == len(dead["bwd"]) == n_dead
          and all(all(x[:2]) for x in dead["fwd"])
          and all(all(x) for x in dead["bwd"]),
          f"dead chunks not zero: {dead}")
    check(rec["launches"] == {
        "forward": {"flash_fwd_tcb": n * n, "flash_dq": 0, "flash_dkv": 0},
        "backward": {"flash_fwd_tcb": 0, "flash_dq": n * n,
                     "flash_dkv": n * n}},
        f"ring launches {rec['launches']}, want {n * n} of each kernel")
    del q, k, v, do, qs, ks, vs, dos, o, lse, dq, dk, dv, os_, lses
    torch.cuda.empty_cache()
    return rec


def seqpipe_phase(torch, np, tllama, tts, tflops, flash, smi):
    """Sequence and pipeline parallelism on one card (``seqpipe``): the
    ring's chunked arithmetic at the 1b train shape
    (``ring_arithmetic``), then 1b at full width and depth through a
    one-rank NCCL mesh: ``attn_impl="ring"`` and ``"ulysses"`` against
    plain flash steps from the same init, ``pipeline_axis="pp"`` (pp 1,
    4 microbatches) under GPipe and 1F1B against the same plain steps,
    and 1F1B through ``StepDriver(steps_per_launch=4)``, which degrades
    to single steps, against the plain 1F1B loop. The launches of the
    mesh runs (the path's) are counted exactly; the process group is
    torn down at the end."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.parallel import context
    from ray_tpu_torch.train.driver import StepDriver

    out = {"phase": "seqpipe", "nvidia_smi": smi,
           "config": "1b, 22 layers, fp32 params, bf16 compute, attn "
                     "flash, remat; one-rank mesh",
           "batch": [TRAIN_BATCH, TRAIN_SEQ + 1]}
    out["ring_arithmetic"] = ring_arithmetic(torch, flash, context)
    emit({"phase": "seqpipe_ring_arithmetic", **out["ring_arithmetic"]})

    base = dataclasses.replace(tllama.PRESETS["1b"], attn_impl="flash")
    L, m = base.n_layers, SEQPIPE_MICROBATCHES
    pipe = dict(pipeline_axis="pp", pipeline_microbatches=m)
    cfgs = {"ring": dataclasses.replace(base, attn_impl="ring"),
            "ulysses": dataclasses.replace(base, attn_impl="ulysses"),
            "gpipe": dataclasses.replace(base, **pipe),
            "1f1b": dataclasses.replace(base, pipeline_schedule="1f1b",
                                        **pipe)}
    steps = {"ring": SEQPIPE_RING_STEPS, "ulysses": SEQPIPE_ULYSSES_STEPS,
             "gpipe": SEQPIPE_PIPE_STEPS, "1f1b": SEQPIPE_PIPE_STEPS}
    opt = tts.default_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seqpipe_")
    runs = {}
    try:
        col.bootstrap_torch_distributed(
            1, 0, "seqpipe", "nccl" if DEV == "cuda" else "gloo",
            timeout_s=300, init_method=f"file://{tmp}/store")
        mesh, _ = tts.auto_mesh(1, device_type=DEV)

        def init(cfg):
            gen = torch.Generator(device=DEV).manual_seed(0)
            params, state = tts.init_sharded_state(cfg, mesh, opt,
                                                   generator=gen)
            tokens = torch.randint(0, cfg.vocab_size,
                                   (TRAIN_BATCH, TRAIN_SEQ + 1),
                                   generator=gen, device=DEV)
            return params, state, {"tokens": tokens}

        # the reference: plain flash steps from a copy of the same init
        params, state, batch = init(base)
        plain = tllama._unflatten({k: v.to_local().clone() for k, v in
                                   tts._leaves(params).items()})
        del params, state
        (_, _, ref_losses, ref_norms, plain_ms,
         plain_dev_ms) = timed_steps(torch, tts.make_train_step(
             base, opt, device=DEV), plain, opt.init(plain), batch,
             SEQPIPE_RING_STEPS)
        del plain
        torch.cuda.empty_cache()

        # the path: every mesh run below, counted from zero; each run's own
        # launches are the counters' change over its steps (a profiled
        # step after each, for the device busy share, is left out)
        zero_launches(flash)
        for name, cfg in cfgs.items():
            params, state, batch = init(cfg)
            step = tts.make_train_step(cfg, opt, mesh=mesh)
            torch.cuda.reset_peak_memory_stats()
            before = read_launches(flash)
            (params, state, losses, norms, host_ms,
             dev_ms) = timed_steps(torch, step, params, state, batch,
                                   steps[name])
            runs[name] = {"losses": losses, "grad_norms": norms,
                          "step_ms": host_ms, "step_event_ms": dev_ms,
                          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                          "launches": launch_delta(flash, before)}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, _, mm = step(params, state, batch)
                float(mm["loss"])
                wall = (time.perf_counter() - t0) * 1e3
            busy = sum(device_kernel_ms(torch, prof, 1).values())
            runs[name]["profiled_step"] = {
                "wall_ms": wall,
                "device_busy_ms": busy if busy else "not measured",
                "device_busy_share": busy / wall if busy else
                "not measured"}
            del params, state, step, prof
            torch.cuda.empty_cache()
        cfg = cfgs["1f1b"]
        params, state, batch = init(cfg)
        drv = StepDriver(cfg, opt, mesh=mesh,
                         steps_per_launch=SEQPIPE_DRIVER_K)
        drv_metrics = []
        before = read_launches(flash)
        params, state, _ = drv.run(params, state,
                                   iter([batch] * SEQPIPE_DRIVER_K),
                                   on_launch=drv_metrics.append)
        torch.cuda.synchronize()
        runs["1f1b_driver"] = {
            "losses": flat_losses(drv_metrics),
            "counts": [drv.steps, drv.launches],
            "requested_steps_per_launch": drv.requested_steps_per_launch,
            "steps_per_launch": drv.steps_per_launch, "fused": drv.fused,
            "launches": launch_delta(flash, before)}
        drv.recorder.close()
        del params, state, drv
        launches = {k: sum(r["launches"][k] for r in runs.values())
                    for k in runs["ring"]["launches"]}
    finally:
        col.clear_rendezvous("seqpipe")
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

    rel = lambda a, b: abs(a - b) / abs(b)
    tokens_per_step, seq = tts._batch_tokens(batch)
    step_flops = tokens_per_step * tflops.train_flops_per_token(base, seq)
    med = lambda xs: float(np.median(xs[1:]))     # step 1 warms up
    for name, r in runs.items():
        ref = ref_losses[:len(r["losses"])]
        r["max_rel_gap_vs_plain"] = max(rel(a, b) for a, b in zip(
            r["losses"], ref))
        if "grad_norms" in r:
            r["max_rel_gap_vs_plain"] = max(r["max_rel_gap_vs_plain"], max(
                rel(a, b) for a, b in zip(r["grad_norms"], ref_norms)))
            r["bit_equal_to_plain"] = (r["losses"] == ref and r[
                "grad_norms"] == ref_norms[:len(ref)])
            r["median_step_ms"] = med(r["step_ms"])
            r["median_step_event_ms"] = med(r["step_event_ms"])
            r["mfu"] = tflops.mfu(step_flops, r["median_step_ms"] / 1e3)
    runs["1f1b_driver"]["bit_equal_to_1f1b_loop"] = (
        runs["1f1b_driver"]["losses"] == runs["1f1b"]["losses"])
    out.update({"runs": runs, "plain_losses": ref_losses,
                "plain_grad_norms": ref_norms, "plain_step_ms": plain_ms,
                "plain_step_event_ms": plain_dev_ms,
                "plain_median_step_ms": med(plain_ms),
                "plain_mfu": tflops.mfu(step_flops, med(plain_ms) / 1e3),
                "mfu_peak": "989e12 bf16 dense (H100 SXM)",
                "launches": launches})
    emit(out)
    check(abs(ref_losses[0] - np.log(base.vocab_size)) <= FIRST_LOSS_MARGIN,
          f"first loss {ref_losses[0]} not within {FIRST_LOSS_MARGIN} of "
          f"ln {base.vocab_size}")
    for name in ("ring", "ulysses"):
        check(runs[name]["max_rel_gap_vs_plain"] <= MESH_REL_TOL,
              f"{name} off the plain step: {runs[name]['max_rel_gap_vs_plain']}"
              f" (tolerance {MESH_REL_TOL})")
    for name in ("gpipe", "1f1b"):
        check(runs[name]["max_rel_gap_vs_plain"] <= BWD_REL_TOL["bfloat16"],
              f"{name} off the plain step: {runs[name]['max_rel_gap_vs_plain']}"
              f" (tolerance {BWD_REL_TOL['bfloat16']})")
    for name, r in runs.items():
        check(all(np.isfinite(r["losses"])),
              f"{name}: non-finite losses {r['losses']}")
    drv = runs["1f1b_driver"]
    check(drv["bit_equal_to_1f1b_loop"] and drv["counts"] == [
        SEQPIPE_DRIVER_K, SEQPIPE_DRIVER_K] and not drv["fused"]
        and drv["steps_per_launch"] == 1,
        f"1f1b driver: {drv}, loop losses {runs['1f1b']['losses']}")
    for name, r in runs.items():
        sched = "1f1b" if name == "1f1b_driver" else name
        n = len(r["losses"])
        want = [c * n for c in seqpipe_launches(sched, m, L)]
        got = [r["launches"][k] for k in ("flash_fwd_tcb", "flash_dq",
                                          "flash_dkv")]
        check(got == want and r["launches"]["flash_fwd_dec"] == 0
              and r["launches"]["flash_fwd_simt"] == 0,
              f"{name}: launches {r['launches']} in {n} steps, want "
              f"tcb/dq/dkv {want}")
    return launches


def restore_launches(flash, counts):
    """Set every launch counter back to ``counts`` (a ``read_launches``):
    launches made to check a path's results stay out of its count."""
    for name in LAUNCH_COUNTERS:
        getattr(flash, name).launches = counts[name]
    for kern in flash.flash_fwd.launches_by_kernel:
        flash.flash_fwd.launches_by_kernel[kern] = counts[f"flash_fwd_{kern}"]


# ------------------------------------------------------------ tools

# rt profile's runs: (label, argv, expected records as (kind, count,
# steps a record)); the 7b modes at JAX's defaults (batch 4, seq 128, 16
# new tokens, 5 steps); --json and --out on the fused train run. Two
# short runs more, outside the measured ones (the profiler slows the
# host), take --torch-trace: train for tcb, dq and dkv, generate for tcb
# and dec
TOOLS_TRAIN = ["--preset", "1b", "--mode", "train", "--batch", "4",
               "--seq", "2048"]
#: stream_bench leg 1's concurrent streams at 7b (JAX's 64; cut to keep
#: the script inside its time limit)
TOOLS_STREAMS = 16
TOOLS_PROFILE_RUNS = (
    ("train_k1", TOOLS_TRAIN + ["--steps", "5"], [("train", 5, 1)]),
    ("train_k4", TOOLS_TRAIN + ["--steps-per-launch", "4", "--steps", "8"],
     [("train", 2, 4)]),
    ("generate", ["--preset", "7b", "--mode", "generate"],
     [("generate", 5, 1)]),
    ("speculative", ["--preset", "7b", "--mode", "speculative"],
     [("speculative", 5, 1)]),
    ("stream", ["--preset", "7b", "--mode", "stream"],
     [("prefill", 5, 1), ("decode", 75, 1)]),
    ("train_traced", TOOLS_TRAIN + ["--steps", "2"], [("train", 2, 1)]),
    ("generate_traced", ["--preset", "7b", "--mode", "generate", "--steps",
                         "1", "--new-tokens", "4"], [("generate", 1, 1)]))
TOOLS_TRACED = {"train_traced": ("tcb::flash_fwd_kernel",
                                 "flash_bwd_dq_kernel",
                                 "flash_bwd_dkv_kernel"),
                "generate_traced": ("tcb::flash_fwd_kernel",
                                    "dec::flash_fwd_kernel")}


def run_tool(main, argv, env=None, **kw):
    """``main(argv)`` in this process with its stdout captured and the
    variables in ``env`` set for the call: (return code, the text it
    printed)."""
    import contextlib
    import io

    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    buf = io.StringIO()
    try:
        os.environ.update(env)
        with contextlib.redirect_stdout(buf):
            rc = main(argv, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, buf.getvalue()


def profile_expected_launches(argv, n_layers, steps):
    """The flash launches of one ``rt profile`` run: a train step is 2L
    tcb forwards (remat) and L dq and dkv; a generate call one tcb
    prefill a layer and a dec decode step a layer for every new token but
    the last, a stream the same per step. Speculative rounds depend on
    acceptance: None."""
    mode = argv[argv.index("--mode") + 1]
    if mode == "train":
        return {"flash_fwd_tcb": 2 * n_layers * steps,
                "flash_fwd_dec": 0, "flash_dq": n_layers * steps,
                "flash_dkv": n_layers * steps}
    if mode in ("generate", "stream"):
        new = int(argv[argv.index("--new-tokens") + 1]
                  if "--new-tokens" in argv else 16)
        return {"flash_fwd_tcb": n_layers * steps,
                "flash_fwd_dec": (new - 1) * n_layers * steps,
                "flash_dq": 0, "flash_dkv": 0}
    return None


def trace_kernel_names(path):
    """The kernel names of a ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def tools_phase(torch, np, tllama, flash, smi):
    """The tooling on the card, each tool's ``main`` called in process:
    ``rt profile`` (1b train at K = 1 and K = 4, 7b generate, speculative
    and stream, and two short traced runs), kv_bench's leg 1 and
    stream_bench's leg 1 at 7b with JAX's defaults (the warm prefix cache
    sized by the tool to hold the 7b prefix's 512 MiB of pages). Record kinds and counts exact, every steady record's
    MFU in (0, 1], the artifact's keys JAX's, the device traces naming
    the flash kernels, the timeline a step span a record; warm first
    tokens against a cold forward (margin rule), every warm admission a
    hit, stream counts exact; launches exact where the work fixes them.
    The whole phase is one launch-count path, ``tools``."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import generate as TG
    from ray_tpu_torch.tools import kv_bench, profile, stream_bench
    from ray_tpu_torch.util import step_profiler

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    out = {"phase": "tools", "nvidia_smi": smi, "profile": {}}
    zero_launches(flash)
    t_phase = time.perf_counter()
    try:
        # 1. rt profile
        for label, argv, want in TOOLS_PROFILE_RUNS:
            extra = []
            if label in TOOLS_TRACED:
                extra += ["--torch-trace", f"{tmp}/trace-{label}"]
            if label == "train_k4":
                extra += ["--json", f"{tmp}/profile.json", "--out",
                          f"{tmp}/timeline.json"]
            before = read_launches(flash)
            t0 = time.perf_counter()
            rc, text = run_tool(profile.main, argv + extra + ["--device",
                                                              DEV])
            wall_s = time.perf_counter() - t0
            launched = launch_delta_since(flash, before)
            recs = step_profiler.records()
            summ = step_profiler.summary()
            steady = [line for line in text.splitlines()
                      if line.startswith(("steady-state:",
                                          "launch amortization:"))]
            for line in steady:
                print(f"rt profile {label}: {line}", flush=True)
            kinds = [(k, sum(r.kind == k for r in recs),
                      sorted({r.steps for r in recs if r.kind == k}))
                     for k in dict.fromkeys(r.kind for r in recs)]
            rec = {"argv": argv + extra, "rc": rc, "wall_s": wall_s,
                   "kinds": kinds, "steady": steady, "summary": summ,
                   "records": [{k: getattr(r, k) for k in (
                       "kind", "step", "wall_s", "compile_s", "dispatch_s",
                       "execute_s", "launches", "steps", "tokens",
                       "tokens_per_s", "mfu", "first_call",
                       "hbm_peak_bytes")} for r in recs],
                   "launches": launched,
                   "metrics": [line for line in text.splitlines()
                               if line.startswith(("rt_step_",
                                                   "rt_hbm_"))]}
            out["profile"][label] = rec
            check(rc == 0, f"rt profile {label}: rc {rc}")
            check([(k, n, [s]) for k, n, s in want] == kinds,
                  f"rt profile {label}: records {kinds}, want {want}")
            bad_mfu = [r.mfu for r in recs if not r.first_call
                       and not 0.0 < r.mfu <= 1.0]
            check(not bad_mfu, f"rt profile {label}: steady MFU outside "
                               f"(0, 1]: {bad_mfu}")
            n_layers = (tllama.PRESETS["1b"] if label.startswith("train")
                        else tllama.PRESETS["7b"]).n_layers
            steps = sum(r.steps for r in recs if r.kind in
                        ("train", "generate", "speculative", "prefill"))
            want_launches = profile_expected_launches(argv, n_layers,
                                                      steps)
            if want_launches is not None:
                got = {k: launched[k] for k in want_launches}
                check(got == want_launches,
                      f"rt profile {label}: launches {got}, want "
                      f"{want_launches}")
            else:   # speculative: a prefill of the target's L layers and
                # the draft's L/2 a call, then L verify forwards and k = 4
                # draft decode steps of L/2 a round
                draft = max(1, n_layers // 2)
                extra_tcb = launched["flash_fwd_tcb"] - (
                    n_layers + draft) * steps
                rounds = extra_tcb // n_layers
                check(extra_tcb > 0 and extra_tcb % n_layers == 0
                      and launched["flash_fwd_dec"] == 4 * draft * rounds,
                      f"rt profile speculative: launches {launched}")
                rec["rounds"] = rounds
            if label in TOOLS_TRACED:
                found = [p for p in Path(f"{tmp}/trace-{label}").glob(
                    "*.json")]
                check(len(found) == 1, f"rt profile {label}: "
                                       f"--torch-trace wrote {found}")
                names = trace_kernel_names(found[0])
                missing = [k for k in TOOLS_TRACED[label]
                           if not any(k in n for n in names)]
                rec["trace"] = {"bytes": found[0].stat().st_size,
                                "kernel_names": len(names),
                                "flash": sorted(n[:90] for n in names
                                                if "flash_" in n)}
                check(not missing, f"rt profile {label}: the device trace "
                                   f"names no {missing}")
            if label == "train_k4":
                art = json.loads(Path(f"{tmp}/profile.json").read_text())
                check(set(art) == {"schema", "t", "config", "platform",
                                   "records", "summary"}
                      and art["schema"] == "rt-profile-v1"
                      and art["platform"]["backend"] == DEV,
                      f"rt profile artifact: keys {sorted(art)}, "
                      f"platform {art.get('platform')}")
                trace = json.loads(Path(f"{tmp}/timeline.json").read_text())
                spans = sum(t["cat"] == "step" for t in trace)
                rec["timeline_events"] = len(trace)
                check(spans == len(recs), f"timeline: {spans} step spans "
                                          f"for {len(recs)} records")
        step_profiler.reset()

        # 2. kv_bench leg 1 at 7b, JAX's defaults
        seen = []
        holder = {}

        def observe(leg, prompt, first, params):
            seen.append((leg, prompt, first))
            holder["params"] = params

        before = read_launches(flash)
        t0 = time.perf_counter()
        rc, text = run_tool(kv_bench.main, ["--device", DEV],
                            env={"RT_KV_BENCH_PRESET": "7b"},
                            observe=observe)
        kv_wall_s = time.perf_counter() - t0
        kv_launched = launch_delta_since(flash, before)
        kv = json.loads(text)
        e = kv["engine_ttft"]
        print(f"kv_bench leg 1: cold p50 {e['cold']['ttft_p50_ms']} ms, "
              f"warm p50 {e['warm']['ttft_p50_ms']} ms, collapse "
              f"x{e['ttft_collapse_x']}", flush=True)
        # outside the count: the cold reference of every timed prompt,
        # one solo forward over the whole prompt
        zero_before = read_launches(flash)
        cfg = tllama.PRESETS["7b"]
        params = holder.pop("params")
        firsts = []
        with torch.inference_mode():
            for leg, prompt, first in seen:
                toks = torch.from_numpy(prompt.astype(np.int64)).to(
                    DEV)[None, :]
                cache = TG.init_cache(cfg, 1, toks.shape[1], device=DEV)
                logits = TG._forward_with_cache(params, toks, cfg, cache,
                                                0)[0, -1]
                top = torch.topk(logits, 2).values
                rel = float(top[0] - top[1]) / float(logits.abs().max())
                firsts.append({"leg": leg, "engine": int(first),
                               "solo": int(logits.argmax()),
                               "margin_rel": rel,
                               "checked": rel > WARM_MARGIN_REL_TOL})
                del cache
        del params
        restore_launches(flash, zero_before)
        torch.cuda.empty_cache()
        admissions = 2 * (kv_bench.REQUESTS + 2)
        out["kv_bench"] = {"artifact": kv, "wall_s": kv_wall_s,
                           "launches": kv_launched,
                           "admissions": admissions,
                           "first_tokens": firsts,
                           "margin_rel_tol": WARM_MARGIN_REL_TOL}
        check(rc == 0 and kv["schema"] == "rt-kv-bench-1",
              f"kv_bench: rc {rc}, schema {kv.get('schema')}")
        check(e["warm"]["kv"]["hits"] >= kv_bench.REQUESTS,
              f"kv_bench: warm hits {e['warm']['kv']}, want >= "
              f"{kv_bench.REQUESTS}")
        check(len(seen) == 2 * kv_bench.REQUESTS,
              f"kv_bench: observed {len(seen)} timed requests")
        warm_checked = [f for f in firsts if f["leg"] == "warm"
                        and f["checked"]]
        check(warm_checked, f"kv_bench: no warm prompt's cold top-2 margin "
                            f"exceeds {WARM_MARGIN_REL_TOL}")
        bad = [f for f in firsts if f["checked"]
               and f["engine"] != f["solo"]]
        check(not bad, f"kv_bench: first tokens differ from the cold "
                       f"forward above the margin: {bad}")
        check(kv_launched["flash_fwd_tcb"] == cfg.n_layers * admissions
              and kv_launched["flash_fwd_dec"] > 0,
              f"kv_bench: launches {kv_launched}, want tcb "
              f"{cfg.n_layers * admissions} (a layer an admission)")

        # 3. stream_bench leg 1 at 7b, JAX's defaults but the stream count
        before = read_launches(flash)
        t0 = time.perf_counter()
        rc, text = run_tool(stream_bench.main, ["--device", DEV],
                            env={"RT_STREAM_BENCH_PRESET": "7b",
                                 "RT_STREAM_BENCH_STREAMS":
                                     str(TOOLS_STREAMS)})
        st_wall_s = time.perf_counter() - t0
        st_launched = launch_delta_since(flash, before)
        st = json.loads(text)
        raw = st["raw_engine"]
        print(f"stream_bench leg 1: {raw['tok_s']} tok/s, "
              f"{raw['streams']} streams x {raw['tokens_per_stream']}",
              flush=True)
        out["stream_bench"] = {"artifact": st, "wall_s": st_wall_s,
                               "launches": st_launched}
        check(rc == 0 and st["schema"] == "rt-stream-bench-1"
              and raw["streams"] == TOOLS_STREAMS
              and raw["tokens_per_stream"] == 64,
              f"stream_bench: rc {rc}, {raw}")
        check(st_launched["flash_fwd_tcb"] == cfg.n_layers * 3 * TOOLS_STREAMS
              and st_launched["flash_fwd_dec"] > 0,
              f"stream_bench: launches {st_launched}, want tcb "
              f"{cfg.n_layers * 3 * TOOLS_STREAMS} (three runs of "
              f"{TOOLS_STREAMS} admissions)")
    finally:
        step_profiler.reset()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    launches = read_launches(flash)
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = launches
    emit(out)
    return launches


# the runtime's path (``cluster``): a TorchTrainer gang of one GPU worker
# trains the 1b preset CLUSTER_STEPS steps through a K = CLUSTER_K
# StepDriver, reports a checkpoint at CLUSTER_DIE_AT, dies once there and
# resumes from it; its losses against the same loop run in this process.
# The resumed attempt makes two launches: the second is warm, and its step
# time must stay within CLUSTER_WARM_RATIO of the warm in-process one's
CLUSTER_STEPS, CLUSTER_K, CLUSTER_DIE_AT = 12, 4, 4
CLUSTER_WARM_RATIO = 1.2
CLUSTER_SEED = 18
CLUSTER_REL_TOL = 1e-5
CLUSTER_EMBED = (32000, 4096)   # the 7b embedding, bf16: 262 MB


def cluster_batches(np, cfg, lo, hi):
    """Batches lo..hi-1 of the cluster phase's seeded token stream."""
    stream = np.random.default_rng(CLUSTER_SEED).integers(
        0, cfg.vocab_size, size=(CLUSTER_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1))
    return [{"tokens": stream[i]} for i in range(lo, hi)]


def cluster_train_loop(config):
    """The train loop of the ``cluster`` phase: what every worker of the
    gang runs (the gang is one worker). It builds the seeded state on its
    device, or loads the session's checkpoint, and runs the remaining
    steps through a ``StepDriver`` whose K the session's ``FastPathConfig``
    sets, reporting after each launch with the per-step losses as a
    device tensor (the session's drainer reads it) and the launches its
    process made. At ``CLUSTER_DIE_AT`` it saves (params, opt_state)
    through the session (an async save the report fences), waits until
    the trainer has registered that checkpoint, notes the time and exits
    without cleanup: the first attempt dies there once."""
    import time

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import flash
    from ray_tpu_torch.parallel import train_step as ts

    dev, cfg, K = config["device"], config["cfg"], CLUSTER_K
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    opt = ts.default_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)
    ckpt = train.get_checkpoint()
    t0 = time.perf_counter()
    if ckpt is None:
        params, state = ts.init_state(
            cfg, opt, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev)
        start = 0
    else:
        tree = ckpt.load_pytree(device=dev)
        params, state, start = tree["params"], tree["opt_state"], \
            tree["step"]
    sync()
    state_s = time.perf_counter() - t0
    drv = train.StepDriver(cfg, opt, device=dev)
    zero_launches(flash)
    for lo in range(start, CLUSTER_STEPS, K):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if dev == "cuda" else None
        if ev:
            ev[0].record()
        t0 = time.perf_counter()
        params, state, m = drv.run(params, state,
                                   iter(cluster_batches(np, cfg, lo,
                                                        lo + K)))
        if ev:
            ev[1].record()
            ev[1].synchronize()
        step, launch_s = lo + K, time.perf_counter() - t0
        metrics = {"step": step, "losses": m["loss"],
                   "steps_per_launch": drv.steps_per_launch,
                   "launch_s": launch_s,
                   # the device's clock on the card (the host's elsewhere)
                   "ms_a_step": (ev[0].elapsed_time(ev[1]) if ev
                                 else launch_s * 1e3) / K,
                   "launches": read_launches(flash), "start": start,
                   "state_s": state_s, "pid": os.getpid(),
                   "cuda_visible_devices":
                       os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "t_report": time.time()}
        zero_launches(flash)
        if step != CLUSTER_DIE_AT or ckpt is not None:
            train.report(metrics)
            continue
        save = train.Checkpoint.from_directory(
            os.path.join(config["tmp"], "worker_save"))
        t0 = time.perf_counter()
        save.save_pytree({"params": params, "opt_state": state,
                          "step": step})     # async: the session decides
        call_s = time.perf_counter() - t0
        train.report(metrics, checkpoint=save)
        save.wait_pending()
        saved = {"call_s": call_s, "save_s": time.perf_counter() - t0,
                 **save.last_save}
        marker = os.path.join(config["run_dir"], "checkpoint_000000",
                              "_metrics.json")
        while not os.path.exists(marker):
            time.sleep(0.01)
        saved["t_exit"] = time.time()
        with open(os.path.join(config["tmp"], "attempt0.json"), "w") as f:
            json.dump(saved, f)
        os._exit(1)


def cluster_gpu_probe():
    """A ``num_gpus=1`` task's view of its devices."""
    import torch

    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(),
            "device_name": (torch.cuda.get_device_name(0)
                            if torch.cuda.is_available() else None),
            "pid": os.getpid()}


def cluster_cpu_probe():
    """A CPU task beside it: no GPU pinned, and torch never imported."""
    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "torch_imported": "torch" in sys.modules, "pid": os.getpid()}


class ClusterEcho:
    """A GPU actor that takes a tensor argument and returns it."""

    def ping(self):
        return os.getpid()

    def echo(self, x):
        return {"device": str(x.device), "is_cuda": x.is_cuda,
                "tensor": x}


def cluster_phase(torch, np, tllama, flash, smi):
    """The port's runtime on the card: ``ray_tpu_torch.init()`` with no
    arguments (its GPU autodetected), a GPU task pinned to one device
    beside a CPU task, the 7b embedding as a CUDA tensor through the
    object plane and a GPU actor and back (bit-equal), then
    ``TorchTrainer`` with one GPU worker training 1b at full width and
    depth (``cluster_train_loop``: a checkpoint through the session at
    step 4, one death, the resume from it), and after ``shutdown()`` the
    same loop in this process as the reference: the losses within
    ``CLUSTER_REL_TOL``, the worker's launches exactly 2L/L/L a step."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (FailureConfig, FastPathConfig,
                                     RunConfig, ScalingConfig, StepDriver,
                                     TorchTrainer)
    from ray_tpu_torch.parallel import train_step as tts

    cfg = dataclasses.replace(tllama.PRESETS["1b"], attn_impl="flash")
    L = cfg.n_layers
    out = {"phase": "cluster", "nvidia_smi": smi, "preset": "1b",
           "steps": CLUSTER_STEPS, "k": CLUSTER_K,
           "die_at": CLUSTER_DIE_AT}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    try:
        # 1. the cluster, its GPU detected
        t0 = time.perf_counter()
        rt.init()
        out["cluster_start_s"] = time.perf_counter() - t0
        res = rt.cluster_resources()
        out["cluster_resources"] = res
        check(res.get("GPU") == 1, f"cluster: resources {res}, want GPU 1")

        # 2. a GPU task and a CPU task at once
        t0 = time.perf_counter()
        gpu_ref = rt.remote(num_gpus=1)(cluster_gpu_probe).remote()
        cpu_ref = rt.remote(cluster_cpu_probe).remote()
        gpu, cpu = rt.get([gpu_ref, cpu_ref], timeout=300)
        out["tasks"] = {"gpu": gpu, "cpu": cpu,
                        "wall_s": time.perf_counter() - t0}
        print(f"cluster: the GPU task sees {gpu['device_name']} "
              f"(CUDA_VISIBLE_DEVICES={gpu['cuda_visible_devices']})",
              flush=True)
        check(gpu["cuda_visible_devices"] not in (None, "")
              and gpu["device_count"] == 1,
              f"cluster: the num_gpus=1 task saw {gpu}")
        check(not cpu["torch_imported"] and cpu["pid"] != gpu["pid"],
              f"cluster: the CPU task {cpu}")

        # 3. a CUDA tensor through the object plane and a GPU actor
        emb = torch.randn(CLUSTER_EMBED, generator=torch.Generator(
            device=DEV).manual_seed(7), device=DEV).to(torch.bfloat16)
        nbytes = emb.numel() * emb.element_size()
        echo = rt.remote(num_gpus=1)(ClusterEcho).remote()
        rt.get(echo.ping.remote(), timeout=300)   # up before the clock
        trips = []
        for trip in ("cold", "warm"):   # cold: the actor imports torch
            t0 = time.perf_counter()
            ref = rt.put(emb)
            put_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = rt.get(echo.echo.remote(ref), timeout=300)
            torch.cuda.synchronize()
            trip_s = time.perf_counter() - t0
            got = back["tensor"]
            equal = bool(got.is_cuda and got.dtype == emb.dtype
                         and torch.equal(got, emb))
            trips.append({"trip": trip, "bytes": nbytes, "put_s": put_s,
                          "roundtrip_s": trip_s,
                          "actor_device": back["device"],
                          "mb_per_s": 2 * nbytes / 1e6 / trip_s,
                          "bit_equal": equal})
            print(f"cluster: the 7b embedding ({nbytes / 1e6:.0f} MB, "
                  f"bf16), {trip}: put in {put_s:.3f} s, to the GPU actor "
                  f"and back in {trip_s:.3f} s "
                  f"({2 * nbytes / 1e6 / trip_s:.0f} MB/s); bit-equal "
                  f"{equal}", flush=True)
            check(back["is_cuda"] and equal,
                  f"cluster: the round trip {trips[-1]}")
            del ref, back, got
        out["roundtrip"] = trips
        rt.kill(echo)
        del emb

        # 4. the gang: one GPU worker, one death, the resume
        run_dir = os.path.join(tmp, "runs", "cluster_1b")
        trainer = TorchTrainer(
            cluster_train_loop,
            train_loop_config={"device": DEV, "cfg": cfg, "tmp": tmp,
                               "run_dir": run_dir},
            scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=1),
            run_config=RunConfig(
                name="cluster_1b", storage_path=os.path.join(tmp, "runs"),
                failure_config=FailureConfig(max_failures=1),
                fast_path=FastPathConfig(steps_per_launch=CLUSTER_K)))
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
        t0 = time.perf_counter()
        rt.shutdown()
        out["shutdown_s"] = time.perf_counter() - t0
        hist = result.metrics_history
        died = json.loads(Path(tmp, "attempt0.json").read_text())
        check(result.error is None and [h["step"] for h in hist]
              == list(range(CLUSTER_DIE_AT, CLUSTER_STEPS + 1, CLUSTER_K)),
              f"cluster: fit {result.error}, steps "
              f"{[h['step'] for h in hist]}")
        # the checkpointed report, the resumed attempt's cold launch and
        # its warm one
        first, resumed, warm = hist
        check(first["start"] == 0 and resumed["start"] == CLUSTER_DIE_AT
              and first["pid"] != resumed["pid"]
              and "checkpoint_path" in first,
              f"cluster: attempts start at {first['start']} and "
              f"{resumed['start']} (pids {first['pid']}, "
              f"{resumed['pid']}), want 0 and {CLUSTER_DIE_AT}")
        worker_losses = [float(x) for h in hist for x in h["losses"]]
        launches = {k: sum(h["launches"][k] for h in hist)
                    for k in first["launches"]}
        check_launches(launches, "cluster", L, CLUSTER_STEPS)

        # 5. the reference: the same loop, uninterrupted, in this process
        torch.cuda.empty_cache()
        opt = tts.default_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)
        params, state = tts.init_state(
            cfg, opt, generator=torch.Generator(device=DEV).manual_seed(0),
            device=DEV)
        drv = StepDriver(cfg, opt, steps_per_launch=CLUSTER_K, device=DEV)
        ref_losses, ref_ms = [], []
        before = read_launches(flash)
        for lo in range(0, CLUSTER_STEPS, CLUSTER_K):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            params, state, m = drv.run(params, state, iter(
                cluster_batches(np, cfg, lo, lo + CLUSTER_K)))
            ev[1].record()
            ev[1].synchronize()
            ref_ms.append(ev[0].elapsed_time(ev[1]) / CLUSTER_K)
            ref_losses += [float(x) for x in m["loss"]]
        restore_launches(flash, before)
        del params, state, drv, m
        torch.cuda.empty_cache()
        rel = [abs(a - b) / abs(b) for a, b in zip(worker_losses,
                                                    ref_losses)]
        out.update({
            "fit_s": fit_s,
            "gang_start_to_first_report_s": first["_timestamp"] - t_fit,
            "report_roundtrip_ms": (warm["_timestamp"]
                                    - warm["t_report"]) * 1e3,
            "checkpoint_report_roundtrip_ms": (first["_timestamp"]
                                               - first["t_report"]) * 1e3,
            "checkpoint": died,
            "death_to_first_report_s": resumed["_timestamp"]
            - died["t_exit"],
            "worker_state_s": [first["state_s"], resumed["state_s"]],
            "worker_ms_a_step": [h["ms_a_step"] for h in hist],
            "in_process_ms_a_step": ref_ms,
            "warm_ms_a_step": {"worker": warm["ms_a_step"],
                               "in_process": ref_ms[-1]},
            "worker_steps_per_launch": [h["steps_per_launch"]
                                        for h in hist],
            "worker_cuda_visible_devices": first["cuda_visible_devices"],
            "losses": worker_losses, "reference_losses": ref_losses,
            "loss_rel": rel, "launches": launches,
            "launches_a_step": {k: launches[k] / CLUSTER_STEPS
                                for k in ("flash_fwd_tcb", "flash_dq",
                                          "flash_dkv")}})
        print(f"cluster ({smi}): start {out['cluster_start_s']:.2f} s, "
              f"gang start to first report "
              f"{out['gang_start_to_first_report_s']:.1f} s, worker "
              f"{[round(x, 2) for x in out['worker_ms_a_step']]} ms a step "
              f"against {[round(x, 2) for x in ref_ms]} in process (warm "
              f"{warm['ms_a_step']:.2f} against {ref_ms[-1]:.2f}), report "
              f"round trip {out['report_roundtrip_ms']:.1f} ms, checkpoint "
              f"save {died['save_s']:.1f} s, death to first report "
              f"{out['death_to_first_report_s']:.1f} s, launches a step "
              f"{out['launches_a_step']}", flush=True)
        check(all(s == CLUSTER_K for s in out["worker_steps_per_launch"]),
              f"cluster: the session's K reached the driver as "
              f"{out['worker_steps_per_launch']}")
        check(max(rel) <= CLUSTER_REL_TOL,
              f"cluster: worker losses {worker_losses} against "
              f"{ref_losses} (rel {max(rel)})")
        check(warm["ms_a_step"] <= CLUSTER_WARM_RATIO * ref_ms[-1],
              f"cluster: the worker's warm step {warm['ms_a_step']:.2f} ms "
              f"against {ref_ms[-1]:.2f} in process")
    finally:
        if rt.is_initialized():
            rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


# ------------------------------------------------------------ phase 21

DEPLOY_SEED = 0
DEPLOY_ENGINE = {"max_slots": 8, "max_len": 1024, "decode_stride": 8}
DEPLOY_STREAM_ITEMS = 6
DEPLOY_STREAM_SHAPE = (4096, 4096)   # bf16: 32 MiB an item
DEPLOY_STREAM_BENCH = {"streams": 16, "tokens": 32, "sweep": [16, 64],
                       "per_n": 1}
DEPLOY_KV_BENCH = {"prefix_len": 1024, "suffix_len": 56, "max_new": 8,
                   "slots": 8, "stride": 4, "rps": 5.0, "secs": 2.0,
                   "rounds": 1}
#: what the phase cuts from each tool's defaults (JAX's knobs)
DEPLOY_CUTS = {
    "stream_bench": "16 streams of 32 tokens (JAX 64 of 64); the RPC "
                    "sweep at 16 and 64 "
                    "tokens, 1 request each (JAX 16, 64, 256, 4 each; a "
                    "request's RPC count does not vary); "
                    "the push and pull legs on "
                    "the phase's replica (JAX deploys one a leg; the pull "
                    "knob is the consumer's)",
    "kv_bench": "legs 2 and 3 only (leg 1 runs in tools); 1 round of 2 s "
                "a leg (JAX 3 of 12 s); each replica a quarter of the "
                "one GPU"}


def deploy_cuda_stream(n, endless=False):
    """A streaming GPU task: ``n`` bf16 CUDA tensors from a seeded
    generator (or without end)."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(DEPLOY_SEED)
    i = 0
    while endless or i < n:
        yield torch.randn(DEPLOY_STREAM_SHAPE, generator=g,
                          device=DEV).to(torch.bfloat16)
        i += 1


def deploy_llm_class():
    """``ContinuousLLM`` with two methods for the phase: the replica's
    device view, and its flash launch counts (``read_launches`` in the
    replica's process)."""
    from ray_tpu_torch.serve.llm import ContinuousLLM

    class DeployLLM(ContinuousLLM):
        def device_info(self):
            import torch

            return {"cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device_count": torch.cuda.device_count(),
                    "device": str(self.device),
                    "device_name": (torch.cuda.get_device_name(0)
                                    if torch.cuda.is_available() else None),
                    "pid": os.getpid()}

        def launches(self):
            from ray_tpu_torch.ops import flash

            return read_launches(flash)

    DeployLLM.__name__ = DeployLLM.__qualname__ = "ContinuousLLM"
    return DeployLLM


def deploy_http_request(port, route, prompt, n_new):
    """One streamed HTTP request: its tokens (a line each) and the seconds
    to the first."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", route, json.dumps(
        {"tokens": [int(t) for t in prompt], "max_new_tokens": n_new}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    toks, ttft = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        if ttft is None:
            ttft = time.perf_counter() - t0
        toks += [int(t) for t in line.split()]
    status = resp.status
    conn.close()
    return {"status": status, "tokens": toks, "ttft_s": ttft}


def deploy_handle_request(h, prompt, n_new):
    """One streamed handle request: its tokens, the seconds to the first,
    its transport and RPC count."""
    t0 = time.perf_counter()
    gen = h.remote({"tokens": [int(t) for t in prompt],
                    "max_new_tokens": n_new}).result(timeout=600)
    toks, ttft = [], None
    for t in gen:
        if ttft is None:
            ttft = time.perf_counter() - t0
        toks.append(int(t))
    return {"tokens": toks, "ttft_s": ttft, "transport": gen._transport,
            "rpcs": gen._rpcs}


def pcts(np, vals):
    return {"p50": float(np.percentile(vals, 50)),
            "p99": float(np.percentile(vals, 99))}


def card_used(torch):
    """Bytes in use on the card, by every process (0 on the CPU)."""
    if DEV != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info()
    return total - free


def deploy_wait_card_free(torch, used0, slack_gib=2.0, timeout_s=120.0):
    """Seconds until the card's memory in use is back within ``slack_gib``
    of ``used0`` (a deleted replica's process has exited); fails after
    ``timeout_s``."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    while card_used(torch) > used0 + slack_gib * 2**30:
        check(time.perf_counter() - t0 < timeout_s,
              f"deploy: {card_used(torch) / 2**30:.1f} GiB of the card "
              f"still held {timeout_s:.0f} s after a deployment was "
              f"deleted (before it: {used0 / 2**30:.1f} GiB)")
        time.sleep(0.5)
    return time.perf_counter() - t0


def deploy_reference(torch, tllama, cfg, prompts, n_new, between):
    """An in-process ``ContinuousEngine`` of the replica's config and
    seed: its greedy tokens, fed one request at a time as the replica will
    be; then ``between()``; then stream_bench's raw leg on it
    (``DEPLOY_STREAM_BENCH``); its weights and cache are freed on
    return."""
    from ray_tpu_torch.models.serving import ContinuousEngine
    from ray_tpu_torch.tools import stream_bench

    params = tllama.init_params(
        cfg, generator=torch.Generator(device=DEV).manual_seed(DEPLOY_SEED),
        device=DEV)
    eng = ContinuousEngine(params, cfg, **DEPLOY_ENGINE, kv_cache_bytes=0,
                           device=DEV)
    ref = []
    try:
        for p in prompts:
            wave = Wave(eng, "deploy_ref", n_new)
            wave.submit(p)
            wave.join()
            ref.append([int(t) for t in wave.outs[0]])
        between()
        sb = DEPLOY_STREAM_BENCH
        raw = {"tok_s": round(stream_bench.engine_tok_s(
            eng, sb["streams"], sb["tokens"]), 1),
            "streams": sb["streams"], "tokens_per_stream": sb["tokens"]}
    finally:
        eng.shutdown()
    return ref, raw


def deploy_phase(torch, np, tllama, flash, smi):
    """The serve deployment layer on the card: the port's cluster with its
    one GPU; a streaming GPU task yielding CUDA tensors (bit-equal to the
    same seeded draws here; its fresh worker starts while an in-process
    ``ContinuousEngine`` of the replica's config makes the reference
    tokens), and an endless one closed early (the GPU it held takes the
    next task); ``continuous_llm_app("7b")`` on a one-GPU replica serving
    ``SERVE_PROMPT_LENS`` greedily, one request at a time, through the
    handle (push, then pull) and through HTTP, each token equal to the
    reference's; ``tcb`` and ``dec`` counted in the replica, exactly a
    layer each for every admission and decode step of its engine;
    stream_bench's push and pull legs with the RPC sweep on that replica
    against the reference's raw engine leg; kv_bench's legs 2 and 3
    (``DEPLOY_CUTS``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import continuous_llm_app
    from ray_tpu_torch.tools import kv_bench, stream_bench

    cfg = dataclasses.replace(tllama.PRESETS["7b"], attn_impl="flash")
    out = {"phase": "deploy", "nvidia_smi": smi, "preset": "7b",
           "engine": DEPLOY_ENGINE, "cuts": DEPLOY_CUTS}
    rng = np.random.default_rng(DEPLOY_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=s).astype(np.int64)
               for s in SERVE_PROMPT_LENS]
    n_new = SERVE_NEW_TOKENS
    torch.cuda.empty_cache()
    used0 = card_used(torch)   # what earlier phases left on the card
    out["card_used_at_start_gib"] = used0 / 2**30
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        rt.init()
        out["cluster_start_s"] = time.perf_counter() - t0
        res = rt.cluster_resources()
        check(res.get("GPU") == 1, f"deploy: resources {res}, want GPU 1")

        # 1. a streaming GPU task: CUDA tensors, read once the in-process
        # reference has its tokens (the task's fresh worker starts
        # meanwhile), then one closed early
        gen_fn = rt.remote(num_gpus=1, num_returns="streaming")(
            deploy_cuda_stream)
        t0 = time.perf_counter()
        stream = gen_fn.remote(DEPLOY_STREAM_ITEMS)
        got = []

        def read_stream():
            got.extend(rt.get(r, timeout=300) for r in stream)

        counted = read_launches(flash)
        ref, raw = deploy_reference(torch, tllama, cfg, prompts, n_new,
                                    read_stream)
        restore_launches(flash, counted)
        stream_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"deploy: the in-process reference done; this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        g = torch.Generator(device=DEV).manual_seed(DEPLOY_SEED)
        want = [torch.randn(DEPLOY_STREAM_SHAPE, generator=g,
                            device=DEV).to(torch.bfloat16)
                for _ in range(DEPLOY_STREAM_ITEMS)]
        equal = [bool(a.device.type == DEV and torch.equal(a, b))
                 for a, b in zip(got, want)]
        check(len(got) == DEPLOY_STREAM_ITEMS and all(equal),
              f"deploy: streamed CUDA tensors {len(got)}, equal {equal}")
        endless = gen_fn.remote(0, True)
        it = iter(endless)
        head = [rt.get(next(it), timeout=300) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(head, want)),
              "deploy: the endless stream's head")
        endless.close()
        del it, endless, head, got, want
        t0 = time.perf_counter()
        probe = rt.get(rt.remote(num_gpus=1)(cluster_gpu_probe).remote(),
                       timeout=120)
        out["gpu_stream"] = {
            "items": DEPLOY_STREAM_ITEMS, "item_bytes": 2 * int(
                np.prod(DEPLOY_STREAM_SHAPE)),
            "wall_s_beside_reference": stream_s, "bit_equal": all(equal),
            "closed_early_then_gpu_task_s": time.perf_counter() - t0}
        check(probe["cuda_visible_devices"] not in (None, "")
              and probe["device_count"] == (DEV == "cuda"),
              f"deploy: the GPU after the closed stream: {probe}")
        print(f"deploy: streamed {DEPLOY_STREAM_ITEMS} CUDA tensors, "
              f"bit-equal, {stream_s:.1f} s from the task's submission (the "
              f"reference ran meanwhile); closed early", flush=True)

        # 2. the 7b app on a one-GPU replica
        app = continuous_llm_app(
            "7b", **DEPLOY_ENGINE, kv_cache_bytes=0, seed=DEPLOY_SEED,
            max_ongoing_requests=4 * DEPLOY_STREAM_BENCH["streams"],
            name="CB", device=DEV)
        check(app._deployment._config.ray_actor_options
              == ({"num_gpus": 1} if DEV == "cuda" else {}),
              f"deploy: continuous_llm_app reserved "
              f"{app._deployment._config.ray_actor_options}")
        dep = app._deployment
        app = type(dep)(deploy_llm_class(), dep.name, dep._config).bind(
            *app._args, **app._kwargs)
        t0 = time.perf_counter()
        serve.run(app, name="deploy", route_prefix="/cb",
                  http_options=serve.HTTPOptions(port=0))
        out["replica_start_to_ready_s"] = time.perf_counter() - t0
        h = serve.get_app_handle("deploy")
        info = h.options(method_name="device_info").remote().result(
            timeout=120)
        out["replica"] = info
        print(f"deploy: replica ready in "
              f"{out['replica_start_to_ready_s']:.1f} s: {info}", flush=True)
        check(info["device_count"] == (DEV == "cuda")
              and (info["cuda_visible_devices"] not in (None, ""))
              == (DEV == "cuda") and info["device"] == DEV,
              f"deploy: the replica's devices {info}")
        port = serve.http_port()

        before = h.options(method_name="launches").remote().result(
            timeout=120)
        stats0 = h.options(method_name="engine_stats").remote().result(
            timeout=120)
        served = {"push": [], "pull": [], "http": []}
        for p in prompts:
            served["push"].append(deploy_handle_request(h, p, n_new))
        os.environ["RT_STREAM_PULL"] = "1"
        try:
            for p in prompts:
                served["pull"].append(deploy_handle_request(h, p, n_new))
        finally:
            del os.environ["RT_STREAM_PULL"]
        for p in prompts:
            served["http"].append(deploy_http_request(port, "/cb", p, n_new))
        after = h.options(method_name="launches").remote().result(
            timeout=120)
        stats1 = h.options(method_name="engine_stats").remote().result(
            timeout=120)
        launches = {k: after[k] - before[k] for k in after}
        out["launches"] = launches
        # a prefill a layer for every admission, a decode step a layer for
        # every engine decode step, in the replica's engine over the window
        admitted = stats1["admitted"] - stats0["admitted"]
        steps = stats1["decode_steps"] - stats0["decode_steps"]
        out["engine_window"] = {"admitted": admitted, "decode_steps": steps}
        L = cfg.n_layers
        check(admitted == 3 * len(prompts)
              and launches["flash_fwd_tcb"] == L * admitted
              and launches["flash_fwd_dec"] == L * steps > 0
              and launches["flash_fwd_simt"] == 0,
              f"deploy: the replica's launches {launches}, its engine "
              f"admitted {admitted} requests in {steps} decode steps "
              f"({L} layers)")
        check([r["transport"] for r in served["push"]] == ["push"] * len(
            prompts) and [r["transport"] for r in served["pull"]]
              == ["pull"] * len(prompts),
              f"deploy: transports {[r['transport'] for r in served['push']]}"
              f" {[r['transport'] for r in served['pull']]}")
        check(all(r["status"] == 200 for r in served["http"]),
              f"deploy: HTTP statuses {[r['status'] for r in served['http']]}")
        for leg in served:
            out[f"ttft_{leg}_s"] = pcts(np, [r["ttft_s"]
                                             for r in served[leg]])
        print(f"deploy: served {3 * len(prompts)} requests; replica "
              f"launches {launches}", flush=True)
        out["rpcs_per_request"] = {
            "push": [r["rpcs"] for r in served["push"]],
            "pull": [r["rpcs"] for r in served["pull"]]}

        # 3. stream_bench's transport legs on this replica, its raw leg here
        sb = DEPLOY_STREAM_BENCH
        t0 = time.perf_counter()
        legs = stream_bench.transport_legs(h, sb["streams"], sb["tokens"],
                                           sb["sweep"], sb["per_n"])
        legs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve.delete("deploy")
        del h
        out["replica_teardown_s"] = deploy_wait_card_free(torch, used0)

        # 4. the served tokens against the reference's, stream_bench's
        # legs against its raw leg
        art = {"raw_engine": raw, **legs}
        stream_bench.summarize(art)
        art["legs_s"] = legs_s
        out["stream_bench"] = art
        print(f"deploy: stream_bench {json.dumps(art)}", flush=True)
        match = {leg: [r["tokens"] == want for r, want in
                       zip(served[leg], ref)] for leg in served}
        out["tokens_equal_in_process"] = match
        print(f"deploy: tokens equal to the in-process engine's: {match}",
              flush=True)
        check(all(all(m) for m in match.values()),
              f"deploy: served tokens against the in-process engine "
              f"{match}")

        # 5. kv_bench's legs 2 and 3
        out["card_free_before_kv_s"] = deploy_wait_card_free(torch, used0)
        kb = DEPLOY_KV_BENCH
        max_len = kb["prefix_len"] + 2 * (kb["suffix_len"]
                                          + kb["max_new"]) + 64
        t0 = time.perf_counter()
        kv = kv_bench._serve_legs(
            "7b", kb["prefix_len"], kb["suffix_len"], kb["max_new"],
            kb["slots"], kb["stride"], kb["rps"], kb["secs"], kb["rounds"],
            max_len, torch.device(DEV))
        kv["legs_s"] = time.perf_counter() - t0
        out["kv_bench"] = kv
        check(kv["hits_advancing"] and all(
            kv["serve"][leg]["completed"] > 0 for leg in kv["serve"]),
            f"deploy: kv_bench legs {kv['serve']}")
        out["ttft_warm_vs_cold"] = {
            "cold_p50_ms": kv["serve"]["cold"]["ttft_p50_ms"],
            "warm_p50_ms": kv["serve"]["warm"]["ttft_p50_ms"],
            "collapse_x": kv["ttft_collapse_x_serve"]}
        serve.shutdown()
    finally:
        if rt.is_initialized():
            try:
                serve.shutdown()
            finally:
                rt.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    sb = out["stream_bench"]
    print(f"deploy ({smi}): cluster start {out['cluster_start_s']:.2f} s, "
          f"replica start to ready {out['replica_start_to_ready_s']:.1f} s "
          f"on {out['replica']['device_name']} (CUDA_VISIBLE_DEVICES="
          f"{out['replica']['cuda_visible_devices']}); TTFT p50/p99 handle "
          f"{out['ttft_push_s']['p50'] * 1e3:.1f}/"
          f"{out['ttft_push_s']['p99'] * 1e3:.1f} ms, HTTP "
          f"{out['ttft_http_s']['p50'] * 1e3:.1f}/"
          f"{out['ttft_http_s']['p99'] * 1e3:.1f} ms; push "
          f"{sb['push']['tok_s']} tok/s against the raw engine's "
          f"{sb['raw_engine']['tok_s']} (push_vs_raw_ratio "
          f"{sb['push_vs_raw_ratio']}); RPCs a request by tokens: push "
          f"{[(s['tokens'], s['rpcs_mean']) for s in sb['push']['rpc_scaling']]}"
          f", pull "
          f"{[(s['tokens'], s['rpcs_mean']) for s in sb['pull']['rpc_scaling']]}"
          f"; TTFT warm {out['ttft_warm_vs_cold']['warm_p50_ms']} ms against "
          f"cold {out['ttft_warm_vs_cold']['cold_p50_ms']} ms; replica "
          f"launches tcb {out['launches']['flash_fwd_tcb']}, dec "
          f"{out['launches']['flash_fwd_dec']}; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    emit(out)
    return out["launches"]


# ------------------------------------------------------------ actors

ACTORS_PPO_ITERS = 4
ACTORS_IMPALA_ITERS = 4
ACTORS_LEARNERS, ACTORS_GPUS_PER_LEARNER = 2, 0.5
ACTORS_RLHF_ITERS = 2
# the session's object store, sized for ONE 1b bf16 shipment (2.2 GB)
# and headroom: the consumer frees each oid frame as it decodes it, so
# the store never holds more than one shipment; the phase checks that the
# store's and /dev/shm's used bytes are back at their level after every
# sync (within these slacks) and that nothing spilled
ACTORS_STORE_BYTES = 3 << 30
ACTORS_STORE_SLACK, ACTORS_SHM_SLACK = 64 << 20, 256 << 20
ACTORS_SHIP_SEED = 23
# the actor pipeline's first iteration against the in-process one on the
# same card, weights and seed: the same kernels on the same inputs, so
# tokens exact and every float within this relative difference
ACTORS_RLHF_REL_TOL = 1e-5
# the in-process rlhf phase's first iteration (generate sequences, reward
# scores, reference logprobs, the learner's metrics), kept for the actors
# phase
RLHF_FIRST = {}


def actor_role_classes(tpipe):
    """The pipeline's role classes as counted by the actors phase: each
    phase method of ``RLHF_ROLE_METHODS`` reads the flash launch counts
    by kernel in the role's process before and after and keeps its
    output, read back (and cleared) by ``phase_record()``; the learner
    ships, and the generator fetches and checks, a seeded 1b tree
    (``ship_check`` / ``fetch_check``)."""
    by_role = {}
    for role, method, phase in RLHF_ROLE_METHODS:
        by_role.setdefault(role, []).append((method, phase))
    names = {"learner": "RLHFLearner", "reference": "RLHFReference",
             "reward": "RLHFReward", "generator": "RLHFGenerator"}
    out = {}
    for role, cls_name in names.items():
        base = getattr(tpipe, cls_name)
        body = {}

        def init(self, *a, _base=base, **kw):
            _base.__init__(self, *a, **kw)
            self._by_phase, self._outs = {}, {}

        def phase_record(self):
            rec = {"launches": self._by_phase, "outputs": self._outs}
            self._by_phase, self._outs = {}, {}
            return rec

        body.update(__init__=init, phase_record=phase_record)
        for method, phase in by_role[role]:
            def counted(self, *a, _base=base, _m=method, _p=phase):
                from ray_tpu_torch.ops import flash

                before = read_launches(flash)
                res = getattr(_base, _m)(self, *a)
                after = read_launches(flash)
                self._by_phase[_p] = {k: after[k] - before[k] for k in after}
                self._outs[_p] = res
                return res
            body[method] = counted
        if role == "learner":
            body["ship_check"] = actors_ship_check
            body["ship_release"] = actors_ship_release
        if role == "generator":
            body["fetch_check"] = actors_fetch_check
        out[cls_name] = type(cls_name, (base,), body)
    return out


def actors_seeded_tree(role, seed):
    """A 1b params tree in the role's compute dtype on its device, drawn
    from ``seed``."""
    import torch

    from ray_tpu_torch.models import llama

    gen = torch.Generator(device=role.device).manual_seed(seed)
    return llama.init_params(role.cfg, generator=gen, device=role.device,
                             dtype=role.cfg.compute_dtype)


def actors_ship_check(self, seed):
    """Learner side: ship a seeded 1b tree (kept alive until released)."""
    from ray_tpu_torch import collective

    self._ship_tree = actors_seeded_tree(self, seed)
    t0 = time.perf_counter()
    ticket = collective.ship_params(self._ship_tree)
    ticket["ship_s"] = time.perf_counter() - t0
    return ticket


def actors_ship_release(self):
    import torch

    self._ship_tree = None
    torch.cuda.empty_cache()


def actors_fetch_check(self, ticket, seed, drop):
    """Generator side: fetch the shipment (chaos dropping the push
    channel on its first take where ``drop``), then hold every leaf
    against the same seeded tree drawn here: dtype, device and values."""
    import torch

    from ray_tpu_torch import collective
    from ray_tpu_torch.parallel.train_step import _leaves
    from ray_tpu_torch.util import chaos

    if drop:
        chaos.arm('{"seed": 1, "faults": [{"site": "rpc.drop", "target": '
                  '"stream_push", "at": 1, "max_fires": 1}]}')
    try:
        t0 = time.perf_counter()
        got, info = collective.fetch_params(ticket)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        info["fetch_s"] = time.perf_counter() - t0
    finally:
        if drop:
            chaos.disarm()
    want = _leaves(actors_seeded_tree(self, seed))
    got = _leaves(got)
    info["leaf_exact"] = (got.keys() == want.keys() and all(
        g.dtype == w.dtype and g.device == w.device and torch.equal(g, w)
        for g, w in ((got[k], want[k]) for k in want)))
    info["device"] = str(next(iter(got.values())).device)
    del got, want
    torch.cuda.empty_cache()
    return info


def averaged_pair_syncs(n):
    """``n`` grad syncs for ``n`` learners updating in ``n`` threads: each
    returns the members' mean gradient (the LearnerGroup's allreduce /
    world, here on the device)."""
    barrier = threading.Barrier(n, timeout=300)
    slots = [None] * n

    def make(i):
        def sync(grads):
            from ray_tpu_torch.rl import models as rlm

            slots[i] = grads
            barrier.wait()
            total = slots[0]
            for other in slots[1:]:
                total = rlm.tree_map(lambda a, b: a + b, total, other)
            avg = rlm.tree_map(lambda a: a / n, total)
            barrier.wait()
            return avg
        sync.barrier = barrier
        return sync

    return [make(i) for i in range(n)]


def actors_ppo_build(trl):
    """PPO at ``RL_TUNED_PPO`` with a LearnerGroup of ``ACTORS_LEARNERS``
    learner actors at ``ACTORS_GPUS_PER_LEARNER`` GPUs: (algo, build s)."""
    cfg = trl.PPOConfig().training(**RL_TUNED_PPO)
    cfg.num_learners = ACTORS_LEARNERS
    cfg.num_gpus_per_learner = ACTORS_GPUS_PER_LEARNER
    t0 = time.perf_counter()
    algo = cfg.build(device=DEV)
    return algo, time.perf_counter() - t0


def actors_ppo(torch, np, trl, rt, algo, build_s):
    """PPO at ``RL_TUNED_PPO`` on 2 CPU runner actors with a LearnerGroup
    of 2 learners at half a GPU each: the members bit-equal after every
    update, the first update against two in-process learners on the same
    shards averaging their gradients (within RL_CNN_REL_TOL)."""
    from ray_tpu_torch.rl import models as rlm
    from ray_tpu_torch.rl.algorithms.ppo import make_ppo_loss
    from ray_tpu_torch.rl.learner import Learner

    cfg = algo.config
    init = algo.get_params()        # rank 0's, broadcast to both
    check(all(isinstance(r, rt.ActorHandle) for r in algo.runners)
          and isinstance(algo.learner, trl.LearnerGroup),
          "actors: PPO's runners and learners are not actors")
    first = {}
    group_update = algo.learner.update

    def capture(batch, **kw):
        if not first:
            first.update(batch={k: np.array(v) for k, v in batch.items()},
                         kw=kw)
        return group_update(batch, **kw)

    algo.learner.update = capture
    iters, members_equal, after_first = [], [], None
    try:
        for i in range(ACTORS_PPO_ITERS):
            t0 = time.perf_counter()
            r = algo.train()
            wall = time.perf_counter() - t0
            members = rt.get([a.get_params.remote()
                              for a in algo.learner.actors])
            members_equal.append(all(
                torch.equal(a, b) for a, b in zip(tree_leaves(members[0]),
                                                  tree_leaves(members[1]))))
            if i == 0:
                after_first = members[0]
            iters.append({"wall_s": wall, "loss": r["loss"],
                          "episode_return_mean": r["episode_return_mean"],
                          "env_steps_this_iter": r["env_steps_this_iter"]})
    finally:
        algo.stop()
    # the reference: two in-process learners on the card, the same shards
    batch, kw = first["batch"], first["kw"]
    n = len(batch["rewards"])
    n_even = n - n % ACTORS_LEARNERS
    loss_fn = make_ppo_loss(algo.spec, cfg.clip_param, cfg.vf_coeff,
                            cfg.entropy_coeff)
    syncs = averaged_pair_syncs(ACTORS_LEARNERS)
    learners = [Learner(rlm.clone_tree(init), loss_fn, cfg.lr,
                        grad_clip=cfg.grad_clip, seed=cfg.seed, device=DEV,
                        grad_sync=syncs[i])
                for i in range(ACTORS_LEARNERS)]
    errors = []

    def member(i):
        try:
            learners[i].update({k: v[i:n_even:ACTORS_LEARNERS]
                                for k, v in batch.items()}, **kw)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)
            syncs[i].barrier.abort()

    threads = [threading.Thread(target=member, args=(i,))
               for i in range(ACTORS_LEARNERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    ref = [[t.cpu() for t in tree_leaves(lr.get_params())]
           for lr in learners]
    got = tree_leaves(after_first)
    rel = [float((g - w).abs().max() / (w.abs().max() + 1e-12))
           for g, w in zip(got, ref[0])]
    out = {"config": {**RL_TUNED_PPO, "num_learners": ACTORS_LEARNERS,
                      "num_gpus_per_learner": ACTORS_GPUS_PER_LEARNER},
           "build_s": build_s, "iterations": iters,
           "members_bit_equal": members_equal,
           "first_update_rel_err_max": max(rel),
           "reference_members_equal": all(
               torch.equal(a, b) for a, b in zip(ref[0], ref[1]))}
    check(all(members_equal), f"actors: the LearnerGroup's members differ "
                              f"after an update: {members_equal}")
    check(max(rel) <= RL_CNN_REL_TOL,
          f"actors: the group's first update against two in-process "
          f"learners: rel err {max(rel)} > {RL_CNN_REL_TOL}")
    check(all(np.isfinite(it["loss"]) and it["env_steps_this_iter"]
              == 2 * 8 * 64 for it in iters), f"actors: PPO {iters}")
    return out


def actors_impala_build(trl):
    """cartpole-impala's algorithm on runner actors: (algo, build s)."""
    cfg = trl.IMPALAConfig().training(**RL_OTHERS[0][3])
    t0 = time.perf_counter()
    algo = cfg.build(device=DEV)
    return algo, time.perf_counter() - t0


def actors_impala(np, rt, algo, build_s):
    """cartpole-impala's config on 2 runner actors, fragments consumed in
    ``wait`` order, the learner on the card."""
    name, run, env, conf, _, steps = RL_OTHERS[0]
    iters = []
    try:
        check(len(algo.runners) == 2 and all(
            isinstance(r, rt.ActorHandle) for r in algo.runners),
            "actors: IMPALA's runners are not actors")
        for _ in range(ACTORS_IMPALA_ITERS):
            t0 = time.perf_counter()
            r = algo.train()
            iters.append({"wall_s": time.perf_counter() - t0,
                          "pi_loss": r["pi_loss"],
                          "env_steps_this_iter": r["env_steps_this_iter"],
                          "episode_return_mean": r["episode_return_mean"]})
    finally:
        algo.stop()
    check(all(np.isfinite(it["pi_loss"]) and it["env_steps_this_iter"]
              == steps for it in iters), f"actors: IMPALA {iters}")
    return {"config": name, "build_s": build_s, "iterations": iters}


def actors_rlhf_reference(torch, np, tllama):
    """The in-process pipeline's first iteration when the rlhf phase did
    not run: its sequences, scores, logprobs and learner metrics."""
    from ray_tpu_torch.rl.rlhf import pipeline as tpipe

    cfg = dataclasses.replace(tllama.PRESETS[RLHF_PRESET], attn_impl="flash")
    pipe = tpipe.RLHFPipeline(tpipe.RLHFConfig(preset=cfg, **RLHF_CFG),
                              device=DEV)
    seen = {}
    for role, method, phase in RLHF_ROLE_METHODS[:4]:
        obj = getattr(pipe, role)
        fn = getattr(obj, method)

        def spy(*a, _fn=fn, _p=phase):
            seen[_p] = _fn(*a)
            return seen[_p]
        setattr(obj, method, spy)
    try:
        pipe.run_iteration()
    finally:
        pipe.shutdown()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return rlhf_first_record(seen)


def rlhf_first_record(seen):
    """What the actors phase compares of a first RLHF iteration."""
    return {"sequences": seen["generate"]["sequences"],
            "scores": seen["score_reward"]["scores"],
            "logprobs": seen["score_ref"]["logprobs"],
            "update": {k: seen["update"][k] for k in (
                "loss", "ratio_mean", "kl_mean", "reward_mean")}}


def actors_rlhf_build(tllama, tpipe):
    """The pipeline at ``RLHF_PRESET`` and ``RLHF_CFG`` with its four
    roles as counted GPU actors (``actor_role_classes``): (pipe, seconds
    to the roles' readiness)."""
    cfg = dataclasses.replace(tllama.PRESETS[RLHF_PRESET], attn_impl="flash")
    rc = tpipe.RLHFConfig(preset=cfg, **RLHF_CFG)
    saved = {name: getattr(tpipe, name) for name in (
        "RLHFLearner", "RLHFReference", "RLHFReward", "RLHFGenerator")}
    for name, cls in actor_role_classes(tpipe).items():
        setattr(tpipe, name, cls)
    t0 = time.perf_counter()
    try:
        pipe = tpipe.RLHFPipeline(rc, device=DEV)
    finally:
        for name, cls in saved.items():
            setattr(tpipe, name, cls)
    return pipe, time.perf_counter() - t0


def actors_rlhf(torch, np, tllama, tpipe, rt, ref, pipe, roles_start_s):
    """The RLHF pipeline on four role actors at 1b, full width: 2
    iterations, each role phase's launches counted in its process and
    held exactly to ``rlhf_expected_launches``; the first iteration
    against the in-process pipeline; a 1b shipment between two role
    processes by push and by the fallback."""
    from ray_tpu_torch.parallel.train_step import _leaves

    cfg, rc = pipe.cfg.preset, pipe.cfg
    out = {"roles_start_s": roles_start_s,
           "placement": pipe.stats()["placement"]}
    print(f"actors: four RLHF roles up in {roles_start_s:.1f} s", flush=True)
    results, records, engine, want = [], [], [], []
    total = {k: 0 for k in read_launches_keys()}
    ship = {}
    # the store before any sync, then after each
    store = [actors_store()]
    try:
        for _ in range(ACTORS_RLHF_ITERS):
            e0 = rt.get(pipe.generator.engine_stats.remote())
            t0 = time.perf_counter()
            results.append(pipe.run_iteration())
            wall = time.perf_counter() - t0
            e1 = rt.get(pipe.generator.engine_stats.remote())
            rec = {}
            for role in ("generator", "reward", "reference", "learner"):
                r = rt.get(getattr(pipe, role).phase_record.remote())
                for phase, counts in r["launches"].items():
                    rec.setdefault("launches", {})[phase] = counts
                    for k in total:
                        total[k] += counts[k]
                rec.setdefault("outputs", {}).update(r["outputs"])
            steps = e1["decode_steps"] - e0["decode_steps"]
            admitted = e1["admitted"] - e0["admitted"]
            engine.append({"decode_steps": steps, "admitted": admitted,
                           "wall_s": wall})
            want.append(rlhf_expected_launches(cfg.n_layers, rc.num_epochs,
                                               admitted, steps))
            records.append(rec)
            store.append(actors_store())
        # a 1b bf16 tree between two role processes: push, then chaos
        for drop in (False, True):
            ticket = rt.get(pipe.learner.ship_check.remote(ACTORS_SHIP_SEED))
            t0 = time.perf_counter()
            info = rt.get(pipe.generator.fetch_check.remote(
                ticket, ACTORS_SHIP_SEED, drop))
            info["wall_s"] = time.perf_counter() - t0
            info["ship_s"] = ticket["ship_s"]
            rt.get(pipe.learner.ship_release.remote())
            ship["fallback" if drop else "push"] = info
            store.append(actors_store())
        summary = pipe.stats()["recorder"]
    finally:
        pipe.shutdown()
    out.update(engine=engine, ship=ship, launches=total, store=store,
               launches_by_iteration=[r["launches"] for r in records],
               recorder={k: summary.get(k) for k in (
                   "bubble_fraction", "coverage", "role_busy_frac",
                   "tax_s", "staleness", "receipt_last")},
               iterations=[{k: r[k] for k in (
                   "iteration", "loss", "kl_mean", "reward_mean",
                   "phases_s", "phases_actor_s", "tokens_generated",
                   "generate_tok_s", "sync_bytes", "sync_s",
                   "swap_drain_s", "receipt", "weights_version",
                   "decoded_version", "staleness")} for r in results])
    # the first iteration against the in-process pipeline's
    got = rlhf_first_record(records[0]["outputs"])

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))

    diffs = {"scores": rel(got["scores"], ref["scores"]),
             "logprobs": rel(got["logprobs"], ref["logprobs"])}
    diffs.update({k: abs(got["update"][k] - v) / max(abs(v), 1e-12)
                  for k, v in ref["update"].items() if v != 0.0})
    tokens_equal = bool(np.array_equal(got["sequences"], ref["sequences"]))
    out["vs_in_process"] = {"tokens_equal": tokens_equal,
                            "rel_diffs": diffs,
                            "kl_mean": got["update"]["kl_mean"]}
    check(tokens_equal, "actors: the actor pipeline's first sequences "
                        "differ from the in-process pipeline's")
    check(all(v <= ACTORS_RLHF_REL_TOL for v in diffs.values()),
          f"actors: first iteration against the in-process pipeline: "
          f"{diffs}")
    # the rlhf phase's checks
    check(results[0]["kl_mean"] == 0.0 and results[1]["kl_mean"] != 0.0,
          f"actors: kl_mean {[r['kl_mean'] for r in results]}, want "
          f"exactly 0 then not")
    check(all(r["staleness"] == 0 for r in results)
          and results[0]["weights_version"] == results[1]["decoded_version"],
          f"actors: versions {[(r['weights_version'], r['decoded_version'], r['staleness']) for r in results]}")
    check(all(r["receipt"]["transport"] == "push"
              and r["receipt"]["oid_leaves"] > 0 for r in results),
          f"actors: sync receipts {[r['receipt'] for r in results]}")
    for i, (got_l, want_l) in enumerate(zip(out["launches_by_iteration"],
                                            want)):
        for phase, w in want_l.items():
            g = {k: got_l.get(phase, {}).get(k) for k in w}
            check(g == w, f"actors: iteration {i + 1} {phase} launches in "
                          f"the role process {g}, want {w}")
    # every shipment's frames freed: the store and /dev/shm back at their
    # level after each of the 4 syncs, and no object spilled
    check(all(s["used_bytes"] - store[0]["used_bytes"] <= ACTORS_STORE_SLACK
              and s["shm_used_bytes"] - store[0]["shm_used_bytes"]
              <= ACTORS_SHM_SLACK and s["spills"] == store[0]["spills"]
              for s in store[1:]),
          f"actors: the store across the syncs {store}")
    check(all(ship[k]["leaf_exact"] and ship[k]["transport"] == k
              and ship[k]["oid_leaves"] > 0 and ship[k]["device"]
              .startswith(DEV) for k in ship),
          f"actors: the 1b shipment {ship}")
    return out


def actors_store():
    """The node store's used bytes and spills so far (its raylet's memory
    report), and the bytes used in /dev/shm (every mapped page, unlinked
    objects' included)."""
    from ray_tpu_torch.core.worker import global_worker

    backend = global_worker()._require_backend()
    rep = backend.io.run(backend._raylet.call("memory_report",
                                              {"limit": 1}))["store"]
    st = os.statvfs("/dev/shm")
    return {"used_bytes": rep["used_bytes"], "spills": rep["spills"],
            "shm_used_bytes": (st.f_blocks - st.f_bfree) * st.f_frsize}


def read_launches_keys():
    return list(LAUNCH_COUNTERS) + [f"flash_fwd_{k}" for k in
                                    ("tcb", "dec", "simt")]


def actors_phase(torch, np, tllama, flash, smi):
    """RL on the port's actors (``actors``): the port's cluster with its
    one GPU; PPO with runner and learner actors, IMPALA on runner actors,
    the RLHF pipeline's four roles as GPU actors at 1b with the weights
    over the stream plane (module docstring, item 22). The path's
    launches are the role processes' (the driver launches none)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import rl as trl
    from ray_tpu_torch.rl.rlhf import pipeline as tpipe

    out = {"phase": "actors", "nvidia_smi": smi,
           "store_bytes": ACTORS_STORE_BYTES}
    t_phase = time.perf_counter()
    # the in-process pipeline's first iteration (the rlhf phase's, else
    # run here, before the runtime: with it the roles would be actors)
    ref = RLHF_FIRST or actors_rlhf_reference(torch, np, tllama)
    out["reference_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    out["card_used_at_start_gib"] = card_used(torch) / 2**30
    out["card_free_wait_s"] = actors_wait_card_free(torch)
    before = read_launches(flash)
    try:
        t0 = time.perf_counter()
        rt.init(_system_config={
            "object_store_memory_bytes": ACTORS_STORE_BYTES})
        out["cluster_start_s"] = time.perf_counter() - t0
        res = rt.cluster_resources()
        check(res.get("GPU") == 1, f"actors: resources {res}, want GPU 1")
        # cold processes start beside earlier work: IMPALA's CPU runners
        # during PPO, the RLHF roles (whose GPU shares PPO's learners
        # hold until they stop) during IMPALA
        pool = concurrent.futures.ThreadPoolExecutor(2)
        t0 = time.perf_counter()
        # one algorithm built at a time: torch's lazy CUDA linear-algebra
        # init (the policy's orthogonal draws) is not thread-safe
        ppo = actors_ppo_build(trl)
        impala_build = pool.submit(actors_impala_build, trl)
        out["ppo"] = actors_ppo(torch, np, trl, rt, *ppo)
        out["ppo"]["part_s"] = time.perf_counter() - t0
        print(f"actors: PPO {json.dumps(out['ppo'])}", flush=True)
        t0 = time.perf_counter()
        rlhf_build = pool.submit(actors_rlhf_build, tllama, tpipe)
        out["impala"] = actors_impala(np, rt, *impala_build.result())
        out["impala"]["part_s"] = time.perf_counter() - t0
        print(f"actors: IMPALA {json.dumps(out['impala'])}", flush=True)
        t0 = time.perf_counter()
        out["rlhf"] = actors_rlhf(torch, np, tllama, tpipe, rt, ref,
                                  *rlhf_build.result())
        out["rlhf"]["part_s"] = time.perf_counter() - t0
        pool.shutdown()
    finally:
        if rt.is_initialized():
            rt.shutdown()
        get_config_reset_store()
    driver = read_launches(flash)
    out["driver_launches"] = {k: driver[k] - before[k] for k in driver}
    out["phase_s"] = time.perf_counter() - t_phase
    r = out["rlhf"]
    print(f"actors ({smi}): cluster start {out['cluster_start_s']:.2f} s; "
          f"PPO {out['ppo']['part_s']:.1f} s (build "
          f"{out['ppo']['build_s']:.1f} s), IMPALA "
          f"{out['impala']['part_s']:.1f} s; RLHF roles up "
          f"{r['roles_start_s']:.1f} s, iterations "
          f"{[round(e['wall_s'], 2) for e in r['engine']]} s, sync "
          f"{[it['sync_s'] for it in r['iterations']]} s of "
          f"{r['iterations'][0]['sync_bytes']} bytes; 1b shipment push "
          f"{r['ship']['push']['wall_s']:.2f} s, fallback "
          f"{r['ship']['fallback']['wall_s']:.2f} s; role launches "
          f"{r['launches']}; phase {out['phase_s']:.1f} s", flush=True)
    emit(out)
    check(all(v == 0 for v in out["driver_launches"].values()),
          f"actors: the driver launched {out['driver_launches']}")
    return r["launches"]


def actors_wait_card_free(torch, slack_gib=2.0, timeout_s=120.0):
    """Seconds until the card holds no more than ``slack_gib`` beyond this
    process's reservation (the processes of earlier phases have exited
    and released theirs); fails after ``timeout_s``."""
    if DEV != "cuda":
        return 0.0
    t0 = time.perf_counter()
    while card_used(torch) - torch.cuda.memory_reserved() \
            > slack_gib * 2**30:
        check(time.perf_counter() - t0 < timeout_s,
              f"actors: {card_used(torch) / 2**30:.1f} GiB of the card "
              f"held by other processes {timeout_s:.0f} s into the phase")
        time.sleep(0.5)
    return time.perf_counter() - t0


def get_config_reset_store():
    """The process's runtime config back to the default store size."""
    from ray_tpu_torch._private.config import get_config

    get_config().object_store_memory_bytes = 0


PHASES = ("kernel", "bwd", "integration", "grad", "serve", "llm", "spec",
          "moe", "train", "driver", "moe_train", "rlhf", "anakin", "rl",
          "vit", "mesh", "seqpipe", "tools", "cluster",
          "deploy", "actors")


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
    if "rl" in only:
        rl_phase(torch, np, flash, smi)
    if "vit" in only:
        vit_phase(torch, np, tts, tflops, flash)
    if "mesh" in only:
        launches["mesh"] = mesh_phase(torch, np, tllama, tts, tflops, flash,
                                      smi)
    if "seqpipe" in only:
        launches["seqpipe"] = seqpipe_phase(torch, np, tllama, tts, tflops,
                                            flash, smi)
    if "tools" in only:
        launches["tools"] = tools_phase(torch, np, tllama, flash, smi)
    if "cluster" in only:
        launches["cluster"] = cluster_phase(torch, np, tllama, flash, smi)
    if "deploy" in only:
        launches["deploy"] = deploy_phase(torch, np, tllama, flash, smi)
    if "actors" in only:
        launches["actors"] = actors_phase(torch, np, tllama, flash, smi)
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
