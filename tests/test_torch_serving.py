"""ray_tpu_torch's ContinuousBatcher / ContinuousEngine: each request's
tokens equal JAX's ``generate`` on its own prompt, token for token
(`debug` preset, float32, CPU, weights carried over with params_from_jax).
The port's counterparts of the CPU cases of tests/test_serving_batcher.py,
plus a request that ends exactly at max_len under 8-step fused ticks."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as JG
from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.serving import ContinuousBatcher, ContinuousEngine


def _setup(seed, attn_impl="flash"):
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32,
                               attn_impl=attn_impl)
    jp = jllama.init_params(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _expected(jp, jcfg, prompt, n):
    out = JG.generate(jp, jnp.asarray(prompt, jnp.int32)[None, :], jcfg,
                      max_new_tokens=n)
    return np.asarray(out)[0].tolist()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=s).astype(np.int32) for s in lens]


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_batcher_token_exact_interleaved(attn_impl):
    jcfg, tcfg, jp, tp = _setup(0, attn_impl)
    eng = ContinuousBatcher(tp, tcfg, max_slots=4, max_len=64, device="cpu")
    prompts = _prompts(7, (5, 9, 7))
    wants = [12, 8, 10]
    # admit mid-flight so requests share decode steps at DIFFERENT
    # positions (per-row rope/masking is what's under test)
    r0 = eng.submit(prompts[0], wants[0])
    for _ in range(3):
        eng.step()
    r1 = eng.submit(prompts[1], wants[1])
    eng.step()
    r2 = eng.submit(prompts[2], wants[2])
    assert eng.num_active == 3
    results = eng.run_to_completion()
    assert eng.num_active == 0
    for rid, prompt, n in zip((r0, r1, r2), prompts, wants):
        assert results[rid] == _expected(jp, jcfg, prompt, n), rid


def test_batcher_slot_reuse_stays_exact():
    """A freed slot re-admitted with a NEW, shorter prompt never sees the
    previous occupant's stale KV."""
    jcfg, tcfg, jp, tp = _setup(1)
    eng = ContinuousBatcher(tp, tcfg, max_slots=1, max_len=64, device="cpu")
    p1, p2 = _prompts(11, (8, 6))
    r1 = eng.submit(p1, 6)
    first = eng.run_to_completion()
    r2 = eng.submit(p2, 9)  # reuses the single slot
    second = eng.run_to_completion()
    assert first[r1] == _expected(jp, jcfg, p1, 6)
    assert second[r2] == _expected(jp, jcfg, p2, 9)


def test_step_many_fused_ticks_stay_exact():
    """K decode steps per tick emit the same tokens as K single steps —
    including a short request finishing mid-tick with its surplus tokens
    discarded."""
    jcfg, tcfg, jp, tp = _setup(2)
    eng = ContinuousBatcher(tp, tcfg, max_slots=4, max_len=64, device="cpu")
    p_long, p_short = _prompts(3, (6, 5))
    r_long = eng.submit(p_long, 13)
    r_short = eng.submit(p_short, 3)  # finishes mid-tick (k=4)
    got = {r: list(req.tokens) for r, req in
           ((req.req_id, req) for req in eng._active.values())}
    while eng.num_active:
        for rid, toks, _done in eng.step_many(4):
            got[rid].extend(toks)
    assert got[r_long] == _expected(jp, jcfg, p_long, 13)
    assert got[r_short] == _expected(jp, jcfg, p_short, 3)


@pytest.mark.parametrize("n_requests", [1, 2])
def test_request_ending_at_max_len_under_k8(n_requests):
    """prompt + new + 1 == max_len: the last 8-step tick decodes surplus
    steps past max_len - 1, whose cache writes and rope gathers clamp as
    JAX's do; the request's own tokens stay exact. One request runs the
    lone-row bucket, two the full-engine bucket."""
    jcfg, tcfg, jp, tp = _setup(5)
    max_len = 64
    eng = ContinuousBatcher(tp, tcfg, max_slots=4, max_len=max_len,
                            device="cpu")
    prompts = _prompts(13, (10, 7))[:n_requests]
    wants = [max_len - 1 - len(p) for p in prompts]
    got = {}
    for p, n in zip(prompts, wants):
        rid, first, _ = eng.submit_ex(p, n)
        got[rid] = [first]
    ticks = 0
    while eng.num_active:
        for rid, toks, _done in eng.step_many(8):
            got[rid].extend(toks)
        ticks += 1
    assert ticks == -(-(wants[0] - 1) // 8)
    for (rid, toks), p, n in zip(sorted(got.items()), prompts, wants):
        assert toks == _expected(jp, jcfg, p, n), rid
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(prompts[0], max_len - len(prompts[0]))


def test_engine_concurrent_streams_exact():
    """The threaded engine: concurrent submitters with staggered arrivals
    each stream back exactly their own greedy continuation; cancel ends a
    pending stream."""
    jcfg, tcfg, jp, tp = _setup(4)
    eng = ContinuousEngine(tp, tcfg, max_slots=2, max_len=64,
                           decode_stride=4, device="cpu")
    try:
        prompts = _prompts(5, (5, 7, 6))
        wants = [9, 6, 11]
        outs = {}

        def consume(i, delay):
            time.sleep(delay)
            q = eng.submit_stream(prompts[i], wants[i])
            toks = []
            while True:
                t = q.get(timeout=60)
                if t is None:
                    break
                toks.append(t)
            outs[i] = toks

        # 3 requests, 2 slots: the third queues until a slot frees
        threads = [threading.Thread(target=consume, args=(i, d))
                   for i, d in ((0, 0.0), (1, 0.05), (2, 0.1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in range(3):
            assert outs[i] == _expected(jp, jcfg, prompts[i], wants[i]), i
        st = eng.stats()
        assert st["admitted"] == 3 and st["active"] == 0
        assert st["tokens_out"] == sum(wants)
        burst = []
        done = threading.Event()

        def on_token(toks):
            burst.extend(toks)
            if toks and toks[-1] is None:
                done.set()

        eng.submit_cb(prompts[0], 4, on_token)
        assert done.wait(60)
        assert burst[:-1] == _expected(jp, jcfg, prompts[0], 4)
        q_c = eng.submit_stream(prompts[0], 5)
        eng.cancel(q_c)
        while q_c.get(timeout=60) is not None:
            pass
    finally:
        eng.shutdown()
    assert not eng._thread.is_alive()
