"""ray_tpu_torch's warm admission, KV capture and drain-barrier weight swap
against the JAX package (`debug` preset, float32, CPU, weights carried
over with params_from_jax).

The ports of the engine-level cases of tests/test_zz_kv_cache.py: warm
equals cold for a shared prefix, multi-turn session replay, warm under
co-batched traffic, a weight swap invalidating the cache, plus the port's
capture-order case (its full bucket writes free slots' rows at position
0, so a finished slot must be captured before the next tick). Each
batcher-level scenario runs the same operation sequence on JAX's
``ContinuousBatcher`` and the port's, for ``attn_impl`` xla and flash,
and every stream and ``last_admission["cached_tokens"]`` must be equal.
JAX's cached forward runs the einsum attention for both configs, so one
JAX run is the reference for both. Engine-level streams are held to JAX's
``generate`` under the weights they ran with."""

import dataclasses
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as JG
from ray_tpu.models import llama as jllama
from ray_tpu.models import serving as JS
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import serving as TS
from ray_tpu_torch.models.convert import params_from_jax

PREFIX = list(range(1, 49))  # 48 tokens = 3 chunks at chunk=16
IMPLS = ["xla", "flash"]


@functools.lru_cache(maxsize=None)
def _jax_model(seed):
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32)
    jp = jllama.init_params(jax.random.key(seed), jcfg)
    return jcfg, jp


@functools.lru_cache(maxsize=None)
def _numpy_params(seed):
    return jax.tree_util.tree_map(np.asarray, _jax_model(seed)[1])


def _tcfg(impl):
    return dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32, attn_impl=impl)


def _port_params(seed, impl):
    return params_from_jax(_numpy_params(seed), _tcfg(impl), device="cpu")


class _Side:
    """Makes batchers of one package: ``impl`` None is JAX."""

    def __init__(self, impl, seed=0):
        self.impl, self.seed = impl, seed

    def batcher(self, cache=False, max_slots=4, max_len=160, max_bytes=None):
        mod = JS if self.impl is None else TS
        pc = (mod.PrefixKVCache(chunk=16, max_bytes=max_bytes or 64 << 20)
              if cache else None)
        if self.impl is None:
            jcfg, jp = _jax_model(self.seed)
            return JS.ContinuousBatcher(jp, jcfg, max_slots=max_slots,
                                        max_len=max_len, prefix_cache=pc)
        return TS.ContinuousBatcher(_port_params(self.seed, self.impl),
                                    _tcfg(self.impl), max_slots=max_slots,
                                    max_len=max_len, prefix_cache=pc,
                                    device="cpu")


def _run_one(b, prompt, n=8):
    rid, first, done = b.submit_ex(np.asarray(prompt, np.int32), n)
    toks = [first]
    while not done:
        for r, t, d in b.step():
            if r == rid:
                toks.append(t)
                done = d
    return toks


def _drain(b, got):
    while b.num_active:
        for r, t, _d in b.step():
            got[r].append(t)
    return got


# ---------------------------------------------------------------------------
# batcher-level scenarios: each returns everything it observed
# ---------------------------------------------------------------------------


def _warm_equals_cold(side):
    cold, warm = side.batcher(), side.batcher(cache=True)
    out = []
    for suffix in ([60, 61, 62, 63], [70, 71], [90]):
        prompt = PREFIX + suffix
        out.append((_run_one(cold, prompt), _run_one(warm, prompt),
                    warm.last_admission["cached_tokens"],
                    _run_one(warm, prompt),
                    warm.last_admission["cached_tokens"],
                    warm.last_admission["prompt_tokens"]))
    return out, warm.prefix_cache.stats()


def _multi_turn(side):
    cold = side.batcher(max_len=200)
    warm = side.batcher(cache=True, max_len=200)
    history, out = list(PREFIX), []
    for turn in range(3):
        prompt = history + [200 + turn]
        c, w = _run_one(cold, prompt), _run_one(warm, prompt)
        out.append((c, w, warm.last_admission["cached_tokens"]))
        history = prompt + c
    return out, warm.prefix_cache.stats()


def _cobatched(side):
    cold, warm = side.batcher(), side.batcher(cache=True)
    p_a = PREFIX + [60, 61, 62, 63]
    p_b = list(range(101, 131))
    want_a, want_b = _run_one(cold, p_a, 10), _run_one(cold, p_b, 10)
    _run_one(warm, p_a, 10)  # seed the cache
    ra, fa, _ = warm.submit_ex(np.asarray(p_b, np.int32), 10)
    rb, fb, _ = warm.submit_ex(np.asarray(p_a, np.int32), 10)  # warm hit
    cached = warm.last_admission["cached_tokens"]
    got = _drain(warm, {ra: [fa], rb: [fb]})
    return (want_a, want_b, got[rb], got[ra], cached), \
        warm.prefix_cache.stats()


def _capture_order(side, how):
    """Request A (shared prefix) ends (``done``) or is cancelled
    (``cancel``) while B and C keep decoding in the full bucket, which
    writes A's freed row at position 0 on the next tick; then D, sharing
    A's prefix, is admitted warm and must equal a cold run."""
    cold = side.batcher()
    warm = side.batcher(cache=True)
    p_a, p_d = PREFIX + [60, 61], PREFIX + [77, 78, 79]
    p_b, p_c = list(range(101, 121)), list(range(130, 147))
    want_d = _run_one(cold, p_d, 6)
    ra, fa, _ = warm.submit_ex(np.asarray(p_a, np.int32), 4)
    rb, fb, _ = warm.submit_ex(np.asarray(p_b, np.int32), 16)
    rc, fc, _ = warm.submit_ex(np.asarray(p_c, np.int32), 16)
    got = {ra: [fa], rb: [fb], rc: [fc]}
    if how == "cancel":
        for r, toks, _d in warm.step_many(2):
            got[r].extend(toks)
        assert warm.cancel(ra)
    while ra in {r.req_id for r in warm._active.values()}:
        for r, t, _d in warm.step():
            got[r].append(t)
    assert warm.num_active == 2
    for _ in range(2):   # full-bucket ticks over A's freed row
        for r, toks, _d in warm.step_many(2):
            got[r].extend(toks)
    rd, fd, _ = warm.submit_ex(np.asarray(p_d, np.int32), 6)
    cached = warm.last_admission["cached_tokens"]
    got[rd] = [fd]
    _drain(warm, got)
    return (want_d, got[rd], cached, got[ra], got[rb], got[rc]), \
        warm.prefix_cache.stats()


SCENARIOS = {"warm_equals_cold": _warm_equals_cold,
             "multi_turn": _multi_turn, "cobatched": _cobatched,
             "capture_done": functools.partial(_capture_order, how="done"),
             "capture_cancel": functools.partial(_capture_order,
                                                 how="cancel")}


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    return SCENARIOS[name](_Side(None))


def _same_as_jax(name, impl):
    got = SCENARIOS[name](_Side(impl))
    want = _jax_result(name)
    assert got[0] == want[0]
    stats = {k: v for k, v in got[1].items() if k != "label"}
    assert stats == {k: v for k, v in want[1].items() if k != "label"}
    return got


@pytest.mark.parametrize("impl", IMPLS)
def test_warm_equals_cold_shared_prefix(impl):
    out, st = _same_as_jax("warm_equals_cold", impl)
    for cold, miss, c_miss, hit, c_hit, _s in out:
        assert miss == cold and hit == cold
        # 48 cached tokens restore at the quantized length 32
        assert c_hit == 32 and c_miss in (0, 32)
    assert [s for *_, s in out] == [52, 50, 49]
    assert out[0][2] == 0   # first sight of the prefix misses
    assert st["hits"] >= 3 and st["hit_tokens"] >= 3 * 32


@pytest.mark.parametrize("impl", IMPLS)
def test_multi_turn_session_replay_exact(impl):
    out, st = _same_as_jax("multi_turn", impl)
    for turn, (cold, warm, cached) in enumerate(out):
        assert warm == cold, f"turn {turn} drifted"
    assert [c for _, _, c in out] == [0, 32, 64] and st["hits"] >= 2


@pytest.mark.parametrize("impl", IMPLS)
def test_warm_exact_under_cobatched_traffic(impl):
    (want_a, want_b, got_a, got_b, cached), st = _same_as_jax("cobatched",
                                                              impl)
    assert got_a == want_a and got_b == want_b
    assert cached == 32 and st["hits"] >= 1


@pytest.mark.parametrize("how", ["done", "cancel"])
@pytest.mark.parametrize("impl", IMPLS)
def test_capture_before_next_full_bucket_tick(impl, how):
    (want_d, got_d, cached, *_), st = _same_as_jax(f"capture_{how}", impl)
    assert cached == 32, "A's pages were never captured"
    assert got_d == want_d
    assert st["inserts"] >= 1


# ---------------------------------------------------------------------------
# the engine: weight swaps through the drain barrier
# ---------------------------------------------------------------------------


def _expected(seed, prompt, n):
    jcfg, jp = _jax_model(seed)
    out = JG.generate(jp, jnp.asarray(prompt, jnp.int32)[None, :], jcfg,
                      max_new_tokens=n)
    return np.asarray(out)[0].tolist()


def _collect(q, timeout=60):
    toks = []
    while True:
        t = q.get(timeout=timeout)
        if t is None:
            return toks
        toks.append(t)


def _engine(impl, gate=None, **kw):
    on_tick = None if gate is None else (lambda a, c: gate.wait(30))
    return TS.ContinuousEngine(_port_params(0, impl), _tcfg(impl),
                               max_slots=2, max_len=160, decode_stride=2,
                               kv_cache_bytes=64 << 20, kv_label="swap",
                               on_tick=on_tick, device="cpu", **kw)


def _wait_for(pred, timeout=30.0):
    t_end = time.time() + timeout
    while not pred():
        assert time.time() < t_end, "condition never held"
        time.sleep(0.005)


@pytest.mark.parametrize("impl", IMPLS)
def test_weight_swap_invalidates_cache(impl):
    """Pages captured under the old weights are dropped at the swap: a
    post-swap request prefills cold under the new weights."""
    prompt = PREFIX + [60, 61]
    eng = _engine(impl)
    try:
        assert _collect(eng.submit_stream(prompt, 8)) == _expected(0, prompt,
                                                                   8)
        cache = eng._batcher.prefix_cache
        pages = cache.stats()["pages"]
        assert pages >= 1
        # numpy leaves shaped like the JAX pytree, through params_from_jax
        out = eng.load_params(_numpy_params(9))
        assert out["weight_swaps"] == 1
        st = cache.stats()
        assert st["pages"] == 0 and st["invalidations"] == pages
        got = _collect(eng.submit_stream(prompt, 8))
        assert eng._recorder.requests()[-1]["cached_tokens"] == 0
        assert eng.stats()["weight_swaps"] == 1
    finally:
        eng.shutdown()
    assert got == _expected(9, prompt, 8), "post-swap output used old pages"


@pytest.mark.parametrize("impl", IMPLS)
def test_swap_drains_inflight_under_old_weights(impl):
    """A stream in flight when the swap is queued finishes token-exact
    under the OLD weights; one submitted after it waits at the barrier
    and runs under the NEW. Two racing swaps coalesce (latest wins, both
    callers unblock on the one swap)."""
    gate = threading.Event()
    eng = _engine(impl, gate=gate)
    p_a, p_b = PREFIX + [60], PREFIX + [61, 62]
    results = {}
    try:
        q_a = eng.submit_stream(p_a, 9)
        first_a = q_a.get(timeout=60)   # admitted; the engine waits in
        # on_tick after its first decode tick until the gate opens
        mid = _port_params(5, impl)

        def swap(name, params):
            results[name] = eng.load_params(params)

        threads = [threading.Thread(target=swap, args=("mid", mid))]
        threads[0].start()
        _wait_for(lambda: eng._pending_swap is not None)
        threads.append(threading.Thread(
            target=swap, args=("new", _port_params(9, impl))))
        threads[1].start()
        _wait_for(lambda: eng._pending_swap is not None
                  and len(eng._pending_swap[1]) == 2)
        q_b = eng.submit_stream(p_b, 7)
        gate.set()
        got_a = [first_a] + _collect(q_a)
        got_b = _collect(q_b)
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        gate.set()
        eng.shutdown()
    assert got_a == _expected(0, p_a, 9)
    assert got_b == _expected(9, p_b, 7)
    assert results["mid"]["weight_swaps"] == results["new"]["weight_swaps"] \
        == 1
    assert eng._recorder.summary()["swaps"] == 1


def test_swap_waiters_released_on_shutdown():
    gate = threading.Event()
    eng = _engine("xla", gate=gate)
    errors = []
    try:
        q = eng.submit_stream(PREFIX + [60], 9)
        q.get(timeout=60)

        def swap():
            try:
                eng.load_params(_port_params(9, "xla"))
            except RuntimeError as e:
                errors.append(str(e))

        th = threading.Thread(target=swap)
        th.start()
        _wait_for(lambda: eng._pending_swap is not None)
        threading.Timer(0.2, gate.set).start()
    finally:
        eng.shutdown()
    th.join(timeout=60)
    assert not th.is_alive()
    assert errors and "weight swap failed" in errors[0]
    assert eng.stopped()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.load_params(_port_params(9, "xla"))


def test_load_params_moves_leaves_to_engine_device_and_dtype():
    eng = TS.ContinuousEngine(_port_params(0, "xla"), _tcfg("xla"),
                              max_slots=2, max_len=64, warmup=False,
                              device="cpu")
    try:
        half = params_from_jax(_numpy_params(9), _tcfg("xla"), device="cpu",
                               dtype=torch.float64)
        eng.load_params(half)
        p = eng._batcher.params
        assert p["embed"].dtype == torch.float32
        assert all(t.dtype == torch.float32 for t in p["layers"].values())
        prompt = PREFIX[:20]
        assert _collect(eng.submit_stream(prompt, 5)) == _expected(9, prompt,
                                                                   5)
    finally:
        eng.shutdown()
