"""ray_tpu_torch's serving front end (``serve/llm.py``, ``serve/batching.py``)
against ray_tpu.serve.llm on the CPU: ``poisson_load``'s arrivals and
``_parse_request`` as JAX's; ``ContinuousLLM`` streams through
``__call__`` equal to JAX's ``ContinuousLLM`` with the same weights (the
`debug` preset in float32 on both sides, put into both PRESETS for the
test); cancel on client close, the replica surface, the hooks; and
``StaticLLM`` equal to JAX's."""

import asyncio
import dataclasses
import gc
import json
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve import batching as tbatching
from ray_tpu_torch.serve import llm as tllm


@pytest.fixture
def fp32_debug(monkeypatch):
    """The `debug` preset in float32 in both packages' PRESETS."""
    monkeypatch.setitem(jllama.PRESETS, "debug", dataclasses.replace(
        jllama.PRESETS["debug"], compute_dtype=jnp.float32))
    monkeypatch.setitem(tllama.PRESETS, "debug", dataclasses.replace(
        tllama.PRESETS["debug"], compute_dtype=torch.float32))


def _np(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=s).tolist() for s in lens]


async def _consume(llm, body, delay=0.0):
    await asyncio.sleep(delay)
    gen = await llm(body)
    return [int(t) async for t in gen]


def _staggered(llm, prompts, wants, gap=0.03):
    async def go():
        return await asyncio.gather(*(
            _consume(llm, {"tokens": p, "max_new_tokens": n}, gap * i)
            for i, (p, n) in enumerate(zip(prompts, wants))))
    return asyncio.run(go())


def _pair(**kw):
    """JAX's ContinuousLLM and the port's, the port's weights loaded from
    JAX's through the engine's load_params."""
    j = jllm.ContinuousLLM("debug", max_slots=4, max_len=64,
                           decode_stride=4, **kw)
    t = tllm.ContinuousLLM("debug", max_slots=4, max_len=64,
                           decode_stride=4, device="cpu", **kw)
    t.engine.load_params(_np(j.params))
    return j, t


class Recorder(tllm.ServeHooks):
    """Keeps every hook call."""

    def __init__(self, ctx=None):
        self.calls = []
        self._lock = threading.Lock()
        self._ctx = ctx

    def _add(self, *call):
        with self._lock:
            self.calls.append(call)

    def on_tick(self, name, active, slots):
        self._add("tick", name, active, slots)

    def kv_cache(self, name, hits, misses, evictions, nbytes):
        self._add("kv", name, hits, misses, evictions, nbytes)

    def request_context(self):
        return self._ctx

    def kv_span(self, name, ctx, **kw):
        self._add("span", name, ctx, kw)

    def push_kv_snapshot(self):
        self._add("push")

    def on_batch(self, fn, size, max_size):
        self._add("batch", fn, size, max_size)

    def of(self, kind):
        with self._lock:
            return [c[1:] for c in self.calls if c[0] == kind]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_poisson_load_offered_matches_jax(seed):
    kw = dict(rps=400.0, duration_s=0.1, seed=seed, max_inflight=8)
    want = jllm.poisson_load(lambda: 1, **kw)
    got = tllm.poisson_load(lambda: 1, **kw)
    assert got["offered"] == want["offered"] > 0
    assert got["offered_rps"] == want["offered_rps"]
    assert got["completed"] + got["failed"] + got["shed"] == got["offered"]
    assert got["tokens"] == got["completed"]


def test_poisson_load_counts_failures_and_ttft():
    calls = iter(range(10 ** 6))
    lock = threading.Lock()

    def fire():
        with lock:
            i = next(calls)
        if i % 3 == 0:
            raise RuntimeError("boom")
        return 4, 0.002

    out = tllm.poisson_load(fire, rps=300.0, duration_s=0.1, seed=3)
    assert out["failed"] > 0 and out["completed"] > 0
    assert out["failed"] + out["completed"] + out["shed"] == out["offered"]
    assert out["tokens"] == 4 * out["completed"]
    assert out["ttft_p50_ms"] == out["ttft_p99_ms"] == 2.0


def test_http_token_request_counts_like_jax():
    """A JSON-list reply and a streamed line-per-token reply from a
    localhost server: both closures count the same tokens."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            n = body["max_new_tokens"]
            reply = (json.dumps(list(range(n))) if self.path == "/list"
                     else "".join(f"{t}\n" for t in range(n)))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(reply.encode())

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        for path, n in (("/list", 5), ("/lines", 7), ("/list", 0)):
            got = tllm.http_token_request(base + path, [1, 2], n,
                                          timeout_s=10)()
            want = jllm.http_token_request(base + path, [1, 2], n,
                                           timeout_s=10)()
            assert got == want == n, path
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
    assert not th.is_alive()


class _Req:
    def __init__(self, body):
        self._body = body

    def json(self):
        return self._body


@pytest.mark.parametrize("request_", [
    {"tokens": [1, 2], "max_new_tokens": 3},
    json.dumps({"tokens": [4], "seed": 2}),
    json.dumps({"tokens": [5, 6]}).encode(),
    _Req({"tokens": [7], "temperature": 0.5}),
])
def test_parse_request_matches_jax(request_):
    assert tllm._parse_request(request_) == jllm._parse_request(request_)


@pytest.mark.parametrize("bad", [{"max_new_tokens": 3}, "[1, 2]", [1, 2],
                                 _Req({"prompt": [1]})])
def test_parse_request_rejects_like_jax(bad):
    with pytest.raises(ValueError, match="expected"):
        jllm._parse_request(bad)
    with pytest.raises(ValueError, match="expected"):
        tllm._parse_request(bad)


def test_continuous_llm_streams_match_jax(fp32_debug):
    """Staggered streamed greedy requests through ``__call__``: the port's
    streams equal JAX's ContinuousLLM's, token for token, and the replica
    surface reports the same cache state."""
    j, t = _pair()
    try:
        prompts = _prompts(11, (5, 8, 6, 7, 4, 9))
        wants = [12, 5, 9, 1, 15, 7]
        want = _staggered(j, prompts, wants)
        got = _staggered(t, prompts, wants)
        assert got == want
        assert [len(s) for s in got] == wants
        # a shared-prefix request after the first wave warms from the
        # cache on both sides
        again = [prompts[1] + prompts[3]]
        assert _staggered(t, again, [6]) == _staggered(j, again, [6])
        assert t.kv_residency() == j.kv_residency() != []
        ts, js = t.engine_stats(), j.engine_stats()
        for key in ("active", "pending", "max_slots", "admitted",
                    "tokens_generated", "requests_completed"):
            assert ts[key] == js[key], key
        assert ts["weight_swaps"] == 1 and js["weight_swaps"] == 0
        for key in ("hits", "misses", "inserts", "pages", "hit_tokens"):
            assert ts["kv"][key] == js["kv"][key], key
        assert ts["max_slots"] == 4 and ts["active"] == 0
        t.check_health()
    finally:
        j.engine.shutdown()
        t.engine.shutdown()


class _SlowTicks(tllm.ServeHooks):
    """5 ms a decode tick: a 200-token stream outlasts the client's two
    reads and its close by far."""

    def on_tick(self, name, active, slots):
        time.sleep(0.005)


def test_cancel_on_client_close_frees_the_slot(fp32_debug):
    llm = tllm.ContinuousLLM("debug", max_slots=1, max_len=256,
                             decode_stride=1, hooks=_SlowTicks(),
                             device="cpu")
    cancels = []
    engine_cancel = llm.engine.cancel

    def cancel(handle):
        cancels.append(handle.cancelled or handle.req_id is not None)
        engine_cancel(handle)

    llm.engine.cancel = cancel
    try:
        async def go():
            gen = await llm({"tokens": [1, 2, 3], "max_new_tokens": 200})
            first = [await gen.__anext__(), await gen.__anext__()]
            await gen.aclose()   # the client goes away mid-stream
            deadline = time.time() + 20
            while llm.engine_stats()["active"] and time.time() < deadline:
                await asyncio.sleep(0.01)
            # the one slot serves the next request
            rest = await _consume(llm, {"tokens": [4, 5],
                                        "max_new_tokens": 3})
            return first, rest

        first, rest = asyncio.run(go())
        assert len(first) == 2 and len(rest) == 3
        # the close cancelled the live request; the second's stream ended
        assert cancels[0] is True and len(cancels) == 2
        st = llm.engine_stats()
        assert st["active"] == 0 and st["pending"] == 0
        assert st["tokens_generated"] < 200 + 3
    finally:
        llm.engine.shutdown()


def test_check_health_fails_on_a_dead_engine(fp32_debug):
    llm = tllm.ContinuousLLM("debug", max_slots=2, max_len=32,
                             kv_cache_bytes=0, device="cpu")
    try:
        llm.check_health()
        assert llm.kv_residency() == []
        assert "kv" not in llm.engine_stats()
        with llm.engine._lock:
            llm.engine._dead = "boom"
        with pytest.raises(RuntimeError, match="boom"):
            llm.check_health()
    finally:
        llm.engine.shutdown()


def test_push_thread_does_not_keep_the_replica_alive(fp32_debug,
                                                     monkeypatch):
    monkeypatch.setenv("RT_KV_PUSH_S", "30")
    llm = tllm.ContinuousLLM("debug", max_slots=1, max_len=32,
                             device="cpu")
    llm.engine.shutdown()
    ref = weakref.ref(llm)
    del llm
    gc.collect()   # the engine's tick callback refers back to the replica
    assert ref() is None


def test_hooks_see_ticks_spans_pushes_and_kv_deltas(fp32_debug, monkeypatch):
    """The tick hook sees live rows, each request with an ambient context
    gets one kv span with its cached-token count, the push thread calls
    its hook, and the kv deltas sum to the engine's counters."""
    monkeypatch.setenv("RT_KV_PUSH_S", "0.05")
    hooks = Recorder(ctx={"request_id": "r", "span_id": "s"})
    llm = tllm.ContinuousLLM("debug", max_slots=4, max_len=96,
                             decode_stride=2, hooks=hooks, device="cpu",
                             name="cbt")
    try:
        base = _prompts(3, (32,))[0]
        prompts = [base + p for p in _prompts(4, (3, 5, 4))]
        _staggered(llm, prompts[:1], [4])
        _staggered(llm, prompts[1:], [4, 6])
        deadline = time.time() + 10
        while not hooks.of("push") and time.time() < deadline:
            time.sleep(0.02)
        ticks = hooks.of("tick")
        assert ticks and all(n == "cbt" and s == 4 for n, _, s in ticks)
        assert max(a for _, a, _ in ticks) > 0
        spans = hooks.of("span")
        assert len(spans) == 3
        assert [kw["cached_tokens"] for _, _, kw in spans].count(32) == 2
        assert all(kw["prompt_tokens"] == len(p) for (_, _, kw), p in
                   zip(sorted(spans, key=lambda s: s[2]["prompt_tokens"]),
                       sorted(prompts, key=len)))
        assert hooks.of("push")
        kv = llm.engine.kv_stats()
        deltas = hooks.of("kv")
        for i, key in enumerate(("hits", "misses", "evictions")):
            assert sum(d[1 + i] for d in deltas) == kv[key], key
        assert kv["hits"] == 2 and deltas[-1][4] == kv["bytes"] > 0
    finally:
        llm.engine.shutdown()


def test_static_llm_matches_jax(fp32_debug):
    """The same weights in both: each request's tokens equal JAX's
    StaticLLM's, batched by ``@batch`` (whose flush reaches the hook)."""
    j = jllm.StaticLLM("debug", max_batch=4, prompt_pad=8, max_new=6)
    hooks = Recorder()
    t = tllm.StaticLLM("debug", max_batch=4, prompt_pad=8, max_new=6,
                       hooks=hooks, device="cpu")
    t.params = params_from_jax(_np(j.params), t.cfg, device="cpu")
    prompts = _prompts(5, (3, 8, 11, 5, 6))
    wants = [6, 4, 6, 2, 9]

    def run(llm):
        async def go():
            return await asyncio.gather(*(
                llm({"tokens": p, "max_new_tokens": n})
                for p, n in zip(prompts, wants)))
        return asyncio.run(go())

    want, got = run(j), run(t)
    assert got == want
    assert [len(g) for g in got] == [min(n, 6) for n in wants]
    sizes = [size for _, size, _ in hooks.of("batch")]
    assert sum(sizes) == len(prompts) and max(sizes) <= 4
    assert all(m == 4 for _, _, m in hooks.of("batch"))


def test_batch_decorator_flushes_by_size_and_fans_out_errors():
    seen = []

    @tbatching.batch(max_batch_size=3, batch_wait_timeout_s=0.05,
                     on_batch=lambda fn, n, m: seen.append((fn, n, m)))
    async def double(items):
        if "bad" in items:
            raise KeyError("bad item")
        return [2 * x for x in items]

    async def go():
        ok = await asyncio.gather(*(double(i) for i in range(5)))
        with pytest.raises(KeyError):
            await double("bad")
        return ok

    assert asyncio.run(go()) == [0, 2, 4, 6, 8]
    assert [n for _, n, _ in seen][:2] == [3, 2]
    assert all(fn == "double" and m == 3 for fn, _, m in seen)
