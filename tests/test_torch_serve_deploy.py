"""The port's ContinuousLLM deployed through ray_tpu.serve on the CPU.

``ray_tpu_torch`` may not import ``ray_tpu``, so its serving classes
report through a hooks object; this test binds one to
``ray_tpu.serve.obs`` (what the JAX package's ContinuousLLM writes
directly), deploys ``ContinuousLLM("debug", device="cpu")`` with it, and
checks staggered streamed requests against the port's own ``generate``
and the ``cb:*`` occupancy series, as ``tests/test_serving_batcher.py``
does for the JAX class. The test holds itself to ``LIMIT_S``."""

import contextlib
import dataclasses
import json
import signal
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest
import torch

from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve import llm as tllm

LIMIT_S = 240


class ObsHooks(tllm.ServeHooks):
    """The port's serving hooks bound to ray_tpu.serve.obs: the series and
    spans the JAX package's ContinuousLLM writes itself."""

    def on_tick(self, name, active, slots):
        from ray_tpu.serve import obs

        tags = {"fn": f"cb:{name}"}
        obs.batch_size_hist().observe(active, tags=tags)
        obs.batch_occupancy_hist().observe(active / max(1, slots), tags=tags)
        obs.cb_slots_gauge().set(active, tags={"deployment": name})

    def kv_cache(self, name, hits, misses, evictions, nbytes):
        from ray_tpu.serve import obs

        tags = {"deployment": name}
        for counter, n in ((obs.kv_cache_hits, hits),
                           (obs.kv_cache_misses, misses),
                           (obs.kv_cache_evictions, evictions)):
            if n > 0:
                counter().inc(n, tags=tags)
        obs.kv_cache_bytes().set(nbytes, tags=tags)

    def request_context(self):
        from ray_tpu.serve import obs

        return obs.current_request_context()

    def kv_span(self, name, ctx, *, t_start, t_end, cached_tokens,
                prompt_tokens):
        from ray_tpu.serve import obs

        span = obs.new_span_id()
        obs.emit_span(
            f"serve:{ctx['request_id']}:kv:{span[:8]}", f"kv:{name}",
            request_id=ctx["request_id"], span_id=span,
            parent_span_id=ctx.get("span_id"), t_start=t_start,
            t_end=t_end, phases={"cached_tokens": float(cached_tokens),
                                 "prompt_tokens": float(prompt_tokens)})

    def push_kv_snapshot(self):
        import ray_tpu
        from ray_tpu.util import memory as rt_memory
        from ray_tpu_torch.models import serving

        caches = serving.live_kv_cache_stats()
        if not caches or not ray_tpu.is_initialized():
            return
        backend = ray_tpu.global_worker()._require_backend()
        owner = getattr(backend, "address", "local")
        backend.kv_put(f"{rt_memory._KVCACHE_KV_PREFIX}{owner}",
                       json.dumps({"t": time.time(), "owner": owner,
                                   "caches": caches}))


@contextlib.contextmanager
def time_limit(seconds):
    def on_alarm(signum, frame):
        raise TimeoutError(f"the deployment test passed {seconds} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def serve_cluster():
    import ray_tpu
    from ray_tpu import serve

    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=6, num_tpus=4)
    yield ray_tpu
    try:
        serve.shutdown()
    finally:
        serve._forget_controller_for_tests()
        ray_tpu.shutdown()


def test_port_continuous_llm_behind_serve(serve_cluster):
    import ray_tpu
    from ray_tpu import serve
    from ray_tpu.util.metrics import metrics_text

    # the replica process cannot import this test module: ship the hooks'
    # class by value
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    try:
        with time_limit(LIMIT_S):
            _deploy_and_check(serve, ray_tpu, metrics_text)
    finally:
        cloudpickle.unregister_pickle_by_value(module)


def _deploy_and_check(serve, ray_tpu, metrics_text):
    app = serve.deployment(tllm.ContinuousLLM).options(
        name="CBT", max_ongoing_requests=16).bind(
        "debug", max_slots=4, max_len=64, decode_stride=4, seed=0,
        name="CBT", hooks=ObsHooks(), device="cpu")
    h = serve.run(app, name="cbt", route_prefix=None)

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=s).astype(np.int64)
               for s in (5, 8, 6, 7, 4, 9)]
    wants = [12, 5, 9, 1, 15, 7]
    outs, errors, done_s = {}, {}, {}
    t0 = time.monotonic()

    def consume(i, delay):
        time.sleep(delay)
        try:
            gen = h.remote({"tokens": prompts[i].tolist(),
                            "max_new_tokens": wants[i]}).result(timeout=120)
            outs[i] = [int(t) for t in gen]
        except BaseException as e:   # noqa: BLE001 — reported below
            errors[i] = repr(e)
        done_s[i] = round(time.monotonic() - t0, 2)

    threads = [threading.Thread(target=consume, args=(i, 0.08 * i))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    # a failure names what each request did and when it ended
    report = f"errors {errors}, seconds to each end {done_s}"
    assert not any(t.is_alive() for t in threads), report
    assert not errors, report

    # the replica's params: the preset from the same seeded generator
    cfg = dataclasses.replace(tllama.PRESETS["debug"], attn_impl="flash")
    params = tllama.init_params(
        cfg, generator=torch.Generator("cpu").manual_seed(0),
        device="cpu")
    for i, (p, n) in enumerate(zip(prompts, wants)):
        want = TG.generate(params, p[None], cfg, max_new_tokens=n,
                           device="cpu")[0].tolist()
        assert outs.get(i) == want, (i, report)

    # occupancy telemetry: the engine ticked with rows busy and the
    # cb:* histograms and the slots gauge recorded it
    rep = ray_tpu.get_actor("RT_SERVE:cbt#CBT#0")
    ray_tpu.get(rep.flush_metrics.remote(), timeout=30)
    text = metrics_text()
    occ = [ln for ln in text.splitlines()
           if ln.startswith("rt_serve_batch_occupancy_count")
           and 'fn="cb:CBT"' in ln]
    assert occ and any(float(ln.rsplit(" ", 1)[1]) > 0 for ln in occ), \
        "cb occupancy histogram did not move"
    assert any(ln.startswith("rt_serve_cb_slots_active")
               for ln in text.splitlines()), "cb slots gauge missing"
    # the replica's engine_stats reach the controller's window
    deadline = time.time() + 10
    stats = {}
    while time.time() < deadline:
        stats = (serve.detailed_status()["applications"]["cbt"]
                 ["deployments"]["CBT"]["stats"])
        if "cb_slots" in stats:
            break
        time.sleep(0.5)
    assert stats.get("cb_slots") == 4, stats
