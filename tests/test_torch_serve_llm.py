"""The LLM app functions served through the port's serve layer against
JAX's: ``continuous_llm_app("debug")`` on ``ray_tpu_torch.serve``
(``device="cpu"``) and on ``ray_tpu.serve``, each on its own runtime's
cluster, the two side by side in one process.

The two replicas hold the same weights: the `debug` preset in float32 and
JAX's params from ``jax.random.key(0)``. Each function's app has its class
swapped for a subclass (``tests/_torch_serve_cases.py:fp32_llm_class``)
that first puts the float32 `debug` preset into its own worker's PRESETS;
JAX's replica then builds its params from the seed as always, and the
port's loads JAX's (numpy, a bind argument, carried across by
``models/convert.py:params_from_jax``) through the engine's
``load_params``. Greedy tokens streamed through handles (push and pull)
and through HTTP are compared token for token with each other and with
the port's in-process ``generate``.

Also: the KV-affinity router sends a shared prefix to the replica that
holds it. (``cb_vs_static_load`` and the serve legs of the benches are in
``tests/test_torch_serve_tools.py``.) Every proxy binds port 0."""

import dataclasses

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.models import llama as jllama
from ray_tpu.serve import llm as jllm
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve import llm as tllm

import _torch_serve_cases as cases

cloudpickle.register_pickle_by_value(cases)

ENGINE = dict(max_slots=4, max_len=64, decode_stride=4,
              kv_cache_bytes=8 << 20)
N_NEW = 8


def _shutdown_all():
    for serve, rt in ((jserve, ray_tpu), (tserve, ray_tpu_torch)):
        if rt.is_initialized():
            try:
                serve.shutdown()
            finally:
                serve._forget_controller_for_tests()
                rt.shutdown()


@pytest.fixture(scope="module")
def clusters():
    _shutdown_all()
    ray_tpu.init(num_cpus=6, num_tpus=0)
    ray_tpu_torch.init(num_cpus=6, num_gpus=0)
    yield
    _shutdown_all()


def _prompts():
    rng = np.random.default_rng(19)
    return [rng.integers(0, 256, size=s).tolist() for s in (5, 9, 3)]


def _jax_params_np():
    cfg = dataclasses.replace(jllama.PRESETS["debug"],
                              compute_dtype=jnp.float32)
    params = jllama.init_params(jax.random.key(0), cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def test_served_greedy_tokens_match_jax_and_generate(clusters):
    """Two replicas a side. The streamed greedy tokens, then the
    KV-affinity router: once it has heard which replica holds a prefix,
    every request sharing it is a cache hit there."""
    prompts = _prompts()
    np_params = _jax_params_np()
    kw = dict(ENGINE, num_replicas=2)
    japp = cases.with_body(jllm.continuous_llm_app("debug", **kw),
                           cases.fp32_llm_class("ray_tpu"))
    tapp = cases.with_body(
        tllm.continuous_llm_app("debug", device="cpu", **kw),
        cases.fp32_llm_class("ray_tpu_torch"), np_params=np_params)
    want = cases.served_tokens("ray_tpu", japp, prompts, N_NEW, "/llm")
    got = cases.served_tokens("ray_tpu_torch", tapp, prompts, N_NEW, "/llm")
    assert got == want
    cfg = dataclasses.replace(tllama.PRESETS["debug"],
                              compute_dtype=torch.float32)
    params = params_from_jax(np_params, cfg, device="cpu")
    ref = [TG.generate(params, torch.tensor([p]), cfg, max_new_tokens=N_NEW,
                       device="cpu")[0].tolist() for p in prompts]
    assert got["push"] == got["pull"] == ref
    assert [h["tokens"] for h in got["http"]] == ref
    assert all(h["status"] == 200 and h["chunked"] for h in got["http"])
    assert got["transport"] == ["push"] * 3 + ["pull"] * 3

    prefix = list(range(1, 33))
    tails = [[40 + i, 90 + i] for i in range(5)]
    want = cases.kv_affinity("ray_tpu", prefix, tails)
    got = cases.kv_affinity("ray_tpu_torch", prefix, tails)
    jserve.delete("llm")
    tserve.delete("llm")
    assert got == want
    assert got == {"residency_heard": True, "hits_gained": len(tails) - 1,
                   "warm_replicas": 1}


def test_llm_apps_reserve_a_gpu_on_cuda():
    """``device="cuda"`` (the default) reserves one GPU a replica unless
    the options say otherwise; ``device="cpu"`` reserves none."""
    def opts(app):
        return app._deployment._config.ray_actor_options

    assert opts(tllm.continuous_llm_app("debug")) == {"num_gpus": 1}
    assert opts(tllm.static_llm_app("debug")) == {"num_gpus": 1}
    assert opts(tllm.continuous_llm_app(
        "debug", ray_actor_options={"num_gpus": 0.5})) == {"num_gpus": 0.5}
    assert opts(tllm.continuous_llm_app("debug", device="cpu")) == {}
    assert tllm.continuous_llm_app("debug")._kwargs["device"] == "cuda"
