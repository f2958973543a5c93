"""``cb_vs_static_load`` on the port's serve layer against JAX's: the
continuous-batching app and the ``@serve.batch`` control under the same
open-loop Poisson mix over the proxy fleet, at `debug` on the CPU, each
package on its own runtime's cluster side by side in one process; both
legs complete every request and report JAX's keys. Every proxy binds
port 0 (the function passes ``HTTPOptions(port=0)`` itself)."""

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.serve import llm as jllm
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.serve import llm as tllm


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


def test_cb_vs_static_load_returns_jax_keys(clusters):
    kw = dict(preset="debug", slots=2, max_len=32, decode_stride=4,
              prompt_len=4, short_tokens=2, long_tokens=4, rps=4.0,
              duration_s=1.0, num_proxies=1, timeout_s=60.0)
    want = jllm.cb_vs_static_load(**kw)
    got = tllm.cb_vs_static_load(device="cpu", **kw)
    assert sorted(got) == sorted(want) == ["continuous", "static"]
    for leg in got:
        assert sorted(got[leg]) == sorted(want[leg])
        assert got[leg]["failed"] == 0 and got[leg]["completed"] > 0
