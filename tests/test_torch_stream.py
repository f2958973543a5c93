"""Streaming generators and the push stream transport of the port against
JAX's: the programs of ``tests/test_streaming_generator.py`` and
``tests/test_zz_stream_transport.py`` (in ``tests/_torch_serve_cases.py``)
run on ``ray_tpu`` and on ``ray_tpu_torch``, local mode and cluster, and
give equal results: the same items in the same order, an error raised
mid-stream, ``close`` releasing the producer's backpressure, push and pull
token-exact through serve handles, a broken push channel resuming through
``resume_pull`` token-exact, and frames above ``RT_STREAM_INLINE_MAX``
spilled to the store.

The two runtimes of a mode run side by side, one module-scoped session
each; every program runs on JAX's first."""

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu_torch import serve as tserve

import _torch_serve_cases as cases

cloudpickle.register_pickle_by_value(cases)

def _shutdown_all():
    for serve, rt in ((jserve, ray_tpu), (tserve, ray_tpu_torch)):
        if rt.is_initialized():
            try:
                serve.shutdown()
            finally:
                serve._forget_controller_for_tests()
                rt.shutdown()


@pytest.fixture(scope="module", params=("local", "cluster"))
def mode(request):
    _shutdown_all()
    local = request.param == "local"
    ray_tpu.init(local_mode=local, num_cpus=4, num_tpus=0)
    ray_tpu_torch.init(local_mode=local, num_cpus=4, num_gpus=0)
    yield request.param
    _shutdown_all()


#: the serve layer and the push channel live on the cluster backend
cluster_only = pytest.mark.parametrize("mode", ["cluster"], indirect=True)


def _both(program, *args):
    fn = getattr(cases, program)
    return fn("ray_tpu", *args), fn("ray_tpu_torch", *args)


def test_streaming_generator_is_exported():
    """``ObjectRefGenerator`` at the top level, as JAX's ``__init__``."""
    assert ray_tpu_torch.ObjectRefGenerator.__name__ == \
        ray_tpu.ObjectRefGenerator.__name__ == "ObjectRefGenerator"


@pytest.mark.parametrize("program", ["stream_items", "stream_error",
                                     "stream_plasma_items",
                                     "stream_tensors"])
def test_stream_programs_match_jax(mode, program):
    want, got = _both(program)
    assert got == want, (program, got, want)


def test_close_releases_producer_like_jax(mode, tmp_path):
    want = cases.stream_close_releases_producer(
        "ray_tpu", str(tmp_path / "jax.txt"))
    got = cases.stream_close_releases_producer(
        "ray_tpu_torch", str(tmp_path / "port.txt"))
    assert got == want
    assert got == {"firsts": [0, 1, 2], "bounded": True, "stopped": True,
                   "pong": "pong"}


@cluster_only
def test_streaming_task_returns_a_generator(mode):
    f = ray_tpu_torch.remote(num_returns="streaming")(cases.gen_squares)
    stream = f.remote(3)
    assert isinstance(stream, ray_tpu_torch.ObjectRefGenerator)
    assert [ray_tpu_torch.get(r) for r in stream] == [0, 1, 4]
    assert stream.completed()


@pytest.mark.parametrize("program", ["stream_inline_threshold",
                                     "stream_credit_window"])
@cluster_only
def test_push_channel_matches_jax(mode, program):
    want, got = _both(program)
    assert got == want, (program, got, want)
    if program == "stream_inline_threshold":
        assert got["default"]["kinds"] == ["v", "o", "v", "v"]
        assert got["1k"]["kinds"] == ["v", "o", "o", "v"]


@pytest.mark.parametrize("program", ["serve_push_pull",
                                     "serve_stream_error_and_cancel",
                                     "serve_fallback_resume",
                                     "serve_stream_metrics"])
@cluster_only
def test_serve_streams_match_jax(mode, program):
    want, got = _both(program)
    assert got == want, (program, got, want)
    if program == "serve_push_pull":
        assert got[200] == (list(range(200)), "push", 2)
        assert got["pull"][:2] == (list(range(50)), "pull")
    if program == "serve_fallback_resume":
        assert got["toks"] == list(range(60))
        assert got["transport"] == "fallback"
