"""The port's runtime core against JAX's: the same programs
(``tests/_torch_runtime_cases.py``: tasks, nested tasks, ``wait``,
``put``/``get`` of numpy arrays and torch CPU tensors, named and
restarting actors, ``kill``/``cancel``, error types and messages) run on
``ray_tpu`` and then on ``ray_tpu_torch``, in local mode and on the
multiprocess cluster, and give equal results. Errors compare by type and
the first line of their message.

The two runtimes of a mode run side by side, one module-scoped session
each (their session roots, shared-memory directories and worker entry
points are their own), and each program runs on JAX's first."""

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

import _torch_runtime_cases as cases

cloudpickle.register_pickle_by_value(cases)

RUNTIMES = (ray_tpu, ray_tpu_torch)


def _shutdown_all():
    for rt in RUNTIMES:
        if rt.is_initialized():
            rt.shutdown()


@pytest.fixture(scope="module", params=("local", "cluster"))
def mode(request):
    _shutdown_all()
    local = request.param == "local"
    ray_tpu.init(local_mode=local, num_cpus=4, num_tpus=4)
    ray_tpu_torch.init(local_mode=local, num_cpus=4, num_gpus=4)
    yield request.param
    _shutdown_all()


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def _both(program):
    fn = getattr(cases, program)
    return fn("ray_tpu"), fn("ray_tpu_torch")


@pytest.mark.parametrize("program", cases.PROGRAMS)
def test_program_matches_jax(mode, program):
    want, got = _both(program)
    assert _same(got, want), (program, got, want)


@pytest.mark.parametrize("program", cases.CLUSTER_PROGRAMS)
def test_cluster_program_matches_jax(mode, program):
    if mode == "local":
        # the module's sessions are parametrized; a crashed actor process
        # restarts only on the cluster, so local mode runs the local form:
        # the actor's state survives ordinary method calls, unrestarted
        want = ray_tpu.get(ray_tpu.remote(cases.Counter).remote().inc.remote())
        got = ray_tpu_torch.get(
            ray_tpu_torch.remote(cases.Counter).remote().inc.remote())
        assert got == want == 1
        return
    want, got = _both(program)
    assert _same(got, want), (program, got, want)
    assert got["crashed"] is not None and got["new_process"]
    assert got["before"] == [1, 2] and got["after"] == 1


def test_top_level_api_covers_jax():
    """Every name of JAX's ``__all__`` is exported by the port."""
    assert set(ray_tpu.__all__) <= set(ray_tpu_torch.__all__)
    assert all(hasattr(ray_tpu_torch, n) for n in ray_tpu.__all__)


def test_streaming_generators_are_refused(mode):
    """Neither mode refuses ``num_returns="streaming"`` now: a generator
    task streams the same items on both runtimes
    (``tests/test_torch_stream.py`` holds the transport to JAX's)."""
    want, got = ([rt.get(r) for r in rt.remote(num_returns="streaming")(
        cases.squares_stream).remote(5)] for rt in RUNTIMES)
    assert got == want == [0, 1, 4, 9, 16]
