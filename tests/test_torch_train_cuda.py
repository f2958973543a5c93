"""The training fast path on the card: the train recorder's done-hook, the
device feed's pinned side-stream copies, the async checkpoint's snapshot
under in-place steps, and the driver against a plain loop of steps.

Marked ``cuda``: each test skips where no CUDA device is present (run on a
GPU host with ``python -m pytest tests/test_torch_train_cuda.py -m
cuda``). Imports no jax, so it runs where jax is not installed.
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.data.iterator import iter_device_batches
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.driver import StepDriver
from ray_tpu_torch.util.train_recorder import TrainRecorder

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batches(n, seed=0, b=2, s=33):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, (b, s)).astype(np.int64)}
            for _ in range(n)]


def test_done_hook_waits_for_its_own_launch(cuda):
    """The watcher stamps a launch done when ITS event completes: not when
    later queued work does (what ``torch.cuda.synchronize()`` in the
    watcher would book), and not at once (a wait on nothing)."""
    rec = TrainRecorder("cuda", enabled=True, n_devices=1)
    try:
        x = torch.ones(1, device=cuda)
        torch.cuda.synchronize()
        t0 = time.time()
        torch.cuda._sleep(200_000_000)          # this launch's device work
        t1 = time.time()
        seq = rec.record_launch(t_start=t0, data_wait_s=0.0, h2d_s=0.0,
                                dispatch_s=t1 - t0, t_dispatch_end=t1)
        rec.watch_outputs(seq, {"loss": x})
        torch.cuda._sleep(2_000_000_000)        # the next launch, far longer
        end = torch.cuda.Event()
        end.record()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and rec.summary()["in_flight"]:
            time.sleep(0.001)
        [launch] = rec.launches()
        end.synchronize()
        t_end = time.time()
        assert launch["phases"]["device_compute"] > 0.02
        assert t_end - launch["t_done"] > 0.2
    finally:
        rec.close()


def test_feed_copies_equal_the_host_batches(cuda):
    host = _batches(7, seed=1)
    feed = iter_device_batches(iter(host), stack=3, prefetch_batches=2,
                               device=cuda)
    groups = []
    for g in feed:
        assert g["tokens"].is_cuda
        groups.append(g["tokens"] * 1)   # consumed on the current stream
    torch.cuda.synchronize()
    want = [np.stack([b["tokens"] for b in host[i:i + 3]])
            for i in (0, 3, 6)]
    assert [tuple(g.shape) for g in groups] == [w.shape for w in want]
    for g, w in zip(groups, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w)
    assert feed.report()["batches"] == 3


def test_async_save_then_in_place_steps_loads_the_state_at_save(cuda,
                                                               tmp_path):
    cfg = tllama.PRESETS["debug"]
    opt = tts.default_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    params, state = tts.init_state(
        cfg, opt, generator=torch.Generator(device=cuda).manual_seed(0),
        device=cuda)
    step = tts.make_train_step(cfg, opt, device=cuda)
    batches = _batches(4, seed=2)
    params, state, _ = step(params, state, batches[0])
    at_save = {k: t.clone() for k, t in tts._leaves(params).items()}
    mu_at_save = {k: t.clone() for k, t in state["mu"].items()}
    strided_at_save = params["embed"].T.clone()
    ck = Checkpoint.from_directory(str(tmp_path / "ck"))
    ck.save_pytree((params, state, {"strided": params["embed"].T}),
                   blocking=False)
    for b in batches[1:]:       # enqueued right behind the snapshot
        params, state, _ = step(params, state, b)
    ck.wait_pending()
    back_params, back_state, extra = ck.load_pytree(device=cuda)
    assert torch.equal(extra["strided"], strided_at_save)
    for k, t in tts._leaves(back_params).items():
        assert torch.equal(t, at_save[k]), k
    for k, t in back_state["mu"].items():
        assert torch.equal(t, mu_at_save[k]), k
    assert back_state["count"] == 1 and state["count"] == 4
    assert not torch.equal(params["embed"], at_save["embed"])


def test_driver_equals_a_plain_loop(cuda):
    cfg = tllama.PRESETS["debug"]
    opt = tts.default_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)

    def init():
        return tts.init_state(
            cfg, opt, generator=torch.Generator(device=cuda).manual_seed(0),
            device=cuda)

    batches = _batches(10, seed=3)
    params, state = init()
    step = tts.make_train_step(cfg, opt, device=cuda)
    ref = []
    for b in batches:
        params, state, m = step(params, state, b)
        ref.append(float(m["loss"]))
    ref_params = tts._leaves(params)
    params, state = init()
    drv = StepDriver(cfg, opt, steps_per_launch=4, device=cuda)
    got = []
    params, state, _ = drv.run(
        params, state, iter_device_batches(iter(batches), stack=4,
                                           device=cuda),
        on_launch=lambda m: got.extend(m["loss"].reshape(-1).tolist()))
    assert (drv.steps, drv.launches, drv.compile_count()) == (10, 4, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    for k, t in tts._leaves(params).items():
        torch.testing.assert_close(t, ref_params[k], rtol=1e-5, atol=1e-6)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and drv.recorder.summary()["in_flight"]:
        time.sleep(0.01)
    summ = drv.recorder.summary()
    drv.recorder.close()
    assert summ["launches_total"] == 2 and summ["in_flight"] == 0
