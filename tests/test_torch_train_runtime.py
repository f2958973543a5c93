"""The port's Train library on its runtime against JAX's: the cases of
``tests/test_train.py`` (metrics history, ranks, the resume step, a
restart from the last checkpoint, ``TrainingFailedError``, list sharding)
and its data-parallel MLP, each loop (``tests/_torch_runtime_cases.py``)
through JAX's ``JaxTrainer`` and then the port's ``TorchTrainer`` with CPU
workers (a gloo gang). Reported metrics compare exactly, apart from each
runtime's timestamps and checkpoint paths; the MLP's losses and weights
within 1e-5, and a ``debug`` Llama loop through each package's
``StepDriver`` in a worker (JAX's weights carried over with
``models/convert.py``, K from the session's ``FastPathConfig``) within
1e-4. One cluster of each runtime serves the module."""

import dataclasses
import time

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import llama as jllama
from ray_tpu_torch.train import session as tsession

import _torch_runtime_cases as cases

cloudpickle.register_pickle_by_value(cases)

PKGS = ("ray_tpu", "ray_tpu_torch")
RUNTIME_KEYS = {"_timestamp", "checkpoint_path"}


@pytest.fixture(scope="module")
def clusters():
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _fit_both(tmp_path, loop, name, **kw):
    return [cases.fit(pkg, loop, storage=str(tmp_path / pkg), name=name,
                      **kw) for pkg in PKGS]


def _metrics(m):
    return {k: v for k, v in m.items() if k not in RUNTIME_KEYS}


def _same_results(want, got):
    assert (got.error is None) == (want.error is None)
    assert _metrics(got.metrics) == _metrics(want.metrics)
    assert [_metrics(m) for m in got.metrics_history] == \
        [_metrics(m) for m in want.metrics_history]
    assert [set(m) for m in got.metrics_history] == \
        [set(m) for m in want.metrics_history]


def test_single_worker_report_flow(clusters, tmp_path):
    want, got = _fit_both(tmp_path, cases.loop_report, "t1",
                          config={"lr": 0.1})
    _same_results(want, got)
    assert got.metrics["step"] == 2 and len(got.metrics_history) == 3


def test_multi_worker_ranks_and_world(clusters, tmp_path):
    want, got = _fit_both(tmp_path, cases.loop_ranks, "t2", num_workers=3)
    _same_results(want, got)
    assert got.metrics["world"] == 3 and got.metrics["rank"] == 0


def test_checkpoint_save_and_resume(clusters, tmp_path):
    first = _fit_both(tmp_path, cases.loop_checkpoint, "t3")
    resumed = [cases.fit(pkg, cases.loop_checkpoint,
                         storage=str(tmp_path / pkg), name="t3b",
                         resume=r.checkpoint)
               for pkg, r in zip(PKGS, first)]
    _same_results(*first)
    _same_results(*resumed)
    assert resumed[1].metrics["step"] == 3
    assert resumed[1].checkpoint.to_dict() == {"step": 3}


def test_failure_restart_from_checkpoint(clusters, tmp_path):
    want, got = _fit_both(tmp_path, cases.loop_fail_once, "t4",
                          max_failures=1)
    _same_results(want, got)
    assert got.metrics["step"] == 3
    assert [m["step"] for m in got.metrics_history] == [0, 1, 2, 3]


def test_failure_without_budget_raises(clusters, tmp_path):
    errors = []
    for pkg in PKGS:
        trainer_mod = cases._rt(pkg + ".train.trainer")
        with pytest.raises(trainer_mod.TrainingFailedError,
                           match="always fails") as e:
            cases.fit(pkg, cases.loop_always_fails,
                      storage=str(tmp_path / pkg), name="t5")
        errors.append(str(e.value).splitlines()[0])
    assert errors[1] == errors[0]


def test_dataset_sharding_lists(clusters, tmp_path):
    want, got = _fit_both(tmp_path, cases.loop_shard, "t6", num_workers=2,
                          datasets={"train": list(range(10))})
    _same_results(want, got)
    assert got.metrics["shard"] == list(range(0, 10, 2))


def test_data_parallel_mlp_matches_jax(clusters, tmp_path):
    want, got = _fit_both(tmp_path, cases.loop_mlp, "mlp", num_workers=2)
    for key in ("first_loss", "last_loss", "w_checksum"):
        assert abs(got.metrics[key] - want.metrics[key]) \
            <= 1e-5 * abs(want.metrics[key]), key
    np.testing.assert_allclose(got.metrics["losses"],
                               want.metrics["losses"], rtol=1e-5)
    assert got.metrics["last_loss"] < got.metrics["first_loss"] * 0.5


def test_debug_llama_loop_matches_jax(clusters, tmp_path):
    cfg = dataclasses.replace(jllama.PRESETS["debug"],
                              compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jax.random.key(0), cfg))
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, size=(2, 25))
                .astype(np.int32)} for _ in range(4)]
    config = {"params": params, "batches": batches,
              "opt": {"lr": 1e-2, "warmup_steps": 1, "total_steps": 50}}
    want, got = _fit_both(tmp_path, cases.loop_llama, "llama",
                          config=config, steps_per_launch=2)
    w, g = want.metrics, got.metrics
    assert (g["steps"], g["launches"], g["steps_per_launch"]) == \
        (w["steps"], w["launches"], w["steps_per_launch"]) == (4, 2, 2)
    np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-4)


def test_gpu_gang_without_gpus_raises_promptly(clusters, tmp_path):
    """A GPU gang on a cluster without a GPU is refused at once, never run
    on the CPU."""
    from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                     TorchTrainer)

    assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
    trainer = TorchTrainer(cases.loop_ranks, train_loop_config={
        "pkg": "ray_tpu_torch"}, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="gpu", storage_path=str(tmp_path)))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="GPU"):
        trainer.fit()
    assert time.monotonic() - t0 < 10


def test_reported_tensors_reach_the_host():
    """The drainer reads tensors with ``.detach().cpu()`` and widens
    bfloat16 and float16 to float32; other leaves pass as JAX's do."""
    got = tsession.coerce_metrics({
        "loss": torch.tensor(2.5, requires_grad=True) * 1,
        "norms": torch.tensor([1.0, 2.0], dtype=torch.bfloat16),
        "half": torch.tensor(0.5, dtype=torch.float16),
        "steps": torch.tensor([3, 4]), "n": 7, "name": "x",
        "arr": np.ones(2, np.float32)})
    assert got["loss"] == 2.5 and isinstance(got["loss"], float)
    assert got["norms"].dtype == np.float32
    assert got["norms"].tolist() == [1.0, 2.0]
    assert got["half"] == 0.5 and isinstance(got["half"], float)
    assert got["steps"].tolist() == [3, 4]
    assert (got["n"], got["name"]) == (7, "x")
    assert got["arr"].dtype == np.float32


def test_scaling_config_picks_the_backend():
    from ray_tpu_torch.train import ScalingConfig

    gpu = ScalingConfig(num_workers=2)
    assert (gpu.gpus_per_worker, gpu.use_gpu, gpu.backend) == \
        (1, True, "nccl")
    assert gpu.bundle() == {"CPU": 1, "GPU": 1.0}
    cpu = ScalingConfig(num_workers=2, gpus_per_worker=0)
    assert (cpu.use_gpu, cpu.backend, cpu.bundle()) == \
        (False, "gloo", {"CPU": 1})
    assert ScalingConfig(use_gpu=False).gpus_per_worker == 0
    with pytest.raises(ValueError, match="whole number"):
        ScalingConfig(gpus_per_worker=1.5)


def test_session_sets_the_driver_k_and_the_save_mode(tmp_path, monkeypatch):
    """Inside a train session the ``FastPathConfig`` reaches the port's
    ``StepDriver`` (K) and ``Checkpoint`` (a ``blocking=None`` save goes
    to the writer thread, and ``report``'s drainer fences it); outside
    one the driver runs single steps and a save blocks, as JAX's."""
    import threading

    from ray_tpu_torch.models import llama as tllama
    from ray_tpu_torch.parallel import train_step as tts
    from ray_tpu_torch.train import Checkpoint, FastPathConfig, StepDriver

    cfg = dataclasses.replace(tllama.PRESETS["debug"],
                              compute_dtype=torch.float32)
    opt = tts.default_optimizer()
    assert StepDriver(cfg, opt, device="cpu").steps_per_launch == 1
    gate, writes = threading.Event(), []

    def held(self, tree, name, ready=None):
        writes.append(threading.current_thread().name)
        assert gate.wait(30)

    monkeypatch.setattr(Checkpoint, "_save_pytree_sync", held)
    session = tsession.TrainSession(
        tsession.TrainContext(0, 1),
        fast_path=FastPathConfig(steps_per_launch=3))
    tsession.init_session(session)
    try:
        assert StepDriver(cfg, opt, device="cpu").steps_per_launch == 3
        ckpt = Checkpoint.from_directory(str(tmp_path / "async"))
        ckpt.save_pytree({"w": torch.ones(2)})   # returns; the writer waits
        session.report({"loss": torch.tensor(1.5)}, checkpoint=ckpt)
        time.sleep(0.2)
        assert session.results.empty()           # fenced on the save
        gate.set()
        item = session.results.get(timeout=30)
        assert item["metrics"] == {"loss": 1.5}
        assert writes == ["rtt-ckpt-writer"]
    finally:
        gate.set()
        tsession.clear_session()
    Checkpoint.from_directory(str(tmp_path / "sync")).save_pytree(
        {"w": torch.ones(2)})
    assert writes[-1] == threading.current_thread().name
