"""ray_tpu_torch's StepDriver against the JAX package's (``mesh=None``).

Both families (``debug``, ``moe-debug``), fp32 compute, the JAX weights
carried over with ``params_from_jax``, one seeded numpy stream of 10
token batches [2, 25], K = 4: two fused launches and a ragged tail of two
single steps, fed per step (the driver stacks) or pre-stacked (the feed
advertises ``stack``). Per-launch ``on_launch`` losses and the final
params must agree within 1e-4 of the reference's max |value| (the train
tests' bound, tests/test_torch_train.py); ``steps``, ``launches`` and
``compile_count`` must equal JAX's, and the hooks must see the series JAX
observes. Torch runs on one thread: these are tiny ops, and a contended
CPU makes its thread pool spin far longer than the work takes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.parallel import train_step as jts
from ray_tpu.train import driver as jdriver
from ray_tpu_torch.data.iterator import iter_device_batches
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train import driver as tdriver

REL = 1e-4
N, K, B, S = 10, 4, 2, 24
FAMILIES = {"llama": (jllama, tllama, "debug"),
            "moe": (jmoe, tmoe, "moe-debug")}
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=50)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(seed=7, n=N):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, size=(B, S + 1))
             .astype(np.int32)} for _ in range(n)]


def _groups(batches):
    """The pre-stacked feed of ``batches``: [K, B, S+1] groups and a
    ragged [N % K, B, S+1] tail."""
    return [{"tokens": np.stack([b["tokens"] for b in batches[i:i + K]])}
            for i in range(0, len(batches), K)]


class _Feed:
    """A pre-stacked feed advertising its stacking, as JAX's
    ``JaxBatchIterator`` does."""

    def __init__(self, groups, stack=K):
        self.groups, self.stack = groups, stack

    def __iter__(self):
        return iter(self.groups)


class _Metric:
    """Stands in for JAX's histogram and gauge handles."""

    def __init__(self, series, op, seen):
        self.series, self.op, self.seen = series, op, seen

    def observe(self, v, *a):
        self.seen.append((self.series, "observe", v))

    def set(self, v, *a):
        self.seen.append((self.series, "set", v))


class _Hooks(tdriver.TrainHooks):
    def __init__(self):
        self.seen = []

    def metric(self, series, op, value):
        self.seen.append((series, op, value))


def _flat(tree):
    out = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            out.update({f"{name}/{k}": v for k, v in node.items()})
        else:
            out[name] = node
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _setup(family):
    jfam, tfam, preset = FAMILIES[family]
    jcfg = dataclasses.replace(jfam.PRESETS[preset],
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tfam.PRESETS[preset],
                               compute_dtype=torch.float32)
    jp = jfam.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp


def _run(drv, params, state, feed):
    losses = []
    params, state, _ = drv.run(params, state, feed, on_launch=lambda m:
                               losses.append(np.atleast_1d(
                                   np.asarray(m["loss"]))))
    return params, losses


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's driver over both feeds, once per family: (final params as
    numpy, per-launch losses, steps, launches, compile_count, hook
    series) by (family, feed)."""
    out = {}
    for family in FAMILIES:
        jcfg, _, jp0 = _setup(family)
        host0 = jax.tree_util.tree_map(np.asarray, jp0)
        jopt = jts.default_optimizer(**OPT)
        drv = jdriver.StepDriver(jcfg, jopt, steps_per_launch=K)
        seen = []
        drv._hist = _Metric(tdriver.SERIES["steps_per_launch"], "observe",
                            seen)
        drv._gauge = _Metric(tdriver.SERIES["host_overhead"], "set", seen)
        for feed in ("self", "pre"):
            # one driver (one jit cache) for both feeds, its counters
            # zeroed as a fresh driver's
            drv.steps = drv.launches = 0
            drv.host_s = drv.step_s = 0.0
            batches = _batches()
            src = iter(batches) if feed == "self" else _Feed(_groups(batches))
            # the JAX step donates its inputs: each run gets fresh arrays
            jp = jax.tree_util.tree_map(jnp.asarray, host0)
            jp, losses = _run(drv, jp, jax.jit(jopt.init)(jp), src)
            out[family, feed] = {
                "params": jax.tree_util.tree_map(np.asarray, jp),
                "losses": losses,
                "steps": drv.steps,
                "launches": drv.launches,
                "compile_count": drv.compile_count(),
                "series": list(seen)}
            seen.clear()
    return out


@pytest.mark.parametrize("family,feed", [("llama", "self"),
                                         ("llama", "pre"),
                                         ("moe", "self"), ("moe", "pre")])
def test_driver_matches_jax(jax_runs, family, feed):
    ref = jax_runs[family, feed]
    jcfg, tcfg, jp0 = _setup(family)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp0), tcfg,
                             device="cpu", dtype=torch.float32)
    topt = tts.default_optimizer(**OPT)
    hooks = _Hooks()
    drv = tdriver.StepDriver(tcfg, topt, steps_per_launch=K, device="cpu",
                             hooks=hooks)
    batches = _batches()
    src = iter(batches) if feed == "self" else iter_device_batches(
        iter(batches), stack=K, device="cpu")
    params, losses = _run(drv, params, topt.init(params), src)
    assert [len(x) for x in losses] == [len(x) for x in ref["losses"]] \
        == [K, K, 1, 1]
    assert _rel(np.concatenate(losses), np.concatenate(ref["losses"])) < REL
    got, want = _flat(params_to_numpy(params)), _flat(ref["params"])
    assert set(got) == set(want)
    for name in want:
        assert _rel(got[name], want[name]) < REL, name
    assert (drv.steps, drv.launches, drv.compile_count()) == (
        ref["steps"], ref["launches"], ref["compile_count"]) == (N, 4, 1)
    assert drv.state[0] is params
    # the hooks see JAX's series, in JAX's order, with its histogram
    # values; the gauge is each side's own host wall ratio
    assert [(s, op) for s, op, _ in hooks.seen] == \
        [(s, op) for s, op, _ in ref["series"]]
    assert [v for s, op, v in hooks.seen if op == "observe"] == \
        [v for s, op, v in ref["series"] if op == "observe"] == \
        [K, K, 1, 1]
    assert hooks.seen[-1] == (tdriver.SERIES["host_overhead"], "set",
                              drv.host_overhead_ratio())
    rep = drv.report()
    assert rep["steps"] == N and rep["launches"] == 4
    assert 0.0 <= rep["host_overhead_ratio"] <= 1.0
    drv.recorder.close()


def test_compile_count_stays_one_once_warm():
    _, tcfg, _ = _setup("llama")
    topt = tts.default_optimizer(**OPT)
    params, state = tts.init_state(tcfg, topt,
                                   generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    drv = tdriver.StepDriver(tcfg, topt, steps_per_launch=K, device="cpu")
    params, state, _ = drv.run(params, state, iter(_batches(n=K)))
    assert drv.compile_count() == 1
    params, state, m = drv.run(params, state, iter(_batches(seed=8, n=K)))
    assert drv.compile_count() == 1 and m["loss"].shape == (K,)
    assert (drv.steps, drv.launches) == (2 * K, 2)
    drv.reset_attribution()
    assert drv.host_s == drv.step_s == drv.host_overhead_ratio() == 0.0
    drv.recorder.close()


def test_driver_refusals_match_jax():
    """A feed stacking more batches per group than the driver fuses would
    silently single-step everything: both drivers refuse it, with JAX's
    messages. The port takes a mesh or a plan, but refuses a device beside
    one. Under the 1f1b schedule both degrade to single steps."""
    from types import SimpleNamespace

    jcfg, tcfg, jp = _setup("llama")
    jopt, topt = jts.default_optimizer(**OPT), tts.default_optimizer(**OPT)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu", dtype=torch.float32)
    drivers = ((jdriver.StepDriver(jcfg, jopt, steps_per_launch=2), jp,
                None),
               (tdriver.StepDriver(tcfg, topt, steps_per_launch=2,
                                   device="cpu"), tp, topt.init(tp)))
    toks = np.zeros((4, 2, 33), np.int32)   # a group of 4 > K = 2
    for drv, params, state in drivers:
        with pytest.raises(ValueError, match="stack"):
            drv.run(params, state, _Feed([{"tokens": toks}], stack=4))
        with pytest.raises(ValueError, match="exceeds"):
            drv.run(params, state, iter([{"tokens": toks}]), stacked=True)
        assert drv.steps == drv.launches == 0
    sp_mesh = SimpleNamespace(mesh_dim_names=("sp", "fsdp"), shape=(2, 2))
    # the 1f1b schedule (item 9) cannot fuse K steps: make_multi_step
    # refuses it and both drivers degrade to single steps
    # (tests/test_zz_train_fast.py:157-173)
    for mod, cfg, where in (
            (jts, dataclasses.replace(jcfg, pipeline_axis="pp",
                                      pipeline_schedule="1f1b"), {}),
            (tts, dataclasses.replace(tcfg, pipeline_axis="pp",
                                      pipeline_schedule="1f1b"),
             {"device": "cpu"})):
        assert not mod.supports_multi_step(cfg)
        with pytest.raises(NotImplementedError, match="1f1b"):
            mod.make_multi_step(cfg, mod.default_optimizer(), 4, **where)
        drv = (jdriver if mod is jts else tdriver).StepDriver(
            cfg, mod.default_optimizer(), steps_per_launch=4, **where)
        assert drv.requested_steps_per_launch == 4
        assert drv.steps_per_launch == 1 and not drv.fused
    for kw in ({"mesh": sp_mesh}, {"plan": object()}):
        with pytest.raises(ValueError, match="not both"):
            tdriver.StepDriver(tcfg, topt, device="cpu", **kw)


def test_fast_path_defaults_and_degrade():
    """The default K is JAX's fast-path default outside a session (1, no
    fusion); K < 1 is refused; K = 1 runs single steps."""
    from ray_tpu.train.config import FastPathConfig as JFastPath

    _, tcfg, _ = _setup("llama")
    topt = tts.default_optimizer(**OPT)
    with pytest.raises(ValueError, match="steps_per_launch"):
        tdriver.StepDriver(tcfg, topt, steps_per_launch=0, device="cpu")
    drv = tdriver.StepDriver(tcfg, topt, device="cpu")
    assert drv.requested_steps_per_launch == JFastPath().steps_per_launch
    assert (drv.requested_steps_per_launch, drv.steps_per_launch,
            drv.fused) == (1, 1, False)
    assert tts.supports_multi_step(tcfg)
    params, state = tts.init_state(tcfg, topt,
                                   generator=torch.Generator().manual_seed(1),
                                   device="cpu")
    drv.run(params, state, iter(_batches(n=3)))
    assert (drv.steps, drv.launches, drv.compile_count()) == (3, 3, 1)
    assert drv.recorder.launches() == []   # only fused launches stamp it


def test_driver_default_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    _, tcfg, _ = _setup("llama")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.StepDriver(tcfg, tts.default_optimizer())
