"""The card's ``seqpipe`` phase rehearsed on the CPU: one gloo rank in this
process, ``auto_mesh(1)``, the ``debug`` preset in bf16 compute with
flash attention and remat, steps of ``make_train_step(mesh=...)`` under
ring and Ulysses attention and under GPipe and 1F1B (pp 1, 4
microbatches) against plain flash steps from the same init. A ring or a
Ulysses of one runs the flash step's arithmetic, so both must equal it
to the bit; the pipelines' microbatch GEMMs round differently in bf16
(``chip_smoke.py``'s ``BWD_REL_TOL``, 1e-2). 1F1B through
``StepDriver(steps_per_launch=2)`` runs single steps equal to the 1F1B
loop's."""

import dataclasses
import threading

import pytest
import torch

from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import context as tcontext
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train.driver import StepDriver

BF16_REL = 1e-2
STEPS = 3
PIPE = {"pipeline_axis": "pp", "pipeline_microbatches": 4}
RUNS = {"ring": {"attn_impl": "ring"}, "ulysses": {"attn_impl": "ulysses"},
        "gpipe": PIPE, "1f1b": dict(PIPE, pipeline_schedule="1f1b")}


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    from ray_tpu_torch.collective import (bootstrap_torch_distributed,
                                          clear_rendezvous)

    store = tmp_path_factory.mktemp("seqpipe") / "store"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bootstrap_torch_distributed(1, 0, "seqpipe_test", "gloo", 60,
                                init_method=f"file://{store}")
    try:
        yield tts.auto_mesh(1, device_type="cpu")[0]
    finally:
        clear_rendezvous("seqpipe_test")
        torch.set_num_threads(threads)


BASE = dataclasses.replace(tllama.PRESETS["debug"], attn_impl="flash")
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)


def _init(cfg, mesh):
    gen = torch.Generator().manual_seed(0)
    opt = tts.default_optimizer(**OPT)
    params, state = tts.init_sharded_state(cfg, mesh, opt, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
    return opt, params, state, {"tokens": tokens}


def _steps(step, params, state, batch, n):
    out = []
    for _ in range(n):
        params, state, m = step(params, state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.fixture(scope="module")
def plain(one_rank):
    opt, params, _, batch = _init(BASE, one_rank)
    params = tllama._unflatten({k: v.to_local().clone() for k, v in
                                tts._leaves(params).items()})
    return _steps(tts.make_train_step(BASE, opt, device="cpu"), params,
                  opt.init(params), batch, STEPS)


@pytest.mark.parametrize("name", list(RUNS))
def test_one_rank_seqpipe_step_matches_the_plain_step(one_rank, plain,
                                                      name):
    cfg = dataclasses.replace(BASE, **RUNS[name])
    opt, params, state, batch = _init(cfg, one_rank)
    got = _steps(tts.make_train_step(cfg, opt, mesh=one_rank), params,
                 state, batch, STEPS)
    if name in ("ring", "ulysses"):
        assert got == plain
    else:
        for (a, b), (c, d) in zip(got, plain):
            assert abs(a - c) / abs(c) < BF16_REL
            assert abs(b - d) / abs(d) < BF16_REL


def test_1f1b_driver_degrades_to_the_1f1b_loop(one_rank):
    cfg = dataclasses.replace(BASE, **RUNS["1f1b"])
    opt, params, state, batch = _init(cfg, one_rank)
    loop = _steps(tts.make_train_step(cfg, opt, mesh=one_rank), params,
                  state, batch, STEPS)
    opt, params, state, batch = _init(cfg, one_rank)
    drv = StepDriver(cfg, opt, mesh=one_rank, steps_per_launch=2)
    got = []
    drv.run(params, state, iter([batch] * STEPS),
            on_launch=lambda m: got.append(float(m["loss"])))
    drv.recorder.close()
    assert got == [a for a, _ in loop]
    assert (drv.steps, drv.launches, drv.fused) == (STEPS, STEPS, False)


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(RUNS))
def test_launches_a_step_are_chip_smokes_formula(one_rank, monkeypatch,
                                                 name):
    """``chip_smoke.seqpipe_launches``, which the card's run holds the
    counters to, against the kernel calls one step makes here: counting
    stand-ins for the forward, dq and dkv wrappers (on the CPU the
    wrappers count nothing, and the backward's plain version calls
    neither dq nor dkv, so it is routed through them)."""
    from ray_tpu_torch.ops import flash as tflash

    calls = {"tcb": 0, "dq": 0, "dkv": 0}

    def counting(key, fn):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(tflash, "flash_fwd",
                        counting("tcb", tflash.flash_fwd))
    monkeypatch.setattr(tflash, "flash_dq", counting("dq", tflash.flash_dq))
    monkeypatch.setattr(tflash, "flash_dkv",
                        counting("dkv", tflash.flash_dkv))

    def bwd(q, k, v, o, lse, do, q_offset=0, **kw):
        dq, delta = tflash.flash_dq(q, k, v, o, lse, do, q_offset, **kw)
        return (dq, *tflash.flash_dkv(q, k, v, lse, delta, do, q_offset,
                                      **kw))

    monkeypatch.setattr(tflash, "flash_bwd", bwd)
    cfg = dataclasses.replace(BASE, **RUNS[name])
    opt, params, state, batch = _init(cfg, one_rank)
    tts.make_train_step(cfg, opt, mesh=one_rank)(params, state, batch)
    want = _chip_smoke().seqpipe_launches(name, 4, cfg.n_layers)
    assert (calls["tcb"], calls["dq"], calls["dkv"]) == want


def test_remat_recompute_finds_the_mesh_on_another_thread(one_rank):
    """On a card autograd runs the backward, and so each block's remat
    recompute, on a device thread of its own, where the step's
    ``mesh_scope`` is not set: the recompute must still find the mesh.
    Here the backward runs on another thread, as there."""
    cfg = dataclasses.replace(BASE, **RUNS["ring"])
    _, params, _, batch = _init(cfg, one_rank)
    leaves = tts._leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    from torch.distributed.tensor.experimental import implicit_replication

    batch = tts.compile_plan(cfg, one_rank).place_batch(batch)
    with tcontext.mesh_scope(one_rank), implicit_replication():
        loss = tllama.lm_loss(params, batch, cfg)
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, list(leaves.values()))
        except Exception as e:   # noqa: BLE001 — reported by the assert
            out["error"] = e

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert "error" not in out, out.get("error")
    assert all(torch.isfinite(g.to_local()).all() for g in out["grads"])

