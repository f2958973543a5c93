"""The card's ``mesh`` phase rehearsed on the CPU: one gloo rank in this
process, ``bootstrap_torch_distributed``, ``auto_mesh(1)``,
``init_sharded_state`` and steps of ``make_train_step(mesh=...)`` and
``StepDriver(mesh=...)`` against plain steps from a copy of the same
params, in bf16 compute for both attention impls. One rank runs the same
local ops as the plain step, so everything must be equal to the bit."""

import dataclasses

import pytest
import torch

from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import train_step as tts


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_one_rank_mesh_step_is_the_plain_step(tmp_path, impl):
    """What the card's ``mesh`` phase checks, in this process on one gloo
    rank with bf16 compute: ``bootstrap_torch_distributed``,
    ``auto_mesh(1)``, ``init_sharded_state`` (the values of
    ``init_state`` for the same generator), then steps of
    ``make_train_step(mesh=...)`` and of ``StepDriver(mesh=...)`` against
    plain steps from a copy of the same params: one rank runs the same
    local ops, so losses, grad norms and params are equal to the bit."""
    from ray_tpu_torch.collective import (bootstrap_torch_distributed,
                                          clear_rendezvous)
    from ray_tpu_torch.train.driver import StepDriver

    cfg = dataclasses.replace(tllama.PRESETS["debug"], attn_impl=impl)
    opt = tts.default_optimizer(lr=3e-4, warmup_steps=2, total_steps=100)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bootstrap_torch_distributed(1, 0, "one", "gloo", 60,
                                init_method=f"file://{tmp_path}/store")
    try:
        mesh, _ = tts.auto_mesh(1, device_type="cpu")

        def init():
            gen = torch.Generator().manual_seed(0)
            params, state = tts.init_sharded_state(cfg, mesh, opt,
                                                   generator=gen)
            tokens = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
            return params, state, {"tokens": tokens}

        params, state, batch = init()
        plain, _ = tts.init_state(cfg, opt, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
        for k, v in tts._leaves(params).items():
            assert torch.equal(v.to_local(), tts._leaves(plain)[k]), k
        pstate = opt.init(plain)
        step = tts.make_train_step(cfg, opt, mesh=mesh)
        pstep = tts.make_train_step(cfg, opt, device="cpu")
        ref = []
        for _ in range(4):
            params, state, m = step(params, state, batch)
            plain, pstate, pm = pstep(plain, pstate, batch)
            ref.append(float(pm["loss"]))
            assert float(m["loss"]) == float(pm["loss"])
            assert float(m["grad_norm"]) == float(pm["grad_norm"])
        for k, v in tts._leaves(params).items():
            assert torch.equal(v.to_local(), tts._leaves(plain)[k]), k
        params, state, batch = init()
        drv = StepDriver(cfg, opt, mesh=mesh, steps_per_launch=2)
        got = []
        drv.run(params, state, iter([batch] * 4),
                on_launch=lambda m: got.extend(m["loss"].tolist()))
        drv.recorder.close()
        assert got == ref and (drv.steps, drv.launches) == (4, 2)
    finally:
        clear_rendezvous("one")
        torch.set_num_threads(threads)
