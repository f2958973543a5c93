"""Package rules of ray_tpu_torch: it imports neither jax nor ray_tpu, its
entry points run on cuda unless asked for the CPU, and the flash wrapper
launches nothing for a CPU tensor."""

import ast
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ray_tpu_torch.collective import bootstrap_torch_distributed
from ray_tpu_torch.data.iterator import iter_device_batches
from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.serving import ContinuousBatcher, ContinuousEngine
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash as tflash
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.rl import anakin as tanakin
from ray_tpu_torch.rl.rlhf import pipeline as tpipe
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.driver import StepDriver

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_ray_tpu():
    pkg = ROOT / "ray_tpu_torch"
    # _build/ holds build outputs, not the package's sources
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"ray_tpu_torch/ops/flash.py", "ray_tpu_torch/models/llama.py",
            "ray_tpu_torch/models/serving.py",
            "ray_tpu_torch/parallel/train_step.py",
            "ray_tpu_torch/util/flops.py",
            "ray_tpu_torch/util/prefix_hash.py",
            "ray_tpu_torch/util/recorder_core.py",
            "ray_tpu_torch/util/engine_recorder.py",
            "ray_tpu_torch/models/moe.py", "ray_tpu_torch/serve/llm.py",
            "ray_tpu_torch/serve/batching.py",
            "ray_tpu_torch/train/__init__.py",
            "ray_tpu_torch/train/driver.py",
            "ray_tpu_torch/train/checkpoint.py",
            "ray_tpu_torch/data/__init__.py",
            "ray_tpu_torch/data/iterator.py",
            "ray_tpu_torch/util/step_profiler.py",
            "ray_tpu_torch/util/train_recorder.py",
            "ray_tpu_torch/util/memory.py",
            "ray_tpu_torch/util/pipeline_recorder.py",
            "ray_tpu_torch/models/vit.py",
            "ray_tpu_torch/models/convert.py",
            "ray_tpu_torch/rl/__init__.py", "ray_tpu_torch/rl/env.py",
            "ray_tpu_torch/rl/device_env.py", "ray_tpu_torch/rl/models.py",
            "ray_tpu_torch/rl/anakin.py",
            "ray_tpu_torch/rl/algorithms/__init__.py",
            "ray_tpu_torch/rl/algorithms/ppo.py",
            "ray_tpu_torch/rl/rlhf/__init__.py",
            "ray_tpu_torch/rl/rlhf/models.py",
            "ray_tpu_torch/rl/rlhf/pipeline.py",
            "ray_tpu_torch/parallel/mesh.py",
            "ray_tpu_torch/parallel/sharding.py",
            "ray_tpu_torch/parallel/plan.py",
            "ray_tpu_torch/collective/__init__.py",
            "ray_tpu_torch/collective/collective.py",
            "ray_tpu_torch/collective/rendezvous.py", "chip_smoke.py"} <= names
    bad = [(f.relative_to(ROOT), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = tllama.PRESETS["debug"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.init_cache(cfg, 1, 8)
    params = tllama.init_params(cfg, generator=torch.Generator(),
                                device="cpu", dtype=torch.float32)
    np_params = {"embed": params["embed"].numpy(),
                 "layers": {k: v.numpy() for k, v in
                            params["layers"].items()},
                 "final_norm": params["final_norm"].numpy(),
                 "lm_head": params["lm_head"].numpy()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(np_params, cfg)
    prompt = np.zeros((1, 4), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.generate(params, prompt, cfg, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(TG.generate_stream(params, prompt, cfg, max_new_tokens=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.generate_speculative(params, params, prompt, cfg, cfg,
                                max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmoe.init_params(tmoe.PRESETS["moe-debug"],
                         generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllm.ContinuousLLM("debug")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllm.StaticLLM("debug")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StepDriver(cfg, tts.default_optimizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iter_device_batches(iter([]))
    ckpt = Checkpoint.from_dict({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.load_pytree()
    # the RLHF roles and pipeline, the fused PPO runner, ViT
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.RLHFLearner("debug", 0, 1e-4, 0.1, 0.2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.RLHFReference("debug", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.RLHFReward("debug", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.RLHFGenerator("debug", 0, 2, 16, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.RLHFPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tanakin.AnakinRunner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.init_params(tvit.PRESETS["debug"], generator=torch.Generator())
    # the mesh, sharded init and the process group: cuda and nccl
    # unless the caller asks for the CPU and gloo
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(tmesh.MeshConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.auto_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.init_sharded_state(cfg, SimpleNamespace(device_type="cuda"),
                               tts.default_optimizer(),
                               generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bootstrap_torch_distributed(1, 0, init_method="file:///unused")
    # and asking for the CPU with params elsewhere is refused, not moved
    with pytest.raises(ValueError, match="params are on"):
        ContinuousBatcher(params, cfg, device="meta")


def test_flash_wrapper_on_cpu_launches_nothing():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2, 16),
                                                    np.float32))
               for _ in range(3))
    before = tflash.flash_fwd.launches
    o, lse = tflash.flash_fwd(q, k, v, 0)
    tflash.flash_attention(q, k, v)
    assert tflash.flash_fwd.launches == before == 0
    ref_o, ref_lse = tflash.flash_fwd_reference(q, k, v, 0)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)


def test_flash_wrapper_validates_shapes():
    q = torch.zeros(1, 4, 3, 16)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tflash.flash_fwd(q, k, k)
    with pytest.raises(ValueError, match="do not match"):
        tflash.flash_fwd(q, k, torch.zeros(1, 5, 2, 16))
    with pytest.raises(ValueError, match="scalar or shape"):
        tflash._offsets(torch.zeros(3, dtype=torch.int32), 2,
                        torch.device("cpu"))


def test_build_names_library_by_source_hash():
    """The library path follows the source bytes and nvcc flags, inside
    the git-ignored build directory; nothing is built at import."""
    path = _build.library_path("flash_fwd")
    assert path.parent == ROOT / "ray_tpu_torch" / "_build"
    assert path.name.startswith("flash_fwd-") and path.suffix == ".so"
    assert path == _build.library_path("flash_fwd")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "ray_tpu_torch/_build/" in ignored
