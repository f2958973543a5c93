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
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import anakin as tanakin
from ray_tpu_torch.rl.rlhf import pipeline as tpipe
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.driver import StepDriver

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the policy server and its client are written on the standard library:
# the port depends on neither aiohttp nor requests, except that the serve
# HTTP proxy runs on aiohttp, as JAX's does
FORBIDDEN = ("jax", "jaxlib", "ray_tpu", "aiohttp", "requests")
ALLOWED = {"ray_tpu_torch/serve/proxy.py": ("aiohttp",)}


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
            "ray_tpu_torch/serve/__init__.py", "ray_tpu_torch/serve/api.py",
            "ray_tpu_torch/serve/asgi.py", "ray_tpu_torch/serve/config.py",
            "ray_tpu_torch/serve/controller.py",
            "ray_tpu_torch/serve/grpc_proxy.py",
            "ray_tpu_torch/serve/handle.py",
            "ray_tpu_torch/serve/multiplex.py", "ray_tpu_torch/serve/obs.py",
            "ray_tpu_torch/serve/proxy.py", "ray_tpu_torch/serve/replica.py",
            "ray_tpu_torch/serve/schema.py",
            "ray_tpu_torch/cluster/stream.py",
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
            "ray_tpu_torch/rl/algorithms/pg.py",
            "ray_tpu_torch/rl/algorithms/a2c.py",
            "ray_tpu_torch/rl/algorithms/impala.py",
            "ray_tpu_torch/rl/algorithms/appo.py",
            "ray_tpu_torch/rl/algorithms/dqn.py",
            "ray_tpu_torch/rl/algorithms/ddpg.py",
            "ray_tpu_torch/rl/algorithms/sac.py",
            "ray_tpu_torch/rl/algorithms/apex.py",
            "ray_tpu_torch/rl/algorithms/r2d2.py",
            "ray_tpu_torch/rl/algorithms/offline.py",
            "ray_tpu_torch/rl/algorithms/cql.py",
            "ray_tpu_torch/rl/algorithms/crr.py",
            "ray_tpu_torch/rl/algorithms/qmix.py",
            "ray_tpu_torch/rl/algorithms/maddpg.py",
            "ray_tpu_torch/rl/algorithms/maml.py",
            "ray_tpu_torch/rl/algorithms/mbmpo.py",
            "ray_tpu_torch/rl/algorithms/dreamer.py",
            "ray_tpu_torch/rl/algorithms/bandits.py",
            "ray_tpu_torch/rl/algorithms/es.py",
            "ray_tpu_torch/rl/algorithms/ars.py",
            "ray_tpu_torch/rl/algorithms/alphazero.py",
            "ray_tpu_torch/rl/algorithms/lc0.py",
            "ray_tpu_torch/rl/algorithms/dt.py",
            "ray_tpu_torch/rl/algorithms/slateq.py",
            "ray_tpu_torch/rl/pixel_env.py",
            "ray_tpu_torch/rl/multi_agent.py",
            "ray_tpu_torch/rl/evaluation.py",
            "ray_tpu_torch/rl/replay_buffer.py", "ray_tpu_torch/rl/ope.py",
            "ray_tpu_torch/rl/connectors.py", "ray_tpu_torch/rl/config.py",
            "ray_tpu_torch/rl/rl_module.py",
            "ray_tpu_torch/rl/env_runner.py",
            "ray_tpu_torch/rl/learner.py", "ray_tpu_torch/rl/algorithm.py",
            "ray_tpu_torch/rl/train.py", "ray_tpu_torch/tune/__init__.py",
            "ray_tpu_torch/tune/trainable.py",
            "ray_tpu_torch/rl/rlhf/__init__.py",
            "ray_tpu_torch/rl/rlhf/models.py",
            "ray_tpu_torch/rl/rlhf/pipeline.py",
            "ray_tpu_torch/parallel/mesh.py",
            "ray_tpu_torch/parallel/sharding.py",
            "ray_tpu_torch/parallel/plan.py",
            "ray_tpu_torch/parallel/context.py",
            "ray_tpu_torch/parallel/pipeline.py",
            "ray_tpu_torch/collective/__init__.py",
            "ray_tpu_torch/collective/collective.py",
            "ray_tpu_torch/collective/rendezvous.py",
            "ray_tpu_torch/rl/policy_server.py",
            "ray_tpu_torch/util/timeline.py",
            "ray_tpu_torch/tools/profile.py",
            "ray_tpu_torch/tools/kv_bench.py",
            "ray_tpu_torch/tools/stream_bench.py", "chip_smoke.py",
            # the runtime core and the Train library on it
            "ray_tpu_torch/__init__.py", "ray_tpu_torch/exceptions.py",
            "ray_tpu_torch/runtime_context.py",
            "ray_tpu_torch/_private/serialization.py",
            "ray_tpu_torch/_private/accelerator.py",
            "ray_tpu_torch/core/worker.py",
            "ray_tpu_torch/core/local_backend.py",
            "ray_tpu_torch/core/resources.py",
            "ray_tpu_torch/dag/dag_node.py",
            "ray_tpu_torch/scheduler/policy.py",
            "ray_tpu_torch/util/placement_group.py",
            "ray_tpu_torch/cluster/gcs.py", "ray_tpu_torch/cluster/raylet.py",
            "ray_tpu_torch/cluster/worker_core.py",
            "ray_tpu_torch/cluster/worker_main.py",
            "ray_tpu_torch/runtime_env/runtime_env.py",
            "ray_tpu_torch/_native/__init__.py",
            "ray_tpu_torch/train/config.py", "ray_tpu_torch/train/session.py",
            "ray_tpu_torch/train/worker_group.py",
            "ray_tpu_torch/train/trainer.py"} <= names
    bad = [(f.relative_to(ROOT), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN
           and mod.split(".")[0] not in ALLOWED.get(
               str(f.relative_to(ROOT)), ())]
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
    # the on-policy RL stack: the algorithm, its learner and runners, the
    # Catalog, the training entry point
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.PPOConfig().build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.Learner({"w": np.zeros(2, np.float32)}, None, 1e-3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.EnvRunner("CartPole-v1", 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.Catalog.build(trl.EnvSpec(obs_dim=4, num_actions=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tanakin.bench_fused_vs_host()
    # the off-policy families: value-based, continuous, recurrent, offline
    offline = {"obs": np.zeros((4, 3), np.float32),
               "actions": np.zeros((4, 1), np.float32),
               "rewards": np.zeros(4, np.float32),
               "next_obs": np.zeros((4, 3), np.float32),
               "dones": np.zeros(4, bool)}
    for cfg in (trl.DQNConfig(), trl.ApexDQNConfig(), trl.SACConfig(),
                trl.TD3Config(), trl.ApexDDPGConfig(), trl.R2D2Config(),
                trl.CQLConfig(offline_data=offline),
                trl.CRRConfig(offline_data=offline)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
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
    # the tools (rt profile, the engine benches) and the policy server
    from ray_tpu_torch.tools import kv_bench, profile, stream_bench

    for tool in (profile, kv_bench, stream_bench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.ExternalEnvRunner(0, {"obs_dim": 4, "num_actions": 2}, 8)
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


# the multi-agent and model-based algorithms' registry names and yamls
MULTI_AGENT_MODEL_BASED = {"MAML": "pointgoal-maml", "MBMPO": "pendulum-mbmpo",
                           "QMIX": "coordination-qmix",
                           "MADDPG": "spread-maddpg",
                           "DREAMERV3": "cartpole-dreamerv3"}


@pytest.mark.parametrize("run", sorted(MULTI_AGENT_MODEL_BASED))
def test_registry_and_yaml_of_multi_agent_and_model_based(run):
    """Each new registry name builds its config, and its tuned example is
    JAX's file byte for byte and names that algorithm."""
    from ray_tpu_torch.rl import train as ttrain

    cfg = ttrain.algorithm_registry()[run]()
    assert cfg.algo_class.__name__ == {"DREAMERV3": "DreamerV3"}.get(run, run)
    name = MULTI_AGENT_MODEL_BASED[run]
    ours = ROOT / "ray_tpu_torch" / "rl" / "tuned_examples" / f"{name}.yaml"
    jaxs = ROOT / "ray_tpu" / "rl" / "tuned_examples" / f"{name}.yaml"
    assert ours.read_bytes() == jaxs.read_bytes()
    exp = ttrain.load_tuned_example(name)
    assert exp["run"] == run
    cfg.update_from_dict(exp["config"])   # every key is known


# the last RL families' registry names and yamls (None: no tuned example)
SEARCH_POPULATION_SEQUENCE_SLATE = {
    "ES": "cartpole-es", "ARS": None, "ALPHAZERO": None,
    "LEELACHESSZERO": "connect4-lc0", "DT": None, "SLATEQ": "recsim-slateq",
    "BANDITLINUCB": None, "BANDITLINTS": None}


@pytest.mark.parametrize("run", sorted(SEARCH_POPULATION_SEQUENCE_SLATE))
def test_registry_and_yaml_of_search_population_sequence_slate(run):
    """Each name builds JAX's class through ``get_algorithm_config`` (the
    two bandits share a config class), and its tuned example is JAX's
    file byte for byte and names that algorithm."""
    from ray_tpu.rl import train as jtrain
    from ray_tpu_torch.rl import train as ttrain

    cfg = ttrain.get_algorithm_config(run)
    assert cfg.algo_class.__name__ \
        == jtrain.get_algorithm_config(run).algo_class.__name__
    assert cfg.algo_class.__module__.startswith("ray_tpu_torch.rl.")
    name = SEARCH_POPULATION_SEQUENCE_SLATE[run]
    if name is None:
        return
    ours = ROOT / "ray_tpu_torch" / "rl" / "tuned_examples" / f"{name}.yaml"
    jaxs = ROOT / "ray_tpu" / "rl" / "tuned_examples" / f"{name}.yaml"
    assert ours.read_bytes() == jaxs.read_bytes()
    exp = ttrain.load_tuned_example(name)
    assert exp["run"] == run
    cfg.update_from_dict(exp["config"])   # every key is known


def test_rl_exports_cover_jax_for_the_last_families():
    """What JAX's ``rl`` and ``rl.algorithms`` export for the pixel envs,
    bandits, ES/ARS, AlphaZero/LC0, DT and SlateQ, the port exports."""
    import ray_tpu.rl as jrl
    import ray_tpu.rl.algorithms as jalgos
    import ray_tpu_torch.rl.algorithms as talgos

    names = {"Game", "MCTS", "TicTacToe", "ConnectFour", "RecSlateEnv",
             "CatchPixels", "FrameStack", "PixelWrapper", "gym_vector_env",
             "ES", "ESConfig", "ARS", "ARSConfig", "AlphaZero",
             "AlphaZeroConfig", "LeelaChessZero", "LeelaChessZeroConfig",
             "DT", "DTConfig", "SlateQ", "SlateQConfig", "BanditConfig",
             "BanditLinUCB", "BanditLinTS", "LinearBanditEnv"}
    for jmod, tmod in ((jrl, trl), (jalgos, talgos)):
        want = {n for n in names if hasattr(jmod, n)}
        assert want and {n for n in want if hasattr(tmod, n)} == want


def test_last_rl_families_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    data = {"obs": np.zeros((4, 4), np.float32),
            "actions": np.zeros(4, np.int64),
            "rewards": np.ones(4, np.float32),
            "dones": np.asarray([0, 1, 0, 1], bool)}
    for cfg in (trl.ESConfig(), trl.ARSConfig(), trl.AlphaZeroConfig(),
                trl.LeelaChessZeroConfig(), trl.SlateQConfig(),
                trl.DTConfig(offline_data=data),
                trl.BanditLinUCB.get_default_config(),
                trl.BanditLinTS.get_default_config()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.AlphaZero({"__algo_config": trl.AlphaZeroConfig()})
    from ray_tpu_torch.rl import train as ttrain

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run_train("SLATEQ", stop_iters=1)
