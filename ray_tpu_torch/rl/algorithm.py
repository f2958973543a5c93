"""Algorithm: the top-level RL loop (port of ``ray_tpu/rl/algorithm.py``).

An ``Algorithm`` is a ``Trainable`` whose ``step()`` delegates to the
per-algorithm ``training_step()``; ``AlgorithmConfig.build()`` makes one.

The runners are a ``rl/fleet.py:Fleet``: actors where the port's
runtime is initialized (either backend), as JAX's, else objects in this
process. Each ``EnvRunner`` (``ExternalEnvRunner`` for external envs)
is created with ``num_cpus_per_runner``, ``runner_runtime_env`` and,
where ``restart_failed_env_runners``, ``max_env_runner_restarts``
restarts. Fault tolerance keeps JAX's semantics (``gather_tolerant``): a
failed call's result is dropped for the iteration and the call raises
only when every runner failed. ``num_learners > 0`` builds a
``LearnerGroup`` of learner actors (``rl/learner.py``), which needs the
runtime. ``stop()`` kills the runner and learner actors without restarts
(an external runner's HTTP server shuts down with its actor, or in
process).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.connectors import build_connectors
from ray_tpu_torch.rl.env import EnvSpec, make_env
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.fleet import Fleet
from ray_tpu_torch.rl.learner import Learner, LearnerGroup
from ray_tpu_torch.rl.policy_server import ExternalEnvRunner
from ray_tpu_torch.rl.rl_module import Catalog
from ray_tpu_torch.tune.trainable import Trainable

class DeviceTrainable(Trainable):
    """A Trainable whose params live on one device (``cuda`` unless
    given; raises without a GPU): the base of ``Algorithm`` and of the
    algorithms JAX writes as plain Trainables with in-process envs
    (MultiAgentPPO, QMIX, MADDPG, MAML, MBMPO, DreamerV3)."""

    def __init__(self, config: Dict[str, Any], device: DeviceLike = None):
        self.device = resolve_device(device)
        super().__init__(config)

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return AlgorithmConfig(algo_class=cls)

    def config_from(self, config: Dict[str, Any]) -> AlgorithmConfig:
        """The ``AlgorithmConfig`` that ``build()`` passed, else the
        default config updated from the flat dict."""
        if "__algo_config" in config:
            return config["__algo_config"]
        return self.get_default_config().update_from_dict(config)

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))


class Algorithm(DeviceTrainable):
    explore_mode = "stochastic"  # DQN overrides with "epsilon_greedy"
    need_env_runners = True      # offline algorithms opt out

    # ---- Trainable API ----

    def setup(self, config: Dict[str, Any]) -> None:
        self.config: AlgorithmConfig = self.config_from(config)
        cfg = self.config
        n_runners = max(1, cfg.num_env_runners) \
            if self.need_env_runners else 0
        if cfg.env.startswith("external://"):
            # external-env serving (rl/policy_server.py): each runner is
            # an HTTP policy server; the spec must be declared up front
            # since no env exists to probe (reference: policy_server_input
            # needs the space config too)
            spec_kwargs = cfg.env_config.get("spec")
            if not spec_kwargs:
                raise ValueError(
                    'external envs need env_config={"spec": {...EnvSpec '
                    'fields...}}')
            if cfg.connectors:
                raise ValueError(
                    "connectors are not applied by external-env runners "
                    "(the external simulator owns preprocessing); drop "
                    "config.connectors or filter client-side")
            self.spec = EnvSpec(**spec_kwargs)
            port = int(cfg.env.split("://", 1)[1] or 0)
            # JAX's external runners are actors without restarts
            self.fleet = self._runner_fleet(ExternalEnvRunner, [
                dict(port=port + i if port else 0, spec=dict(spec_kwargs),
                     rollout_len=cfg.rollout_fragment_length,
                     num_slots=cfg.num_envs_per_runner, gamma=cfg.gamma,
                     lam=cfg.lambda_, seed=cfg.seed + 1000 * i)
                for i in range(n_runners)], 0)
            # bind now so callers can fetch ports before training starts
            self.server_ports = self.fleet.gather("ready",
                                                  [()] * n_runners)
        else:
            # probe the env spec
            self.spec = make_env(cfg.env, 1, cfg.env_config).spec
            restarts = (cfg.max_env_runner_restarts
                        if cfg.restart_failed_env_runners else 0)
            self.fleet = self._runner_fleet(EnvRunner, [
                dict(env_name=cfg.env, num_envs=cfg.num_envs_per_runner,
                     rollout_len=cfg.rollout_fragment_length,
                     gamma=cfg.gamma, lam=cfg.lambda_,
                     seed=cfg.seed + 1000 * i, env_config=cfg.env_config,
                     explore=self.explore_mode, connectors=cfg.connectors)
                for i in range(n_runners)], restarts)
            # a runner actor that cannot be created fails here
            self.fleet.gather("get_spec", [()] * n_runners)
        # the algorithm's own pipeline skeleton: holds/merges the global
        # connector state the runners sync through (reference: filter
        # deltas flushed to the algorithm and re-broadcast each iteration)
        self._conn_pipeline = (build_connectors(cfg.connectors,
                                                self.spec.obs_dims[-1])
                               if n_runners else None)
        self._connector_state = None
        self._env_steps_total = 0
        self._return_window: List[float] = []
        self.build_learner()

    def _runner_fleet(self, cls, args: List[Dict[str, Any]],
                      restarts: int) -> Fleet:
        cfg = self.config
        return Fleet(cls, args, self.device,
                     num_cpus=cfg.num_cpus_per_runner,
                     runtime_env=cfg.runner_runtime_env,
                     max_restarts=restarts)

    @property
    def runners(self) -> List:
        """The runners: actor handles, or the objects themselves."""
        return self.fleet.members

    @property
    def _restarts_left(self) -> List[int]:
        return self.fleet.restarts_left

    def build_learner(self) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        result = self.training_step()
        result.setdefault("env_steps_total", self._env_steps_total)
        return result

    # ---- helpers ----

    def init_policy_params(self):
        """Initial policy/value param tree on the algorithm's device:
        routed through the RLModule Catalog when ``config.module_spec`` is
        set, else the default ``models.init_policy`` network, drawn from a
        generator seeded with ``config.seed``."""
        cfg = self.config
        if getattr(cfg, "module_spec", None) is not None:
            return Catalog.build_params(self.spec, cfg.module_spec,
                                        cfg.seed, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        return models.init_policy(gen, self.spec, cfg.hidden)

    def gather_tolerant(self, method: str, *args) -> List:
        """``method(*args)`` on every runner, dropping failed results
        (``Fleet.gather_tolerant``)."""
        return self.fleet.gather_tolerant(method, *args)

    def synchronous_sample(self, params) -> Dict[str, np.ndarray]:
        """``sample`` on every runner, fragments concatenated (reference:
        ``rollout_ops.synchronous_parallel_sample``); a failed runner's
        fragment is dropped for the iteration."""
        batches = self.gather_tolerant("sample", self.fleet.put(params))
        self._sync_connectors()
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in batches[0]}
        n = len(batch["rewards"])
        # drop per-fragment extras (the [N] bootstrap values) that can't be
        # row-sliced with the [T*N] columns by minibatch updates
        batch = {k: v for k, v in batch.items() if len(v) == n}
        self._env_steps_total += n
        return batch

    def _sync_connectors(self) -> None:
        """Merge runner connector deltas into the global state and
        broadcast it back: every runner then normalizes with the FLEET's
        statistics."""
        if self._conn_pipeline is None:
            return
        deltas = self.gather_tolerant("pop_connector_deltas")
        self._connector_state = self._conn_pipeline.merge_deltas(
            self._connector_state, [d for d in deltas if d is not None])
        try:
            self.gather_tolerant("set_connector_globals",
                                 self._connector_state)
        except Exception:  # noqa: BLE001 — rebroadcast next iteration
            pass

    def _set_fleet_connectors(self, state) -> None:
        self.fleet.gather("set_connector_globals",
                          [(state,)] * len(self.fleet))

    def collect_episode_stats(self) -> Dict[str, float]:
        stats = self.gather_tolerant("episode_stats")
        returns = [s["mean_return"] for s in stats if s["episodes"] > 0]
        episodes = sum(s["episodes"] for s in stats)
        if returns:
            self._return_window.extend(returns)
            self._return_window = self._return_window[-100:]
        mean_ret = (float(np.mean(self._return_window))
                    if self._return_window else float("nan"))
        return {"episodes_this_iter": episodes,
                "episode_return_mean": mean_ret}

    # ---- checkpointing ----

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        """JAX's payload: the params as numpy arrays in JAX's tree."""
        return {"params": params_to_numpy(self.get_params()),
                "env_steps_total": self._env_steps_total,
                "connector_state": self._connector_state,
                "extra": self.get_extra_state()}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        self.set_params(checkpoint["params"])
        self._env_steps_total = checkpoint.get("env_steps_total", 0)
        self._connector_state = checkpoint.get("connector_state")
        if self._connector_state is not None and self._conn_pipeline:
            self._set_fleet_connectors(self._connector_state)
        self.set_extra_state(checkpoint.get("extra"))

    def get_params(self):
        return self.learner.get_params()

    def set_params(self, params) -> None:
        self.learner.set_params(params)

    def get_extra_state(self):
        return None

    def set_extra_state(self, state) -> None:
        pass

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        config: Optional[AlgorithmConfig] = None,
                        device: DeviceLike = None) -> "Algorithm":
        algo = (config or cls.get_default_config()).build(device=device)
        algo.restore(checkpoint_dir)
        return algo

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Roll out the policy and report episode returns (reference:
        ``Algorithm.evaluate``), sampling through the runners with
        ``_eval_params()`` where an algorithm defines it. The env-step
        counter, the episode-return window and the runners' connector
        state are restored afterwards."""
        if not self.runners:
            raise ValueError(
                f"{type(self).__name__} has no env runners; evaluate is "
                "not supported")
        if hasattr(self, "_eval_params"):
            params = self._eval_params()
        elif hasattr(self, "_runner_params"):
            params = self._runner_params()
        else:
            params = self.get_params()
        episodes_seen = 0
        steps_before = self._env_steps_total
        saved_window = self._return_window
        saved_conn = self._connector_state
        self._return_window = []  # eval episodes only
        try:
            deadline = time.monotonic() + 300
            while episodes_seen < num_episodes \
                    and time.monotonic() < deadline:
                self.synchronous_sample(params)
                stats = self.collect_episode_stats()
                episodes_seen += stats["episodes_this_iter"]
            mean_ret = (float(np.mean(self._return_window))
                        if self._return_window else float("nan"))
        finally:
            # evaluation must not advance schedules, pollute the training
            # return window, or shift the fleet's obs-filter statistics
            self._env_steps_total = steps_before
            self._return_window = saved_window
            if self._conn_pipeline is not None:
                # unconditional: saved_conn=None (evaluate before any
                # train) must also roll the fleet back to pristine stats
                self._connector_state = saved_conn
                self._set_fleet_connectors(saved_conn)
        return {"episodes": episodes_seen,
                "episode_return_mean": mean_ret}

    def stop(self) -> None:
        """Release the fleet (``Fleet.kill``) and a ``LearnerGroup``'s
        actors."""
        fleet = getattr(self, "fleet", None)
        if fleet is not None:
            fleet.kill()
        learner = getattr(self, "learner", None)
        if isinstance(learner, LearnerGroup):
            learner.stop()


def make_learner(algo: Algorithm, loss_fn: Callable):
    """PPO's and A2C's learner on the algorithm's device; where
    ``num_learners > 0`` a ``LearnerGroup`` of learner actors, each on
    the algorithm's device type with ``num_gpus_per_learner`` GPUs."""
    cfg = algo.config
    if cfg.num_learners > 0:
        ctor = functools.partial(
            Learner, models.host_tree(algo.init_policy_params()), loss_fn,
            cfg.lr,
            grad_clip=cfg.grad_clip, seed=cfg.seed)
        return LearnerGroup(ctor, cfg.num_learners,
                            cfg.num_gpus_per_learner, device=algo.device)
    return Learner(algo.init_policy_params(), loss_fn, cfg.lr,
                   grad_clip=cfg.grad_clip, seed=cfg.seed,
                   device=algo.device)
