"""Algorithm: the top-level RL loop (port of ``ray_tpu/rl/algorithm.py``).

An ``Algorithm`` is a ``Trainable`` whose ``step()`` delegates to the
per-algorithm ``training_step()``; ``AlgorithmConfig.build()`` makes one.
JAX runs its EnvRunners as actors and gathers their results with
``ray_tpu.get``; here the whole algorithm runs in one process on one
device: the runners are plain objects in a list, a remote call is a
method call, and the learner and the runners' policy forwards share the
algorithm's device.

Fault tolerance keeps JAX's semantics (``gather_tolerant``): a runner
whose call raises loses that call's result for the iteration and is
rebuilt from its constructor arguments, as an actor restart would, while
it has restarts left (``max_env_runner_restarts`` when
``restart_failed_env_runners``); the call raises only when every runner
failed. External envs (``external://``, JAX's policy server) need the
cluster runtime (ROADMAP item R) and are refused.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.connectors import build_connectors
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.learner import Learner, LearnerGroup
from ray_tpu_torch.rl.rl_module import Catalog
from ray_tpu_torch.tune.trainable import Trainable

logger = logging.getLogger("ray_tpu_torch.rl")


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
        if cfg.env.startswith("external://"):
            raise NotImplementedError(
                "external envs (the policy server, ExternalEnvRunner) need "
                "the cluster runtime, which the port does not have "
                "(ROADMAP item R)")
        # probe the env spec
        self.spec = make_env(cfg.env, 1, cfg.env_config).spec
        n_runners = max(1, cfg.num_env_runners) \
            if self.need_env_runners else 0
        restarts = (cfg.max_env_runner_restarts
                    if cfg.restart_failed_env_runners else 0)
        self._runner_args = [
            dict(env_name=cfg.env, num_envs=cfg.num_envs_per_runner,
                 rollout_len=cfg.rollout_fragment_length, gamma=cfg.gamma,
                 lam=cfg.lambda_, seed=cfg.seed + 1000 * i,
                 env_config=cfg.env_config, explore=self.explore_mode,
                 connectors=cfg.connectors, device=self.device)
            for i in range(n_runners)]
        self._restarts_left = [restarts] * n_runners
        self.runners = [EnvRunner(**kw) for kw in self._runner_args]
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

    def call_runner(self, i: int, method: str, *args):
        """``runners[i].method(*args)``; when it raises, the runner is
        rebuilt from its constructor arguments if it has restarts left,
        and the error propagates (the call's result is lost)."""
        try:
            return getattr(self.runners[i], method)(*args)
        except Exception:
            if self._restarts_left[i] > 0:
                self._restarts_left[i] -= 1
                self.runners[i] = EnvRunner(**self._runner_args[i])
            raise

    def gather_tolerant(self, method: str, *args) -> List:
        """``method(*args)`` on every runner, DROPPING failed results
        instead of failing the iteration (reference:
        FaultTolerantActorManager.foreach_worker). Raises only when every
        runner failed."""
        out, last_err = [], None
        for i in range(len(self.runners)):
            try:
                out.append(self.call_runner(i, method, *args))
            except Exception as e:  # noqa: BLE001 — result lost, not fatal
                last_err = e
                logger.warning("env-runner %d %s failed (%s: %s) — "
                               "dropping its result; the runner is rebuilt "
                               "if it has restarts left", i, method,
                               type(e).__name__, str(e)[:120])
        if not out and self.runners:
            raise last_err
        return out

    def synchronous_sample(self, params) -> Dict[str, np.ndarray]:
        """``sample`` on every runner, fragments concatenated (reference:
        ``rollout_ops.synchronous_parallel_sample``); a failed runner's
        fragment is dropped for the iteration."""
        batches = self.gather_tolerant("sample", params)
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
        for r in self.runners:
            r.set_connector_globals(state)

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
        """Release the runners (JAX kills their actors)."""
        self.runners = []


def make_learner(algo: Algorithm, loss_fn: Callable):
    """PPO's and A2C's learner on the algorithm's device; where
    ``num_learners > 0`` JAX builds a ``LearnerGroup`` of actors, which
    the port refuses (ROADMAP item R)."""
    cfg = algo.config
    if cfg.num_learners > 0:
        return LearnerGroup(cfg.num_learners, cfg.num_tpus_per_learner)
    return Learner(algo.init_policy_params(), loss_fn, cfg.lr,
                   grad_clip=cfg.grad_clip, seed=cfg.seed,
                   device=algo.device)
