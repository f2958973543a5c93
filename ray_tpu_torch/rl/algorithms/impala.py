"""IMPALA: actor-learner with V-trace off-policy correction (port of
``ray_tpu/rl/algorithms/impala.py``).

JAX keeps every runner sampling asynchronously under the params it was
submitted with and consumes fragments in the order ``ray_tpu.wait`` gives.
On the port's runner actors so does the port (``RoundRobinFleet``). In
one process that staleness is reproduced deterministically: each
runner in flight holds a snapshot of the params taken when it was
submitted; the runners are consumed round robin, each sampled at consume
time with its snapshot, and resubmitted with the current params BEFORE the
learner's update on its fragment, as JAX resubmits before
``update_minibatch``. So a runner's fragment is always one update or more
behind the params it is trained into, as in JAX's pipeline.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.algorithms.ppo import logp_and_entropy
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner, mean_metrics

logger = logging.getLogger("ray_tpu_torch.rl")


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, bootstrap_value,
           dones, gamma, clip_rho: float = 1.0, clip_pg_rho: float = 1.0):
    """V-trace targets over a [T, N] fragment (Espeholt et al. 2018) as a
    reverse loop over T; the results carry no gradient (JAX's
    ``stop_gradient``)."""
    rho = torch.exp(target_logp - behavior_logp)
    clipped_rho = torch.clamp(rho, max=clip_rho)
    clipped_pg_rho = torch.clamp(rho, max=clip_pg_rho)
    nonterminal = 1.0 - dones.float()
    values_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rho * (
        rewards + gamma * nonterminal * values_next - values)
    cs = torch.clamp(rho, max=1.0)
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [None] * deltas.shape[0]
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + gamma * nonterminal[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_advantages = clipped_pg_rho * (
        rewards + gamma * nonterminal * vs_next - values)
    return vs, pg_advantages


def _vtrace_terms(spec, cfg, params, batch):
    """The fragment reshaped to [T, N] (the runner's flat order is
    t-major), the target policy's logp, entropy and values, and V-trace's
    targets and advantages."""
    T = cfg.rollout_fragment_length
    N = batch["rewards"].shape[0] // T
    sh = lambda a: a.reshape((T, N) + tuple(a.shape[1:]))  # noqa: E731
    obs = sh(batch["obs"])
    behavior_logp = sh(batch["logp"])
    logits = models.policy_logits(params, obs)
    target_logp, entropy = logp_and_entropy(spec, params, logits,
                                            sh(batch["actions"]))
    values = models.value(params, obs)
    vs, pg_adv = vtrace(
        behavior_logp, target_logp, sh(batch["rewards"]), values,
        batch["last_values"], sh(batch["dones"]), cfg.gamma,
        cfg.vtrace_clip_rho, cfg.vtrace_clip_pg_rho)
    return behavior_logp, target_logp, entropy, values, vs, pg_adv


def make_impala_loss(spec, cfg: AlgorithmConfig):
    def loss_fn(params, batch, key=None):
        _, target_logp, entropy, values, vs, pg_adv = _vtrace_terms(
            spec, cfg, params, batch)
        pi_loss = -torch.mean(target_logp * pg_adv)
        vf_loss = torch.mean((values - vs) ** 2)
        total = pi_loss + cfg.vf_coeff * vf_loss \
            - cfg.entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss_fn


class RoundRobinFleet:
    """JAX's runners in flight, made deterministic (IMPALA, Ape-X): each
    runner in flight holds a snapshot of the params it was submitted with
    (``_params_for(i)``); ``_consume_round`` takes them round robin, one
    fragment a runner, each sampled at consume time with its snapshot and
    resubmitted with the current params before the fragment is yielded
    (JAX resubmits before the learner's update). A failed runner's
    fragment is dropped and the (rebuilt) runner resubmitted (reference:
    FaultTolerantActorManager); one that fails
    ``_MAX_CONSECUTIVE_FAILURES`` times in a row leaves the rotation.

    On runner actors the fleet is JAX's: each runner samples as soon as
    it is submitted, and the fragments are consumed in ``wait`` order,
    each runner resubmitted with the current params before its fragment
    is yielded."""

    # a runner that keeps failing would otherwise be resubmitted forever
    _MAX_CONSECUTIVE_FAILURES = 3

    def _init_fleet(self) -> None:
        # runner index -> its submitted ``sample`` (``Fleet.submit``)
        self._inflight: Dict[int, Any] = {}
        self._runner_failures: Dict[int, int] = {}

    def _submit(self, i: int) -> None:
        if self._runner_failures.get(i, 0) \
                >= self._MAX_CONSECUTIVE_FAILURES:
            return  # evicted from rotation
        # a snapshot: in process the call runs when it is consumed
        params = models.clone_tree(self._params_for(i))
        self._inflight[i] = self.fleet.submit(i, "sample",
                                              self.fleet.put(params))

    def _consume_round(self, label: str) -> Iterator[Dict]:
        """One fragment from each runner in flight, in turn; each counts
        into the env steps before it is yielded."""
        for i in range(len(self.runners)):  # keep every runner in flight
            if i not in self._inflight:
                self._submit(i)
        if not self._inflight:
            raise RuntimeError(
                "all env-runners failed permanently (each exceeded "
                f"{self._MAX_CONSECUTIVE_FAILURES} consecutive failures)")
        for _ in range(len(self.runners)):
            if not self._inflight:
                break
            i = self.fleet.next_ready(self._inflight)
            pending = self._inflight.pop(i)
            try:
                batch = self.fleet.get(pending)
            except Exception as e:  # noqa: BLE001 — fragment lost, not fatal
                logger.warning(
                    "%s runner %d fragment lost (%s: %s) — resubmitting",
                    label, i, type(e).__name__, str(e)[:120])
                self._runner_failures[i] = \
                    self._runner_failures.get(i, 0) + 1
                self._submit(i)
                continue
            self._runner_failures.pop(i, None)
            self._submit(i)  # resubmit with the current params
            self._env_steps_total += len(batch["rewards"])
            yield batch

    def stop(self) -> None:
        self._inflight.clear()
        super().stop()


class IMPALA(RoundRobinFleet, Algorithm):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        cfg = AlgorithmConfig(algo_class=cls)
        cfg.num_env_runners = 2
        cfg.entropy_coeff = 0.01
        return cfg

    def make_loss(self):
        return make_impala_loss(self.spec, self.config)

    def build_learner(self) -> None:
        cfg = self.config
        self.learner = Learner(self.init_policy_params(), self.make_loss(),
                               cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=self.device)
        self._init_fleet()

    def _params_for(self, runner_i: int):
        return self.learner.get_params()

    def training_step(self) -> Dict[str, Any]:
        metrics_list: List[Dict] = []
        consumed = 0
        for batch in self._consume_round("IMPALA"):
            consumed += len(batch["rewards"])
            metrics_list.append(self.learner.update_minibatch(batch))
        if not metrics_list:
            return {"env_steps_this_iter": 0,
                    **self.collect_episode_stats()}
        out = mean_metrics(metrics_list)
        out["env_steps_this_iter"] = consumed
        out.update(self.collect_episode_stats())
        return out


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=IMPALA, **kwargs)
        self.num_env_runners = 2
