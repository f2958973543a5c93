"""APPO: IMPALA's pipeline with PPO's clipped surrogate over V-trace
advantages (port of ``ray_tpu/rl/algorithms/appo.py``).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rl.algorithms.impala import IMPALA, _vtrace_terms
from ray_tpu_torch.rl.algorithms.ppo import normalize
from ray_tpu_torch.rl.config import AlgorithmConfig


def make_appo_loss(spec, cfg: AlgorithmConfig):
    clip = cfg.clip_param

    def loss_fn(params, batch, key=None):
        behavior_logp, target_logp, entropy, values, vs, pg_adv = \
            _vtrace_terms(spec, cfg, params, batch)
        adv = normalize(pg_adv)
        # PPO clip on the behavior ratio (APPO: surrogate over v-trace
        # advantages instead of IMPALA's plain pg loss)
        ratio = torch.exp(target_logp - behavior_logp)
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        pi_loss = -surr.mean()
        vf_loss = torch.mean((values - vs) ** 2)
        total = pi_loss + cfg.vf_coeff * vf_loss \
            - cfg.entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "ratio_mean": ratio.mean()}

    return loss_fn


class APPO(IMPALA):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        cfg = AlgorithmConfig(algo_class=cls)
        cfg.num_env_runners = 2
        cfg.clip_param = 0.3
        return cfg

    def make_loss(self):
        return make_appo_loss(self.spec, self.config)


class APPOConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=APPO, **kwargs)
        self.num_env_runners = 2
        self.clip_param = 0.3
