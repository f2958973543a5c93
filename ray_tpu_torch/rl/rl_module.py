"""RLModule + Catalog: the configurable model-container layer (port of
``ray_tpu/rl/rl_module.py``).

A ``ModuleSpec`` describes the architecture (encoder family, widths,
activation), the ``Catalog`` resolves it against an ``EnvSpec`` into an
initialized ``RLModule`` on a device, and custom architectures plug in via
``register_module_builder``. The trees keep ``rl/models.py``'s layout
(``pi``/``vf``/``enc``/``log_std``), so every algorithm, the EnvRunner
and the checkpoints consume catalog-built modules unchanged:
``AlgorithmConfig.module_spec`` switches an on-policy algorithm onto a
custom architecture with no other code change.

Builders take a ``torch.Generator`` where JAX's take a key; the draws
are not JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env import EnvSpec


@dataclasses.dataclass
class ModuleSpec:
    """Architecture description, resolved by the Catalog.

    ``encoder``: "auto" (mlp for flat specs, cnn for pixel specs), "mlp",
    "cnn", or a name registered via ``register_module_builder``.
    """

    encoder: str = "auto"
    hidden: Sequence[int] = (64, 64)
    activation: str = "tanh"            # "tanh" | "relu"
    encoder_out: int = 512              # cnn feature width
    free_log_std: bool = True           # continuous: global learned std
    builder_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


# name -> builder(gen, env_spec, module_spec) -> params tree
_MODULE_BUILDERS: Dict[str, Callable] = {}


def register_module_builder(name: str, builder: Callable) -> None:
    """Catalog extension hook. ``builder(gen, env_spec, module_spec)``
    draws from the ``torch.Generator`` ``gen`` on the module's device and
    must return a params tree with the standard ``pi``/``vf`` (+ ``enc`` /
    ``log_std``) layout."""
    _MODULE_BUILDERS[name] = builder


def _act_marker(activation: str, device: torch.device) -> torch.Tensor:
    if activation == "tanh":
        return torch.zeros(0, device=device)
    if activation == "relu":
        return torch.zeros(1, device=device)
    raise ValueError(f"unknown activation {activation!r} "
                     "(expected 'tanh' or 'relu')")


def _check_log_std(spec: EnvSpec, ms: ModuleSpec) -> None:
    if not spec.discrete and not ms.free_log_std:
        raise ValueError(
            "continuous-action modules require free_log_std=True (the "
            "losses and exploration paths read params['log_std']; a "
            "state-dependent std head is not supported)")


def _log_std(spec: EnvSpec, device: torch.device) -> torch.Tensor:
    return torch.zeros(spec.action_dim, dtype=torch.float32, device=device)


def _build_mlp_module(gen: torch.Generator, spec: EnvSpec,
                      ms: ModuleSpec) -> Dict:
    _check_log_std(spec, ms)
    out = spec.num_actions if spec.discrete else spec.action_dim
    marker = _act_marker(ms.activation, gen.device)
    pi = models.init_mlp(gen, [spec.obs_dim, *ms.hidden, out])
    vf = models.init_mlp(gen, [spec.obs_dim, *ms.hidden, 1], out_scale=1.0)
    if marker.shape[0]:
        pi["act"] = marker
        vf["act"] = marker.clone()
    params = {"pi": pi, "vf": vf}
    if not spec.discrete:
        params["log_std"] = _log_std(spec, gen.device)
    return params


def _build_cnn_module(gen: torch.Generator, spec: EnvSpec,
                      ms: ModuleSpec) -> Dict:
    if not spec.is_pixel:
        raise ValueError("cnn encoder needs a pixel EnvSpec (obs_shape "
                         "of rank 3)")
    _check_log_std(spec, ms)
    out = spec.num_actions if spec.discrete else spec.action_dim
    feat = ms.encoder_out
    params = {
        "enc": models.init_cnn(gen, spec.obs_shape, feat),
        "pi": models.init_mlp(gen, [feat, out]),
        "vf": models.init_mlp(gen, [feat, 1], out_scale=1.0),
    }
    if not spec.discrete:
        params["log_std"] = _log_std(spec, gen.device)
    return params


_MODULE_BUILDERS["mlp"] = _build_mlp_module
_MODULE_BUILDERS["cnn"] = _build_cnn_module


def _first_leaf(params) -> torch.Tensor:
    return next(iter(models._leaves(params).values()))


class RLModule:
    """Params + the three forward contracts of the reference RLModule:

    - ``forward_inference``: greedy/deterministic actions
    - ``forward_exploration``: stochastic actions + logp
    - ``forward_train``: logits/values for the learner loss

    The params' device is the module's: observations are moved there, and
    the inference and exploration results come back as numpy arrays.
    """

    def __init__(self, params: Dict, env_spec: EnvSpec,
                 module_spec: Optional[ModuleSpec] = None):
        self.params = params
        self.env_spec = env_spec
        self.module_spec = module_spec or ModuleSpec()
        self.device = _first_leaf(params).device

    def _obs(self, obs) -> torch.Tensor:
        return torch.as_tensor(obs, dtype=torch.float32, device=self.device)

    def forward_train(self, obs) -> Dict[str, torch.Tensor]:
        obs = self._obs(obs)
        return {"action_logits": models.policy_logits(self.params, obs),
                "values": models.value(self.params, obs)}

    @torch.no_grad()
    def forward_inference(self, obs) -> np.ndarray:
        spec = self.env_spec
        logits = models.policy_logits(self.params, self._obs(obs))
        if spec.discrete:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        return torch.clamp(logits, spec.action_low,
                           spec.action_high).cpu().numpy()

    @torch.no_grad()
    def forward_exploration(self, obs, key: torch.Generator):
        """Sampled actions and their logp; ``key`` is the generator the
        draws come from (on the module's device)."""
        spec, p = self.env_spec, self.params
        logits = models.policy_logits(p, self._obs(obs))
        if spec.discrete:
            acts = models.categorical_sample(key, logits)
            logp = models.categorical_logp(logits, acts)
        else:
            acts = models.gaussian_sample(key, logits, p["log_std"])
            logp = models.gaussian_logp(logits, p["log_std"], acts)
            acts = torch.clamp(acts, spec.action_low, spec.action_high)
        return acts.cpu().numpy(), logp.cpu().numpy()

    # -- state ------------------------------------------------------------

    def get_state(self) -> Dict:
        return params_to_numpy(self.params)

    def set_state(self, state: Dict) -> None:
        self.params = models.params_to_device(state, self.device)

    def num_params(self) -> int:
        return models.num_params(self.params)


class Catalog:
    """Resolves (EnvSpec, ModuleSpec) -> initialized RLModule."""

    @staticmethod
    def build(env_spec: EnvSpec,
              module_spec: Optional[ModuleSpec] = None,
              seed: int = 0, device: DeviceLike = None) -> RLModule:
        """The module on ``device`` (``cuda`` unless given), its params
        drawn from a generator seeded with ``seed``."""
        device = resolve_device(device)
        ms = module_spec or ModuleSpec()
        name = ms.encoder
        if name == "auto":
            name = "cnn" if env_spec.is_pixel else "mlp"
        if name not in _MODULE_BUILDERS:
            raise ValueError(
                f"unknown module builder {name!r}; registered: "
                f"{sorted(_MODULE_BUILDERS)}")
        gen = torch.Generator(device=device).manual_seed(seed)
        params = _MODULE_BUILDERS[name](gen, env_spec, ms)
        return RLModule(params, env_spec, ms)

    @staticmethod
    def build_params(env_spec: EnvSpec,
                     module_spec: Optional[ModuleSpec] = None,
                     seed: int = 0, device: DeviceLike = None) -> Dict:
        """Just the initialized param tree (what ``Algorithm`` feeds its
        Learner when ``config.module_spec`` is set)."""
        return Catalog.build(env_spec, module_spec, seed, device).params


class MultiAgentRLModule:
    """Policy-id -> RLModule container (reference ``marl_module.py``)."""

    def __init__(self, modules: Dict[str, RLModule]):
        self._modules = dict(modules)

    def __getitem__(self, policy_id: str) -> RLModule:
        return self._modules[policy_id]

    def __contains__(self, policy_id: str) -> bool:
        return policy_id in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def get_state(self) -> Dict[str, Dict]:
        return {pid: m.get_state() for pid, m in self._modules.items()}

    def set_state(self, state: Dict[str, Dict]) -> None:
        for pid, s in state.items():
            self._modules[pid].set_state(s)

    @staticmethod
    def build(env_specs: Dict[str, EnvSpec],
              module_specs: Optional[Dict[str, ModuleSpec]] = None,
              seed: int = 0, device: DeviceLike = None
              ) -> "MultiAgentRLModule":
        module_specs = module_specs or {}
        return MultiAgentRLModule({
            pid: Catalog.build(es, module_specs.get(pid), seed + i, device)
            for i, (pid, es) in enumerate(sorted(env_specs.items()))})
