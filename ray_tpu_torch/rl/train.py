"""Training and evaluation entry points of the RL stack (port of
``ray_tpu/rl/train.py``, JAX's ``rt rl train`` / ``rt rl evaluate``).

Reference analogs: ``rllib/train.py``, ``rllib/evaluate.py`` and
``rllib/algorithms/registry.py``. The registry holds the algorithms the
port has, under JAX's names: every algorithm JAX registers (PPO, APPO,
IMPALA, A2C, PG, MAML, MBMPO, DQN, APEXDQN, APEXDDPG, SIMPLEQ, SAC, DDPG,
TD3, BC, MARWIL, CQL, CRR, DT, ES, ARS, QMIX, MADDPG, SLATEQ, DREAMERV3,
ALPHAZERO, LEELACHESSZERO, R2D2, BANDITLINUCB, BANDITLINTS); the bundled
tuned examples are JAX's. The checkpoint directory stores the pickled
``AlgorithmConfig`` next to the Trainable payload so ``run_evaluate`` can
rebuild the algorithm without re-specifying flags. Every entry point runs
on ``cuda`` unless given ``device``. PyYAML is imported only where a YAML
file is read.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch._device import DeviceLike


def algorithm_registry() -> Dict[str, type]:
    """name -> AlgorithmConfig class for every algorithm (JAX's keys)."""
    from ray_tpu_torch import rl

    return {
        "PPO": rl.PPOConfig, "APPO": rl.APPOConfig,
        "IMPALA": rl.IMPALAConfig, "A2C": rl.A2CConfig,
        "PG": rl.PGConfig,
        "DQN": rl.DQNConfig, "APEXDQN": rl.ApexDQNConfig,
        "APEXDDPG": rl.ApexDDPGConfig,
        "SIMPLEQ": rl.SimpleQConfig,
        "SAC": rl.SACConfig,
        "DDPG": rl.DDPGConfig, "TD3": rl.TD3Config,
        "BC": rl.BCConfig, "MARWIL": rl.MARWILConfig,
        "CQL": rl.CQLConfig, "CRR": rl.CRRConfig,
        "R2D2": rl.R2D2Config,
        "MAML": rl.MAMLConfig, "MBMPO": rl.MBMPOConfig,
        "DT": rl.DTConfig, "ES": rl.ESConfig, "ARS": rl.ARSConfig,
        "QMIX": rl.QMIXConfig, "MADDPG": rl.MADDPGConfig,
        "SLATEQ": rl.SlateQConfig, "DREAMERV3": rl.DreamerV3Config,
        "ALPHAZERO": rl.AlphaZeroConfig,
        "LEELACHESSZERO": rl.LeelaChessZeroConfig,
        "BANDITLINUCB": rl.BanditConfig, "BANDITLINTS": rl.BanditConfig,
    }


def get_algorithm_config(run: str):
    reg = algorithm_registry()
    key = run.replace("-", "").replace("_", "").upper()
    if key not in reg:
        raise ValueError(
            f"unknown algorithm {run!r}; available: {sorted(reg)}")
    cfg = reg[key]()
    # the two bandit flavors share a config class; pick the right algo
    if key in ("BANDITLINTS", "BANDITLINUCB"):
        from ray_tpu_torch import rl

        cfg.algo_class = (rl.BanditLinTS if key == "BANDITLINTS"
                          else rl.BanditLinUCB)
    return cfg


def _load_overrides(config_json: Optional[str],
                    config_file: Optional[str]) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    if config_file:
        with open(config_file) as f:
            text = f.read()
        try:
            overrides.update(json.loads(text))
        except json.JSONDecodeError:
            import yaml

            overrides.update(yaml.safe_load(text) or {})
    if config_json:
        overrides.update(json.loads(config_json))
    return overrides


def run_train(run: str, env: Optional[str] = None,
              config_json: Optional[str] = None,
              config_file: Optional[str] = None,
              stop_iters: int = 10,
              stop_reward: Optional[float] = None,
              stop_timesteps: Optional[int] = None,
              checkpoint_dir: Optional[str] = None,
              out=sys.stdout, device: DeviceLike = None) -> Dict[str, Any]:
    """Train `run` on ``device`` until a stop criterion fires; returns the
    last result."""
    cfg = get_algorithm_config(run)
    if env:
        cfg.env = env
    overrides = _load_overrides(config_json, config_file)
    if overrides:
        cfg.update_from_dict(overrides)
    algo = cfg.build(device=device)
    result: Dict[str, Any] = {}
    try:
        for i in range(stop_iters):
            t0 = time.monotonic()
            result = algo.train()
            dt = time.monotonic() - t0
            # display metric: best-effort fallback chain
            shown = result.get("episode_return_mean",
                               result.get("mean_return",
                                          result.get("reward_mean_per_step",
                                                     float("nan"))))
            steps = result.get("env_steps_total", 0)
            print(f"iter {i + 1}/{stop_iters}  reward={shown:.2f}  "
                  f"env_steps={steps}  {dt:.1f}s", file=out, flush=True)
            # stop metric: episode-return semantics only (mean_return for
            # the population-based algos, which never report episodes) —
            # never the per-step reward, whose scale is episode-length
            # smaller and would fire a threshold meant for episode returns
            stop_metric = result.get("episode_return_mean",
                                     result.get("mean_return"))
            if stop_reward is not None and stop_metric is not None \
                    and np.isfinite(stop_metric) \
                    and stop_metric >= stop_reward:
                print(f"stop: reward {stop_metric:.2f} >= {stop_reward}",
                      file=out)
                break
            if stop_timesteps is not None and steps >= stop_timesteps:
                print(f"stop: env steps {steps} >= {stop_timesteps}",
                      file=out)
                break
        if checkpoint_dir:
            path = algo.save(checkpoint_dir)
            with open(os.path.join(checkpoint_dir, "algo_config.pkl"),
                      "wb") as f:
                pickle.dump({"run": run, "config": cfg}, f)
            print(f"checkpoint saved to {path}", file=out)
    finally:
        stop = getattr(algo, "stop", None)
        if stop:
            stop()
    return result


def tuned_examples_dir() -> str:
    """The bundled convergence configs of the ported algorithms
    (reference: ``rllib/tuned_examples/``)."""
    return os.path.join(os.path.dirname(__file__), "tuned_examples")


def load_tuned_example(name_or_path: str) -> Dict[str, Any]:
    """Load one experiment from a tuned-example YAML.

    Accepts a path or a bare name resolved against the bundled zoo
    (``cartpole-ppo`` -> ``rl/tuned_examples/cartpole-ppo.yaml``). The
    file uses the reference's format: one top-level experiment key with
    ``run`` / ``env`` / ``stop`` / ``config`` fields.
    """
    import yaml

    path = name_or_path
    if not os.path.exists(path):
        candidate = os.path.join(tuned_examples_dir(),
                                 name_or_path.replace(".yaml", "")
                                 + ".yaml")
        if os.path.exists(candidate):
            path = candidate
        else:
            raise FileNotFoundError(
                f"{name_or_path!r} is neither a file nor a bundled tuned "
                f"example; bundled: {sorted(list_tuned_examples())}")
    with open(path) as f:
        doc = yaml.safe_load(f)
    if not isinstance(doc, dict) or not doc:
        raise ValueError(f"{path}: expected one top-level experiment key")
    name, exp = next(iter(doc.items()))
    if "run" not in exp:
        raise ValueError(f"{path}: experiment {name!r} needs a 'run' key")
    return {"name": name, **exp}


def list_tuned_examples() -> list:
    d = tuned_examples_dir()
    if not os.path.isdir(d):
        return []
    return [f[:-5] for f in sorted(os.listdir(d)) if f.endswith(".yaml")]


def run_tuned_example(name_or_path: str,
                      checkpoint_dir: Optional[str] = None,
                      stop_iters: Optional[int] = None,
                      stop_reward: Optional[float] = None,
                      stop_timesteps: Optional[int] = None,
                      out=sys.stdout,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Train a bundled (or user) tuned example to its stop criteria.
    Explicit stop arguments override the YAML's ``stop`` block."""
    exp = load_tuned_example(name_or_path)
    stop = exp.get("stop") or {}
    return run_train(
        exp["run"], env=exp.get("env"),
        config_json=json.dumps(exp.get("config") or {}),
        stop_iters=int(stop_iters if stop_iters is not None
                       else stop.get("training_iteration", 100)),
        stop_reward=(stop_reward if stop_reward is not None
                     else stop.get("episode_return_mean")),
        stop_timesteps=(stop_timesteps if stop_timesteps is not None
                        else stop.get("timesteps_total")),
        checkpoint_dir=checkpoint_dir, out=out, device=device)


def run_evaluate(checkpoint_dir: str, run: Optional[str] = None,
                 episodes: int = 10, out=sys.stdout,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Roll out a trained policy and report episode returns."""
    meta_path = os.path.join(checkpoint_dir, "algo_config.pkl")
    if os.path.exists(meta_path):
        with open(meta_path, "rb") as f:
            meta = pickle.load(f)
        cfg = meta["config"]
        run = run or meta["run"]
    elif run:
        cfg = get_algorithm_config(run)
    else:
        raise ValueError(
            f"{meta_path} not found; pass --run to name the algorithm")
    algo = cfg.build(device=device)
    algo.restore(checkpoint_dir)
    try:
        eval_fn = getattr(algo, "evaluate", None)
        if eval_fn is None:
            raise ValueError(
                f"{type(algo).__name__} does not implement evaluate()")
        result = eval_fn(episodes)
        print(json.dumps(result, indent=2), file=out)
        return result
    finally:
        stop = getattr(algo, "stop", None)
        if stop:
            stop()
