"""Pixel-observation envs: the Atari-class path (the port's own numpy
copy of ``ray_tpu/rl/pixel_env.py``; with the same seed and actions both
packages step bit for bit alike).

Reference analog: RLlib's Atari stack — gym's ``AtariPreprocessing``
(grayscale, resize, frame-skip) + ``FrameStack`` wrappers feeding a Nature
CNN (``rllib/models``' default vision net), exercised by
``rllib/tuned_examples/ppo/atari-ppo.yaml``. ALE is not a dependency,
so the capability ships in four pieces:

- :class:`PixelWrapper` — frame-skip (max-pooled), grayscale, area resize,
  [0,1] scaling over ANY pixel :class:`VectorEnv`;
- :class:`FrameStack` — channel-stacked history;
- :class:`CatchPixels` — a vectorized synthetic pixel control task (a
  falling ball must be caught by a 3px paddle) that trains a conv policy
  end-to-end in CI the way CartPole stands in for control tasks;
- :func:`gym_vector_env` — an adapter that wraps ``gymnasium`` vector envs
  (incl. real Atari) when the package is installed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rl.env import EnvSpec, VectorEnv, register_env


class CatchPixels(VectorEnv):
    """N independent games of catch on an (H, W, 1) board.

    A ball falls one row per step from a random column; the bottom-row
    paddle (3px wide) moves left/stay/right. Reward +1 on catch, -1 on
    miss, episode ends when the ball reaches the bottom. Solvable to
    ~+1.0 mean return quickly — the CI stand-in for pixel control.
    """

    def __init__(self, num_envs: int, seed: int = 0, size: int = 16):
        self.num_envs = num_envs
        self._size = size
        self._rng = np.random.default_rng(seed)
        self.spec = EnvSpec(num_actions=3, obs_shape=(size, size, 1))
        self._ball_r = np.zeros(num_envs, dtype=np.int64)
        self._ball_c = np.zeros(num_envs, dtype=np.int64)
        self._paddle = np.zeros(num_envs, dtype=np.int64)

    def _reset_envs(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if n:
            self._ball_r[mask] = 0
            self._ball_c[mask] = self._rng.integers(0, self._size, size=n)
            self._paddle[mask] = self._rng.integers(
                1, self._size - 1, size=n)

    def _obs(self) -> np.ndarray:
        s = self._size
        obs = np.zeros((self.num_envs, s, s, 1), dtype=np.float32)
        idx = np.arange(self.num_envs)
        obs[idx, self._ball_r, self._ball_c, 0] = 1.0
        for d in (-1, 0, 1):
            cols = np.clip(self._paddle + d, 0, s - 1)
            obs[idx, s - 1, cols, 0] = 0.5
        return obs

    def reset(self) -> np.ndarray:
        self._reset_envs(np.ones(self.num_envs, dtype=bool))
        return self._obs()

    def step(self, actions: np.ndarray):
        a = np.asarray(actions).reshape(self.num_envs)
        self._paddle = np.clip(self._paddle + (a - 1), 1, self._size - 2)
        self._ball_r = self._ball_r + 1
        dones = self._ball_r >= self._size - 1
        caught = dones & (np.abs(self._ball_c - self._paddle) <= 1)
        rewards = np.where(dones, np.where(caught, 1.0, -1.0), 0.0
                           ).astype(np.float32)
        self._reset_envs(dones)
        return self._obs(), rewards, dones


class PixelWrapper(VectorEnv):
    """Atari-style preprocessing over any pixel VectorEnv: frame-skip with
    2-frame max-pool (flicker removal), grayscale, integer-factor area
    resize, float32 [0, 1] scaling."""

    def __init__(self, env: VectorEnv, frame_skip: int = 1,
                 grayscale: bool = True, resize_factor: int = 1):
        assert env.spec.is_pixel, "PixelWrapper needs a pixel env"
        self._env = env
        self.num_envs = env.num_envs
        self._skip = max(1, frame_skip)
        self._gray = grayscale
        self._factor = max(1, resize_factor)
        h, w, c = env.spec.obs_shape
        if h % self._factor or w % self._factor:
            raise ValueError(f"resize_factor {self._factor} must divide "
                             f"{(h, w)}")
        if grayscale and c not in (1, 3):
            raise ValueError(
                f"grayscale needs 1- or 3-channel frames, got C={c} "
                "(wrap BEFORE frame-stacking)")
        out = (h // self._factor, w // self._factor,
               1 if grayscale else c)
        self.spec = EnvSpec(num_actions=env.spec.num_actions,
                            action_dim=env.spec.action_dim,
                            action_low=env.spec.action_low,
                            action_high=env.spec.action_high,
                            obs_shape=out)

    def _transform(self, obs: np.ndarray) -> np.ndarray:
        raw = np.asarray(obs)
        x = raw.astype(np.float32)
        # scale by DTYPE, not value range: an all-dark uint8 batch must
        # land on the same scale as a bright one
        if raw.dtype == np.uint8:
            x = x / 255.0
        if self._gray and x.shape[-1] == 3:
            x = (x * np.array([0.299, 0.587, 0.114],
                              dtype=np.float32)).sum(-1, keepdims=True)
        f = self._factor
        if f > 1:
            n, h, w, c = x.shape
            x = x.reshape(n, h // f, f, w // f, f, c).mean((2, 4))
        return x

    def reset(self) -> np.ndarray:
        return self._transform(self._env.reset())

    def step(self, actions: np.ndarray):
        total = None
        prev = frame = None
        done_any = None
        dones = None
        for i in range(self._skip):
            frame, rewards, dones = self._env.step(actions)
            total = rewards if total is None else total + rewards
            done_any = dones if done_any is None else (done_any | dones)
            if i == self._skip - 2:
                prev = frame
            if dones.any():
                break  # env auto-resets; don't skip across the boundary
        if prev is not None:
            # flicker max-pool — but NOT across an auto-reset boundary:
            # done rows' `frame` is the NEXT episode's first obs, and
            # blending the dead episode's pixels into it would corrupt the
            # new episode's (and FrameStack's seeded) first observation
            pooled = np.maximum(frame, prev)
            frame = np.where(dones[:, None, None, None], frame, pooled)
        return self._transform(frame), total, done_any


class FrameStack(VectorEnv):
    """Channel-stacks the last k frames (the temporal context a
    feed-forward conv policy needs for velocity)."""

    def __init__(self, env: VectorEnv, k: int = 4):
        assert env.spec.is_pixel, "FrameStack needs a pixel env"
        self._env = env
        self._k = k
        self.num_envs = env.num_envs
        h, w, c = env.spec.obs_shape
        self.spec = EnvSpec(num_actions=env.spec.num_actions,
                            action_dim=env.spec.action_dim,
                            action_low=env.spec.action_low,
                            action_high=env.spec.action_high,
                            obs_shape=(h, w, c * k))
        self._frames: Optional[np.ndarray] = None

    def reset(self) -> np.ndarray:
        first = self._env.reset()
        # frame-major layout [f0|f1|...]: concatenate, NOT np.repeat —
        # repeat interleaves channels ([r,r,g,g,b,b]) which step()'s
        # oldest-frame slice would then scramble for C > 1
        self._frames = np.concatenate([first] * self._k, axis=-1)
        return self._frames.copy()

    def step(self, actions: np.ndarray):
        obs, rewards, dones = self._env.step(actions)
        c = obs.shape[-1]
        self._frames = np.concatenate([self._frames[..., c:], obs], axis=-1)
        if dones.any():
            # reset rows restart their stack from the post-reset frame
            self._frames[dones] = np.concatenate(
                [obs[dones]] * self._k, axis=-1)
        return self._frames.copy(), rewards, dones


def gym_vector_env(env_id: str, num_envs: int, seed: int = 0,
                   **kwargs) -> VectorEnv:
    """Wrap a gymnasium vector env (incl. real Atari via ale_py) into the
    VectorEnv protocol. Raises ``ImportError`` where gymnasium is not
    installed."""
    try:
        import gymnasium as gym
    except ImportError as e:  # pragma: no cover — needs gymnasium
        raise ImportError(
            "gym_vector_env requires gymnasium (pip install "
            "'gymnasium[atari]')") from e

    venv = gym.make_vec(env_id, num_envs=num_envs, **kwargs)

    class _GymAdapter(VectorEnv):  # pragma: no cover — needs gymnasium
        def __init__(self):
            self.num_envs = num_envs
            space = venv.single_observation_space
            act = venv.single_action_space
            if hasattr(act, "n"):
                spec = EnvSpec(num_actions=int(act.n))
            else:
                spec = EnvSpec(action_dim=int(np.prod(act.shape)),
                               action_low=float(np.min(act.low)),
                               action_high=float(np.max(act.high)))
            if len(space.shape) == 3:
                spec.obs_shape = tuple(space.shape)
            else:
                spec.obs_dim = int(np.prod(space.shape))
            self.spec = spec
            self._seeded = False

        def reset(self):
            obs, _ = venv.reset(seed=seed if not self._seeded else None)
            self._seeded = True
            return np.asarray(obs, dtype=np.float32)

        def step(self, actions):
            obs, rew, term, trunc, _ = venv.step(np.asarray(actions))
            return (np.asarray(obs, dtype=np.float32),
                    np.asarray(rew, dtype=np.float32),
                    np.asarray(term) | np.asarray(trunc))

    return _GymAdapter()


def _make_catch(config: Dict) -> VectorEnv:
    env = CatchPixels(config["num_envs"], seed=config.get("seed", 0),
                      size=config.get("size", 16))
    k = config.get("frame_stack", 0)
    return FrameStack(env, k) if k else env


register_env("CatchPixels-v0", _make_catch)
