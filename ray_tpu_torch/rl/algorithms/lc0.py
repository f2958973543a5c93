"""LeelaChessZero: AlphaZero scaled out — a self-play fleet +
prioritized replay (port of ``ray_tpu/rl/algorithms/lc0.py``).

Reference analog: ``rllib/algorithms/leela_chess_zero/leela_chess_zero.py``
(an AlphaZero variant for two-player zero-sum games at chess scale). What
distinguishes the reference's LC0 from its alpha_zero — and what this
module adds over ``alphazero.py``:

1. **A self-play fleet** — games are generated by ``SelfPlayWorker``s,
   each with its own generator, running MCTS under the latest params
   (the reference runs self-play on its rollout workers), instead of the
   trainable's own loop.
2. **Prioritized replay over positions** — samples enter a proportional
   sum-tree buffer and are drawn by |v(obs) - z| priority with
   importance weights (the reference trains LC0 from a
   ``PrioritizedReplayBuffer``; alpha_zero uses a plain one).
3. **A bigger bundled game** — ConnectFour (6x7, branching 7, games to
   ~42 plies). Chess itself needs an external move-generator package
   (not a dependency, and the reference leans on PettingZoo for it);
   ConnectFour exercises the identical machinery at a depth TicTacToe
   cannot (the convergence gate needs real search, not memorization).

The MCTS, ``Game`` protocol, and self-play loop are shared with
``alphazero.py`` (``play_selfplay_game``).

JAX's self-play workers are actors, seeded ``seed + 97 * i``; so are
the port's where its runtime is initialized (a ``rl/fleet.py:Fleet``:
each gets the learner's params as host tensors and predicts on the CPU),
else they are plain objects in one process reading the learner's tensors
(nothing is copied). Each plays its share of the games under those
params, and the results are taken in submission order, as JAX's
``ray_tpu.get`` of the list takes them, so an iteration is the same
either way. The importance-weighted loss returns the per-sample
``|v - z|``, read to the host once per update for the priority refresh.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithms.alphazero import (
    GAMES,
    AlphaZero,
    Game,
    make_game,
    play_selfplay_game,
    predict_on,
)
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.fleet import Fleet
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer

_C4_ROWS, _C4_COLS = 6, 7


class ConnectFour(Game):
    """State: (board tuple of 42 in {0, +1, -1} row-major bottom-up,
    player). Drop a piece in a column; four-in-a-row wins."""

    num_actions = _C4_COLS
    obs_dim = 2 * _C4_ROWS * _C4_COLS

    def initial_state(self):
        return ((0,) * (_C4_ROWS * _C4_COLS), 1)

    def legal_actions(self, state) -> np.ndarray:
        board, _ = state
        top = board[(_C4_ROWS - 1) * _C4_COLS:]
        return np.array([c == 0 for c in top], dtype=bool)

    def next_state(self, state, action: int):
        board, player = state
        nb = list(board)
        for r in range(_C4_ROWS):
            i = r * _C4_COLS + action
            if nb[i] == 0:
                nb[i] = player
                return (tuple(nb), -player)
        raise ValueError(f"column {action} full")

    @staticmethod
    def _won_scan(board, sign: int) -> bool:
        g = [[board[r * _C4_COLS + c] for c in range(_C4_COLS)]
             for r in range(_C4_ROWS)]
        for r in range(_C4_ROWS):
            for c in range(_C4_COLS):
                if g[r][c] != sign:
                    continue
                for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
                    rr, cc, n = r, c, 0
                    while (0 <= rr < _C4_ROWS and 0 <= cc < _C4_COLS
                           and g[rr][cc] == sign):
                        n += 1
                        if n == 4:
                            return True
                        rr += dr
                        cc += dc
        return False

    def terminal_value(self, state):
        board, player = state
        # only the side that just moved (-player) can have completed a line
        if self._won_scan(board, -player):
            return -1.0  # player to move has lost
        if all(c != 0 for c in board):
            return 0.0
        return None

    def encode(self, state) -> np.ndarray:
        board, player = state
        arr = np.asarray(board, dtype=np.float32)
        own = (arr == player).astype(np.float32)
        opp = (arr == -player).astype(np.float32)
        return np.concatenate([own, opp])


GAMES["connect4"] = ConnectFour


class SelfPlayWorker:
    """Self-play generator: MCTS per move under the params last set
    (reference: LC0 self-play on rollout workers)."""

    def __init__(self, game_name: str, mcts_cfg: Dict[str, Any], seed: int,
                 device):
        self.game = make_game(game_name)
        self.cfg = mcts_cfg
        self.rng = np.random.default_rng(seed)
        self.device = device
        self._params = None

    def set_params(self, params) -> None:
        self._params = params

    def play(self, n_games: int
             ) -> Tuple[Dict[str, np.ndarray], int, List[float]]:
        params, device = self._params, self.device

        def predict(obs: np.ndarray):
            return predict_on(params, obs, device)

        obs_l, pi_l, z_l, outcomes, moves = [], [], [], [], 0
        for _ in range(n_games):
            examples, m = play_selfplay_game(
                self.game, predict, rng=self.rng, **self.cfg)
            moves += m
            outcomes.append(examples[-1][2])  # first position's z
            for o, p, z in examples:
                obs_l.append(o)
                pi_l.append(p)
                z_l.append(z)
        batch = {"obs": np.stack(obs_l), "pi": np.stack(pi_l),
                 "z": np.asarray(z_l, dtype=np.float32)}
        return batch, moves, outcomes


class LeelaChessZeroConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=LeelaChessZero, **kwargs)
        self.env = "connect4"
        self.lr = 5e-3
        self.hidden = (128, 128)
        self.num_workers = 2          # self-play workers
        self.games_per_iter = 8       # split across the fleet
        self.num_simulations = 48
        self.c_puct = 1.5
        self.dirichlet_alpha = 0.8
        self.root_noise_eps = 0.25
        self.temperature_moves = 6
        self.buffer_size = 16_384
        self.minibatch_size = 256
        self.updates_per_iter = 16
        self.replay_alpha = 0.6
        self.replay_beta = 0.4
        self.vf_coeff = 1.0


def make_lc0_loss(vf_coeff: float):
    """AlphaZero's loss with per-sample importance ``weights`` (ones where
    the batch has none) and the per-sample ``verr`` = |v - z| as a
    metric, outside the gradient."""
    def loss_fn(p, batch, gen=None):
        logits = models.mlp_forward(p["pi"], batch["obs"])
        logp = torch.log_softmax(logits, dim=-1)
        w = batch.get("weights")
        if w is None:
            w = torch.ones_like(batch["z"])
        pi_loss = -torch.mean(w * torch.sum(batch["pi"] * logp, dim=-1))
        v = torch.tanh(models.mlp_forward(p["v"], batch["obs"])[..., 0])
        verr = v - batch["z"]
        v_loss = torch.mean(w * verr ** 2)
        return pi_loss + vf_coeff * v_loss, \
            {"pi_loss": pi_loss, "v_loss": v_loss,
             "verr": torch.abs(verr).detach()}

    return loss_fn


class LeelaChessZero(AlphaZero):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return LeelaChessZeroConfig()

    def setup(self, config: Dict[str, Any]) -> None:
        self.config = self.config_from(config)
        super().setup({"__algo_config": self.config})
        cfg = self.config
        # swap the list buffer for the prioritized tree
        self.buffer = PrioritizedReplayBuffer(
            cfg.buffer_size, alpha=cfg.replay_alpha, beta=cfg.replay_beta,
            seed=cfg.seed)
        # re-derive the learner with an importance-weighted loss that also
        # emits the per-sample |v - z| the priority refresh needs
        self.learner = Learner(self.learner.get_params(),
                               make_lc0_loss(cfg.vf_coeff), cfg.lr,
                               grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=self.device)
        mcts_cfg = dict(num_simulations=cfg.num_simulations,
                        c_puct=cfg.c_puct,
                        dirichlet_alpha=cfg.dirichlet_alpha,
                        root_noise_eps=cfg.root_noise_eps,
                        temperature_moves=cfg.temperature_moves)
        game_name = cfg.env if isinstance(cfg.env, str) else "connect4"
        self.worker_fleet = Fleet(SelfPlayWorker, [
            dict(game_name=game_name, mcts_cfg=mcts_cfg,
                 seed=cfg.seed + 97 * i)
            for i in range(max(1, cfg.num_workers))], self.device)

    @property
    def workers(self) -> List:
        return self.worker_fleet.members

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        fleet = self.worker_fleet
        n = len(fleet)
        fleet.gather("set_params",
                     [(fleet.put(self.learner.get_params()),)] * n)
        per = max(1, cfg.games_per_iter // n)
        results = fleet.gather("play", [(per,)] * n)
        outcomes: List[float] = []
        for batch, moves, outs in results:
            self.buffer.add_batch(batch)
            self._env_steps_total += moves
            outcomes.extend(outs)
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_iter):
            mb, idx, weights = self.buffer.sample(
                min(cfg.minibatch_size, len(self.buffer)))
            mb = dict(mb, weights=weights)
            metrics = self.learner.update_minibatch(mb)
            self.buffer.update_priorities(idx,
                                          metrics["verr"].cpu().numpy())
        scalars = [k for k, v in metrics.items() if v.dim() == 0]
        metrics = dict(zip(scalars, torch.stack(
            [metrics[k].float() for k in scalars]).double().tolist()))
        metrics["buffer_size"] = len(self.buffer)
        metrics["draw_rate"] = float(np.mean(np.asarray(outcomes) == 0.0))
        metrics["env_steps_total"] = self._env_steps_total
        return metrics

    def cleanup(self) -> None:
        self.worker_fleet.kill()

    def stop(self) -> None:
        """Alias matching the Algorithm surface (tests/CLI call stop())."""
        self.cleanup()
