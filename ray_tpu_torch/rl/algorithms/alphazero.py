"""AlphaZero: self-play MCTS + policy/value network for two-player games
(port of ``ray_tpu/rl/algorithms/alphazero.py``).

Reference analog: ``rllib/algorithms/alpha_zero/`` (Silver et al. 2017).
Components: a pluggable perfect-information ``Game`` protocol, PUCT MCTS
guided by network priors with Dirichlet root noise, self-play data
generation (MCTS visit counts become policy targets; the game outcome
becomes the value target), and a policy+value training step through the
shared ``Learner`` on the algorithm's device.

The bundled game is TicTacToe — small enough that the convergence test
runs on CPU in seconds, while the MCTS/self-play machinery is exactly the
scaled game's. States are hashable; search trees are per-move dicts (the
tree is discarded between moves, as in the reference's single-player MCTS).

The games, ``MCTS`` and ``play_selfplay_game`` are numpy on the host and
copied from JAX's line for line: given the same ``predict`` and the same
``np.random.Generator`` they make the same trees, draws and games. The
network's ``predict`` is one device forward of ``{pi, v}`` and one host
read per simulation, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import DeviceTrainable
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner


class Game:
    """Two-player zero-sum perfect-information game protocol. States are
    hashable values seen from an absolute perspective; ``encode`` renders
    the state from the side-to-move's perspective."""

    num_actions: int
    obs_dim: int

    def initial_state(self):
        raise NotImplementedError

    def legal_actions(self, state) -> np.ndarray:  # bool [num_actions]
        raise NotImplementedError

    def next_state(self, state, action: int):
        raise NotImplementedError

    def terminal_value(self, state) -> Optional[float]:
        """Value for the player to move (+1 win, -1 loss, 0 draw), or
        None if the game continues."""
        raise NotImplementedError

    def encode(self, state) -> np.ndarray:
        raise NotImplementedError


_WIN_LINES = ((0, 1, 2), (3, 4, 5), (6, 7, 8),
              (0, 3, 6), (1, 4, 7), (2, 5, 8),
              (0, 4, 8), (2, 4, 6))


class TicTacToe(Game):
    """State: (board 9-tuple of {0, +1, -1}, player {+1, -1})."""

    num_actions = 9
    obs_dim = 18  # own-pieces plane ++ opponent plane

    def initial_state(self):
        return ((0,) * 9, 1)

    def legal_actions(self, state) -> np.ndarray:
        board, _ = state
        return np.array([c == 0 for c in board], dtype=bool)

    def next_state(self, state, action: int):
        board, player = state
        assert board[action] == 0
        nb = list(board)
        nb[action] = player
        return (tuple(nb), -player)

    def terminal_value(self, state) -> Optional[float]:
        board, player = state
        for a, b, c in _WIN_LINES:
            s = board[a] + board[b] + board[c]
            if s == 3 or s == -3:
                # the winner just moved; the player to move has lost
                return -1.0
            # (winner's sign is irrelevant: a full line belongs to the
            # player who completed it, who is never the one to move)
        if all(c != 0 for c in board):
            return 0.0
        return None

    def encode(self, state) -> np.ndarray:
        board, player = state
        arr = np.asarray(board, dtype=np.float32)
        own = (arr == player).astype(np.float32)
        opp = (arr == -player).astype(np.float32)
        return np.concatenate([own, opp])


class MCTS:
    """PUCT search over one root. Q/N/P tables are keyed by state; values
    are always from the perspective of the player to move at that state."""

    def __init__(self, game: Game, predict, c_puct: float = 1.5,
                 dirichlet_alpha: float = 0.5, noise_eps: float = 0.25,
                 rng: Optional[np.random.Generator] = None):
        self.game = game
        self.predict = predict  # encoded obs -> (priors [A], value)
        self.c_puct = c_puct
        self.alpha = dirichlet_alpha
        self.eps = noise_eps
        self.rng = rng or np.random.default_rng(0)
        self._P: Dict[Any, np.ndarray] = {}
        self._N: Dict[Any, np.ndarray] = {}
        self._W: Dict[Any, np.ndarray] = {}

    def _expand(self, state) -> float:
        priors, value = self.predict(self.game.encode(state))
        legal = self.game.legal_actions(state)
        priors = np.where(legal, priors, 0.0)
        total = priors.sum()
        priors = (priors / total if total > 0
                  else legal / max(1, legal.sum()))
        self._P[state] = priors
        self._N[state] = np.zeros(self.game.num_actions)
        self._W[state] = np.zeros(self.game.num_actions)
        return float(value)

    def _simulate(self, state) -> float:
        """Returns the value of `state` for its player to move."""
        tv = self.game.terminal_value(state)
        if tv is not None:
            return tv
        if state not in self._P:
            return self._expand(state)
        n, w, p = self._N[state], self._W[state], self._P[state]
        legal = self.game.legal_actions(state)
        q = np.divide(w, n, out=np.zeros_like(w), where=n > 0)
        u = self.c_puct * p * math.sqrt(max(1.0, n.sum())) / (1.0 + n)
        score = np.where(legal, q + u, -np.inf)
        a = int(np.argmax(score))
        child = self.game.next_state(state, a)
        # child value is for the opponent; negate for our perspective
        v = -self._simulate(child)
        n[a] += 1
        w[a] += v
        return v

    def search(self, state, num_simulations: int,
               root_noise: bool = True) -> np.ndarray:
        if state not in self._P:
            self._expand(state)
        if root_noise and self.eps > 0:
            legal = self.game.legal_actions(state)
            k = int(legal.sum())
            noise = np.zeros(self.game.num_actions)
            noise[legal] = self.rng.dirichlet([self.alpha] * k)
            self._P[state] = ((1 - self.eps) * self._P[state]
                              + self.eps * noise)
        for _ in range(num_simulations):
            self._simulate(state)
        return self._N[state].copy()


def play_selfplay_game(game: Game, predict, *, num_simulations: int,
                       c_puct: float, dirichlet_alpha: float,
                       root_noise_eps: float, temperature_moves: int,
                       rng: np.random.Generator
                       ) -> Tuple[List[Tuple[np.ndarray, np.ndarray, float]],
                                  int]:
    """One self-play game -> ([(obs, pi, z)], moves). Shared by the local
    AlphaZero loop and LeelaChessZero's remote self-play workers."""
    state = game.initial_state()
    history: List[Tuple[np.ndarray, np.ndarray]] = []
    move = 0
    while True:
        tv = game.terminal_value(state)
        if tv is not None:
            # tv is for the player to move at the terminal state; walk
            # back alternating signs
            examples = []
            z = tv
            for obs, pi in reversed(history):
                z = -z
                examples.append((obs, pi, z))
            return examples, move
        # fresh tree per move: visit counts from earlier searches ran
        # under that root's Dirichlet noise and must not leak into this
        # move's policy target
        mcts = MCTS(game, predict, c_puct, dirichlet_alpha,
                    root_noise_eps, rng)
        visits = mcts.search(state, num_simulations)
        pi = visits / visits.sum()
        if move < temperature_moves:
            a = int(rng.choice(len(pi), p=pi))
        else:
            a = int(np.argmax(visits))
        history.append((game.encode(state), pi))
        state = game.next_state(state, a)
        move += 1


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self, **kwargs):
        super().__init__(algo_class=AlphaZero, **kwargs)
        self.env = "tictactoe"
        self.lr = 5e-3
        self.num_simulations = 32
        self.games_per_iter = 16
        self.c_puct = 1.5
        self.dirichlet_alpha = 0.5
        self.root_noise_eps = 0.25
        self.temperature_moves = 2   # sample ~ N^(1/T) for the first moves
        self.buffer_size = 4_096
        self.minibatch_size = 128
        self.num_epochs = 2
        self.vf_coeff = 1.0


GAMES = {"tictactoe": TicTacToe}  # lc0.py registers connect4


def make_game(name_or_game) -> Game:
    if isinstance(name_or_game, Game):
        return name_or_game
    if name_or_game in GAMES:
        return GAMES[name_or_game]()
    raise ValueError(f"unknown game {name_or_game!r}")


def make_alphazero_loss(vf_coeff: float):
    """``loss_fn(params, batch, gen)`` over ``{pi, v}``: cross-entropy to
    the visit distribution plus ``vf_coeff`` times the squared error of
    ``tanh(v)`` to the outcome."""
    def loss_fn(p, batch, gen=None):
        logits = models.mlp_forward(p["pi"], batch["obs"])
        logp = torch.log_softmax(logits, dim=-1)
        pi_loss = -torch.mean(torch.sum(batch["pi"] * logp, dim=-1))
        v = torch.tanh(models.mlp_forward(p["v"], batch["obs"])[..., 0])
        v_loss = torch.mean((v - batch["z"]) ** 2)
        return pi_loss + vf_coeff * v_loss, \
            {"pi_loss": pi_loss, "v_loss": v_loss}

    return loss_fn


@torch.no_grad()
def predict_on(params, obs: np.ndarray, device) -> Tuple[np.ndarray, float]:
    """(priors [A], value) of one encoded state: one forward of ``{pi,
    v}`` on ``device`` and one host read."""
    x = torch.as_tensor(obs[None], device=device)
    pri = torch.softmax(models.mlp_forward(params["pi"], x), dim=-1)
    val = torch.tanh(models.mlp_forward(params["v"], x)[..., 0])
    out = torch.cat([pri, val[:, None]], dim=-1)[0].cpu().numpy()
    return out[:-1], float(out[-1])


class AlphaZero(DeviceTrainable):
    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return AlphaZeroConfig()

    def setup(self, config: Dict[str, Any]) -> None:
        self.config: AlgorithmConfig = self.config_from(config)
        cfg = self.config
        self.game = make_game(cfg.env)
        A, D = self.game.num_actions, self.game.obs_dim
        gen = self.generator(cfg.seed)
        params = {
            "pi": models.init_mlp(gen, (D,) + tuple(cfg.hidden) + (A,)),
            "v": models.init_mlp(gen, (D,) + tuple(cfg.hidden) + (1,),
                                 out_scale=0.1),
        }
        self.learner = Learner(params, make_alphazero_loss(cfg.vf_coeff),
                               cfg.lr, grad_clip=cfg.grad_clip,
                               seed=cfg.seed, device=self.device)
        self._rng = np.random.default_rng(cfg.seed)
        self._buf: List[Tuple[np.ndarray, np.ndarray, float]] = []
        self._env_steps_total = 0

    # -- inference helpers ------------------------------------------------

    def _predict_fn(self):
        params, device = self.learner.get_params(), self.device

        def predict(obs: np.ndarray):
            return predict_on(params, obs, device)

        return predict

    def policy_action(self, state, num_simulations: Optional[int] = None,
                      greedy: bool = True) -> int:
        """Act with the current net + MCTS (no root noise) — the
        evaluation/serving entry. Shares the self-play generator, so an
        evaluation moves the later self-play draws as in JAX."""
        cfg = self.config
        mcts = MCTS(self.game, self._predict_fn(), cfg.c_puct,
                    noise_eps=0.0, rng=self._rng)
        visits = mcts.search(state, num_simulations or cfg.num_simulations,
                             root_noise=False)
        if greedy:
            return int(np.argmax(visits))
        probs = visits / visits.sum()
        return int(self._rng.choice(len(probs), p=probs))

    # -- self-play --------------------------------------------------------

    def _self_play_game(self) -> Tuple[List, int]:
        cfg = self.config
        return play_selfplay_game(
            self.game, self._predict_fn(),
            num_simulations=cfg.num_simulations, c_puct=cfg.c_puct,
            dirichlet_alpha=cfg.dirichlet_alpha,
            root_noise_eps=cfg.root_noise_eps,
            temperature_moves=cfg.temperature_moves, rng=self._rng)

    # -- Trainable API ----------------------------------------------------

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        outcomes = []
        for _ in range(cfg.games_per_iter):
            examples, moves = self._self_play_game()
            self._buf.extend(examples)
            self._env_steps_total += moves
            # examples[-1] is the first position: z from player-1's view
            outcomes.append(examples[-1][2])
        self._buf = self._buf[-cfg.buffer_size:]
        obs = np.stack([e[0] for e in self._buf])
        pis = np.stack([e[1] for e in self._buf])
        zs = np.asarray([e[2] for e in self._buf], dtype=np.float32)
        metrics = self.learner.update(
            {"obs": obs, "pi": pis, "z": zs},
            num_epochs=cfg.num_epochs,
            minibatch_size=min(cfg.minibatch_size, len(zs)),
            seed=cfg.seed + self._iteration)
        metrics["buffer_size"] = len(self._buf)
        metrics["draw_rate"] = float(np.mean(np.asarray(outcomes) == 0.0))
        metrics["env_steps_total"] = self._env_steps_total
        return metrics

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Score against a uniform-random opponent, alternating first
        move; win=1, draw=0.5, loss=0 (a competent player scores ~1)."""
        rng = np.random.default_rng(self.config.seed + 4242)
        score = 0.0
        for g in range(num_episodes):
            state = self.game.initial_state()
            az_turn = g % 2 == 0
            while True:
                tv = self.game.terminal_value(state)
                if tv is not None:
                    val = -tv if not az_turn else tv
                    score += {1.0: 1.0, 0.0: 0.5, -1.0: 0.0}[val]
                    break
                if az_turn:
                    a = self.policy_action(state, greedy=True)
                else:
                    legal = np.nonzero(self.game.legal_actions(state))[0]
                    a = int(rng.choice(legal))
                state = self.game.next_state(state, a)
                az_turn = not az_turn
        return {"episodes": num_episodes,
                "episode_return_mean": score / max(1, num_episodes)}

    def get_params(self):
        return self.learner.get_params()

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return {"params": params_to_numpy(self.learner.get_params()),
                "env_steps_total": self._env_steps_total}

    def load_checkpoint(self, checkpoint: Dict) -> None:
        self.learner.set_params(checkpoint["params"])
        self._env_steps_total = checkpoint.get("env_steps_total", 0)
