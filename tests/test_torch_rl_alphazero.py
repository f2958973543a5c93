"""ray_tpu_torch's AlphaZero and LeelaChessZero against the JAX package's,
in one process.

Conventions in ``tests/_torch_rl_offpolicy.py``. The games, ``MCTS`` and
``play_selfplay_game`` are numpy in both packages: given the same numpy
``predict`` and seed they make the same trees and games, bit for bit. The
networks' ``predict`` is held within 1e-5; with JAX's params carried
across, a whole iteration (self-play, buffer, update) is held to JAX's.
JAX's LC0 self-play workers are actors, built here in this process
(``local_actors``).
"""

import jax
import numpy as np
import pytest

from _torch_rl_offpolicy import (ATOL, assert_loss_parity,
                                 assert_tree_close, carry, local_actors,
                                 one_thread)  # noqa: F401
from ray_tpu.rl.algorithms import alphazero as jaz
from ray_tpu.rl.algorithms import lc0 as jlc0
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl.algorithms import alphazero as taz
from ray_tpu_torch.rl.algorithms import lc0 as tlc0

pytestmark = pytest.mark.usefixtures("one_thread")


def _playouts(jgame, tgame, games: int, seed: int):
    """Random games in both packages: legal moves, next states, terminal
    values and encodings equal at every ply."""
    rng = np.random.default_rng(seed)
    outcomes = set()
    for _ in range(games):
        js, ts = jgame.initial_state(), tgame.initial_state()
        while True:
            assert ts == js
            tv = tgame.terminal_value(ts)
            assert tv == jgame.terminal_value(js)
            enc = tgame.encode(ts)
            assert enc.dtype == np.float32
            np.testing.assert_array_equal(enc, jgame.encode(js))
            if tv is not None:
                outcomes.add(tv)
                break
            legal = tgame.legal_actions(ts)
            np.testing.assert_array_equal(legal, jgame.legal_actions(js))
            a = int(rng.choice(np.nonzero(legal)[0]))
            js, ts = jgame.next_state(js, a), tgame.next_state(ts, a)
    return outcomes


def test_tictactoe_rules_match_jax():
    assert _playouts(jaz.TicTacToe(), taz.TicTacToe(), 60, 0) == {-1.0, 0.0}
    assert taz.make_game("tictactoe").num_actions == 9
    with pytest.raises(ValueError, match="unknown game"):
        taz.make_game("go")


def test_connect_four_rules_match_jax():
    assert -1.0 in _playouts(jlc0.ConnectFour(), tlc0.ConnectFour(), 25, 1)
    g = tlc0.ConnectFour()
    s = g.initial_state()
    for _ in range(6):
        s = g.next_state(s, 3)
    assert not g.legal_actions(s)[3]
    with pytest.raises(ValueError, match="column 3 full"):
        g.next_state(s, 3)
    assert isinstance(taz.make_game("connect4"), tlc0.ConnectFour)


def _numpy_predict(num_actions: int, obs_dim: int, seed: int = 0):
    """A fixed numpy network: priors and value from one random layer,
    float32 as the device predict returns them."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(obs_dim, num_actions + 1)).astype(np.float32)

    def predict(obs):
        z = obs @ w
        p = np.exp(z[:-1] - z[:-1].max())
        return (p / p.sum()).astype(np.float32), float(np.tanh(z[-1]))

    return predict


@pytest.mark.parametrize("game", ["tictactoe", "connect4"])
def test_mcts_search_bit_equal(game):
    jgame, tgame = jaz.make_game(game), taz.make_game(game)
    predict = _numpy_predict(tgame.num_actions, tgame.obs_dim)
    js, ts = jgame.initial_state(), tgame.initial_state()
    for a in (0, 1, 2):
        js, ts = jgame.next_state(js, a), tgame.next_state(ts, a)
    jm = jaz.MCTS(jgame, predict, 1.5, 0.5, 0.25, np.random.default_rng(3))
    tm = taz.MCTS(tgame, predict, 1.5, 0.5, 0.25, np.random.default_rng(3))
    for root_noise in (True, False):
        np.testing.assert_array_equal(tm.search(ts, 8, root_noise),
                                      jm.search(js, 8, root_noise))
    for table in ("_P", "_N", "_W"):
        got, want = getattr(tm, table), getattr(jm, table)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert tm.rng.random() == jm.rng.random()


@pytest.mark.parametrize("game", ["tictactoe", "connect4"])
def test_selfplay_game_bit_equal(game):
    jgame, tgame = jaz.make_game(game), taz.make_game(game)
    predict = _numpy_predict(tgame.num_actions, tgame.obs_dim, seed=1)
    kw = dict(num_simulations=6, c_puct=1.5, dirichlet_alpha=0.5,
              root_noise_eps=0.25, temperature_moves=3)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        (jex, jmoves), (tex, tmoves) = (
            jaz.play_selfplay_game(jgame, predict, rng=jrng, **kw),
            taz.play_selfplay_game(tgame, predict, rng=trng, **kw))
        assert tmoves == jmoves and len(tex) == len(jex) == jmoves
        for (to, tp, tz), (jo, jp, jz) in zip(tex, jex):
            np.testing.assert_array_equal(to, jo)
            np.testing.assert_array_equal(tp, jp)
            assert tz == jz
    assert trng.random() == jrng.random()


AZ_KW = {"num_simulations": 5, "games_per_iter": 2, "hidden": (8,),
         "minibatch_size": 16, "num_epochs": 2, "seed": 2}


def _az_pair(**kw):
    cfg = trl.AlphaZeroConfig().training(**{**AZ_KW, **kw})
    algo = trl.AlphaZero({"__algo_config": cfg}, device="cpu")
    jalgo = jaz.AlphaZero({"__algo_config": jaz.AlphaZeroConfig().training(
        **{**AZ_KW, **kw})})
    algo.learner.set_params(carry(jalgo.learner.get_params(), algo))
    return algo, jalgo


def test_predict_matches_jax():
    algo, jalgo = _az_pair()
    tp, jp = algo._predict_fn(), jalgo._predict_fn()
    game = algo.game
    s = game.initial_state()
    for a in (4, 0, 8):
        obs = game.encode(s)
        (tpri, tv), (jpri, jv) = tp(obs), jp(obs)
        assert tpri.dtype == np.float32 and tpri.shape == (9,)
        np.testing.assert_allclose(tpri, jpri, rtol=0, atol=ATOL)
        assert abs(tv - jv) < ATOL
        s = game.next_state(s, a)


def test_alphazero_loss_matches_jax():
    algo, jalgo = _az_pair()
    rng = np.random.default_rng(0)
    pi = rng.random((12, 9)).astype(np.float32)
    batch = {"obs": rng.integers(0, 2, (12, 18)).astype(np.float32),
             "pi": pi / pi.sum(-1, keepdims=True),
             "z": rng.choice([-1.0, 0.0, 1.0], 12).astype(np.float32)}
    assert_loss_parity(algo.learner._loss_fn, algo.get_params(),
                       jalgo.learner._loss_fn, jalgo.learner.params, batch,
                       jax.random.key(0))


def test_alphazero_iterations_match_jax(tmp_path):
    """Self-play under the carried params, the buffer and the update
    (``Learner.update`` seeded ``seed + iteration``) as JAX's; then the
    evaluation, which shares the self-play generator."""
    algo, jalgo = _az_pair()
    for _ in range(2):
        got, want = algo.train(), jalgo.train()
        for k in ("buffer_size", "draw_rate", "env_steps_total",
                  "training_iteration"):
            assert got[k] == want[k], k
        for k in ("loss", "pi_loss", "v_loss", "grad_norm"):
            assert abs(got[k] - want[k]) < ATOL * max(1, abs(want[k])), k
        assert_tree_close(algo.get_params(), jalgo.learner.get_params())
    assert algo.evaluate(2) == jalgo.evaluate(2)
    assert algo._rng.random() == jalgo._rng.random()
    path = algo.save(str(tmp_path / "az"))
    again = trl.AlphaZero({"__algo_config": algo.config}, device="cpu")
    again.restore(path)
    assert_tree_close(again.get_params(), jalgo.learner.get_params())
    assert again._env_steps_total == algo._env_steps_total
    assert again._iteration == 2


LC0_KW = {"num_workers": 2, "games_per_iter": 2, "num_simulations": 4,
          "updates_per_iter": 3, "minibatch_size": 16, "hidden": (8,),
          "seed": 1}


@pytest.fixture
def jax_selfplay(monkeypatch):
    local_actors(monkeypatch, jlc0, "SelfPlayWorker")


def _lc0_pair():
    algo = trl.LeelaChessZeroConfig().training(**LC0_KW).build(device="cpu")
    jalgo = jlc0.LeelaChessZero({"__algo_config": jlc0.LeelaChessZeroConfig(
    ).training(**LC0_KW)})
    algo.learner.set_params(carry(jalgo.learner.get_params(), algo))
    return algo, jalgo


def test_lc0_loss_matches_jax(jax_selfplay):
    algo, jalgo = _lc0_pair()
    rng = np.random.default_rng(1)
    pi = rng.random((10, 7)).astype(np.float32)
    batch = {"obs": rng.integers(0, 2, (10, 84)).astype(np.float32),
             "pi": pi / pi.sum(-1, keepdims=True),
             "z": rng.choice([-1.0, 0.0, 1.0], 10).astype(np.float32),
             "weights": rng.uniform(0.2, 1.0, 10).astype(np.float32)}
    _, metrics = assert_loss_parity(
        algo.learner._loss_fn, algo.get_params(), jalgo.learner._loss_fn,
        jalgo.learner.params, batch, jax.random.key(0))
    assert metrics["verr"].shape == (10,)
    # without weights both packages weigh every row 1
    batch.pop("weights")
    assert_loss_parity(algo.learner._loss_fn, algo.get_params(),
                       jalgo.learner._loss_fn, jalgo.learner.params, batch,
                       jax.random.key(0))


def test_lc0_iteration_matches_jax(jax_selfplay, tmp_path):
    """Workers seeded ``seed + 97 i`` play their share in turn; the
    prioritized buffer, its refreshed priorities and the params after the
    importance-weighted updates equal JAX's."""
    algo, jalgo = _lc0_pair()
    assert [w.rng.random() for w in algo.workers] == \
        [w._obj.rng.random() for w in jalgo.workers]
    got, want = algo.train(), jalgo.train()
    for k in ("buffer_size", "draw_rate", "env_steps_total"):
        assert got[k] == want[k], k
    for k in ("loss", "pi_loss", "v_loss", "grad_norm"):
        assert abs(got[k] - want[k]) < ATOL * max(1, abs(want[k])), k
    assert "verr" not in got
    base, n = algo.buffer._leaf_base, len(algo.buffer)
    leaves = algo.buffer._tree[base:base + n]
    np.testing.assert_allclose(leaves, jalgo.buffer._tree[base:base + n],
                               rtol=1e-5, atol=0)
    assert leaves.max() > leaves.min()          # priorities were refreshed
    for k in algo.buffer._storage:
        np.testing.assert_array_equal(algo.buffer._storage[k],
                                      jalgo.buffer._storage[k])
    assert_tree_close(algo.get_params(), jalgo.learner.get_params())
    ev = algo.evaluate(2)
    assert ev == jalgo.evaluate(2) and 0.0 <= ev["episode_return_mean"] <= 1
    algo.save(str(tmp_path / "lc0"))
    algo.stop()
    assert algo.workers == []


def test_alphazero_defaults_and_run_train():
    import io

    from ray_tpu_torch.rl import train as ttrain

    for name, jcls in (("ALPHAZERO", jaz.AlphaZeroConfig),
                       ("LEELACHESSZERO", jlc0.LeelaChessZeroConfig)):
        cfg = ttrain.get_algorithm_config(name)
        assert vars(cfg).keys() == vars(jcls()).keys()
        for k, v in vars(jcls()).items():
            if k != "algo_class":
                assert getattr(cfg, k) == v, (name, k)
    res = ttrain.run_train("alphazero", config_json='{"num_simulations": 3,'
                           ' "games_per_iter": 1, "hidden": [8]}',
                           stop_iters=1, out=io.StringIO(), device="cpu")
    assert res["training_iteration"] == 1 and np.isfinite(res["loss"])
