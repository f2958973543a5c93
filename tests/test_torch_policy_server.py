"""The port's external-env policy server (``ray_tpu_torch/rl/
policy_server.py``) against the JAX package's.

CPU. ``_finish_episode`` and ``sample``'s cut equal JAX's on scripted
episodes (JAX's class undecorated through ``ExternalEnvRunner._cls``,
whose ``__init__`` only jits): a terminal episode, a mid-episode cut that
leaves a pending action in place, and a cut bootstrapped from the next
state's value. JAX's ``PolicyClient`` (on ``requests``) and the port's
(on ``urllib``) both drive the port's server, 404 and 503 replies
included. PPO on ``external://0`` with a CartPole simulator thread meets
JAX's own assertions (``tests/test_rl_extras.py:210-250``), and the two
``ValueError``s of an external env equal JAX's.
"""

import asyncio
import threading
import urllib.error

import numpy as np
import pytest
import requests
import torch

import ray_tpu.rl as jrl
from ray_tpu.rl.policy_server import ExternalEnvRunner as JRunner
from ray_tpu.rl.policy_server import PolicyClient as JClient
import ray_tpu_torch.rl as trl
from ray_tpu_torch.rl.env import CartPole
from ray_tpu_torch.rl.policy_server import ExternalEnvRunner, PolicyClient

SPEC = {"obs_dim": 4, "num_actions": 2}
WATCHDOG_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _episode(rng, n_actions, n_rewards):
    obs = [rng.standard_normal(4).astype(np.float32)
           for _ in range(n_actions)]
    return {"obs": obs,
            "actions": [np.int64(rng.integers(0, 2))
                        for _ in range(n_actions)],
            "logp": [float(-0.7 + 0.1 * rng.standard_normal())
                     for _ in range(n_actions)],
            "values": [float(rng.standard_normal())
                       for _ in range(n_actions)],
            "rewards": [1.0] * n_rewards, "return": float(n_rewards)}


def _copy(ep):
    return {k: list(v) if isinstance(v, list) else v for k, v in ep.items()}


def _runners(rollout_len=8):
    j = JRunner._cls(0, SPEC, rollout_len, 1, 0.97, 0.9, seed=0)
    t = ExternalEnvRunner(0, SPEC, rollout_len, 1, 0.97, 0.9, seed=0,
                          device="cpu")
    return j, t


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
            assert g[k].dtype == w[k].dtype, k


@pytest.mark.parametrize("case", ["terminal", "cut_pending", "cut_last"])
def test_finish_episode_equals_jax(case):
    rng = np.random.default_rng({"terminal": 0, "cut_pending": 1,
                                 "cut_last": 2}[case])
    # a pending action (5 actions, 4 rewards) bootstraps from values[4];
    # with no pending action the cut bootstraps from its last state
    ep = _episode(rng, 5, 5 if case == "cut_last" else 4)
    j, t = _runners()
    terminal = case == "terminal"
    assert t._finish_episode_locked(_copy(ep), terminal) \
        == j._finish_episode(_copy(ep), terminal)
    _assert_rows_equal(t._done_rows, j._done_rows)
    assert t._steps_buffered == j._steps_buffered
    assert t._completed_returns == j._completed_returns


def test_sample_cut_equals_jax():
    """Two open episodes past the target: each is cut at its last
    complete step, its pending action stays, and a later sample sees the
    tail first."""
    rng = np.random.default_rng(3)
    eps = {"a": _episode(rng, 6, 5), "b": _episode(rng, 4, 4)}
    j, t = _runners(rollout_len=8)
    j._episodes = {k: _copy(v) for k, v in eps.items()}
    t._episodes = {k: _copy(v) for k, v in eps.items()}
    done = _episode(rng, 3, 3)
    j._finish_episode(_copy(done), True)
    t._finish_episode_locked(_copy(done), True)
    want = asyncio.run(j.sample({"unused": 0}))
    got = t.sample({"unused": 0})
    _assert_rows_equal([got], [want])
    for k in eps:
        assert {f: len(t._episodes[k][f]) for f in eps[k] if f != "return"} \
            == {f: len(j._episodes[k][f]) for f in eps[k] if f != "return"}
    assert t.episode_stats() == j.episode_stats()
    assert t.pop_connector_deltas() is None


def _params(seed=0):
    return trl.models.init_policy(torch.Generator().manual_seed(seed),
                                  trl.EnvSpec(**SPEC), (16, 16))


def test_both_clients_drive_the_server():
    runner = ExternalEnvRunner(0, SPEC, 4, device="cpu")
    port = runner.ready()
    assert runner.ready() == port
    base = f"http://127.0.0.1:{port}"
    jc, tc = JClient(base), PolicyClient(base)
    obs = [0.01, -0.02, 0.03, 0.0]
    try:
        assert jc.start_episode("j") == "j"
        assert tc.start_episode() == "ep0"
        # 503 until a policy is installed: both clients retry, then give up
        for c, eid in ((jc, "j"), (tc, "ep0")):
            with pytest.raises(TimeoutError, match="never became ready"):
                c._post(f"/episodes/{eid}/action", {"obs": obs}, retries=2)
        # 404 for an unknown episode, on every route that needs one
        with pytest.raises(requests.HTTPError) as e:
            jc.get_action("nope", obs)
        assert e.value.response.status_code == 404
        assert e.value.response.json() == {"error": "unknown episode"}
        for call in (lambda: tc.get_action("nope", obs),
                     lambda: tc.log_returns("nope", 1.0),
                     lambda: tc.end_episode("nope")):
            with pytest.raises(urllib.error.HTTPError) as e:
                call()
            assert e.value.code == 404
        # a malformed body is refused, the episode left as it was
        with pytest.raises(urllib.error.HTTPError) as e:
            tc._post("/episodes/ep0/rewards", {"rew": 1.0})
        assert e.value.code == 400
        out = []
        th = threading.Thread(target=lambda: out.append(
            runner.sample(_params())), daemon=True)
        th.start()
        # "j" ends before the fourth step reaches the target, so the
        # cut finds only "ep0" open, whenever the sampler polls
        for c, eid in ((jc, "j"), (tc, "ep0")):
            for _ in range(2):
                a = c.get_action(eid, obs)
                assert a in (0, 1) and isinstance(a, int)
                c.log_returns(eid, 1.0)
            if c is jc:
                jc.end_episode("j")
        th.join(timeout=60)
        batch = out[0]
        assert len(batch["rewards"]) == 4
        assert batch["dones"].sum() == 1          # j ended, ep0 was cut
        assert set(batch["actions"].tolist()) <= {0, 1}
        assert runner.episode_stats() == {"episodes": 1, "mean_return": 2.0}
    finally:
        runner.shutdown()
    with pytest.raises(urllib.error.URLError):
        tc.start_episode("late")


def test_shutdown_ends_a_waiting_sample():
    """``sample`` waits for steps as JAX's does; shutting the runner down
    ends the wait with an error instead of leaving the caller blocked."""
    runner = ExternalEnvRunner(0, SPEC, 4, device="cpu")
    runner.ready()
    errors = []

    def wait():
        try:
            runner.sample(_params())
        except RuntimeError as e:
            errors.append(str(e))

    th = threading.Thread(target=wait, daemon=True)
    th.start()
    th.join(timeout=0.2)
    assert th.is_alive()
    runner.shutdown()
    th.join(timeout=10)
    assert not th.is_alive()
    assert errors and "shut down with fewer than 4 steps" in errors[0]


def test_continuous_actions_come_back_as_lists():
    spec = {"obs_dim": 3, "action_dim": 1, "action_low": -2.0,
            "action_high": 2.0}
    runner = ExternalEnvRunner(0, spec, 2, device="cpu")
    runner._params = trl.models.init_policy(
        torch.Generator().manual_seed(0), trl.EnvSpec(**spec), (16, 16))
    try:
        client = PolicyClient(f"http://127.0.0.1:{runner.ready()}")
        eid = client.start_episode()
        a = client.get_action(eid, [0.1, 0.2, 0.3])
        assert isinstance(a, list) and len(a) == 1
    finally:
        runner.shutdown()


def test_ppo_on_external_cartpole():
    """JAX's ``test_policy_server_external_cartpole`` on the port."""
    cfg = trl.PPOConfig()
    cfg.env = "external://0"
    cfg.env_config = {"spec": dict(SPEC)}
    cfg.env_runners(num_env_runners=1, num_envs_per_runner=1,
                    rollout_fragment_length=64)
    cfg.num_epochs = 2
    cfg.minibatch_size = 64
    algo = cfg.build(device="cpu")
    port = algo.server_ports[0]
    stop = threading.Event()

    def simulator():
        client = PolicyClient(f"http://127.0.0.1:{port}")
        env = CartPole(1, seed=3)
        while not stop.is_set():
            eid = client.start_episode()
            obs = env.reset()
            for _ in range(100):
                a = client.get_action(eid, obs[0])
                obs, r, d = env.step(np.array([a]))
                client.log_returns(eid, float(r[0]))
                if d[0] or stop.is_set():
                    break
            client.end_episode(eid)

    t = threading.Thread(target=simulator, daemon=True)
    t.start()
    # a broken server fails the test instead of hanging the run: stopping
    # the algorithm ends a waiting sample with a RuntimeError
    watchdog = threading.Timer(WATCHDOG_S, algo.stop)
    watchdog.start()
    try:
        m1 = algo.step()
        m2 = algo.step()
        assert np.isfinite(m1["policy_loss"])
        assert np.isfinite(m2["policy_loss"])
        stats = {**m1, **m2}
        assert stats["env_steps_total"] >= 128
    finally:
        watchdog.cancel()
        stop.set()
        t.join(timeout=10)
        algo.stop()
    assert not t.is_alive()


def _value_error(cfg_mod, **over):
    cfg = cfg_mod.PPOConfig()
    cfg.env = "external://0"
    for k, v in over.items():
        setattr(cfg, k, v)
    kw = {"device": "cpu"} if cfg_mod is trl else {}
    with pytest.raises(ValueError) as e:
        cfg.build(**kw)
    return str(e.value)


def test_external_value_errors_equal_jax():
    assert _value_error(trl) == _value_error(jrl)
    over = {"env_config": {"spec": dict(SPEC)}, "connectors": ["mean_std"]}
    assert _value_error(trl, **over) == _value_error(jrl, **over)
