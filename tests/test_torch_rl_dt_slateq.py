"""ray_tpu_torch's Decision Transformer and SlateQ against the JAX
package's, in one process.

Conventions in ``tests/_torch_rl_offpolicy.py``. DT's forward, losses and
gradients are held to JAX's with left padding, including a window whose
first query rows see only padded keys (finite and equal: the mask fills
-1e9, not -inf); its windows and return-conditioned rollouts draw from
numpy as JAX's do, so an iteration is held to JAX's. ``RecSlateEnv`` is
numpy in both packages and held bit for bit; a SlateQ iteration
(exploration, replay, updates with the target restored, the target copy)
is held to JAX's with JAX's params carried across.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_rl_offpolicy import (ATOL, assert_loss_parity,
                                 assert_tree_close, carry, jax_algo,
                                 np_tree, one_thread,  # noqa: F401
                                 shares_storage, tree_equal)
from ray_tpu.rl.algorithms import dt as jdt
from ray_tpu.rl.algorithms import slateq as jslateq
from ray_tpu.rl.env import make_env as jmake_env
from ray_tpu_torch import rl as trl
from ray_tpu_torch.models.convert import rl_params_from_jax
from ray_tpu_torch.parallel.train_step import value_and_grad
from ray_tpu_torch.rl.algorithms import dt as tdt
from ray_tpu_torch.rl.algorithms import slateq as tslateq

pytestmark = pytest.mark.usefixtures("one_thread")

# ------------------------------------------------------------------- DT --


def _dt_params(obs_dim=4, act_in=2, act_out=2, d=16, n_layers=1,
               max_ep_len=30):
    jp = jdt.init_dt_model(jax.random.key(0), obs_dim, act_in, act_out, d,
                           n_layers, max_ep_len)
    like = tdt.init_dt_model(torch.Generator(), obs_dim, act_in, act_out, d,
                             n_layers, max_ep_len)
    assert isinstance(like["blocks"], list) and like["emb_t"].shape == (
        max_ep_len, d)
    return jp, rl_params_from_jax(np_tree(jp), like, device="cpu")


def _dt_inputs(B=3, K=4, obs_dim=4, act=2, seed=0, pad=(0, 2, 3)):
    """Left-padded windows: row b has ``pad[b]`` padded slots; the last
    row's first query tokens see only padding."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, K), np.float32)
    for b, n in enumerate(pad):
        mask[b, :n] = 0.0
    return dict(
        rtg=rng.normal(size=(B, K, 1)).astype(np.float32),
        obs=rng.normal(size=(B, K, obs_dim)).astype(np.float32),
        act_in=rng.normal(size=(B, K, act)).astype(np.float32),
        timesteps=rng.integers(0, 30, (B, K)).astype(np.int32),
        pad_mask=mask)


def test_dt_forward_matches_jax_with_left_padding():
    jp, tp = _dt_params(n_layers=2)
    x = _dt_inputs()
    want = np.asarray(jdt.dt_forward(jp, **x, n_heads=2))
    got = tdt.dt_forward(tp, **{k: torch.as_tensor(v) for k, v in x.items()},
                         n_heads=2).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # a row that is all padding too: uniform attention, finite
    x["pad_mask"][1] = 0.0
    got = tdt.dt_forward(tp, **{k: torch.as_tensor(v) for k, v in x.items()},
                         n_heads=2).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jdt.dt_forward(jp, **x, n_heads=2)), rtol=0,
        atol=ATOL)
    assert np.isfinite(got).all()


def test_dt_forward_is_causal():
    """JAX's own check (tests/test_rl_offline_seq.py:83-106): the action
    prediction at t does not change when inputs after t change."""
    _, tp = _dt_params(d=32, n_layers=2)
    x = {k: torch.as_tensor(v) for k, v in _dt_inputs(
        B=2, K=8, pad=(0, 0)).items()}
    x["timesteps"] = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    out1 = tdt.dt_forward(tp, **x, n_heads=2)
    t = 4
    for k in ("rtg", "obs", "act_in"):
        x[k] = x[k].clone()
        x[k][:, t + 1:] += 100.0
    out2 = tdt.dt_forward(tp, **x, n_heads=2)
    torch.testing.assert_close(out1[:, :t + 1], out2[:, :t + 1], rtol=1e-4,
                               atol=1e-4)
    assert not torch.allclose(out1[:, t + 1:], out2[:, t + 1:])


def _dt_batch(discrete: bool, seed=1):
    x = _dt_inputs(seed=seed)
    rng = np.random.default_rng(seed)
    if discrete:
        actions = rng.integers(0, 2, (3, 4)).astype(np.int64)
    else:
        actions = rng.normal(size=(3, 4, 2)).astype(np.float32)
    return {"obs": x["obs"], "act_in": x["act_in"], "actions": actions,
            "rtg": x["rtg"][..., 0] * 100.0, "timesteps": x["timesteps"],
            "mask": x["pad_mask"]}


@pytest.mark.parametrize("discrete", [True, False],
                         ids=["discrete", "continuous"])
def test_dt_loss_and_grads_match_jax(discrete):
    spec = (trl.EnvSpec(obs_dim=4, num_actions=2) if discrete else
            trl.EnvSpec(obs_dim=4, action_dim=2))
    cfg = jdt.DTConfig()
    cfg.offline_data = _dataset(40)
    for k, v in DT_KW.items():
        setattr(cfg, k, v)
    jalgo = jax_algo(jdt.DT, cfg, spec)
    jp, tp = _dt_params(max_ep_len=30)
    assert_loss_parity(tdt.make_dt_loss(discrete, cfg.rtg_scale, 2), tp,
                       jalgo.learner._loss_fn, jp, _dt_batch(discrete),
                       jax.random.key(0))


def test_episodes_from_arrays_match_jax():
    """JAX's stream case (tests/test_rl_offline_seq.py:156-171) and a
    flat stream with a trailing partial episode."""
    stream = {"obs": np.arange(18, dtype=np.float32).reshape(6, 3),
              "actions": np.arange(6, dtype=np.int64),
              "rewards": np.asarray([1, 1, 1, 2, 2, 2], np.float32),
              "dones": np.asarray([0, 0, 1, 0, 0, 1], bool),
              "env_ids": np.asarray([0, 1, 0, 1, 0, 1])}
    flat = {k: v for k, v in stream.items() if k != "env_ids"}
    flat["dones"] = np.asarray([0, 1, 0, 0, 0, 0], bool)
    for data in (stream, flat):
        got = tdt._episodes_from_arrays(data, 0.99)
        want = jdt._episodes_from_arrays(data, 0.99)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    lens = sorted(len(e["rewards"]) for e in
                  tdt._episodes_from_arrays(stream, 0.99))
    assert lens == [2, 3]
    with pytest.raises(ValueError, match="no completed episodes"):
        tdt._episodes_from_arrays({**flat, "dones": np.zeros(1, bool),
                                   "rewards": np.ones(1, np.float32)}, 0.9)


def _dataset(n=160, seed=0):
    """Scripted CartPole rows over 4 env streams (JAX's DT test's
    controller, tests/test_rl_offline_seq.py:109-131, at a small size)."""
    env = jmake_env("CartPole-v1", 4, {})
    rng = np.random.default_rng(seed)
    obs = env.reset()
    rows = {"obs": [], "actions": [], "rewards": [], "dones": [],
            "env_ids": []}
    for _ in range(n // 4):
        act = (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)
        act = np.where(rng.random(4) < 0.1, 1 - act, act)
        nobs, rew, done = env.step(act)
        for e in range(4):
            rows["obs"].append(obs[e])
            rows["actions"].append(act[e])
            rows["rewards"].append(rew[e])
            rows["dones"].append(done[e])
            rows["env_ids"].append(e)
        obs = nobs
    return {k: np.asarray(v) for k, v in rows.items()}


DT_KW = {"env": "CartPole-v1", "context_len": 4, "d_model": 16,
         "n_layers": 1, "n_heads": 2, "updates_per_iter": 3,
         "minibatch_size": 6, "max_ep_len": 30, "target_return": 20.0,
         "seed": 3}


def _assert_dt_params_close(got, want, d):
    """Every leaf within REL of JAX's, the key third of each ``qkv``
    bias aside: its gradient is zero in exact arithmetic (it adds one
    constant to every score of a query row, which the softmax ignores),
    so each package moves it by Adam steps on its own rounding noise.
    That third is held within 1e-5 absolute."""
    got, want = dict(got), dict(np_tree(want))
    got["blocks"] = [dict(b) for b in got["blocks"]]
    want["blocks"] = [dict(b) for b in want["blocks"]]
    for gb, wb in zip(got["blocks"], want["blocks"]):
        gk = gb["qkv"]["b"][d:2 * d].numpy()
        wk = np.asarray(wb["qkv"]["b"])[d:2 * d]
        np.testing.assert_allclose(gk, wk, rtol=0, atol=ATOL)
        keep = np.r_[0:d, 2 * d:3 * d]
        gb["qkv"] = dict(gb["qkv"], b=gb["qkv"]["b"][keep])
        wb["qkv"] = dict(wb["qkv"], b=np.asarray(wb["qkv"]["b"])[keep])
    assert_tree_close(got, want)


def test_dt_iteration_and_evaluate_match_jax(tmp_path):
    data = _dataset()
    cfg = trl.DTConfig().training(offline_data=data, **DT_KW)
    algo = cfg.build(device="cpu")
    jcfg = jdt.DTConfig().training(offline_data=data, **DT_KW)
    jalgo = jax_algo(jdt.DT, jcfg, algo.spec)
    algo.learner.set_params(carry(jalgo.learner.get_params(), algo))
    # the windows: numpy draws in JAX's order
    got, want = algo._minibatch(24), jalgo._minibatch(24)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["mask"] == 0).any()           # some windows are padded
    m, jm = algo.train(), jalgo.training_step()
    for k in ("action_nll", "action_acc", "loss", "grad_norm"):
        assert abs(m[k] - jm[k]) < ATOL * max(1, abs(jm[k])), k
    assert m["env_steps_total"] == 0
    _assert_dt_params_close(algo.get_params(), jalgo.learner.get_params(),
                            DT_KW["d_model"])
    assert algo.evaluate(1) == pytest.approx(jalgo.evaluate(1), abs=0)
    path = algo.save(str(tmp_path / "dt"))
    again = cfg.build(device="cpu")
    again.restore(path)
    assert tree_equal(again.get_params(), algo.get_params())


def test_dt_rejections():
    with pytest.raises(ValueError, match="needs config.offline_data"):
        trl.DTConfig().training(env="CartPole-v1").build(device="cpu")
    data = _dataset(8)
    data.pop("dones")
    with pytest.raises(ValueError, match="missing 'dones'"):
        trl.DTConfig().training(env="CartPole-v1",
                                offline_data=data).build(device="cpu")


# --------------------------------------------------------------- SlateQ --

def test_recslate_env_bit_equal():
    kw = dict(num_envs=5, num_docs=6, slate_size=2, feat_dim=3, horizon=4,
              seed=2)
    jenv, tenv = jslateq.RecSlateEnv(**kw), tslateq.RecSlateEnv(**kw)
    assert tenv.obs_dim == jenv.obs_dim
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    rng = np.random.default_rng(0)
    clicks = set()
    for _ in range(9):
        slates = np.stack([rng.choice(6, 2, replace=False)
                           for _ in range(5)])
        np.testing.assert_array_equal(tenv.choice_probs(slates),
                                      jenv.choice_probs(slates))
        out, jout = tenv.step(slates), jenv.step(slates)
        for got, want in zip(out, jout):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        clicks |= set(out[3].tolist())
    assert clicks == {-1, 0, 1}


SLATEQ_KW = {"num_envs_per_runner": 4, "rollout_fragment_length": 5,
             "learning_starts": 24, "updates_per_iter": 3,
             "minibatch_size": 8, "target_update_freq": 4, "hidden": (8,),
             "num_docs": 6, "slate_size": 2, "feat_dim": 3,
             "epsilon_decay_steps": 40, "seed": 1}


def _slateq_pair():
    algo = trl.SlateQConfig().training(**SLATEQ_KW).build(device="cpu")
    jalgo = jslateq.SlateQ({"__algo_config": jslateq.SlateQConfig(
    ).training(**SLATEQ_KW)})
    # targets away from the online net, so the losses see them
    jp = dict(jalgo.learner.params)
    jp["target"] = jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01,
                                          jp["target"])
    jalgo.learner.params = jp
    algo.learner.set_params(carry(jp, algo))
    return algo, jalgo


def test_greedy_slate_and_loss_match_jax():
    algo, jalgo = _slateq_pair()
    env = tslateq.RecSlateEnv(num_envs=7, num_docs=6, slate_size=2,
                              feat_dim=3, seed=5)
    obs = env.reset()
    greedy = jax.jit(jslateq_greedy(jalgo))
    want = np.asarray(greedy(jalgo.learner.params["q"], obs))
    got = algo._greedy_slate(algo.get_params()["q"], obs)
    np.testing.assert_array_equal(got, want)   # in descending order
    nobs, rew, dones, clicked = env.step(got)
    clicked_doc = np.where(clicked >= 0, np.take_along_axis(
        got, np.maximum(clicked, 0)[:, None], 1)[:, 0], -1)
    batch = {"obs": obs, "clicked_doc": clicked_doc.astype(np.int32),
             "rewards": rew, "dones": dones.astype(np.float32),
             "next_obs": nobs}
    assert (clicked_doc >= 0).any() and (clicked_doc < 0).any()
    assert_loss_parity(algo.learner._loss_fn, algo.get_params(),
                       jalgo.learner._loss_fn, jalgo.learner.params, batch,
                       jax.random.key(0))


def jslateq_greedy(jalgo):
    """JAX's ``greedy_slate`` (the function its jitted picker wraps)."""
    fn = jalgo._greedy_slate
    while hasattr(fn, "__wrapped__"):
        fn = fn.__wrapped__
    return fn


def test_slateq_iterations_match_jax(tmp_path):
    """Collection with epsilon-greedy slates, replay, updates with the
    target put back after each and copied every 4 updates."""
    algo, jalgo = _slateq_pair()
    target0 = algo.get_params()["target"]
    for i in range(4):
        got, want = algo.train(), jalgo.train()
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k != "time_total_s":
                assert abs(got[k] - v) < ATOL * max(1, abs(v)), (i, k)
        assert_tree_close(algo.get_params(), jalgo.learner.params)
        p = algo.get_params()
        assert shares_storage(p["q"], p["target"]) == []
        if i == 0:      # 20 rows: no update yet
            assert algo._updates == 0
        if algo._updates < 4:
            assert tree_equal(p["target"], target0)
    assert algo._updates == 9
    # the last copy was at update 8, then one more update moved q only
    assert not tree_equal(p["target"], target0)
    assert not tree_equal(p["q"], p["target"])
    np.testing.assert_allclose(algo.evaluate(4)["episode_return_mean"],
                               jalgo.evaluate(4)["episode_return_mean"],
                               rtol=0, atol=ATOL)
    path = algo.save(str(tmp_path / "slateq"))
    again = trl.SlateQConfig().training(**SLATEQ_KW).build(device="cpu")
    again.restore(path)
    assert tree_equal(again.get_params(), algo.get_params())
    assert again._updates == 9 and again._env_steps_total == 80


def test_slateq_target_gets_no_gradient():
    """The bootstrap is built under ``no_grad`` (JAX's stop_gradient):
    the target's gradient is zero, the online net's is not."""
    algo, _ = _slateq_pair()
    algo._collect(5)
    mb = algo.learner._to_device(algo.buffer.sample(8))
    _, grads = value_and_grad(lambda p: algo.learner._loss_fn(p, mb, None),
                              algo.get_params(), has_aux=True)
    assert all(not g.any() for k, g in grads.items()
               if k.startswith("target/"))
    assert any(g.any() for k, g in grads.items() if k.startswith("q/"))
