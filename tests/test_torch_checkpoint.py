"""ray_tpu_torch's checkpoints (``train/checkpoint.py``): the port's own
tensor-tree format saved and loaded bit for bit; an async save taken
before in-place train steps loads the state AT the save (the port's step
updates params and moments in place, where JAX's donates them); the
completion fence (writer errors, pickling); and ``CheckpointManager``'s
retention against the JAX package's for one metric sequence."""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

from ray_tpu.train import checkpoint as jckpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import train_step as tts
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state(seed=0):
    cfg = tllama.PRESETS["debug"]
    opt = tts.default_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    params, state = tts.init_state(
        cfg, opt, generator=torch.Generator().manual_seed(seed),
        device="cpu")
    return cfg, opt, params, state


def _assert_same(got, want, path="root"):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got.view(torch.uint8) if got.dtype == torch.bool
                           else got, want.view(torch.uint8)
                           if want.dtype == torch.bool else want), path
    else:
        assert got == want, path


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def test_save_load_bitwise(tmp_path):
    _, _, params, state = _state()
    g = torch.Generator().manual_seed(3)
    extra = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
             "scalar": torch.tensor(2.5), "ids": torch.arange(7),
             "flags": torch.tensor([True, False, True]),
             "empty": torch.zeros(0, 4),
             "strided": torch.arange(24.0).reshape(4, 6).T,
             "nested": [1, 2.0, "three", None, (torch.ones(2),)]}
    tree = (params, state, extra)
    ck = Checkpoint.from_directory(str(tmp_path / "ck"))
    ck.save_pytree(tree, "state")
    back = ck.load_pytree("state", device="cpu")
    _assert_same(back, tree)
    assert back[1]["count"] == 0 and isinstance(back[1]["count"], int)
    # the format: one raw file per tensor under its flat name + an index
    root = tmp_path / "ck" / "state"
    assert (root / "index.json").is_file()
    assert (root / "0" / "layers" / "wq.bin").stat().st_size == \
        params["layers"]["wq"].numel() * 4
    assert (root / "1" / "mu" / "layers" / "wq.bin").is_file()
    assert ck.last_save["bytes"] == sum(
        t.numel() * t.element_size() for t in
        (*tts._leaves(params).values(), *state["mu"].values(),
         *state["nu"].values(), extra["bf16"], extra["scalar"],
         extra["ids"], extra["flags"], extra["empty"], extra["strided"],
         extra["nested"][4][0]))
    # a second save under the name replaces the first whole
    ck.save_pytree({"only": torch.ones(1)}, "state")
    _assert_same(ck.load_pytree("state", device="cpu"),
                 {"only": torch.ones(1)})
    assert not (root / "0").exists()
    assert not any(p.name.startswith(".") for p in (tmp_path / "ck")
                   .iterdir())


def test_async_save_then_in_place_steps_loads_the_state_at_save(tmp_path):
    cfg, opt, params, state = _state(seed=1)
    step = tts.make_train_step(cfg, opt, device="cpu")
    rng = np.random.default_rng(0)
    batch = lambda: {"tokens": rng.integers(0, 256, (2, 17)).astype(np.int32)}
    params, state, _ = step(params, state, batch())   # nonzero moments
    at_save = _clone((params, state))
    ck = Checkpoint.from_directory(str(tmp_path / "ck"))
    ck.save_pytree((params, state), blocking=False)
    for _ in range(3):
        params, state, _ = step(params, state, batch())
    assert not torch.equal(params["layers"]["wq"], at_save[0]["layers"]["wq"])
    ck.wait_pending()
    back = ck.load_pytree(device="cpu")
    _assert_same(back, at_save)
    assert back[1]["count"] == 1 and state["count"] == 4


def test_async_save_error_raises_at_fence(tmp_path, monkeypatch):
    ck = Checkpoint.from_directory(str(tmp_path / "ck"))

    def boom(self, tree, name, ready=None):
        raise RuntimeError("writer exploded")

    monkeypatch.setattr(Checkpoint, "_save_pytree_sync", boom)
    ck.save_pytree({"x": torch.zeros(2)}, blocking=False)
    with pytest.raises(RuntimeError, match="writer exploded"):
        ck.wait_pending()
    ck.wait_pending()   # the error is consumed; the fence is idempotent


def test_pickling_waits_for_pending_saves(tmp_path, monkeypatch):
    release = threading.Event()
    real = Checkpoint._save_pytree_sync

    def slow(self, tree, name, ready=None):
        release.wait(5)
        real(self, tree, name, ready)

    monkeypatch.setattr(Checkpoint, "_save_pytree_sync", slow)
    ck = Checkpoint.from_directory(str(tmp_path / "ck"))
    tree = {"w": torch.arange(8.0), "b": torch.tensor(3.0)}
    ck.save_pytree(tree, blocking=False)
    assert ck._pending and not (tmp_path / "ck" / "state").exists()
    threading.Timer(0.2, release.set).start()
    clone = pickle.loads(pickle.dumps(ck))   # the ack boundary
    assert (tmp_path / "ck" / "state" / "index.json").is_file()
    _assert_same(clone.load_pytree(device="cpu"), tree)


def test_blocking_default_and_dict_checkpoints(tmp_path):
    ck = Checkpoint.from_directory(str(tmp_path / "ck"))
    ck.save_pytree({"x": torch.ones(2)})   # blocking=None blocks
    assert not ck._pending and (tmp_path / "ck" / "state").is_dir()
    d = Checkpoint.from_dict({"epoch": 3, "arr": np.arange(4)})
    back = d.to_dict()
    assert back["epoch"] == 3 and back["arr"].tolist() == [0, 1, 2, 3]
    assert os.path.isdir(d.as_directory())
    with pytest.raises(TypeError, match="file path"):
        ck.save_pytree({"../up": torch.ones(1)})
    with pytest.raises(TypeError, match="cannot checkpoint"):
        ck.save_pytree({"x": object()})


@pytest.mark.parametrize("score_attribute,order,num_to_keep", [
    ("acc", "max", 2), ("loss", "min", 3), (None, "max", 2),
    ("acc", "max", None)])
def test_checkpoint_manager_matches_jax(tmp_path, score_attribute, order,
                                        num_to_keep):
    seq = [{"acc": 0.1, "loss": 3.0}, {"acc": 0.9, "loss": 1.0},
           {"acc": 0.5, "loss": 2.5}, {"acc": 0.7, "loss": 0.5},
           {"acc": 0.7, "loss": 2.0}, {"acc": "bad", "loss": 0.7}]
    out = {}
    for side, (Ck, Mgr) in {"jax": (jckpt.Checkpoint,
                                    jckpt.CheckpointManager),
                            "port": (Checkpoint, CheckpointManager)}.items():
        mgr = Mgr(str(tmp_path / side), num_to_keep=num_to_keep,
                  score_attribute=score_attribute, score_order=order)
        handles = [mgr.register(Ck.from_dict({"i": i}), m)
                   for i, m in enumerate(seq)]
        name = lambda c: os.path.basename(c.path)
        out[side] = {
            "kept": sorted(name(h) for h in handles
                           if os.path.isdir(h.path)),
            "scores": sorted(e["score"] for e in mgr._entries),
            "best": name(mgr.best_checkpoint),
            "latest": name(mgr.latest_checkpoint),
            "payloads": sorted(Ck(h.path).to_dict()["i"] for h in handles
                               if os.path.isdir(h.path))}
    assert out["port"] == out["jax"]
    assert len(out["port"]["kept"]) == (num_to_keep or len(seq))


def test_load_default_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    ck = Checkpoint.from_directory(str(tmp_path / "ck"))
    ck.save_pytree({"x": torch.ones(1)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.load_pytree()
