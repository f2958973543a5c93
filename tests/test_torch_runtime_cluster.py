"""The port's cluster scheduling against JAX's, on two-node
``cluster_utils.Cluster``s (a head without accelerators and a node with
four: JAX's TPU chips, the port's fake GPUs): placement groups and their
bundle indices, the GPU indices each request gets against JAX's chip
indices for the same requests, and what the port keeps apart from JAX's
runtime (a worker's modules, the session root, the state file, the
shared-memory prefix). Both clusters run side by side, one each for the
module; results compare exactly."""

import json

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster import cluster_utils as jcu
from ray_tpu.core import resources as jres
from ray_tpu_torch.cluster import cluster_utils as tcu
from ray_tpu_torch.core import resources as tres

import _torch_runtime_cases as cases

cloudpickle.register_pickle_by_value(cases)


def _shutdown_all():
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()


@pytest.fixture(scope="module")
def clusters():
    _shutdown_all()
    jc = jcu.Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    jt = jc.add_node(num_cpus=4, num_tpus=4)
    tc = tcu.Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    tt = tc.add_node(num_cpus=4, num_gpus=4)
    jc.connect_driver()
    tc.connect_driver()
    yield {"ray_tpu": jt.node_id, "ray_tpu_torch": tt.node_id}
    tc.shutdown()
    jc.shutdown()


def _both(program, clusters, with_target=False):
    fn = getattr(cases, program)
    return [fn(pkg, clusters[pkg]) if with_target else fn(pkg)
            for pkg in ("ray_tpu", "ray_tpu_torch")]


def test_placement_groups_match_jax(clusters):
    want, got = _both("placement", clusters, with_target=True)
    # the bundles name each runtime's accelerator
    want["bundles"] = [{("GPU" if k == "TPU" else k): v
                        for k, v in b.items()} for b in want["bundles"]]
    assert got == want
    assert got["ready"] and got["bundle0_on_target"] \
        and got["task_on_target"] and got["spread_nodes"] == 2
    assert len(got["task_ids"]) == 2 and not got["too_big_ready"]


def test_slice_groups_carry_gpu_bundles(clusters):
    want, got = _both("slice_groups", clusters, with_target=True)
    want["bundles"] = [{("GPU" if k == "TPU" else k): v
                        for k, v in b.items()} for b in want["bundles"]]
    assert got == want
    assert got["ready"] and got["on_target"] and not got["two_hosts_ready"]
    assert got["bundles"] == [{"GPU": 2.0, "CPU": 1.0}]


def test_gpu_indices_match_jax_chip_indices(clusters):
    want, got = _both("accelerator_sequence", clusters)
    assert got == want == {"a": [0], "b": [1, 2], "c": [3], "d": [0, 1]}


@pytest.mark.parametrize("seq", [
    [("take", 1), ("take", 2), ("give", 0), ("take", 2), ("give", 1),
     ("take", 1)],
    [("take", 4), ("give", 0), ("take", 3), ("take", 1), ("give", 1),
     ("give", 2), ("take", 2)],
])
def test_node_gpu_instances_match_jax_chips(seq):
    """``NodeResources`` on four GPUs hands out JAX's chip indices for the
    same allocate/release sequence (``give i`` releases the i-th take)."""
    def run(mod, name):
        node = mod.NodeResources({"CPU": 8, name: 4})
        taken, out = [], []
        for op, n in seq:
            if op == "take":
                req = mod.ResourceSet({"CPU": 1, name: n})
                taken.append((req, node.allocate(req)))
                out.append(taken[-1][1].get(name))
            else:
                node.release(*taken[n])
                out.append(None)
        return out, node.available.get(name)

    assert run(tres, "GPU") == run(jres, "TPU")


def test_port_worker_imports_no_jax(clusters):
    f = ray_tpu_torch.remote(cases.worker_modules)
    seen = ray_tpu_torch.get([f.remote() for _ in range(3)], timeout=120)
    for s in seen:
        assert "jax" not in s["roots"] and "jaxlib" not in s["roots"]
        assert "ray_tpu" not in s["roots"]
        assert "ray_tpu_torch" in s["roots"]
        assert "torch" not in s["roots"]   # a CPU task never pays for it
    jseen = ray_tpu.get(ray_tpu.remote(cases.worker_modules).remote())
    assert "ray_tpu" in jseen["roots"] and "ray_tpu_torch" not in \
        jseen["roots"]


def test_session_roots_and_state_files_are_the_ports_own(tmp_path,
                                                          monkeypatch):
    from ray_tpu._private import config as jconfig
    from ray_tpu.cluster import node_main as jnode
    from ray_tpu_torch._private import config as tconfig
    from ray_tpu_torch.cluster import node_main as tnode
    from ray_tpu_torch.cluster import object_store as tstore

    import os
    import tempfile

    from ray_tpu_torch.train import trainer as ttrainer

    # the port's roots follow the TMPDIR in use and are never JAX's
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmpdir"))
    root = tconfig.Config().session_dir_root
    assert root == str(tmp_path / "tmpdir" / "ray_tpu_torch")
    assert root != jconfig.Config().session_dir_root

    class RunDir(Exception):
        pass

    def manager(run_dir, **kw):       # fit's first step past the run dir
        raise RunDir(run_dir)

    monkeypatch.setattr(ttrainer, "CheckpointManager", manager)
    with pytest.raises(RunDir) as run_dir:
        ttrainer.TorchTrainer(lambda: None, run_config=ttrainer.RunConfig(
            name="r")).fit()
    assert run_dir.value.args[0] == os.path.join(
        str(tmp_path / "tmpdir"), "ray_tpu_torch_results", "r")
    assert tstore.SESSION_PREFIX == "torch_session_"
    # even under one shared root, the port never reads JAX's state file
    monkeypatch.setattr(tconfig.get_config(), "session_dir_root",
                        str(tmp_path))
    monkeypatch.setattr(jconfig.get_config(), "session_dir_root",
                        str(tmp_path))
    assert jnode.session_latest_path() == tnode.session_latest_path()
    with open(jnode.session_latest_path(), "w") as f:
        json.dump({"session_name": "session_0123456789ab",
                   "gcs_address": "127.0.0.1:1"}, f)
    assert jnode.read_session_latest()["session_name"] \
        == "session_0123456789ab"
    assert tnode.read_session_latest() is None
    from ray_tpu_torch._private.ids import JobID
    from ray_tpu_torch.cluster.driver_backend import start_or_connect

    with pytest.raises(ConnectionError, match="no running cluster"):
        start_or_connect("auto", JobID.from_random())
    with open(tnode.session_latest_path(), "w") as f:
        json.dump({"session_name": "torch_session_0123456789ab"}, f)
    assert tnode.read_session_latest()["session_name"].startswith(
        "torch_session_")


def test_worker_entry_point_is_the_ports():
    import inspect

    from ray_tpu_torch.cluster import raylet

    src = inspect.getsource(raylet.Raylet._spawn_worker)
    assert '"ray_tpu_torch.cluster.worker_main"' in src
    assert '"ray_tpu.cluster.worker_main"' not in src


def test_gpu_count_and_pinning(tmp_path, monkeypatch):
    """The count: device nodes this process may open, narrowed by
    ``CUDA_VISIBLE_DEVICES``, overridden by ``RT_NUM_GPUS``; a worker's
    pin maps the node's instances through the raylet's own list."""
    from ray_tpu_torch._private import accelerator as acc

    nodes = [str(tmp_path / f"nvidia{i}") for i in range(3)]
    for n in nodes[1:]:
        open(n, "w").close()          # nvidia0 cannot be opened
    monkeypatch.setattr(acc.glob, "glob", lambda pattern: nodes)
    monkeypatch.delenv("RT_NUM_GPUS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert acc.autodetect_num_gpus() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert acc.autodetect_num_gpus() == 1
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,-1,0")
    assert acc.autodetect_num_gpus() == 1
    monkeypatch.setenv("RT_NUM_GPUS", "4")
    assert acc.autodetect_num_gpus() == 4
    env = {}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    acc.set_visible_gpus([1], env)
    assert env == {"CUDA_VISIBLE_DEVICES": "3"}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    acc.set_visible_gpus([0, 1], env)
    assert env == {"CUDA_VISIBLE_DEVICES": "0,1"}


def test_cuda_tensor_needs_cuda_to_be_read():
    """A CUDA tensor's bytes read in a process without CUDA raise,
    naming the device, rather than coming back on the CPU."""
    import pickle

    import torch

    from ray_tpu_torch._private import serialization as ser

    if torch.cuda.is_available():
        pytest.skip("this process has CUDA: the tensor would be read")
    buf = pickle.PickleBuffer(torch.arange(4, dtype=torch.float32).numpy())
    with pytest.raises(RuntimeError, match="CUDA device"):
        ser._rebuild_tensor(buf, "float32", (4,), "cuda", False, False)
    back = ser._rebuild_tensor(buf, "float32", (4,), "cpu", True, False)
    assert back.requires_grad and back.tolist() == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("kind", ["sparse", "quantized", "conj", "neg"])
def test_other_tensors_take_torchs_pickling_as_in_jax(kind):
    """Tensors whose elements are not their strided bytes cross as JAX's
    runtime carries them: by torch's own pickling, layout, dtype and
    conjugate or negative bit kept."""
    import torch

    from ray_tpu._private.serialization import SerializationContext as J
    from ray_tpu_torch._private.serialization import SerializationContext as T

    make = {
        "sparse": lambda: torch.sparse_coo_tensor([[0, 2]], [1.0, 2.0], (4,)),
        "quantized": lambda: torch.quantize_per_tensor(
            torch.tensor([0.5, 1.0, 2.0]), 0.1, 3, torch.quint8),
        "conj": lambda: torch.tensor([1 + 2j, 3 - 1j]).conj(),
        "neg": lambda: torch.tensor([1 + 1j])._neg_view(),
    }[kind]

    def back(ctx):
        s = ctx.serialize({"x": make()})
        x = ctx.deserialize(s.inband, s.buffers)["x"]
        dense = x.dequantize() if x.is_quantized else x.to_dense()
        return (str(x.layout), str(x.dtype), x.is_conj(), x.is_neg(),
                dense.resolve_conj().resolve_neg().tolist())

    assert back(T()) == back(J())
