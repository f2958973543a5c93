"""The port's meshes (``ray_tpu_torch/parallel/mesh.py``) against
``ray_tpu.parallel.mesh`` on its 8 virtual CPU devices: the axis order,
``MeshConfig``, ``balanced_factors``, and the rank layouts of
``make_mesh`` and the hybrid meshes (the cases of
``tests/test_hybrid_mesh.py``: rank r of the port sits where JAX puts
device r) with JAX's errors. The DeviceMeshes are built in this one
process as rank r of an 8-rank group with torch's ``fake`` backend,
which runs no collective."""

import contextlib

import jax
import numpy as np
import pytest
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding

CONFIGS = [dict(dp=2, fsdp=2, tp=2), dict(fsdp=8), dict(fsdp=4, tp=2),
           dict(pp=2, fsdp=2, tp=2), dict(dp=2, ep=2, tp=2),
           dict(fsdp=2, sp=2, tp=2)]


@contextlib.contextmanager
def fake_rank(rank: int, world: int = 8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


def test_axis_order_and_config_match_jax():
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for kw in CONFIGS:
        t, j = tmesh.MeshConfig(**kw), jmesh.MeshConfig(**kw)
        assert (t.num_devices, t.axis_sizes()) == (j.num_devices,
                                                   j.axis_sizes())
    for n, kw in ((8, dict(tp=2)), (8, dict(tp=2, ep=2)), (16, dict(dp=2))):
        assert dataclass_fields(tmesh.MeshConfig.for_devices(n, **kw)) == \
            dataclass_fields(jmesh.MeshConfig.for_devices(n, **kw))
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="not divisible"):
            mod.MeshConfig.for_devices(6, tp=4)


def dataclass_fields(cfg) -> dict:
    return {a: getattr(cfg, a) for a in jmesh.AXIS_ORDER}


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12, 16, 64, 128])
@pytest.mark.parametrize("k", [2, 3])
def test_balanced_factors_match_jax(n, k):
    assert tmesh.balanced_factors(n, k) == jmesh.balanced_factors(n, k)


@pytest.mark.parametrize("kw", CONFIGS)
def test_make_mesh_places_rank_r_where_jax_puts_device_r(kw):
    want = _ids(jmesh.make_mesh(jmesh.MeshConfig(**kw), jax.devices()))
    with fake_rank(5):
        m = tmesh.make_mesh(tmesh.MeshConfig(**kw), device_type="cpu")
        assert m.mesh_dim_names == tmesh.AXIS_ORDER
        np.testing.assert_array_equal(m.mesh.numpy(), want)
        # the compute mesh keeps the axes of size > 1, in order
        cm = sharding.compute_mesh(m)
        assert cm.mesh_dim_names == tuple(
            a for a in tmesh.AXIS_ORDER if kw.get(a, 1) > 1)
        coord = np.argwhere(want == 5)[0]
        assert list(cm.get_coordinate()) == [
            c for c, a in zip(coord, tmesh.AXIS_ORDER) if kw.get(a, 1) > 1]


def test_make_mesh_errors_and_cuda_default():
    with fake_rank(0):
        with pytest.raises(ValueError, match="mesh needs 16 devices, have 8"):
            tmesh.make_mesh(tmesh.MeshConfig(fsdp=16), device_type="cpu")
    with pytest.raises(RuntimeError, match="default process group"):
        tmesh.make_mesh(tmesh.MeshConfig(), device_type="cpu")
    with fake_rank(0, world=1):
        one = tmesh.make_mesh(tmesh.MeshConfig(), device_type="cpu")
        assert sharding.compute_mesh(one).mesh_dim_names == ("fsdp",)


def _two_slices():
    return [list(range(4)), list(range(4, 8))]


HYBRID = [(dict(dp=2, fsdp=2, tp=2), ("dp",)),
          (dict(pp=2, fsdp=2, tp=2), ("pp",)),
          (dict(dp=2, fsdp=4), ("dp",))]


@pytest.mark.parametrize("kw,dcn", HYBRID)
def test_hybrid_layout_matches_jax(kw, dcn):
    devs = jax.devices()
    want = _ids(jmesh.make_hybrid_mesh(jmesh.MeshConfig(**kw),
                                       [devs[:4], devs[4:8]], dcn))
    got = tmesh.hybrid_layout(tmesh.MeshConfig(**kw), _two_slices(), dcn)
    np.testing.assert_array_equal(got, want)
    with fake_rank(3):
        m = tmesh.make_hybrid_mesh(tmesh.MeshConfig(**kw), _two_slices(),
                                   dcn, device_type="cpu")
        np.testing.assert_array_equal(m.mesh.numpy(), want)


def test_hybrid_mesh_dp_crosses_slices_inner_axes_stay_within():
    arr = tmesh.hybrid_layout(tmesh.MeshConfig(dp=2, fsdp=2, tp=2),
                              _two_slices())
    slice_of = {r: i for i, s in enumerate(_two_slices()) for r in s}
    dp = tmesh.AXIS_ORDER.index("dp")
    for idx in np.ndindex(*[n for i, n in enumerate(arr.shape) if i != dp]):
        full = list(idx)
        full.insert(dp, slice(None))
        assert {slice_of[r] for r in arr[tuple(full)]} == {0, 1}
    for d in range(arr.shape[dp]):
        sel = [slice(None)] * arr.ndim
        sel[dp] = d
        assert len({slice_of[r] for r in arr[tuple(sel)].ravel()}) == 1


@pytest.mark.parametrize("kw,slices,dcn,match", [
    (dict(dp=4, fsdp=2), None, ("dp",), "multiply to the .*slice count"),
    (dict(dp=2, fsdp=8), None, ("dp",), "needs .* devices"),
    (dict(dp=2, fsdp=2), "ragged", ("dp",), "equal-sized"),
    (dict(dp=2, fsdp=2), None, ("nope",), "unknown dcn axis"),
])
def test_hybrid_mesh_validation_matches_jax(kw, slices, dcn, match):
    devs = jax.devices()
    jslices = [devs[:4], devs[4:8]]
    tslices = _two_slices()
    if slices == "ragged":
        jslices, tslices = [jslices[0], jslices[1][:2]], [tslices[0],
                                                          tslices[1][:2]]
    with pytest.raises(ValueError, match=match):
        jmesh.make_hybrid_mesh(jmesh.MeshConfig(**kw), jslices, dcn)
    with pytest.raises(ValueError, match=match):
        tmesh.hybrid_layout(tmesh.MeshConfig(**kw), tslices, dcn)


def test_hybrid_mesh_from_process_slices():
    """Ranks grouped by slice name in order of first appearance; one
    slice degrades to a flat mesh, as JAX's single-process case."""
    assert tmesh.slices_from_process_slices(["b", "a", "b", "a"]) == [
        [0, 2], [1, 3]]
    with fake_rank(0):
        m = tmesh.hybrid_mesh_from_process_slices(
            tmesh.MeshConfig(fsdp=8), ["solo"] * 8, device_type="cpu")
        flat = jmesh.hybrid_mesh_from_process_slices(
            jmesh.MeshConfig(dp=1, fsdp=8), ["solo"])
        np.testing.assert_array_equal(m.mesh.numpy(), _ids(flat))
