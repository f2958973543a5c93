"""The port's sharded ViT step against JAX's on a mesh.

As ``test_torch_sharded_train.py`` (fp32 compute, the same bounds and
the same exception for Adam's eps regime), with the data of JAX's own
sharded ViT test (``tests/test_model_vit.py:81``): ``debug``, params from
``key(0)``, the 16-image toy batch, trained through
``make_train_step(loss_fn=cls_loss)`` on both sides; JAX under its
(dp 2, fsdp 2, tp 2) mesh of 8 devices, the port as a gloo gang of 4
ranks under (fsdp 2, tp 2) (a layout changes only the summation order;
dp is held by the Llama test's 8 ranks, and half the ranks halve the
gang's CPU). The gang holds itself to ``LIMIT_S``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gang as gang
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import train_step as jts
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import vit_params_from_jax
from ray_tpu_torch.parallel import sharding
from test_torch_sharded_moe import jax_steps
from test_torch_sharded_train import _check

LIMIT_S = 180
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=50)


def _toy_batch(n=16, seed=0):
    """JAX's ViT toy batch (tests/test_model_vit.py:18)."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n, 32, 32, 3)).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.int32)
    imgs[labels == 1, :16] += 1.0
    imgs[labels == 0, 16:] += 1.0
    return {"images": imgs, "labels": labels}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp("sharded_vit")
    vcfg = dataclasses.replace(jvit.PRESETS["debug"],
                               compute_dtype=jnp.float32)
    tvcfg = dataclasses.replace(tvit.PRESETS["debug"],
                                compute_dtype=torch.float32)
    vp = jax.tree_util.tree_map(np.asarray,
                                jvit.init_params(jax.random.key(0), vcfg))
    batch = _toy_batch()
    torch.save(vit_params_from_jax(vp, tvcfg, device="cpu",
                                   dtype=torch.float32), tmp / "vit.pt")
    np.savez(tmp / "vit.npz", **batch)
    g = gang.start(
        "train", 4, tmp, LIMIT_S, family="vit", preset="debug",
        mesh=dict(fsdp=2, tp=2), impls=["-"], steps=STEPS, opt=OPT,
        params=str(tmp / "vit.pt"), batch=str(tmp / "vit.npz"))
    ref = jax_steps(vcfg, vp, batch,
                    jmake_mesh(JMeshConfig(dp=2, fsdp=2, tp=2),
                               jax.devices()),
                    jvit.sharding_rules(), jts.default_optimizer(**OPT),
                    loss_fn=jvit.cls_loss)
    return ref, g.result()


def test_vit_step_matches_jax(runs):
    ref, got = runs
    _check(got[0]["-"], ref, OPT)


def test_vit_placements_follow_its_rules(runs):
    class Mesh:
        mesh_dim_names = ("fsdp", "tp")

    _, got = runs
    rules = tvit.sharding_rules()
    for rank in got:
        for name, places in rank["-"]["placements"].items():
            assert places == sharding.placements(rules.spec_for(name),
                                                 Mesh()), name
