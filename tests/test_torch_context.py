"""Sequence parallelism of the port (``ray_tpu_torch/parallel/context.py``)
against the JAX package's (``ray_tpu/parallel/context.py``).

``flash_vjp_chunk`` and the pairwise merge are held against JAX's in one
process (JAX's Pallas kernels in interpret mode on the CPU). Ring and
Ulysses attention run on a 4-rank gloo gang (``_torch_gang``) at (sp 4)
and at (sp 2, tp 2), JAX's on its 8 virtual devices at (sp 4, tp 2), the
shapes of JAX's own tests (``tests/test_long_context.py:82-110``): two
q/k/v sets from a numpy seed, 8/4 and 8/2 heads of 16 over 128 positions,
so Ulysses runs both GQA branches (kv heads split over sp, and repeated
up to the q heads first). Outputs within 1e-5, the gradients of sum(o^2)
within 1e-4 of the largest (JAX's tolerances there). JAX's values are
computed once for the module while the gang runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gang as gang
from ray_tpu.ops.pallas import flash as jflash
from ray_tpu.parallel import context as jcontext
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu_torch.ops import flash as tflash
from ray_tpu_torch.ops.attention import NEG_INF, mha
from ray_tpu_torch.parallel import context as tcontext

OUT_TOL = 1e-5
GRAD_REL = 1e-4
LIMIT_S = 120
SETS = {"gqa_split": (8, 4), "gqa_repeat": (8, 2)}   # (q heads, kv heads)
IMPLS = ("ring", "ulysses")
MESHES = {"sp4": {"sp": 4}, "sp2_tp2": {"sp": 2, "tp": 2}}


def _qkv(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(b, s, hq, d), f(b, s, hkv, d), f(b, s, hkv, d)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _jax_sp(q, k, v, impl):
    mesh = jmake_mesh(JMeshConfig.for_devices(8, sp=4, tp=2))
    fn = lambda *a: jcontext.sequence_parallel_attention(*a, impl=impl)
    with jcontext.mesh_scope(mesh):
        o = jax.jit(fn)(q, k, v)
        grads = jax.jit(jax.grad(lambda *a: (fn(*a) ** 2).sum(),
                                 argnums=(0, 1, 2)))(q, k, v)
    return {"o": np.asarray(o),
            **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    tmp = tmp_path_factory.mktemp("context")
    data = {}
    for i, (name, (hq, hkv)) in enumerate(SETS.items()):
        for n, x in zip("qkv", _qkv(7 + i, 2, 128, hq, hkv, 16)):
            data[f"{name}_{n}"] = x
    np.savez(tmp / "qkv.npz", **data)
    g = gang.start("sp_attention", 4, tmp, LIMIT_S, qkv=str(tmp / "qkv.npz"),
                   meshes=MESHES, sets=list(SETS), impls=list(IMPLS),
                   check_heads=True)
    ref = {(name, impl): _jax_sp(*(data[f"{name}_{n}"] for n in "qkv"),
                                 impl)
           for name in SETS for impl in IMPLS}
    return ref, g.result()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(SETS))
def test_sequence_parallel_attention_matches_jax(runs, mesh, impl, name):
    ref, got = runs
    want = ref[(name, impl)]
    for rank in got:
        out = rank[f"{mesh}/{name}/{impl}"]
        assert np.abs(out["o"] - want["o"]).max() < OUT_TOL
        for n in "qkv":
            assert _rel(out[f"d{n}"], want[f"d{n}"]) < GRAD_REL, n


def test_ulysses_head_refusal_matches_jax(runs):
    """Ulysses with q heads that sp does not divide: JAX's ValueError."""
    _, got = runs
    assert got[0]["heads_error"] == "ulysses: q heads 2 not divisible by sp=4"


def test_flash_vjp_chunk_matches_jax():
    """Three k/v chunks of one softmax (positions 0-31, 32-63, 64-95) for
    queries at 32-63: each chunk's (dq, dk, dv) from the global (o, lse)
    at offset 32 (every key visible), 0 (the diagonal) and -32 (fully
    masked: zero shares), against JAX's ``flash_vjp_chunk``; their sum
    is the whole backward."""
    q, _, _ = _qkv(3, 2, 32, 4, 2, 16)
    _, k, v = _qkv(4, 2, 96, 4, 2, 16)
    do = _qkv(5, 2, 32, 4, 2, 16)[0]
    o, lse = jflash.flash_attention_with_lse(q, k, v, causal=True,
                                             q_offset=32)
    o, lse = np.array(o), np.array(lse)
    t = torch.from_numpy
    dq_sum = 0.0
    for c, off in enumerate((32, 0, -32)):
        kc, vc = k[:, 32 * c:32 * (c + 1)], v[:, 32 * c:32 * (c + 1)]
        want = jflash.flash_vjp_chunk(q, kc, vc, o, do, lse, q_offset=off)
        got = tflash.flash_vjp_chunk(t(q), t(kc), t(vc), t(o), t(do),
                                     t(lse), q_offset=off)
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() < OUT_TOL, off
        if off < 0:
            assert all(not g.any() for g in got)
        dq_sum = dq_sum + got[0]
    dq, _, _ = tflash.flash_bwd_reference(t(q), t(k), t(v), t(o), t(lse),
                                          t(do), 32)
    assert torch.allclose(dq_sum, dq, atol=OUT_TOL)


def test_pairwise_merge_matches_jax():
    rng = np.random.default_rng(11)
    o1, o2 = (rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
              for _ in range(2))
    lse1, lse2 = (rng.standard_normal((2, 4, 8)).astype(np.float32)
                  for _ in range(2))
    lse1[0, 0, :3] = NEG_INF            # dead in one partial
    lse1[1, 2, 5], lse2[1, 2, 5] = NEG_INF, NEG_INF   # dead in both
    want = jcontext._merge(o1, lse1, o2, lse2)
    got = tcontext._merge(*(torch.from_numpy(x) for x in (o1, lse1, o2,
                                                          lse2)))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < OUT_TOL
    assert not got[0][1, 5, 2].any() and got[1][1, 2, 5] == NEG_INF


def test_ring_in_memory_matches_whole_sequence():
    """The ring loops with every rank held in memory (``memory_rotation``,
    as ``chip_smoke.py`` drives them on one card): 4 chunks of 32 give the
    whole-sequence forward's (o, lse) and backward's (dq, dk, dv)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 2, 128, 8, 2, 16))
    do = torch.from_numpy(_qkv(10, 2, 128, 8, 2, 16)[0])
    n = 4
    chunks = lambda x, d=1: list(x.chunk(n, d))
    outs = tcontext.ring_forward(chunks(q), chunks(k), chunks(v),
                                 list(range(n)), n, tcontext.memory_rotation)
    o, lse = tflash.flash_fwd_reference(q, k, v)
    assert torch.allclose(torch.cat([x[0] for x in outs], 1), o,
                          atol=OUT_TOL)
    assert torch.allclose(torch.cat([x[1] for x in outs], 2), lse,
                          atol=OUT_TOL)
    grads = tcontext.ring_backward(
        chunks(q), chunks(k), chunks(v), [x[0] for x in outs], chunks(do),
        [x[1] for x in outs], list(range(n)), n, tcontext.memory_rotation)
    whole = tflash.flash_bwd_reference(q, k, v, o, lse, do)
    for i, w in enumerate(whole):
        got = torch.cat([g[i] for g in grads], 1)
        assert _rel(got.numpy(), w.numpy()) < GRAD_REL, i


def test_sp_of_one_is_flash_attention_bit_for_bit():
    """A ring of one merges its one chunk with weight exactly 1 and a
    Ulysses of one exchanges nothing: both equal ``flash_attention``
    forward and backward, bit for bit (what the card's one-rank mesh
    runs)."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(12, 2, 64, 4, 2, 16))
    ref = tflash.flash_attention(q, k, v, causal=True)
    ref_g = torch.autograd.grad(ref, [q, k, v], 2 * ref.detach())
    for fn in (tcontext.ring_attention, tcontext.ulysses_attention):
        o = fn(q, k, v, None)
        assert torch.equal(o, ref)
        for a, b in zip(torch.autograd.grad(o, [q, k, v], 2 * o.detach()),
                        ref_g):
            assert torch.equal(a, b)
    assert torch.equal(
        tcontext.ulysses_attention(q, k, v, None, use_flash=False),
        mha(q, k, v, causal=True))


def test_refusals_match_jax():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="needs a mesh") as t_err:
        tcontext.sequence_parallel_attention(q, q, q)
    with pytest.raises(ValueError, match="needs a mesh") as j_err:
        jcontext.sequence_parallel_attention(*(jnp.zeros((1, 4, 2, 16)),) * 3)
    assert str(t_err.value) == str(j_err.value)
    mesh8 = jmake_mesh(JMeshConfig.for_devices(8, sp=4, tp=2))
    with pytest.raises(ValueError, match="unknown sp impl 'bogus'"):
        jcontext.sequence_parallel_attention(
            *(jnp.zeros((2, 8, 2, 16)),) * 3, impl="bogus", mesh=mesh8)
    with pytest.raises(ValueError, match="unknown sp impl 'bogus'"):
        tcontext.sequence_parallel_attention(q, q, q, impl="bogus",
                                             mesh=object())
    with tcontext.mesh_scope("m"):
        assert tcontext.current_mesh() == "m"
    assert tcontext.current_mesh() is None
