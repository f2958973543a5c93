"""ray_tpu_torch ops against the JAX package on the same numpy inputs.

Everything runs in float32 on the CPU, where the port's flash wrapper runs
the kernel's plain PyTorch version and JAX's Pallas kernel runs in
interpret mode (as tests/test_long_context.py runs it). Tolerance: 1e-5
absolute, the reference's own kernel tolerance
(tests/test_long_context.py:34): both sides compute the same fp32 math and
differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu.ops.pallas import flash as jflash
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash as tflash
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rope as trope

TOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _qkv(b=2, s=96, hq=4, hkv=2, d=16, sk=None, seed=7):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.standard_normal((b, s, hq, d), np.float32)
    k = rng.standard_normal((b, sk, hkv, d), np.float32)
    v = rng.standard_normal((b, sk, hkv, d), np.float32)
    return q, k, v


def _close(port, ref, tol=TOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    err = np.abs(_np(port) - _np(ref)).max()
    assert err < tol, err


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    w = rng.standard_normal((64,), np.float32)
    _close(tnorms.rmsnorm(_t(x), _t(w), 1e-5),
           jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("with_positions", [False, True])
def test_rope_matches_jax(with_positions):
    rng = np.random.default_rng(1)
    b, s, h, d, table = 2, 12, 3, 16, 40
    x = rng.standard_normal((b, s, h, d), np.float32)
    sin_t, cos_t = trope.rope_angles(table, d, 10000.0)
    sin_j, cos_j = jrope.rope_angles(table, d, 10000.0)
    _close(sin_t, sin_j)
    _close(cos_t, cos_j)
    pos = rng.integers(0, table, size=(b, s)) if with_positions else None
    port = trope.apply_rope(_t(x), sin_t, cos_t,
                            None if pos is None else _t(pos))
    ref = jrope.apply_rope(jnp.asarray(x), sin_j, cos_j,
                           None if pos is None else jnp.asarray(pos))
    _close(port, ref)


@pytest.mark.parametrize("case", ["gqa_causal", "mha_noncausal",
                                  "q_offset", "segment_ids", "bias"])
def test_mha_matches_jax(case):
    hkv = 4 if case == "mha_noncausal" else 2
    q, k, v = _qkv(s=24, hkv=hkv, seed=3)
    kw_t, kw_j = {}, {}
    if case == "mha_noncausal":
        kw_t["causal"] = kw_j["causal"] = False
    if case == "q_offset":
        q = q[:, :5]
        kw_t["q_offset"] = kw_j["q_offset"] = 19
    if case == "segment_ids":
        seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), 8, axis=1)
        kw_t["segment_ids"], kw_j["segment_ids"] = _t(seg), jnp.asarray(seg)
    if case == "bias":
        bias = np.random.default_rng(4).standard_normal(
            (2, 4, 24, 24)).astype(np.float32)
        kw_t["bias"], kw_j["bias"] = _t(bias), jnp.asarray(bias)
    port = tattn.mha(_t(q), _t(k), _t(v), **kw_t)
    ref = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_j)
    _close(port, ref)


def test_mha_per_row_offsets_match_jax_rows():
    """A tensor q_offset gives each row its own causal position, as one
    JAX call per row with a scalar offset."""
    q, k, v = _qkv(b=3, s=1, sk=32, seed=5)
    offs = np.array([0, 17, 31])
    port = tattn.mha(_t(q), _t(k), _t(v), q_offset=torch.tensor(offs))
    for r, off in enumerate(offs):
        ref = jattn.mha(jnp.asarray(q[r:r + 1]), jnp.asarray(k[r:r + 1]),
                        jnp.asarray(v[r:r + 1]), q_offset=int(off))
        _close(port[r:r + 1], ref)


# The cases of TestFlashKernel (tests/test_long_context.py:29-74) except
# gradients: (seq, causal, q_offset).
FLASH_CASES = {
    "causal": (96, True, 0),
    "noncausal": (96, False, 0),
    "unaligned_s77": (77, True, 0),
    "q_offset_40": (96, True, 40),
    "fully_masked": (96, True, -1000),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(name):
    s, causal, off = FLASH_CASES[name]
    q, k, v = _qkv(s=s)
    o_t, lse_t = tflash.flash_attention_with_lse(
        _t(q), _t(k), _t(v), causal=causal, q_offset=off)
    o_j, lse_j = jflash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=jnp.int32(off), block_q=32, block_k=32)
    assert tuple(lse_t.shape) == (2, 4, s)
    _close(o_t, o_j)
    o_only = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                    q_offset=off)
    _close(o_only, jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=off, block_q=32, block_k=32))
    if off == -1000:
        # no visible key: the kernel's dead-row rule, not mha's uniform
        # softmax over NEG_INF logits
        assert bool((o_t == 0).all()) and float(lse_t.max()) < -1e9
        return
    _close(lse_t, lse_j)
    _close(o_t, jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, q_offset=off))


def test_flash_per_row_offsets_match_jax_rows():
    """Batched decode: sq=1 against a 40-key cache, each row at its own
    position, as one JAX flash call per row."""
    q, k, v = _qkv(b=3, s=1, sk=40, seed=9)
    offs = np.array([3, 39, 20], np.int32)
    o_t, lse_t = tflash.flash_attention_with_lse(
        _t(q), _t(k), _t(v), q_offset=torch.from_numpy(offs))
    for r, off in enumerate(offs):
        o_j, lse_j = jflash.flash_attention_with_lse(
            jnp.asarray(q[r:r + 1]), jnp.asarray(k[r:r + 1]),
            jnp.asarray(v[r:r + 1]), q_offset=jnp.int32(off),
            block_q=32, block_k=32)
        _close(o_t[r:r + 1], o_j)
        _close(lse_t[r:r + 1], lse_j)


def test_flash_plain_rounds_p_to_v_dtype():
    """bf16 inputs: p is rounded to V's dtype before PV while l sums the
    fp32 p — the Pallas kernel's rule (flash.py:80-84)."""
    q, k, v = _qkv(b=1, s=8, seed=11)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    o, _ = tflash.flash_fwd_reference(qb, kb, vb, causal=False)
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     qb.float().reshape(1, 8, 2, 2, 16), kb.float())
    s = s.reshape(1, 4, 8, 8) * 16 ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bhgqk,bkhd->bhgqd",
                       p.to(torch.bfloat16).float().reshape(1, 2, 2, 8, 8),
                       vb.float()).reshape(1, 4, 8, 16)
    want = (acc / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    assert o.dtype == torch.bfloat16
    torch.testing.assert_close(o, want.permute(0, 2, 1, 3), atol=0, rtol=0)


def test_flash_rejects_grad():
    """flash_fwd and flash_attention_with_lse are forward-only, as JAX's
    flash_attention_with_lse is; flash_attention is differentiable."""
    q, k, v = (_t(x).requires_grad_() for x in _qkv(b=1, s=8))
    with pytest.raises(NotImplementedError, match="forward-only"):
        tflash.flash_fwd(q, k, v)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tflash.flash_attention_with_lse(q, k, v)
    o = tflash.flash_attention(q, k, v)
    grads = torch.autograd.grad(o.sum(), (q, k, v))
    assert all(g.shape == x.shape and bool(torch.isfinite(g).all())
               for g, x in zip(grads, (q, k, v)))
