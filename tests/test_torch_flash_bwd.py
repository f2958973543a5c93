"""Gradients of ray_tpu_torch's flash attention against the JAX package's.

float32 on the CPU, inputs and cotangents from numpy with a seed. The
port's ``flash_attention`` runs its autograd Function, whose backward is
``flash_bwd``; for a CPU tensor that is the kernels' plain version,
``flash_bwd_reference``. JAX's side is ``jax.grad`` through its Pallas
kernels in interpret mode with 32-row blocks, as
tests/test_long_context.py:48-57 runs them. Tolerance: 1e-4 of max |grad|,
the reference's own gradient tolerance (test_long_context.py:57); both
sides do the same fp32 math in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash as jflash
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash as tflash

REL = 1e-4

# name: (b, s, hq, hkv, causal, q_offset)
CASES = {
    "causal": (2, 96, 4, 2, True, 0),
    "noncausal": (2, 96, 4, 2, False, 0),
    "unaligned_s77": (2, 77, 4, 2, True, 0),
    "mha_4_4": (2, 96, 4, 4, True, 0),
    "gqa_4_1": (1, 64, 4, 1, True, 0),
    "q_offset_40": (2, 96, 4, 2, True, 40),
    "fully_masked": (2, 96, 4, 2, True, -1000),
}


def _inputs(b, s, hq, hkv, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d), np.float32)
    k = rng.standard_normal((b, s, hkv, d), np.float32)
    v = rng.standard_normal((b, s, hkv, d), np.float32)
    w = rng.standard_normal((b, s, hq, d), np.float32)   # the cotangent
    return q, k, v, w


def _port_grads(q, k, v, w, **kw):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tflash.flash_attention(*ts, **kw)
    return torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)


def _jax_grads(q, k, v, w, **kw):
    loss = lambda *a: (jflash.flash_attention(
        *a, block_q=32, block_k=32, **kw) * w).sum()
    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _close(port, ref):
    for name, a, b in zip("qkv", port, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-9)
        assert err < REL, (name, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_grads_match_jax(name):
    b, s, hq, hkv, causal, off = CASES[name]
    q, k, v, w = _inputs(b, s, hq, hkv)
    port = _port_grads(q, k, v, w, causal=causal, q_offset=off)
    ref = _jax_grads(q, k, v, w, causal=causal, q_offset=off)
    if off == -1000:
        # no key is visible to any row: every gradient is exactly zero
        assert all(bool((g == 0).all()) for g in port)
        assert all(bool((np.asarray(g) == 0).all()) for g in ref)
        return
    _close(port, ref)


def test_flash_grads_per_row_offsets_match_jax_rows():
    """A tensor q_offset [b]: each row's gradients equal one JAX call with
    that row's scalar offset."""
    q, k, v, w = _inputs(3, 40, 4, 2, seed=1)
    offs = np.array([0, 25, -10], np.int32)
    port = _port_grads(q, k, v, w, q_offset=torch.from_numpy(offs))
    for r, off in enumerate(offs):
        sl = slice(r, r + 1)
        ref = _jax_grads(q[sl], k[sl], v[sl], w[sl], q_offset=int(off))
        _close([g[sl] for g in port], ref)


@pytest.mark.parametrize("causal,hkv,off", [(True, 2, 0), (False, 4, 0),
                                            (True, 1, 13)])
def test_bwd_reference_matches_autograd_through_mha(causal, hkv, off):
    """In fp32 the plain backward is the exact gradient of the plain
    attention ``mha`` wherever some key is visible (mha's softmax and the
    kernels' saved-lse form differ only in rounding)."""
    q, k, v, w = _inputs(2, 33, 4, hkv, seed=2)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    do = torch.from_numpy(w)
    out = tattn.mha(*ts, causal=causal, q_offset=off)
    want = torch.autograd.grad(out, ts, do)
    qt, kt, vt = (t.detach() for t in ts)
    o, lse = tflash.flash_fwd_reference(qt, kt, vt, off, causal=causal)
    got = tflash.flash_bwd_reference(qt, kt, vt, o, lse, do, off,
                                     causal=causal)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) < REL


def test_per_kernel_references_compose_the_backward():
    """flash_dq then flash_dkv (their plain versions on the CPU) give
    flash_bwd_reference's dq, dk, dv, and delta = rowsum(o * do)."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(2, 50, 4, 2, seed=3))
    o, lse = tflash.flash_fwd_reference(q, k, v, 7)
    dq, delta = tflash.flash_dq(q, k, v, o, lse, w, 7)
    dk, dv = tflash.flash_dkv(q, k, v, lse, delta, w, 7)
    ref = tflash.flash_bwd_reference(q, k, v, o, lse, w, 7)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)
    assert delta.shape == (2, 4, 50)
    torch.testing.assert_close(delta, (o * w).sum(-1).transpose(1, 2))


def test_bwd_reference_keeps_p_in_fp32_and_casts_once():
    """bf16 inputs: dq, dk, dv come back in bf16, equal to the fp32
    computation on the same (widened) values cast once at the end."""
    q, k, v, w = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(1, 24, 4, 2, seed=4))
    o, lse = tflash.flash_fwd_reference(q, k, v)
    got = tflash.flash_bwd_reference(q, k, v, o, lse, w)
    wide = tflash.flash_bwd_reference(q.float(), k.float(), v.float(),
                                      o.float(), lse, w.float())
    for a, b in zip(got, wide):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))


def test_flash_bwd_on_cpu_launches_nothing():
    q, k, v, w = (torch.from_numpy(x).requires_grad_(i < 3)
                  for i, x in enumerate(_inputs(1, 9, 2, 1, seed=5)))
    before = (tflash.flash_fwd.launches, tflash.flash_bwd.launches,
              tflash.flash_dq.launches, tflash.flash_dkv.launches)
    o = tflash.flash_attention(q, k, v)
    torch.autograd.grad((o * w).sum(), (q, k, v))
    after = (tflash.flash_fwd.launches, tflash.flash_bwd.launches,
             tflash.flash_dq.launches, tflash.flash_dkv.launches)
    assert before == after == (0, 0, 0, 0)


def test_flash_bwd_validates_shapes():
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 1, seed=6))
    o, lse = tflash.flash_fwd_reference(q, k, v)
    with pytest.raises(ValueError, match="do .* must match q"):
        tflash.flash_bwd(q, k, v, o, lse, w[:, :4])
    with pytest.raises(ValueError, match="lse"):
        tflash.flash_bwd(q, k, v, o, lse[:, :1], w)
