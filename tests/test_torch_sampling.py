"""ray_tpu_torch's sampling engine against the JAX package's.

The masking rule is JAX's ``_row_sample`` bit for bit in fp32 (the
temperature division, the k-th largest threshold, ties at it kept, top-k
0 and above V disabled), and a row at temperature <= 0 takes the argmax.
The draws are the port's own (``jax.random`` cannot be reproduced in
torch): held to JAX's key-chain property (a seeded request replays; its
tokens do not depend on co-batched rows, the bucket or the tick stride),
to greedy at top-k 1, and to the softmax of the masked logits by a
chi-square test of draw frequencies."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ray_tpu.models import generate as JG
from ray_tpu.models import llama as jllama
from ray_tpu.models import serving as JS
from ray_tpu_torch.models import generate as TG
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import serving as TS
from ray_tpu_torch.models.convert import params_from_jax

PREFIX = list(range(1, 49))


def _jax_masked(logits, temps, top_ks, jit):
    """JAX's masked logits, captured where ``_row_sample`` hands them to
    ``jax.random.categorical``: per row eagerly, or jitted and vmapped over
    the rows as the engine's decode program runs it."""
    box = []
    real = jax.random.categorical

    def capture(key, lg, *args, **kwargs):
        box.append(lg)
        return real(key, lg, *args, **kwargs)

    jax.random.categorical = capture
    try:
        key = jax.random.PRNGKey(0)
        if jit:
            def one(lg, t, k):
                JS._row_sample(lg, t, k, key)
                return box[-1]

            out = jax.jit(jax.vmap(one))(jnp.asarray(logits),
                                         jnp.asarray(temps, jnp.float32),
                                         jnp.asarray(top_ks, jnp.int32))
            return np.asarray(out)
        rows = []
        for lg, t, k in zip(logits, temps, top_ks):
            JS._row_sample(jnp.asarray(lg), jnp.float32(t), jnp.int32(k),
                           key)
            rows.append(np.asarray(box[-1]))
        return np.stack(rows)
    finally:
        jax.random.categorical = real


def _logits_with_ties(seed, b, v):
    rng = np.random.default_rng(seed)
    # quarter steps over a narrow range: many values tie, at the k-th
    # largest too
    return (np.round(rng.standard_normal((b, v)) * 4) / 4).astype(np.float32)


V = 64
TOPKS = [0, 1, 7, 13, V, V + 5]
TEMPS = [0.7, 1.0, 1.3, 0.0, -1.0, 0.35]


@pytest.mark.parametrize("jit", [False, True])
def test_masked_logits_bit_for_bit(jit):
    logits = _logits_with_ties(0, len(TOPKS), V)
    want = _jax_masked(logits, TEMPS, TOPKS, jit)
    got = TS._mask_logits(torch.from_numpy(logits),
                          torch.tensor(TEMPS, dtype=torch.float32),
                          torch.tensor(TOPKS)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # ties at the threshold are kept: a row keeps at least top_k values
    for row, k in zip(got, TOPKS):
        kept = int(np.isfinite(row).sum())
        assert kept == V if k in (0, V, V + 5) else kept >= k


def test_nonpositive_temperature_is_argmax():
    logits = _logits_with_ties(1, 4, V)
    temps = torch.tensor([0.0, -1.0, 0.0, -0.5])
    got = TS._row_sample(torch.from_numpy(logits), temps,
                         torch.tensor([0, 5, V, 1]),
                         torch.tensor([1, 2, 3, 4]),
                         torch.tensor([0, 9, 3, 1]))
    assert got.tolist() == np.argmax(logits, axis=-1).tolist()
    key = jax.random.PRNGKey(3)
    jax_tok = [int(JS._row_sample(jnp.asarray(lg), jnp.float32(t),
                                  jnp.int32(k), key))
               for lg, t, k in zip(logits, temps.tolist(), [0, 5, V, 1])]
    assert got.tolist() == jax_tok


@pytest.mark.parametrize("over", ["draws", "seeds"])
def test_draw_frequencies_match_softmax(over):
    """Chi-square of 40,000 draws of one row (temperature 0.9, top-k 8)
    against the softmax of its masked logits: the statistic must stay
    below the chi-square quantile at 1 - 1e-4 for its degrees of
    freedom. ``draws``: the n-th draws of one seed; ``seeds``: draw 0 of
    40,000 seeds."""
    n = 40_000
    logits = torch.from_numpy(_logits_with_ties(2, 1, 16)[0] / 2)
    temp, topk = torch.full((n,), 0.9), torch.full((n,), 8)
    idx = torch.arange(n)
    seed, draw = ((torch.full((n,), 1234), idx) if over == "draws"
                  else (idx * 7919 + 3, torch.zeros(n, dtype=torch.long)))
    toks = TS._row_sample(logits.expand(n, -1), temp, topk, seed, draw)
    masked = TS._mask_logits(logits[None], temp[:1], topk[:1])[0]
    p = torch.softmax(masked.double(), -1).numpy()
    counts = np.bincount(toks.numpy(), minlength=16)
    support = p > 0
    assert counts[~support].sum() == 0, "drew a masked token"
    expected = p[support] * n
    chi2 = float(((counts[support] - expected) ** 2 / expected).sum())
    bound = stats.chi2.ppf(1 - 1e-4, int(support.sum()) - 1)
    assert chi2 < bound, (chi2, bound, counts, expected)


def test_gumbel_noise_is_a_pure_function_of_seed_draw_vocab():
    seed = torch.tensor([5, 5, 6, -3, 2**40 + 5])
    draw = torch.tensor([0, 1, 0, 0, 0])
    g = TS._gumbel(seed, draw, 1000)
    assert torch.isfinite(g).all()
    assert torch.equal(g, TS._gumbel(seed, draw, 1000))
    # each row is its own (seed, draw), whatever the batch around it
    assert torch.equal(g[2], TS._gumbel(seed[2:3], draw[2:3], 1000)[0])
    # a draw number, a seed, or the seed's high word changes the noise
    for i, j in ((0, 1), (0, 2), (0, 4)):
        assert not torch.equal(g[i], g[j])


# ---------------------------------------------------------------------------
# the sampling batcher and engine
# ---------------------------------------------------------------------------


def _setup(seed=0):
    jcfg = dataclasses.replace(jllama.PRESETS["debug"],
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.PRESETS["debug"],
                               compute_dtype=torch.float32, attn_impl="flash")
    jp = jllama.init_params(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    return _setup()


def _batcher(model, sampling=True, max_slots=4):
    _, tcfg, _, tp = model
    return TS.ContinuousBatcher(tp, tcfg, max_slots=max_slots, max_len=160,
                                sampling=sampling, device="cpu")


def _run_one(b, prompt, n=8, k=1, **kw):
    rid, first, done = b.submit_ex(np.asarray(prompt), n, **kw)
    toks = [first]
    while not done:
        for r, t, d in b.step_many(k):
            if r == rid:
                toks.extend(t)
                done = d
    return toks


def test_sampling_seeded_determinism(model):
    b = _batcher(model)
    prompt = PREFIX + [60]
    a1 = _run_one(b, prompt, temperature=0.8, top_k=7, seed=11)
    a2 = _run_one(b, prompt, temperature=0.8, top_k=7, seed=11)
    b1 = _run_one(b, prompt, temperature=0.8, top_k=7, seed=12)
    assert a1 == a2, "same seed must replay the same draw chain"
    assert a1 != b1
    assert all(0 <= t < 256 for t in a1 + b1)
    # admission's first token is draw 0 of the chain
    _, tcfg, _, tp = model
    cache = TG.init_cache(tcfg, 1, 160, device="cpu")
    logits = TG._forward_with_cache(
        tp, torch.tensor([prompt]), tcfg, cache, 0)[:, -1]
    first = TS._row_sample(logits, torch.tensor([0.8]), torch.tensor([7]),
                           torch.tensor([11]), torch.tensor([0]))
    assert int(first[0]) == a1[0]


@pytest.mark.parametrize("stride", [1, 8])
def test_sampling_independent_of_cobatching_and_stride(model, stride):
    """A sampled request's tokens are the same alone (lone-row bucket,
    single steps) as beside greedy and other sampled traffic in the full
    bucket, at tick stride 1 or 8."""
    prompt = PREFIX + [60]
    solo = _run_one(_batcher(model), prompt, n=17, temperature=0.9,
                    top_k=20, seed=5)
    b = _batcher(model)
    others = [(list(range(101, 121)), {}),
              (list(range(30, 41)), {"temperature": 1.2, "seed": 6})]
    got = {}
    for p, kw in others[:1]:
        rid, first, _ = b.submit_ex(np.asarray(p), 24, **kw)
        got[rid] = [first]
    for r, toks, _ in b.step_many(3):   # the others run ahead
        got[r].extend(toks)
    rid, first, _ = b.submit_ex(np.asarray(prompt), 17, temperature=0.9,
                                top_k=20, seed=5)
    got[rid] = [first]
    p, kw = others[1]
    r2, f2, _ = b.submit_ex(np.asarray(p), 30, **kw)
    got[r2] = [f2]
    while b.num_active:
        for r, toks, _ in b.step_many(stride):
            got[r].extend(toks)
    assert got[rid] == solo


def test_greedy_rows_on_sampling_engine_equal_greedy(model):
    jcfg, _, jp, _ = model
    prompt = PREFIX + [60, 61]
    greedy = _run_one(_batcher(model, sampling=False), prompt, n=10)
    samp = _batcher(model)
    # a greedy row beside a sampled one, in the full bucket
    rs, fs, _ = samp.submit_ex(np.asarray(PREFIX[:20]), 12, temperature=1.0,
                               seed=3)
    rg, fg, _ = samp.submit_ex(np.asarray(prompt), 10)
    got = {rs: [fs], rg: [fg]}
    while samp.num_active:
        for r, toks, _ in samp.step_many(4):
            got[r].extend(toks)
    want = np.asarray(JG.generate(jp, jnp.asarray(prompt, jnp.int32)[None],
                                  jcfg, max_new_tokens=10))[0].tolist()
    assert got[rg] == greedy == want


def test_top_k_one_equals_greedy(model):
    prompt = PREFIX + [70]
    greedy = _run_one(_batcher(model, sampling=False), prompt, n=10)
    assert _run_one(_batcher(model), prompt, n=10, k=4, temperature=0.8,
                    top_k=1, seed=99) == greedy


def test_greedy_engine_refuses_sampling(model):
    b = _batcher(model, sampling=False)
    for kw in ({"temperature": 0.5}, {"top_k": 3}):
        with pytest.raises(ValueError, match="sampling"):
            b.submit_ex(np.asarray(PREFIX), 4, **kw)
    assert len(b._free) == b.max_slots   # no slot leaked
    _, tcfg, _, tp = model
    eng = TS.ContinuousEngine(tp, tcfg, max_slots=2, max_len=64,
                              warmup=False, device="cpu")
    try:
        with pytest.raises(ValueError, match="sampling"):
            eng.submit_stream(np.asarray(PREFIX[:8]), 4, temperature=0.5)
    finally:
        eng.shutdown()


def test_sampling_engine_streams_replay_the_batcher(model):
    """The threaded sampling engine (warmed on the sampling path, stride
    4) streams the same sampled tokens as a lone batcher run."""
    _, tcfg, _, tp = model
    prompts = [PREFIX + [60], list(range(101, 121))]
    kws = [{"temperature": 0.9, "top_k": 20, "seed": 5},
           {"temperature": 1.1, "seed": 8}]
    want = [_run_one(_batcher(model), p, n=13, **kw)
            for p, kw in zip(prompts, kws)]
    eng = TS.ContinuousEngine(tp, tcfg, max_slots=2, max_len=160,
                              decode_stride=4, sampling=True, device="cpu")
    try:
        qs = [eng.submit_stream(p, 13, **kw) for p, kw in zip(prompts, kws)]
        got = [list(iter(lambda q=q: q.get(timeout=60), None)) for q in qs]
    finally:
        eng.shutdown()
    assert got == want
