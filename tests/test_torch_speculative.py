"""Parity of the port's speculative-decoding math (``engine/speculative.py``)
with the JAX package's.

Inputs come from numpy seeds. ``spec_accept`` gets the JAX function's own
draws: the uniforms of ``fold_in(rng, 0)`` and the Gumbel noise of
``fold_in(rng, 1)``, which is what ``jax.random.categorical`` adds to the
log-probabilities before its argmax. Token outputs must be equal; the
sampling distribution within ``PROB_ATOL`` (one f32 softmax, filtered the
same way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.engine import speculative as jspec
from distrl_llm_tpu_torch.engine import speculative as tspec

PROB_ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _seq_buf(rng, r, w, vocab, lens):
    buf = rng.integers(0, vocab, (r, w)).astype(np.int32)
    for i, n in enumerate(lens):
        buf[i, n:] = 0
    return buf


@pytest.mark.parametrize("k,d", [(1, 1), (2, 4), (3, 2)])
def test_propose_ngram_drafts_matches_jax(k, d):
    """Random rows over a tiny vocabulary (many matches, several per row:
    the latest one wins), rows whose tail never recurs (last token
    repeated), rows shorter than k, and drafts that run past the buffer."""
    rng = np.random.default_rng(k * 10 + d)
    r, w = 12, 24
    lens = np.array([24, 20, 3, 1, 2, 17, 24, 9, 5, 12, 24, 8])
    buf = _seq_buf(rng, r, w, 4, lens)
    # a row of distinct tokens: no earlier occurrence of its tail
    buf[1, :20] = np.arange(20) + 100
    # a row whose tail recurs twice: the later occurrence must win
    buf[5, :17] = [7, 8, 1, 2, 3, 7, 8, 4, 5, 6, 9, 9, 9, 9, 9, 7, 8]
    want = np.asarray(jspec.propose_ngram_drafts(jnp.asarray(buf), jnp.asarray(lens), k=k, d=d))
    got = tspec.propose_ngram_drafts(_t(buf), _t(lens), k=k, d=d)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got.shape == (r, d)
    assert (got[1] == 119).all()  # no match: the last token repeated
    if k == 2:
        np.testing.assert_array_equal(got[5].numpy(), [4, 5, 6, 9][:d])


@pytest.mark.parametrize("temperature,top_p,impl", [
    (0.0, 0.95, "bisect"), (1.2, 0.95, "bisect"), (0.6, 0.9, "exact"), (1.0, 1.0, "bisect")])
def test_sampling_probs_matches_jax(temperature, top_p, impl):
    rng = np.random.default_rng(3)
    logits = (2.0 * rng.standard_normal((5, 3, 257))).astype(np.float32)
    want = np.asarray(jspec.sampling_probs(jnp.asarray(logits), temperature, top_p,
                                           top_p_impl=impl))
    got = tspec.sampling_probs(_t(logits), temperature, top_p, top_p_impl=impl)
    assert got.shape == logits.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL, rtol=0)
    if temperature == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)  # one-hot, exactly
    # the multiway filter is ported too: its distribution equals JAX's
    want_mw = np.asarray(jspec.sampling_probs(jnp.asarray(logits), 1.0, 0.9,
                                              top_p_impl="bisect_mw"))
    got_mw = tspec.sampling_probs(_t(logits), 1.0, 0.9, top_p_impl="bisect_mw")
    np.testing.assert_allclose(got_mw.numpy(), want_mw, atol=PROB_ATOL, rtol=0)


def _jax_draws(rng, r, d, v):
    u = jax.random.uniform(jax.random.fold_in(rng, 0), (r, d))
    g = jax.random.gumbel(jax.random.fold_in(rng, 1), (r, v))
    return _t(u), _t(g)


def _accept_case(seed, r=64, d=4, v=12, full_q=False):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(v, 0.3), size=(r, d + 1)).astype(np.float32)
    draft = rng.integers(0, v, (r, d)).astype(np.int32)
    # some rows draft their distribution's argmax (likely accepted)
    hot = rng.random((r, d)) < 0.5
    draft = np.where(hot, probs[:, :d].argmax(-1), draft).astype(np.int32)
    q = (rng.dirichlet(np.full(v, 0.5), size=(r, d)).astype(np.float32)
         if full_q else None)
    return probs, draft, q


@pytest.mark.parametrize("full_q", [False, True], ids=["point_mass", "full_q"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_accept_matches_jax_given_its_draws(seed, full_q):
    probs, draft, q = _accept_case(seed, full_q=full_q)
    r, dp1, v = probs.shape
    rng = jax.random.PRNGKey(seed)
    jq = None if q is None else jnp.asarray(q)
    emit, n_emit, n_acc = jspec.spec_accept(rng, jnp.asarray(probs), jnp.asarray(draft), jq)
    u, g = _jax_draws(rng, r, dp1 - 1, v)
    te, tn, ta = tspec.spec_accept(u, g, _t(probs), _t(draft), None if q is None else _t(q))
    np.testing.assert_array_equal(te.numpy(), np.asarray(emit))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(n_emit))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(n_acc))
    assert (tn.numpy() == ta.numpy() + 1).all()
    # a spread of outcomes: full acceptance, rejections at every position
    assert len(set(ta.tolist())) >= 3


def test_spec_accept_greedy_is_exact():
    """Greedy (one-hot p): a draft survives exactly while it equals the
    argmax, and the emitted token after it is the argmax, whatever the
    noise."""
    rng = np.random.default_rng(5)
    r, d, v = 32, 3, 9
    logits = rng.standard_normal((r, d + 1, v)).astype(np.float32)
    probs = tspec.sampling_probs(_t(logits), 0.0, 1.0)
    best = logits.argmax(-1)
    draft = np.where(rng.random((r, d)) < 0.6, best[:, :d],
                     (best[:, :d] + 1) % v).astype(np.int32)
    u = tspec.draw_uniforms((r, d), torch.Generator().manual_seed(0), "cpu")
    g = tspec.draw_gumbel((r, v), torch.Generator().manual_seed(1), "cpu")
    emit, n_emit, _ = tspec.spec_accept(u, g, probs, _t(draft))
    for i in range(r):
        m = 0
        while m < d and draft[i, m] == best[i, m]:
            m += 1
        assert int(n_emit[i]) == m + 1
        np.testing.assert_array_equal(emit[i, :m + 1].numpy(), best[i, :m + 1])


@pytest.mark.parametrize("full_q", [False, True], ids=["point_mass", "full_q"])
def test_acceptance_leaves_the_distribution_unchanged(full_q):
    """Chi-square test (as the JAX package's): over many draws of one row,
    the first emitted token is distributed as p[0], whether the draft was
    accepted or a token resampled from the residual."""
    v, draws = 6, 20000
    p0 = np.array([0.35, 0.25, 0.15, 0.12, 0.08, 0.05], np.float32)
    probs = np.broadcast_to(p0, (draws, 2, v)).copy()
    rng = np.random.default_rng(11)
    if full_q:
        q = rng.dirichlet(np.full(v, 1.0), size=(1, 1)).astype(np.float32)
        q = np.broadcast_to(q, (draws, 1, v)).copy()
        draft = np.array([rng.choice(v, p=q[0, 0] / q[0, 0].sum()) for _ in range(draws)])
    else:
        q = None
        draft = np.full(draws, 2)  # a point mass on token 2
    gen = torch.Generator().manual_seed(7)
    u = tspec.draw_uniforms((draws, 1), gen, "cpu")
    g = tspec.draw_gumbel((draws, v), gen, "cpu")
    emit, _, _ = tspec.spec_accept(u, g, _t(probs), _t(draft[:, None].astype(np.int32)),
                                   None if q is None else _t(q))
    counts = np.bincount(emit[:, 0].numpy(), minlength=v)
    expected = p0 / p0.sum() * draws
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # 5 degrees of freedom: P(chi2 > 20.5) = 0.001
    assert chi2 < 20.5, (chi2, counts, expected)


def test_draws_are_in_range():
    gen = torch.Generator().manual_seed(0)
    u = tspec.draw_uniforms((1000, 50), gen, "cpu")
    assert (u > 0).all() and (u < 1).all()
    g = tspec.draw_gumbel((1000, 50), gen, "cpu")
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.02  # the Euler-Mascheroni mean
