"""The refill scheduler's turn hook and in-place turn resume
(``engine/paged_engine.py``'s ``turn_hook``, ``_turn_resume_fixup``) against
the live JAX engine.

TINY in f32 (the numpy param tree and adapter of
``test_torch_refill_engine.py``), an EOS set of half the vocabulary so that
greedy turns end early enough to leave window for an observation and a
continuation (the JAX package's own resume tests do the same,
``tests/test_env.py``), 8-token pages, 4 slots, ``decode_chunk=4``, two
prompts x 2 candidates, and the same scripted grants (``ScriptHook``) on
both sides. The JAX engine takes the copying ``asarray`` (``_SnapshotJnp``,
``test_torch_refill_preemption.py`` states why). Tokens, lengths, the
hook's calls and declines, ``turn_resumes`` and
``turn_prefill_saved_tokens`` must be equal; captured behavior logprobs
agree within ``LOGP_ATOL`` (f32: the two frameworks sum in different
orders, as in every refill parity test). The same cases with
``scan_chunk=4`` (the chunk runner; eager on the CPU) must equal the port's
step-by-step rounds bit for bit, logprobs included, and no refill-state
tensor may move across a resume (captured chunks read them by address).
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig
from distrl_llm_tpu.engine import paged_engine as jpe
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu_torch import GenerationEngine, PagedGenerationEngine
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine import paged_engine as tpe
from tests.test_torch_refill_engine import (  # noqa: F401  (weights: the fixture)
    LOGP_ATOL, LORA_SCALE, PAD, weights,
)
from tests.test_torch_refill_preemption import _SnapshotJnp

P = 16
T = 48
N = 2
EOS = list(range(2, TINY.vocab_size, 2))  # half the vocabulary
OBS = (np.arange(5, 21, 2, dtype=np.int32) % 251) | 1  # 8 odd ids: no EOS among them


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """TINY's tensors are too small for torch's intra-op threads to pay."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _snapshot_jnp(monkeypatch):
    monkeypatch.setattr(jpe, "jnp", _SnapshotJnp())


class ScriptHook:
    """A deterministic turn hook: grants each candidate its scripted
    observations in order, then lets it finish (``tests/test_env.py``'s)."""

    def __init__(self, grants=None):
        self.grants = {c: list(seq) for c, seq in (grants or {}).items()}
        self.calls: list[tuple[int, int]] = []
        self.declines: list[int] = []

    def __call__(self, cand_id, gen_tokens):
        self.calls.append((int(cand_id), int(len(gen_tokens))))
        seq = self.grants.get(int(cand_id))
        return np.asarray(seq.pop(0), np.int32) if seq else None

    def declined(self, cand_id):
        self.declines.append(int(cand_id))


# the JAX engines by their knobs, shared across cases: each compiles its
# programs once, which is most of this file's time
_JENGINES: dict = {}


def _engines(weights, *, jax_side=True, **kw):
    common = dict(max_prompt_tokens=P, max_new_tokens=T, eos_token_ids=EOS, pad_token_id=PAD,
                  lora_scale=LORA_SCALE, capture_logprobs=True, page_size=8,
                  scheduler="refill", max_concurrent_rows=4, decode_chunk=4, **kw)
    teng = PagedGenerationEngine(weights["cfg"], cache_dtype=torch.float32, device="cpu",
                                 **common)
    if not jax_side:
        return None, teng
    key = tuple(sorted(kw.items()))
    if key not in _JENGINES:
        _JENGINES[key] = jpe.PagedGenerationEngine(
            TINY, cache_dtype=jax.numpy.float32, autotune=False, scan_chunk=0,
            paged_impl="reference", **common)
    return _JENGINES[key], teng


def _prompts(b=2, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY.vocab_size, size=(b, P)).astype(np.int32)
    return ids, np.ones((b, P), np.int32)


def _greedy(t=T, n=N):
    return (JSamplingConfig(max_tokens=t, temperature=0.0, n=n),
            SamplingConfig(max_tokens=t, temperature=0.0, n=n))


def _round(eng, weights, ids, mask, hook, *, jax_side, t=T, n=N):
    js, ts = _greedy(t, n)
    eng.turn_hook = hook
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if jax_side:
            res = eng.generate(weights["jparams"], weights["jlora"], ids, mask, js,
                               jax.random.PRNGKey(0))
        else:
            res = eng.generate(weights["model"], weights["lora"], ids, mask, ts, 0)
    eng.turn_hook = None
    msgs = [str(w.message) for w in caught if "multi-turn window" in str(w.message)]
    return res, msgs


def _turn_stats(eng):
    st = eng.last_pool_stats
    return st["turn_resumes"], st["turn_prefill_saved_tokens"]


# (grants, max_kv_pages): never granting; one grant; grants to several
# candidates of both groups (one twice); observations too long for the
# window (every grant declined, the window warning); a page budget so
# small that ``ensure`` declines some grants
CASES = {
    "never": ({}, 0),
    "one": ({0: [OBS]}, 0),
    "several": ({0: [OBS, OBS[:3]], 1: [OBS[:5]], 3: [OBS]}, 0),
    "oversize": ({c: [np.full(64, 5, np.int32)] for c in range(4)}, 0),
    "budget10": ({c: [np.full(16, 7, np.int32)] for c in range(4)}, 10),
    "budget12": ({c: [np.full(24, 7, np.int32)] for c in range(4)}, 12),
}


@pytest.mark.parametrize("case", list(CASES))
def test_turn_resume_matches_jax(weights, case):
    grants, pages = CASES[case]
    kw = {"max_kv_pages": pages} if pages else {}
    jeng, teng = _engines(weights, **kw)
    ids, mask = _prompts()
    jhook, thook = ScriptHook(grants), ScriptHook(grants)
    jres, jwarn = _round(jeng, weights, ids, mask, jhook, jax_side=True)
    tres, twarn = _round(teng, weights, ids, mask, thook, jax_side=False)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.lengths, jres.lengths)
    np.testing.assert_allclose(tres.logprobs, jres.logprobs, atol=LOGP_ATOL, rtol=0)
    assert thook.calls == jhook.calls and thook.calls
    assert thook.declines == jhook.declines
    assert _turn_stats(teng) == _turn_stats(jeng)
    assert tres.steps_dispatched == jres.steps_dispatched
    assert twarn == jwarn
    resumes, saved = _turn_stats(teng)
    granted = sum(len(v) for v in grants.values())
    if case == "never":
        # armed but never granting is invisible: the unarmed round's bits
        plain, _ = _round(_engines(weights, jax_side=False, **kw)[1], weights, ids, mask, None,
                          jax_side=False)
        for a, b in ((tres.tokens, plain.tokens), (tres.lengths, plain.lengths),
                     (tres.logprobs, plain.logprobs)):
            np.testing.assert_array_equal(a, b)
        assert (resumes, saved) == (0, 0) and not thook.declines
    elif case == "oversize":
        assert resumes == 0 and len(thook.declines) == 4 and len(twarn) == 1
    elif case.startswith("budget"):
        assert thook.declines and 0 < resumes < granted
        assert resumes + len(thook.declines) == granted
    else:
        assert resumes == granted and not thook.declines
    if pages:
        assert teng.last_pool_stats["preemptions"] == jeng.last_pool_stats["preemptions"]
    # each resume kept its prompt and every earlier turn resident; the
    # observations sit in the rows verbatim, with behavior logprobs of 0
    if case in ("one", "several"):
        lengths, toks, logps = tres.lengths.reshape(-1), tres.tokens.reshape(
            -1, T), tres.logprobs.reshape(-1, T)
        want_saved = 0
        for c, obs_seq in grants.items():
            cursor = 0
            calls = [g for cc, g in thook.calls if cc == c]
            for obs, g in zip(obs_seq, calls):
                want_saved += P + g
                np.testing.assert_array_equal(toks[c, g:g + obs.size], obs)
                assert not logps[c, g:g + obs.size].any()
                cursor = g + obs.size
            assert lengths[c] > cursor  # a continuation was decoded
        assert saved == want_saved


def test_window_short_warning_matches_jax(weights):
    """No EOS id is ever sampled, so every candidate runs to its window: the
    hook is never consulted (no room for an observation and a token after
    it), and both packages warn alike that the round ran single-turn."""
    common = dict(max_prompt_tokens=P, max_new_tokens=8, eos_token_ids=[999], pad_token_id=PAD,
                  lora_scale=LORA_SCALE, capture_logprobs=True, page_size=8,
                  scheduler="refill", max_concurrent_rows=4, decode_chunk=4)
    jeng = jpe.PagedGenerationEngine(TINY, cache_dtype=jax.numpy.float32, autotune=False,
                                     scan_chunk=0, paged_impl="reference", **common)
    teng = PagedGenerationEngine(weights["cfg"], cache_dtype=torch.float32, device="cpu",
                                 **common)
    ids, mask = _prompts()
    jhook, thook = ScriptHook({0: [OBS]}), ScriptHook({0: [OBS]})
    jres, jwarn = _round(jeng, weights, ids, mask, jhook, jax_side=True, t=8)
    tres, twarn = _round(teng, weights, ids, mask, thook, jax_side=False, t=8)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    assert twarn == jwarn and len(twarn) == 1 and "within 2 tokens" in twarn[0]
    assert thook.calls == jhook.calls == []


@pytest.mark.parametrize("kw", [dict(scheduler="waves"), dict(spec_draft=2)],
                         ids=["waves", "spec_draft"])
def test_hook_outside_the_plain_refill_scheduler_raises_as_jax(weights, kw):
    common = dict(max_prompt_tokens=P, max_new_tokens=8, eos_token_ids=[1], pad_token_id=PAD,
                  page_size=8, max_concurrent_rows=4)
    common.update({"scheduler": "refill", **kw})
    jeng = jpe.PagedGenerationEngine(TINY, cache_dtype=jax.numpy.float32, autotune=False,
                                     scan_chunk=0, paged_impl="reference", **common)
    teng = PagedGenerationEngine(weights["cfg"], cache_dtype=torch.float32, device="cpu",
                                 **common)
    ids, mask = _prompts(1)
    js, ts = _greedy(8, 1)
    jeng.turn_hook, teng.turn_hook = ScriptHook(), ScriptHook()
    with pytest.raises(ValueError, match="refill") as jerr:
        jeng.generate(weights["jparams"], None, ids, mask, js, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="refill") as err:
        teng.generate(weights["model"], None, ids, mask, ts, 0)
    assert str(err.value) == str(jerr.value)


def test_resume_continues_as_a_dense_decode_of_the_whole_conversation(weights):
    """The KV-exactness pin: after an in-place resume the port's refill
    engine decodes exactly what its dense engine decodes when handed the
    whole conversation (prompt, turn 1, observation) as a prompt: the
    resident KV is the prefilled context."""
    _, teng = _engines(weights, jax_side=False)
    ids, mask = _prompts(1)
    base, _ = _round(teng, weights, ids, mask, None, jax_side=False, n=1)
    g1 = int(base.lengths[0, 0])
    gen1 = base.tokens[0, 0, :g1]
    assert g1 + OBS.size < T - 8  # room for the observation and a continuation
    hook = ScriptHook({0: [OBS]})
    res, _ = _round(teng, weights, ids, mask, hook, jax_side=False, n=1)
    total, row = int(res.lengths[0, 0]), res.tokens[0, 0]
    assert _turn_stats(teng) == (1, P + g1)
    np.testing.assert_array_equal(row[:g1], gen1)
    np.testing.assert_array_equal(row[g1:g1 + OBS.size], OBS)
    conv = np.concatenate([ids[0], gen1, OBS]).astype(np.int32)[None]
    dense = GenerationEngine(weights["cfg"], max_prompt_tokens=conv.shape[1], max_new_tokens=T,
                             eos_token_ids=EOS, pad_token_id=PAD, lora_scale=LORA_SCALE,
                             cache_dtype=torch.float32, device="cpu")
    dres = dense.generate(weights["model"], weights["lora"], conv, np.ones_like(conv),
                          _greedy(T, 1)[1], 0)
    g2 = int(dres.lengths[0, 0])
    assert total == g1 + OBS.size + min(g2, T - g1 - OBS.size)
    np.testing.assert_array_equal(row[g1 + OBS.size:total], dres.tokens[0, 0, :total - g1 - OBS.size])


def _state_ptrs(s) -> dict:
    return {f.name: getattr(s, f.name).data_ptr() for f in dataclasses.fields(s)
            if isinstance(getattr(s, f.name), torch.Tensor)}


@pytest.mark.parametrize("case", ["one", "several", "budget12"])
def test_chunked_resume_equals_step_by_step(weights, case, monkeypatch):
    """``scan_chunk=4`` over ``check`` 4: every host decision, the resume
    included, falls on a chunk boundary, and the resume writes the refill
    state's tensors in place. The chunked rounds equal the step-by-step
    ones bit for bit, and no state tensor (nor any page pool) changes its
    address across a resume."""
    grants, pages = CASES[case]
    kw = {"max_kv_pages": pages} if pages else {}
    ids, mask = _prompts()
    _, step = _engines(weights, jax_side=False, **kw)
    _, chunked = _engines(weights, jax_side=False, scan_chunk=4, **kw)
    moved = []
    fixup = tpe._turn_resume_fixup

    def watched(model, lora, s, *a, **k):
        before = (_state_ptrs(s), [p.data_ptr() for p in s.k_pages + s.v_pages])
        fixup(model, lora, s, *a, **k)
        after = (_state_ptrs(s), [p.data_ptr() for p in s.k_pages + s.v_pages])
        moved.append(before != after)

    monkeypatch.setattr(tpe, "_turn_resume_fixup", watched)
    hooks = [ScriptHook(grants), ScriptHook(grants)]
    a, _ = _round(step, weights, ids, mask, hooks[0], jax_side=False)
    b, _ = _round(chunked, weights, ids, mask, hooks[1], jax_side=False)
    assert chunked.scan_chunk_active and step.scan_chunk_active is None
    for x, y in ((a.tokens, b.tokens), (a.lengths, b.lengths), (a.logprobs, b.logprobs)):
        np.testing.assert_array_equal(x, y)
    assert hooks[0].calls == hooks[1].calls and hooks[0].declines == hooks[1].declines
    assert _turn_stats(step) == _turn_stats(chunked) and _turn_stats(chunked)[0] > 0
    assert a.steps_dispatched == b.steps_dispatched
    assert moved and not any(moved)


@pytest.mark.parametrize("n_eos", [1, 3, 40, 4752])
def test_is_eos_equals_isin(n_eos):
    """The decode steps' EOS test (``engine/engine.py::is_eos``) computes
    ``torch.isin`` at every EOS set's size; unlike ``torch.isin``, which
    sorts past a few dozen ids and waits on the host there, it is one
    broadcast compare that a CUDA graph can capture (phase 15's widened EOS
    set)."""
    from distrl_llm_tpu_torch.engine.engine import is_eos

    gen = torch.Generator().manual_seed(n_eos)
    eos = torch.randperm(152064, generator=gen)[:n_eos].to(torch.int32)
    tok = torch.cat([eos[:5], torch.randint(0, 152064, (70 - min(n_eos, 5),), generator=gen,
                                            dtype=torch.int32)])
    for t in (tok, tok.reshape(-1, 5)[:11]):
        assert torch.equal(is_eos(t, eos), torch.isin(t, eos))
