"""Scan chunks on the refill scheduler (``scheduler="refill"`` with
``scan_chunk`` = k > 1): the port's plain, speculative and self-drafted
steps k at a time, against the live JAX engine at the same ``scan_chunk``.

Both engines run chunks of the largest divisor of the host cadence
``check = min(decode_chunk, 16, max_steps)`` that is <= ``scan_chunk``, so
every admission, grant, preemption, snapshot read and draft-length decision
falls on the step it falls on one step at a time, and in-flight adapter
pushes are consumed at chunk boundaries. On the CPU the port's chunk body
runs eagerly at the chunk cadence (on the card each chunk is a CUDA graph
replay over a refill state and page pools kept across rounds); the JAX
engine runs one scanned program a chunk.

So greedy tokens, lengths, the steps dispatched and the swap log must equal
the JAX engine's, and behavior logprobs agree within ``LOGP_ATOL`` (f32
pages) or ``LOGP_ATOL_INT8`` (int8 pages), the tolerances of
``test_torch_refill_engine.py``, which says why they are not 0. Each round
is also held to the port's own step-by-step round: tokens, lengths,
logprobs and steps bit for bit. Sampled rounds are held to the port's
step-by-step round only (the JAX package draws other numbers by
construction): a chunk's seed vectors are drawn before it in the per-step
loop's order, and the speculative draws inside it come from the round's
generator in the eager order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig
from distrl_llm_tpu.engine import paged_engine as jpe
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu_torch import PagedGenerationEngine
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy
from tests.test_torch_prefix_cache import _one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_refill_engine import (  # noqa: F401  (weights: the fixture)
    LOGP_ATOL, LOGP_ATOL_INT8, _common, _lora, _prompts, _swap_at, weights,
)
from tests.test_torch_refill_preemption import _SnapshotJnp
from tests.test_torch_self_draft import _perturbed

_JENGINES: dict = {}


def _refill(slots: int = 4, **kw) -> dict:
    return dict(scheduler="refill", max_concurrent_rows=slots, **kw)


def _jengine(t: int, k: int, **kw):
    """One JAX engine per configuration for this module: its jitted steps
    and chunk programs belong to the instance. Its mailbox goes back to a
    new engine's before each use."""
    key = (t, k, repr(sorted(kw.items())))
    if key not in _JENGINES:
        _JENGINES[key] = jpe.PagedGenerationEngine(
            TINY, cache_dtype=jnp.float32, autotune=False, scan_chunk=k,
            paged_impl="reference", **_common(t, **kw))
    jeng = _JENGINES[key]
    for name in ("_pending", "_swapped_lora", "_prev_lora", "_prev_lora_version",
                 "_take_pending_lora"):  # the last: a push hook (_swap_at)
        jeng.__dict__.pop(name, None)
    jeng.last_swap_steps, jeng.last_swap_versions = [], []
    return jeng


def _tengine(weights, t: int, k: int, **kw):
    return PagedGenerationEngine(weights["cfg"], cache_dtype=torch.float32, device="cpu",
                                 scan_chunk=k, **_common(t, **kw))


def _sampling(t: int, n: int, temperature: float = 0.0):
    return (JSamplingConfig(max_tokens=t, temperature=temperature, top_p=0.9, n=n),
            SamplingConfig(max_tokens=t, temperature=temperature, top_p=0.9, n=n))


def _chunk(teng, res) -> int:
    """The steps a chunk of ``teng``'s last round ran (every dispatch of a
    chunked round is a chunk: on the CPU each runs eagerly)."""
    g = teng.decode_graphs
    assert g.replays == 0 and g.eager_chunks > 0 and teng.scan_chunk_active
    return teng.last_round_stats["decode_forwards"] // g.eager_chunks


def _same(a, b, atol: float = 0.0) -> None:
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_allclose(a.logprobs, b.logprobs, atol=atol, rtol=0)
    assert a.steps_dispatched == b.steps_dispatched


def _round(eng, weights, ids, mask, sampling, *, lora, seed: int, jax_side: bool):
    if jax_side:
        return eng.generate(weights["jparams"], lora, ids, mask, sampling,
                            jax.random.PRNGKey(seed))
    return eng.generate(weights["model"], lora, ids, mask, sampling, seed)


def _against_jax(weights, *, t: int, k: int, n: int, ids, mask, kw: dict, rounds: int = 1,
                 lora: bool = True, pushes=(), atol: float = LOGP_ATOL) -> dict:
    """``rounds`` greedy rounds of the JAX engine, the port's chunked
    engine and the port's step-by-step engine over the same prompts, each
    engine kept across its rounds, ``pushes`` ((step, numpy adapter,
    version), ...) pushed into each as it reaches that step of the first
    round. Chunked equals JAX (tokens, lengths, steps, swap log; logprobs
    within ``atol``) and equals step by step bit for bit. Returns the
    engines and the last rounds."""
    js, ts = _sampling(t, n)
    jeng, teng, eager = _jengine(t, k, **kw), _tengine(weights, t, k, **kw), _tengine(
        weights, t, 0, **kw)
    for step, tree, version in pushes:
        _swap_at(jeng, step, jax.tree_util.tree_map(jnp.asarray, tree), version)
        for eng in (teng, eager):
            _swap_at(eng, step, lora_from_numpy(tree, weights["cfg"], device="cpu"), version)
    for _ in range(rounds):
        jres = _round(jeng, weights, ids, mask, js, lora=weights["jlora"] if lora else None,
                      seed=0, jax_side=True)
        tres, eres = (_round(eng, weights, ids, mask, ts, lora=weights["lora"] if lora
                             else None, seed=0, jax_side=False) for eng in (teng, eager))
        _same(tres, jres, atol)
        _same(tres, eres)
        assert teng.last_swap_steps == jeng.last_swap_steps == eager.last_swap_steps
        assert teng.last_swap_versions == jeng.last_swap_versions
        assert jeng.scan_chunk_active
    return {"j": jeng, "t": teng, "e": eager, "jres": jres, "tres": tres, "eres": eres}


PROMPTS = [5, 8, 16, 0, 11]  # an empty padding row, two page-aligned prompts


@pytest.mark.parametrize("d,k,kv_quant,want", [(0, 16, "none", 12), (3, 4, "none", 4),
                                               (0, 16, "int8", 12)],
                         ids=["plain", "spec", "int8"])
def test_greedy_refills_match_jax(weights, d, k, kv_quant, want):
    """15 candidates through 4 slots, 12 new tokens (check 12): scan_chunk
    16 runs chunks of 12, 4 runs chunks of 4 (the speculative case of the
    JAX package's ``test_chunked_spec_parity``)."""
    ids, mask = _prompts(PROMPTS)
    out = _against_jax(weights, t=12, k=k, n=3, ids=ids, mask=mask,
                       kw=_refill(spec_draft=d, kv_quant=kv_quant),
                       atol=LOGP_ATOL_INT8 if kv_quant == "int8" else LOGP_ATOL)
    teng, tres = out["t"], out["tres"]
    assert _chunk(teng, tres) == want
    assert tres.alive_slot_steps == out["jres"].alive_slot_steps
    stats = teng.last_round_stats
    assert stats["graph_steps"] == 0  # nothing is graphed on the CPU
    if d:
        for key in ("emit_hist", "drafted", "accepted", "draft_len_trace"):
            assert teng.last_spec_stats[key] == out["e"].last_spec_stats[key], key
        assert teng.last_spec_stats["emit_hist"] == out["j"].last_spec_stats["emit_hist"]
    else:
        assert stats["sampler_calls"] == tres.steps_dispatched


def test_structural_swap_into_a_none_round_matches_jax(weights):
    """A round without an adapter takes its first one at step 0, a chunk
    boundary (the JAX package rebuilds its chunk program for the new
    signature; the port's chunk runner keys the adapter's tensors)."""
    ids, mask = _prompts(PROMPTS, seed=2)
    out = _against_jax(weights, t=6, k=16, n=1, ids=ids, mask=mask,
                       kw=_refill(slots=2), lora=False,
                       pushes=[(0, _lora(), 3)])
    assert out["t"].last_swap_steps == [0] and out["t"].last_swap_versions == [3]


def test_eos_with_logprobs_matches_jax_and_sampled_equals_step_by_step(weights):
    """EOS mid-round frees slots for refills (greedy against JAX), and a
    sampled round (t 1.3, top-p 0.9) of the chunked engine equals the
    step-by-step engine's bit for bit, speculative and plain."""
    ids, mask = _prompts(PROMPTS, seed=9)
    probe = _tengine(weights, 8, 0, **_refill(slots=3)).generate(
        weights["model"], weights["lora"], ids, mask, _sampling(8, 1)[1], 0)
    eos = int(probe.tokens[0, 0, 2])
    out = _against_jax(weights, t=8, k=16, n=2, ids=ids, mask=mask,
                       kw=_refill(slots=3, eos=eos))
    assert (out["tres"].lengths < 8).any()
    for d in (0, 2):
        kw = _refill(slots=3, eos=eos, spec_draft=d)
        a, b = (_tengine(weights, 8, k, **kw).generate(
            weights["model"], weights["lora"], ids, mask, _sampling(8, 2, 1.3)[1], 5)
            for k in (0, 16))
        _same(a, b)


def test_non_divisor_chunk_rounds_down_and_matches_jax(weights):
    """scan_chunk 4 over check 6 (6 new tokens) runs chunks of 3: a
    non-divisor would stretch the host cadence past the grant horizon."""
    ids, mask = _prompts(PROMPTS, seed=3)
    out = _against_jax(weights, t=6, k=4, n=2, ids=ids, mask=mask,
                       kw=_refill(slots=2))
    assert _chunk(out["t"], out["tres"]) == 3


@pytest.mark.parametrize("d,k,want", [(0, 5, 4), (0, 16, 12), (2, 16, 12)],
                         ids=["plain_non_divisor", "plain", "spec"])
def test_tight_budget_matches_jax(monkeypatch, weights, d, k, want):
    """A pool of one full region and two pages of slack, 12 new tokens
    (check 12), 2 slots (the JAX package's tight-budget cases: a non-divisor
    chunk, 5, rounded down to 4; the budgeted pool at chunk 16; speculative
    decoding under the budget, whose grant horizon scales by d + 1)."""
    monkeypatch.setattr(jpe, "jnp", _SnapshotJnp())
    ids, mask = _prompts(PROMPTS, seed=4)
    pages = 1 + _tengine(weights, 12, 0, **_refill(spec_draft=d)).private_pages + 2
    out = _against_jax(weights, t=12, k=k, n=1, ids=ids, mask=mask,
                       kw=_refill(slots=2, spec_draft=d, max_kv_pages=pages))
    pool = out["t"].last_pool_stats
    assert pool["budgeted"] and pool["preemptions"] == out["j"].last_pool_stats["preemptions"]
    assert _chunk(out["t"], out["tres"]) == want


# budgets under which occupants are preempted (test_torch_refill_engine.py's
# cases): (d, new tokens, decode_chunk = check, pages)
PREEMPTING = {"plain": (0, 24, 4, 9), "spec": (1, 40, 2, 10)}


def test_preemption_under_a_small_budget_matches_jax(monkeypatch, weights):
    """Occupants are preempted and resumed by recompute between chunks of
    ``check`` = 4 steps (the speculative case's preemptions under chunks are
    held to step by step in the address test)."""
    d, t, check, pages = PREEMPTING["plain"]
    monkeypatch.setattr(jpe, "jnp", _SnapshotJnp())
    ids, mask = _prompts([5, 8, 16, 11], seed=3)
    out = _against_jax(weights, t=t, k=16, n=2, ids=ids, mask=mask,
                       kw=_refill(spec_draft=d, max_kv_pages=pages, decode_chunk=check))
    pool, jpool = out["t"].last_pool_stats, out["j"].last_pool_stats
    assert pool["preemptions"] == jpool["preemptions"] > 0 and pool["resumes"] > 0
    assert _chunk(out["t"], out["tres"]) == check


SELF_DRAFT = _refill(spec_draft=4, spec_drafter="self", spec_adapt=True, decode_chunk=4)


def test_chunked_drafter_rotation_none_to_adapter_matches_jax(weights):
    """The JAX package's ``test_chunked_drafter_rotation_none_to_adapter``
    on the adaptive case's engine (chunks of 4): a lora=None round of the
    self-drafter, two pushes: the first (step 0) leaves the drafter None,
    so the current adapter drafts for itself, and the second (step 4, the
    next boundary) rotates it None -> v1 with the target's structure
    unchanged, so the drafter's tensors must key the chunk. Before this
    test the port drafted with the bare base where the drafter is None (the
    JAX package's ``_spec_step`` falls back to the target adapter): the
    rounds' acceptance, steps and tokens then differed from the JAX
    engine's, chunked and step by step alike."""
    v1 = jax.tree_util.tree_map(np.asarray, _lora())
    v2 = _perturbed(v1, 11, 0.05)
    ids, mask = _prompts([9, 16, 5], seed=14)
    out = _against_jax(weights, t=24, k=16, n=1, ids=ids, mask=mask, lora=False,
                       kw=SELF_DRAFT, pushes=[(0, v1, 1), (4, v2, 2)])
    teng = out["t"]
    assert teng.last_swap_steps == [0, 4] and teng.last_swap_versions == [1, 2]
    ts, js = teng.last_spec_stats, out["j"].last_spec_stats
    assert ts["drafter_version"] == js["drafter_version"] == 1
    assert ts["target_version"] == js["target_version"] == 2
    assert ts["emit_hist"] == js["emit_hist"]
    assert _chunk(teng, out["tres"]) == 4


def test_self_drafter_with_adaptive_length_matches_jax(weights):
    """``spec_adapt`` with the self-drafter under two rounds of pushes (a
    far neighbour, so the controller halves d and grows it back), chunks of
    4 over check 4: every draft length is its own chunk key (the JAX
    package's ``spec:d{d}``); the controller reads the totals at the same
    boundaries, so its choices equal the JAX engine's."""
    t, n = 24, 2
    ids, mask = _prompts([5, 8, 16, 11], seed=3)
    kw = SELF_DRAFT
    js, ts = _sampling(t, n)
    jeng, teng, eager = _jengine(t, 16, **kw), _tengine(weights, t, 16, **kw), _tengine(
        weights, t, 0, **kw)
    v0 = jax.tree_util.tree_map(np.asarray, _lora())
    v1 = _perturbed(v0, 11, 0.6)
    v2 = _perturbed(v1, 12, 0.6)
    cfg = weights["cfg"]
    switches = 0
    for version, (entry, pushed) in enumerate(((v0, v1), (v1, v2)), start=1):
        jeng.push_lora(jax.tree_util.tree_map(jnp.asarray, pushed), version)
        for eng in (teng, eager):
            eng.push_lora(lora_from_numpy(pushed, cfg, device="cpu"), version)
        jres = jeng.generate(weights["jparams"], jax.tree_util.tree_map(jnp.asarray, entry),
                             ids, mask, js, jax.random.PRNGKey(0))
        tres, eres = (eng.generate(weights["model"], lora_from_numpy(entry, cfg, device="cpu"),
                                   ids, mask, ts, 0) for eng in (teng, eager))
        _same(tres, jres, LOGP_ATOL)
        _same(tres, eres)
        assert teng.last_swap_steps == jeng.last_swap_steps == [0] * version
        st, sj = teng.last_spec_stats, jeng.last_spec_stats
        for key in ("drafted", "emit_hist", "draft_len_final", "draft_len_switches",
                    "drafter_version", "target_version"):
            assert st[key] == sj[key], (version, key, st[key], sj[key])
        assert st["draft_len_trace"] == eager.last_spec_stats["draft_len_trace"]
        assert st["draft_forwards"] == eager.last_spec_stats["draft_forwards"]
        switches += st["draft_len_switches"]
    assert switches >= 2


def test_riders_with_spill_under_a_budget_match_jax(monkeypatch, weights):
    """Continuous admission, the radix cache and host spill under a budget
    that preempts, chunks of 4, two rounds (the second admits warm through
    the cache): the riders' counts equal the JAX engine's and the
    step-by-step engine's."""
    monkeypatch.setattr(jpe, "jnp", _SnapshotJnp())
    ids, mask = _prompts([5, 8, 16, 11], seed=3)
    kw = _refill(continuous_admission=True, prefix_cache=True, kv_spill=True,
                 max_kv_pages=13, decode_chunk=4)
    out = _against_jax(weights, t=24, k=16, n=2, ids=ids, mask=mask, kw=kw, rounds=2)
    pool, jpool, epool = (out[s].last_pool_stats for s in ("t", "j", "e"))
    for key in ("preemptions", "spilled_pages", "restored_pages", "prefill_tok_saved",
                "groups_prefilled", "peak_pages_used"):
        assert pool[key] == jpool[key] == epool[key], key
    assert pool["preemptions"] > 0 and pool["prefill_tok_saved"] > 0
    assert out["t"].last_round_stats["warm_prefills"] == out["e"].last_round_stats[
        "warm_prefills"] > 0


SAMPLED_CASES = {
    "int8": _refill(kv_quant="int8"),
    "spec_int8": _refill(kv_quant="int8", spec_draft=3),
    "riders": _refill(continuous_admission=True, prefix_cache=True, kv_spill=True,
                      max_kv_pages=13, decode_chunk=4),
    "sharing_budget": _refill(prefix_sharing=True, max_kv_pages=9, decode_chunk=4),
    "self_draft": SELF_DRAFT,
}


@pytest.mark.parametrize("case", SAMPLED_CASES)
def test_sampled_chunks_equal_step_by_step(weights, case):
    """Sampled (t 1.2, top-p 0.9), two rounds an engine (the chunked
    engine's state is kept and reset in place), an adapter pushed at step
    8: chunked equals step by step bit for bit, with the pool's and the
    drafter's counts."""
    kw = SAMPLED_CASES[case]
    t, n = 24, 2
    ids, mask = _prompts([5, 8, 16, 11], seed=6)
    pushed = lora_from_numpy(_perturbed(jax.tree_util.tree_map(np.asarray, _lora()), 3, 0.05),
                             weights["cfg"], device="cpu")
    sampling = _sampling(t, n, 1.2)[1]
    engines = [_tengine(weights, t, k, **kw) for k in (0, 16)]
    for eng in engines:
        _swap_at(eng, 16, pushed, 1)  # a chunk boundary at check 4 and 16
    for seed in (0, 1):
        a, b = (eng.generate(weights["model"], weights["lora"], ids, mask, sampling, seed)
                for eng in engines)
        _same(a, b)
        assert engines[0].last_swap_steps == engines[1].last_swap_steps == [16] * (seed + 1)
        pools = [dict(eng.last_pool_stats) for eng in engines]
        for pool in pools:
            pool.pop("spill_restore_ms_p50")  # a host time
        assert pools[0] == pools[1]
        assert engines[0].last_spec_stats == engines[1].last_spec_stats
    assert engines[1].scan_chunk_active and engines[0].scan_chunk_active is None
    if case in ("riders", "sharing_budget"):
        assert engines[1].last_pool_stats["preemptions"] > 0


@pytest.mark.parametrize("case", PREEMPTING)
def test_a_chunk_keeps_every_state_tensor_at_its_address(weights, monkeypatch, case):
    """What a captured graph needs: the tensors a refill chunk reads and
    writes (the state's buffers, seeds and page pools) are the same at the
    same addresses after every chunk as before the first, across two
    rounds, under a budget that preempts (admissions, grants, resumes and
    the page table's shipping all write in place); each round equals the
    step-by-step engine's."""
    d, t, check, pages = PREEMPTING[case]
    ids, mask = _prompts([5, 8, 16, 11], seed=3)
    teng = _tengine(weights, t, 16, **_refill(spec_draft=d, max_kv_pages=pages,
                                              decode_chunk=check))
    seen = []
    run = teng.decode_graphs.run

    def recording(key, body, device, generators=()):
        state = teng._chunk_state[1]
        before = _addresses(state)
        run(key, body, device, generators)
        seen.append((before, _addresses(state)))

    monkeypatch.setattr(teng.decode_graphs, "run", recording)
    eager = _tengine(weights, t, 0, **_refill(spec_draft=d, max_kv_pages=pages,
                                              decode_chunk=check))
    for seed in range(2):
        a, b = (eng.generate(weights["model"], weights["lora"], ids, mask,
                             _sampling(t, 2)[1], seed) for eng in (teng, eager))
        _same(a, b)
    assert teng.last_pool_stats["preemptions"] == eager.last_pool_stats["preemptions"] > 0
    assert len(seen) == 2 * teng.last_round_stats["decode_forwards"] // check
    assert all(before == after == seen[0][0] for before, after in seen)


def _addresses(state) -> list:
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        for x in (v if isinstance(v, list) else [v]):
            for t in (x if isinstance(x, tuple) else (x,)):  # int8 pages: (weight, scales)
                if isinstance(t, torch.Tensor):
                    out.append((f.name, t.data_ptr()))
    return out


def test_chip_smoke_refill_graph_phase_rehearses_on_cpu(tmp_path):
    """Phase 12 of chip_smoke.py at TINY on the CPU, chunks of 4 over 8 new
    tokens at 4 slots (nothing is graphed here: each chunk runs eagerly):
    (a) plain refill and (b) speculative refill, the graphed and eager
    engines in turns with equal tokens; (c) the riders under a budget, two
    rounds; (d) the self-drafter sampled with a push; (e) one
    ``Trainer.train()`` step with ``decode_scan_chunk`` on the refill
    engine over an int4 base, beside the same step eager."""
    import chip_smoke
    from distrl_llm_tpu_torch.models.configs import TINY as TTINY

    cfg = dataclasses.replace(TTINY, vocab_size=1024)  # the BPE needs 259 ids
    shape = dict(max_prompt_tokens=96, max_new_tokens=8, n=2, page_size=16, rank=4, chunk=4,
                 slots=4)
    w = chip_smoke.make_weights(cfg, "cpu", seed=0, rank=4)
    a = chip_smoke.refill_graph_ab(cfg, "cpu", w, seed=0, spec_draft=0, **shape)
    b = chip_smoke.refill_graph_ab(cfg, "cpu", w, seed=0, spec_draft=4, **shape)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])  # greedy spec is exact
    assert a["g"].scan_chunk_active and a["e"].scan_chunk_active is None
    # at this shape the budget's admission gate keeps every occupant's pages
    # granted (preemption under chunks: test_riders_with_spill_under_a_budget)
    c = chip_smoke.refill_graph_riders(cfg, "cpu", w, seed=0, pages=24, min_preemptions=0,
                                       **shape)
    assert c["warm_groups"] > 0
    d = chip_smoke.refill_graph_self_draft(cfg, "cpu", w, seed=0, step=4, **shape)
    assert d["swap_steps"] == [4]
    tok = chip_smoke.write_bpe_tokenizer(tmp_path / "tok", cfg.vocab_size)
    e = chip_smoke.refill_graph_trainer(cfg, "cpu", seed=0, workdir=tmp_path / "e",
                                        tokenizer_dir=tok, group=16, hbm_bytes=2**30,
                                        max_prompt_tokens=96, max_new_tokens=8,
                                        num_candidates=4, topk=4, train_batch_size=4,
                                        eval_n=2, max_concurrent_sequences=8)
    for run in e.values():
        assert [r["refill"] for r in run["rounds"]] == [False, True]
    assert e["graphed"]["active"] and e["eager"]["active"] is None
