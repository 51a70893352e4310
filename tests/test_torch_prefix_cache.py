"""Parity of the refill scheduler's riders with the JAX package's:
prefix sharing, continuous admission, the radix prefix cache and host
spill (``engine/page_pool.py``, ``engine/paged_engine.py``, the model's
``paged_prefix`` forward, ``engine/budget.py``).

* The page pool: one seeded random sequence of group prefills, admissions,
  grants, releases, group finishes (cached or dropped), radix matches with
  restores from the host store, warm admissions, flushes and
  invalidations runs through both packages' ``PagePool``; after every
  operation the tables, refcounts, chains, free lists, radix counters and
  stored keys and bytes must be equal.
* The engine on TINY in f32 (8-token pages, 4 slots): each rider against
  the JAX engine (tokens, lengths and dispatched steps exactly, captured
  logprobs within ``LOGP_ATOL``) and against the port's own unshared
  engine (tokens identical).
* ``kv_pool_pages`` with ``continuous`` and ``prefix_cache`` equals JAX's.
"""

import numpy as np
import pytest
import torch

from distrl_llm_tpu.engine import budget as jbudget
from distrl_llm_tpu.engine import paged_engine as jpe
from distrl_llm_tpu.engine.page_pool import HostPageStore as JStore
from distrl_llm_tpu.engine.page_pool import PagePool as JPool
from distrl_llm_tpu.engine.page_pool import RadixCache as JRadix
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine import budget as tbudget
from distrl_llm_tpu_torch.engine.page_pool import HostPageStore as TStore
from distrl_llm_tpu_torch.engine.page_pool import PagePool as TPool
from distrl_llm_tpu_torch.engine.page_pool import RadixCache as TRadix
from distrl_llm_tpu_torch.models.configs import QWEN2_7B as TQWEN, TINY as TTINY
from tests.test_torch_refill_engine import (  # noqa: F401  (weights: the fixture)
    LOGP_ATOL, _assert_same, _jengine, _prompts, _refill, _run, _run_both, _tengine, weights,
)
from tests.test_torch_refill_preemption import _SnapshotJnp

PS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """TINY's tensors are too small for torch's intra-op threads to pay:
    they only spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ pool


def _settle(store: JStore) -> None:
    """Wait until the JAX store's worker has converted every payload (its
    byte accounting and cap run there)."""
    with store._cv:
        while store._queue or any(v is store._PENDING for v in store._data.values()):
            store._cv.wait(0.01)


def _same_pools(jp, tp, jstore, tstore) -> None:
    _settle(jstore)
    np.testing.assert_array_equal(tp.table, jp.table)
    assert (tp.owned, tp.free, tp.ref, tp.shared, tp.tail_shared) == (
        jp.owned, jp.free, jp.ref, jp.shared, jp.tail_shared)
    assert tp.chains == jp.chains and tp.adopted == jp.adopted
    assert (tp.cow_splits, tp.peak_pages_used, tp.peak_shared_pages, tp.prefix_admissions,
            tp.total_admissions, tp.shared_pages, tp.used_pages) == (
        jp.cow_splits, jp.peak_pages_used, jp.peak_shared_pages, jp.prefix_admissions,
        jp.total_admissions, jp.shared_pages, jp.used_pages)
    assert tp.radix.snapshot() == jp.radix.snapshot()
    assert sorted(tp.radix._resident) == sorted(jp.radix._resident)
    assert {n: p.page for n, p in tp.radix._resident.items()} == {
        n: p.page for n, p in jp.radix._resident.items()}
    assert sorted(tstore._data, key=str) == sorted(jstore._data, key=str)
    assert (tstore.used_bytes, tstore.dropped_payloads) == (
        jstore.used_bytes, jstore.dropped_payloads)
    jp.check_invariants()
    tp.check_invariants()


def _payload(page: int, *, torch_side: bool):
    """A page's parked tiles as each package's engine would hand them over
    (bytes depend on the page, so the store's accounting is exercised)."""
    tile = np.full((2, PS, 4), page, np.float32)
    return {"k": [torch.from_numpy(tile)] if torch_side else [tile]}


@pytest.mark.parametrize("seed", range(3))
def test_seeded_pool_sequence_matches_jax(seed):
    """Groups of 3 candidates over 4 slots: a group is prefilled cold
    (``alloc_prefix``) or warm through a radix match (``restore_nodes``
    then ``admit_cached``), its candidates admitted with the imminent first
    write splitting the tail page (or split later by ``note_write``); grants, releases (a preemption now and
    then), and a finished group cached (``cache_chain``) or dropped; now
    and then a flush to the host store or an invalidation. The store's
    byte cap drops payloads along the way."""
    rng = np.random.default_rng(seed)
    prompt_pages, r, n = 3, 4, 3
    kw = dict(first_page=0, n_pages=int(rng.integers(18, 26)), r_slots=r,
              width=prompt_pages + 4, page_size=PS, prompt_pages=prompt_pages,
              prefix_sharing=True)
    # seed 0: room for three payloads, 1: for one (the cap drops), 2: no cap
    cap = (3, 1, 0)[seed] * 2 * PS * 4 * 4
    jstore, tstore = JStore(max_bytes=cap), TStore(max_bytes=cap)
    jp = JPool(**kw, radix=JRadix(PS), store=jstore)
    tp = TPool(**kw, radix=TRadix(PS), store=tstore)
    jp.spill_fn = lambda page: _payload(page, torch_side=False)
    tp.spill_fn = lambda page: _payload(page, torch_side=True)
    # prompts drawn from a few shared stems, so radix matches happen
    stems = [rng.integers(4, 50, 2 * PS) for _ in range(3)]
    prompts = []
    for _ in range(12):
        stem = stems[int(rng.integers(0, 3))]
        cut = int(rng.integers(PS, 2 * PS + 1))
        tail = rng.integers(4, 50, int(rng.integers(1, PS)))
        prompts.append(np.concatenate([stem[:cut], tail])[:prompt_pages * PS])
    live: dict[int, list] = {}  # group -> [slot or None per candidate]
    slot_of: dict[int, tuple] = {}
    frontier = np.zeros(r, np.int64)
    ops = dict(cold=0, warm=0, admit=0, finish=0, flush=0)
    next_g = 0
    try:
        for _ in range(160):
            op = rng.random()
            free_slots = [s for s in range(r) if s not in slot_of]
            waiting = [(g, i) for g, c in live.items() for i, s in enumerate(c) if s is None]
            if op < 0.2 and next_g < len(prompts) and len(live) < r + 1:
                g, toks = next_g, prompts[next_g]
                rl = toks.size
                n_chain = -(-rl // PS)
                nodes_j, hit_j = jp.radix_match(toks)
                nodes_t, hit_t = tp.radix_match(toks)
                assert hit_t == hit_j
                chain_j = chain_t = None
                if nodes_j:
                    res_j, up_j = jp.restore_nodes(nodes_j)
                    res_t, up_t = tp.restore_nodes(nodes_t)
                    assert [(nd.nid, p) for nd, p, _ in up_t] == [
                        (nd.nid, p) for nd, p, _ in up_j]
                    for (_, _, pj), (_, _, pt) in zip(up_j, up_t):
                        np.testing.assert_array_equal(pt["k"][0].numpy(), pj["k"][0])
                    if res_j:
                        chain_j = jp.admit_cached(g, res_j, n_chain, rl // PS)
                        chain_t = tp.admit_cached(g, res_t, n_chain, rl // PS)
                        ops["warm"] += chain_j is not None
                if chain_j is None and g not in jp.chains:
                    chain_j = jp.alloc_prefix(g, n_chain, rl // PS)
                    chain_t = tp.alloc_prefix(g, n_chain, rl // PS)
                    ops["cold"] += chain_j is not None
                assert chain_t == chain_j
                if chain_j is not None:
                    live[g] = [None] * n
                    next_g += 1
            elif op < 0.5 and free_slots and waiting:
                s = free_slots[int(rng.integers(0, len(free_slots)))]
                g, i = waiting[0]
                rl = prompts[g].size
                last = rl + int(rng.integers(0, 3 * PS))
                # now and then the tail stays attached until its first write
                # (note_write) instead of splitting at admission
                first = rl if rng.random() < 0.7 else None
                ok = jp.admit(s, g, rl, last, first_write=first)
                assert tp.admit(s, g, rl, last, first_write=first) == ok
                assert tp.slot_alias_info(s) == jp.slot_alias_info(s)
                if ok and first is None:
                    if jp.free_pages:  # the split needs a page (callers gate on it)
                        assert tp.note_write(s, rl) == jp.note_write(s, rl)
                    else:  # no page to split into: the admission is undone
                        jp.release(s)
                        tp.release(s)
                        ok = False
                assert tp.take_copy(s) == jp.take_copy(s)
                if ok:
                    live[g][i] = s
                    slot_of[s] = (g, i)
                    frontier[s] = rl
                    ops["admit"] += 1
            elif op < 0.7 and slot_of:
                s = list(slot_of)[int(rng.integers(0, len(slot_of)))]
                frontier[s] += int(rng.integers(1, PS))
                assert tp.ensure(s, int(frontier[s])) == jp.ensure(s, int(frontier[s]))
            elif op < 0.93 and slot_of:
                s = list(slot_of)[int(rng.integers(0, len(slot_of)))]
                g, i = slot_of.pop(s)
                jp.release(s)
                tp.release(s)
                if rng.random() < 0.25:  # preempted: requeued in its group
                    live[g][i] = None
                else:
                    live[g][i] = "done"
                    if all(c == "done" for c in live[g]):
                        del live[g]
                        if rng.random() < 0.75:
                            jp.cache_chain(g, prompts[g])
                            tp.cache_chain(g, prompts[g])
                        else:
                            jp.drop_prefix(g)
                            tp.drop_prefix(g)
                        ops["finish"] += 1
            elif 0.93 <= op < 0.96:
                jp.flush_cache()
                tp.flush_cache()
                ops["flush"] += 1
            elif op >= 0.99:
                jp.invalidate_cache()
                tp.invalidate_cache()
            _same_pools(jp, tp, jstore, tstore)
    finally:
        jstore.close()
    assert ops["cold"] and ops["admit"] and ops["finish"], ops
    assert ops["warm"] and ops["flush"], ops
    if seed != 1:
        assert jp.radix.restored_pages, "no page was restored from the host store"
    else:
        assert jstore.dropped_payloads, "the byte cap dropped nothing"


def test_pool_budget_matches_jax():
    """``kv_pool_pages`` with continuous admission and the prefix cache
    (no static prompt region, the floor raised by a chain each), at a
    fixed device size, at 7B width and on TINY's clamped floor."""
    for cfgs, hbm in (((TQWEN, None), 80 * 2**30), ((TTINY, TINY), 2**20)):
        tcfg = cfgs[0]
        jcfg = cfgs[1] if cfgs[1] is not None else tcfg
        for continuous, cache in ((False, False), (True, False), (True, True)):
            kw = dict(gpu_usage=0.35, param_bytes=5 * 2**30 if hbm > 2**30 else 0,
                      batch_prompts=8, max_prompt_tokens=350, max_new_tokens=1200,
                      page_size=128, spec_draft=0, hbm_bytes=hbm,
                      continuous=continuous, prefix_cache=cache)
            want = jbudget.kv_pool_pages(jcfg, **kw)
            assert tbudget.kv_pool_pages(tcfg, **kw) == want, (tcfg.name, kw)


# ---------------------------------------------------------------- engine

T, N = 12, 3


def _rider(kind: str) -> dict:
    return {"sharing": _refill(prefix_sharing=True),
            "continuous": _refill(continuous_admission=True),
            "cache": _refill(continuous_admission=True, prefix_cache=True)}[kind]


@pytest.mark.parametrize("kind", ["sharing", "continuous", "cache"])
def test_riders_match_jax_and_the_unshared_engine(monkeypatch, weights, kind):
    """Prompts of 3, 8, 13 and 16 tokens (a page-aligned one, a partial
    tail, a prompt shorter than a page), 3 candidates each through 4 slots.
    ``cache`` runs two rounds over the same prompts and adapter: the
    second admits every group with a full page warm through the radix
    cache (its pages restored from the host store, its suffix alone
    prefilled) and must still equal the JAX engine's second round and the
    unshared engine."""
    monkeypatch.setattr(jpe, "jnp", _SnapshotJnp())
    ids, mask = _prompts([3, 8, 13, 16], seed=5)
    kw = _rider(kind)
    jeng, teng = _jengine(T, **kw), _tengine(weights, T, **kw)
    plain = _run(weights, _tengine(weights, T, **_refill()), ids, mask, T, N)
    for rnd in range(2 if kind == "cache" else 1):
        jres, tres = _run_both(weights, jeng, teng, ids, mask, T, N, seed=rnd)
        _assert_same(jres, tres, logp_atol=LOGP_ATOL)
        assert tres.steps_dispatched == jres.steps_dispatched
        np.testing.assert_array_equal(tres.tokens, plain.tokens)
        pool, jpool = teng.last_pool_stats, jeng.last_pool_stats
        for key in ("peak_pages_used", "cow_splits", "pages_shared_frac",
                    "prefill_shared_frac", "groups_prefilled", "radix_hit_rate",
                    "prefill_tok_saved", "spilled_pages", "restored_pages"):
            assert pool[key] == jpool[key], (rnd, key, pool[key], jpool[key])
        assert pool["cb_mode"] == jeng.cb_mode
    if kind == "cache":
        # round 2: the 13- and 16-token prompts hit their first page (a hit
        # stops below the last token, so the 8-token one hits nothing)
        assert pool["prefill_tok_saved"] == 2 * PS and pool["restored_pages"] == 2
        assert teng.last_round_stats["prefill_tokens_skipped"] == 2 * PS
        # a new adapter object drops the cache: the next round misses
        other = {"layers": {t: dict(ab) for t, ab in weights["lora"]["layers"].items()}}
        teng.generate(weights["model"], other, ids, mask,
                      SamplingConfig(max_tokens=T, temperature=0.0, n=N), 0)
        assert teng.last_pool_stats["prefill_tok_saved"] == 0


def test_host_spill_matches_jax_and_the_unpreempted_engine(monkeypatch, weights):
    """Continuous admission with the prefix cache and host spill under a
    budget small enough that slots are preempted: every preempted
    candidate's pages and logits row are parked in host memory and copied
    back at its resume (no recompute). Tokens, lengths, steps and
    logprobs equal the JAX engine's; tokens equal the worst-case pool's."""
    monkeypatch.setattr(jpe, "jnp", _SnapshotJnp())
    t, n = 24, 2
    ids, mask = _prompts([5, 8, 16, 11], seed=3)
    kw = _refill(continuous_admission=True, prefix_cache=True, kv_spill=True,
                 max_kv_pages=13, decode_chunk=4)
    jeng, teng = _jengine(t, **kw), _tengine(weights, t, **kw)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres, logp_atol=LOGP_ATOL)
    assert tres.steps_dispatched == jres.steps_dispatched
    pool, jpool = teng.last_pool_stats, jeng.last_pool_stats
    assert pool["preemptions"] == jpool["preemptions"] > 0
    assert pool["spilled_pages"] == jpool["spilled_pages"] > 0
    assert pool["restored_pages"] == jpool["restored_pages"] > 0
    assert pool["spill_restore_ms_p50"] is not None
    full = _run(weights, _tengine(weights, t, **_refill(continuous_admission=True)),
                ids, mask, t, n)
    np.testing.assert_array_equal(tres.tokens, full.tokens)
    np.testing.assert_allclose(tres.logprobs, full.logprobs, atol=LOGP_ATOL, rtol=0)


# ---------------------------------------------------------------- config

_PAGED = dict(engine_impl="paged", continuous_batching=True, max_concurrent_sequences=8)
RIDER_FLAGS = [
    dict(_PAGED, prefix_sharing=True),
    dict(_PAGED, continuous_admission=True),
    dict(_PAGED, continuous_admission=True, prefix_cache=True),
    dict(_PAGED, continuous_admission=True, prefix_cache=False),
    dict(_PAGED, continuous_admission=True, prefix_cache=True, kv_spill=True,
         kv_spill_host_mb=64),
    dict(_PAGED, spec_draft=4, spec_drafter="self", spec_adapt=True, spec_verify="unrolled"),
    dict(_PAGED, spec_drafter="self"),
    dict(_PAGED, spec_adapt=True),
    dict(_PAGED, continuous_admission=True, kv_cache_quant="int8", spec_draft=2),
    # refused
    dict(prefix_sharing=True),
    dict(continuous_admission=True, engine_impl="paged"),
    dict(_PAGED, prefix_cache=True),
    dict(_PAGED, continuous_admission=True, prefix_cache=True, kv_cache_quant="int8"),
    dict(_PAGED, continuous_admission=True, kv_spill=True),
    dict(_PAGED, continuous_admission=True, prefix_cache=True, kv_spill=True, spec_draft=4),
    dict(_PAGED, kv_spill_host_mb=64),
    dict(_PAGED, spec_draft=4, spec_drafter="draft_model"),
    dict(_PAGED, spec_draft=4, spec_verify="blocked"),
    dict(_PAGED, spec_draft=0, spec_adapt=True),
    dict(_PAGED, spec_draft=0, spec_drafter="self"),
    dict(spec_drafter="ngram"),
    dict(spec_adapt=True),
]


@pytest.mark.parametrize("kw", RIDER_FLAGS,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()
                                                 if k not in _PAGED))
def test_train_config_rider_flags_validate_and_wire_as_jax(kw):
    """``TrainConfig`` accepts and refuses the riders' flag combinations as
    the JAX package's does, and ``engine_kwargs_from_config`` passes the
    accepted ones to the engine as JAX's does."""
    from distrl_llm_tpu import config as jconfig
    from distrl_llm_tpu import trainer as jtrainer
    from distrl_llm_tpu_torch import config as tconfig
    from distrl_llm_tpu_torch import trainer as ttrainer

    try:
        j = jconfig.TrainConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            tconfig.TrainConfig(**kw)
        return
    p = tconfig.TrainConfig(**kw)
    assert ttrainer.engine_kwargs_from_config(p) == jtrainer.engine_kwargs_from_config(j)


def test_cli_takes_the_rider_flags():
    from distrl_llm_tpu_torch import train_distributed as cli

    args = cli.build_parser().parse_args([
        "--engine_impl", "paged", "--continuous_batching", "--max_concurrent_sequences", "8",
        "--continuous_admission", "--prefix_cache", "on", "--kv_spill",
        "--kv_spill_host_mb", "512"])
    cfg = cli.config_from_args(args)
    assert (cfg.continuous_admission, cfg.prefix_cache, cfg.kv_spill,
            cfg.kv_spill_host_mb) == (True, True, True, 512)
    args = cli.build_parser().parse_args([
        "--engine_impl", "paged", "--continuous_batching", "--max_concurrent_sequences", "8",
        "--prefix_sharing", "--spec_draft", "4", "--spec_drafter", "self", "--spec_adapt",
        "--spec_verify", "unrolled", "--prefix_cache", "off"])
    cfg = cli.config_from_args(args)
    assert (cfg.prefix_sharing, cfg.spec_drafter, cfg.spec_adapt, cfg.spec_verify,
            cfg.prefix_cache) == (True, "self", True, "unrolled", False)


RIDERS_REHEARSAL = """
import dataclasses, sys, tempfile
from pathlib import Path
for name in ("safetensors", "tokenizers", "transformers", "datasets", "jax"):
    sys.modules[name] = None  # importing any of them now raises
sys.path.insert(0, ".")
import numpy as np
import torch
torch.set_num_threads(1)  # tiny tensors: threads only contend with the other workers
import chip_smoke as cs
from distrl_llm_tpu_torch.models.configs import GEMMA_2B, TINY

w = cs.make_weights(TINY, "cpu", seed=0, rank=4)
small = dict(n=2, slots=4, page_size=8, max_prompt_tokens=96)
a = cs.prefix_cache_phase(TINY, "cpu", w, seed=0, splash=False, max_new_tokens=8, **small)
r1, r2 = a["rounds"]
# round 1 goes warm only where an earlier group left a matching leading page
assert r1["stats"]["warm_prefills"] < 8 and r2["stats"]["warm_prefills"] == 8
assert r2["pool"]["prefill_tok_saved"] > 0 and r2["pool"]["restored_pages"] > 0
assert np.array_equal(r1["res"].tokens, r2["res"].tokens)
for r in (r1, r2):
    assert r["counts"] == {k["name"]: 0 for k in cs.KERNELS}  # CPU: no launch
    try:
        cs.check_rider_counts(r, TINY.num_layers, splash=False)
        raise AssertionError("a CPU round passed the launch check")
    except cs.SmokeFailure:
        pass
b = cs.spill_phase(TINY, "cpu", w, seed=0, max_new_tokens=64, max_kv_pages=16,
                   **{**small, "page_size": 32})
assert b["spill"]["pool"]["preemptions"] > 0 and b["spill"]["pool"]["restored_pages"] > 0
assert np.array_equal(b["spill"]["res"].tokens, b["full"]["res"].tokens)
c = cs.self_draft_phase(TINY, "cpu", w, seed=0, max_new_tokens=12, **small)
assert c["greedy"]["spec"]["draft_forwards"] > 0 and c["sampled"]["spec"]["drafted"] > 0
assert np.array_equal(c["greedy"]["res"].tokens, c["plain"]["res"].tokens)
ex = cs.self_draft_exactness("cpu", 0, max_new_tokens=12)
assert np.array_equal(ex["spec"]["res"].tokens, ex["plain"]["res"].tokens)
assert ex["spec"]["spec"]["accepted"] > 0
wide = cs.make_weights(TINY, "cpu", seed=0, dtype=torch.float32)
wc = cs.warm_cold_logits(wide, max_prompt_tokens=96, page_size=8)
assert wc["err"] <= 1e-5 and wc["skipped"] > 0, wc
miss = cs.cache_miss_after_a_push(TINY, "cpu", wide, page_size=8)
assert miss["saved"][0] == 0 < miss["saved"][1] and miss["saved"][2] == 0, miss
assert miss["same"], miss
qc = cs.dense_int8_quantize_check("cpu", 0, shape=(2, 2, 16, 32))
assert qc["q_equal"] and qc["s_equal"]
lg = cs.dense_int8_logits(wide, seed=0, n=2, max_prompt_tokens=96, max_new_tokens=12)
assert 0 < lg["err"] < 0.05, lg
d = cs.rollout(TINY, "cpu", seed=0, max_prompt_tokens=96, max_new_tokens=8, n=2, rank=4,
               engine="dense", kv_quant="int8", weights=w, top_p_impl="bisect_mw")
assert d["steps"] > 0 and d["counts"]["fused_sample"] == 0 and len(d["greedy"]) == 2
gcfg = dataclasses.replace(GEMMA_2B, num_layers=2, vocab_size=2048, hidden_size=64,
                           intermediate_size=128, num_heads=2, num_kv_heads=1, head_dim=32)
kw = dict(max_prompt_tokens=96, max_new_tokens=8, num_candidates=4, topk=4,
          train_batch_size=4, eval_n=2)
with tempfile.TemporaryDirectory() as tmp:
    gm = cs.gemma_phase(gcfg, "cpu", seed=0, workdir=Path(tmp), hbm_bytes=2**30,
                        config_kw=kw)
cs.check_trainer_run(gm, 2, steps=1, lr=gm["trainer"].config.lr, cuda=False)
assert gm["tokenizer"] == "NativeSPMTokenizer" and gm["ids"] == gm["expected"], gm["ids"]
assert gm["kv_quant"] == "int8"
print("REHEARSAL OK")
"""


def test_chip_smoke_riders_phase_rehearses_on_cpu():
    """Phase 9 of chip_smoke.py on TINY on the CPU (8-token pages, 4 slots,
    a few new tokens; the Gemma checkpoint at a 64-wide, 2048-token cut of
    Gemma-2B), in a process where ``safetensors``, ``tokenizers``,
    ``transformers``, ``datasets`` and ``jax`` cannot be imported: the
    phase's path needs none of them."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", RIDERS_REHEARSAL], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REHEARSAL OK" in proc.stdout
