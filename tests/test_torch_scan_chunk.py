"""Scan chunks (``scan_chunk``, the trainer's ``decode_scan_chunk``): the
port's chunked dense engine and paged wave scheduler against the live JAX
engines at the same ``scan_chunk``.

On the CPU the port's chunk body runs eagerly at the chunk cadence (on the
card each chunk is a CUDA graph replay); the JAX engines run one scanned
program a chunk. Both run ``pick_chunk``'s k, ``max_steps // k`` chunks
with an early-exit read of the snapshot one chunk old, then the per-step
tail, and consume in-flight adapter swaps at chunk boundaries. So greedy
tokens, lengths, the steps dispatched and the swap log must be equal.
Behavior logprobs agree within ``LOGP_ATOL``: the JAX chunked dense
program reads the cache with its "mulred" formulation and the port with
the plain one, and the paged engines attend with an online against a
one-shot softmax: the same f32 sums in other orders. The largest distance
measured over these cases is 9.5e-7 (4.8e-7 with the int8 dense cache), at
TINY's widths.

The JAX engines do not report the steps they dispatched; the tests read
them from the ``steps_seen`` counter their chunk step shares with the tail
(``make_swap_aware_chunk_step`` wrapped).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.engine import engine as jengine_mod
from distrl_llm_tpu.engine import paged_engine as jpaged_mod
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.engine.engine import pick_chunk as jpick_chunk
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu_torch import PagedGenerationEngine
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.engine import GenerationEngine, pick_chunk
from distrl_llm_tpu_torch.models.configs import TINY as TTINY
from distrl_llm_tpu_torch.models.convert import lora_from_numpy
from tests.test_torch_engine import _lora, _prompts, weights  # noqa: F401  (weights: the fixture)
from tests.test_torch_paged_engine import P, PS, _swap_at
from tests.test_torch_prefix_cache import _one_torch_thread  # noqa: F401  (autouse)

LOGP_ATOL = 1e-5
PAD = 0
NO_EOS = 999  # outside TINY's vocabulary: never sampled
LORA_SCALE = 0.5
ENGINES = ("dense", "waves")


@pytest.fixture
def jax_steps(monkeypatch):
    """The JAX engines' ``steps_seen`` counters, one per chunked wave."""
    seen = []
    for mod in (jengine_mod, jpaged_mod):
        orig = mod.make_swap_aware_chunk_step

        def wrapped(mailbox, lora_cell, steps_seen, *a, _orig=orig, **kw):
            seen.append(steps_seen)
            return _orig(mailbox, lora_cell, steps_seen, *a, **kw)

        monkeypatch.setattr(mod, "make_swap_aware_chunk_step", wrapped)
    return seen


def _pair(weights, kind: str, *, t: int, k: int, eos=NO_EOS, kv_quant=None):
    """(JAX engine, port engine) of ``kind`` at ``scan_chunk=k``: f32 cache
    or pages, no autotune."""
    common = dict(max_prompt_tokens=P, max_new_tokens=t, eos_token_ids=[eos],
                  pad_token_id=PAD, lora_scale=LORA_SCALE, capture_logprobs=True,
                  scan_chunk=k, kv_quant=kv_quant)
    if kind == "dense":
        return (JEngine(TINY, cache_dtype=jnp.float32, autotune=False, **common),
                GenerationEngine(weights["cfg"], cache_dtype=torch.float32, device="cpu",
                                 **common))
    paged = dict(common, page_size=PS)
    return (jpaged_mod.PagedGenerationEngine(TINY, cache_dtype=jnp.float32, autotune=False,
                                             paged_impl="reference", **paged),
            PagedGenerationEngine(weights["cfg"], cache_dtype=torch.float32, device="cpu",
                                  **paged))


def _greedy(t, n):
    from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig

    return (JSamplingConfig(max_tokens=t, temperature=0.0, n=n),
            SamplingConfig(max_tokens=t, temperature=0.0, n=n))


def _run(weights, jeng, teng, ids, mask, t, n, jax_steps, *, lora=True, seed=0):
    js, ts = _greedy(t, n)
    jres = jeng.generate(weights["jparams"], weights["jlora"] if lora else None, ids, mask,
                         js, jax.random.PRNGKey(seed))
    tres = teng.generate(weights["model"], weights["lora"] if lora else None, ids, mask,
                         ts, seed)
    return jres, tres, sum(s[0] for s in jax_steps)


def _assert_same(jres, tres, jsteps, tsteps_want=None):
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.lengths, jres.lengths)
    np.testing.assert_allclose(tres.logprobs, jres.logprobs, atol=LOGP_ATOL, rtol=0)
    assert tres.steps_dispatched == jsteps
    if tsteps_want is not None:
        assert jsteps == tsteps_want


@pytest.mark.parametrize("kind", ENGINES)
@pytest.mark.parametrize("k,t,want_chunk", [(4, 6, 3), (4, 7, 4), (16, 3, 3)],
                         ids=["divisor", "prime_tail", "k_above_max_new"])
def test_greedy_chunks_match_jax(weights, jax_steps, kind, k, t, want_chunk):
    """4 over 6 (k = 3, two chunks), 4 over 7 (one chunk of 4 and a 3-step
    tail), 16 over 3 (one chunk of 3); prompts of 5, 16, 9 tokens and an
    empty padding row, n = 2."""
    assert pick_chunk(k, t) == want_chunk
    ids, mask = _prompts([5, 16, 0, 9], P)
    jeng, teng = _pair(weights, kind, t=t, k=k)
    jres, tres, jsteps = _run(weights, jeng, teng, ids, mask, t, 2, jax_steps)
    _assert_same(jres, tres, jsteps, tsteps_want=t)
    assert jeng.scan_chunk_active and teng.scan_chunk_active
    forwards = teng.last_round_stats["decode_forwards"]
    # every chunk step forwards its token; only a tail's last step skips it
    assert forwards == (t - 1 if t % want_chunk else t)
    assert teng.last_round_stats["graph_steps"] == 0  # nothing graphed on the CPU


@pytest.mark.parametrize("kind", ENGINES)
def test_eos_at_a_chunk_boundary_stops_as_jax(weights, jax_steps, kind):
    """One prompt, n = 2 (identical greedy rows): EOS is the token the rows
    emit at step j, the first step whose token they did not emit before, and
    k = j + 1, so every row is done at the end of chunk 1. Both engines see
    it in the snapshot read after chunk 2 and stop there: 2k of 3k steps."""
    for seed in range(32):  # a prompt whose greedy row changes token early
        ids, mask = _prompts([7], P, seed=seed)
        probe = _pair(weights, kind, t=6, k=0)[1].generate(
            weights["model"], weights["lora"], ids, mask, _greedy(6, 1)[1], 0).tokens[0, 0]
        j = next((i for i in range(1, 6) if probe[i] not in probe[:i]), None)
        if j is not None:
            break
    assert j is not None
    k = j + 1
    jeng, teng = _pair(weights, kind, t=3 * k, k=k, eos=int(probe[j]))
    jres, tres, jsteps = _run(weights, jeng, teng, ids, mask, 3 * k, 2, jax_steps)
    _assert_same(jres, tres, jsteps, tsteps_want=2 * k)
    assert (tres.lengths == k).all()


@pytest.mark.parametrize("kind", ENGINES)
def test_in_flight_push_at_a_chunk_boundary_matches_jax(weights, jax_steps, kind):
    """An adapter pushed as the engines reach step 3 (k = 3 over 6: a chunk
    boundary) is consumed there by both: the same swap log, and tokens equal
    to JAX's under the swap."""
    t, n = 6, 2
    ids, mask = _prompts([9, 16], P, seed=14)
    new = _lora(seed=5, scale=0.5)
    jeng, teng = _pair(weights, kind, t=t, k=4)
    _swap_at(jeng, 3, jax.tree_util.tree_map(jnp.asarray, new), 7)
    _swap_at(teng, 3, lora_from_numpy(new, weights["cfg"], device="cpu"), 7)
    jres, tres, jsteps = _run(weights, jeng, teng, ids, mask, t, n, jax_steps)
    _assert_same(jres, tres, jsteps, tsteps_want=t)
    assert teng.last_swap_steps == jeng.last_swap_steps == [3]
    assert teng.last_swap_versions == jeng.last_swap_versions == [7]


def test_first_adapter_pushed_into_a_none_round_matches_jax(weights, jax_steps):
    """A round without an adapter that receives its first one before step
    0 (the JAX package's structural swap: its chunk program is rebuilt; the
    port's chunk runner keys the adapter's tensors). The prefill ran
    without it, so the round is held to JAX's, not to a round that passed
    the adapter."""
    t = 6
    ids, mask = _prompts([5, 12], P, seed=2)
    jeng, teng = _pair(weights, "dense", t=t, k=3)
    jeng.push_lora(weights["jlora"])
    teng.push_lora(weights["lora"])
    jres, tres, jsteps = _run(weights, jeng, teng, ids, mask, t, 2, jax_steps, lora=False)
    _assert_same(jres, tres, jsteps, tsteps_want=t)
    assert teng.last_swap_steps == jeng.last_swap_steps == [0]


def test_int8_dense_cache_chunks_match_jax(weights, jax_steps):
    t = 7
    ids, mask = _prompts([5, 16, 9], P)
    jeng, teng = _pair(weights, "dense", t=t, k=4, kv_quant="int8")
    jres, tres, jsteps = _run(weights, jeng, teng, ids, mask, t, 2, jax_steps)
    _assert_same(jres, tres, jsteps, tsteps_want=t)


def test_pick_chunk_matches_jax():
    for scan_chunk in range(1, 70):
        for max_steps in (1, 2, 3, 4, 6, 7, 12, 13, 60, 97, 128, 1200):
            assert pick_chunk(scan_chunk, max_steps) == jpick_chunk(scan_chunk, max_steps)


@pytest.mark.parametrize("kind", ENGINES)
def test_negative_scan_chunk_raises_as_jax(weights, kind):
    with pytest.raises(ValueError, match="scan_chunk"):
        _pair(weights, kind, t=4, k=-1)


@pytest.mark.parametrize("kind", ENGINES)
def test_sampled_chunks_equal_the_per_step_loop(weights, kind):
    """Sampled (t = 1.1, top-p 0.9), 4 over 7: a chunk's k seed vectors are
    drawn before it by the per-step loop's k calls, so the port's chunked
    round equals its per-step round bit for bit (the JAX engines draw other
    numbers than the port's by construction)."""
    t = 7
    ids, mask = _prompts([5, 16, 9], P)
    sampling = SamplingConfig(max_tokens=t, temperature=1.1, top_p=0.9, n=3)
    a, b = (_pair(weights, kind, t=t, k=k)[1].generate(
        weights["model"], weights["lora"], ids, mask, sampling, 5) for k in (0, 4))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.logprobs, b.logprobs)


@pytest.mark.parametrize("kind", ENGINES)
def test_a_chunk_keeps_every_state_tensor_at_its_address(weights, monkeypatch, kind):
    """What a captured graph needs: the tensors a chunk reads and writes are
    the same objects at the same addresses after it as before (a re-bound
    ``s.logits = ...`` or a reallocated cache would fail here), and the
    next round decodes over the same state."""
    t, n = 8, 2
    ids, mask = _prompts([5, 11], P)
    teng = _pair(weights, kind, t=t, k=4)[1]
    seen = []
    run = teng.decode_graphs.run

    def recording(key, body, device):
        state = teng._chunk_state[1]
        before = _addresses(state)
        run(key, body, device)
        seen.append((before, _addresses(state)))

    monkeypatch.setattr(teng.decode_graphs, "run", recording)
    for _ in range(2):
        teng.generate(weights["model"], weights["lora"], ids, mask, _greedy(t, n)[1], 0)
    assert len(seen) == 4  # two chunks a round
    assert all(before == after == seen[0][0] for before, after in seen)


def _addresses(state) -> list:
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        tensors = (v if isinstance(v, list) else
                   [x for layers in v.values() for x in layers] if isinstance(v, dict) else [v])
        for x in tensors:
            for t in (x if isinstance(x, tuple) else (x,)):  # int8 pages: (weight, scales)
                if isinstance(t, torch.Tensor):
                    out.append((f.name, t.data_ptr()))
    return out


def test_chip_smoke_graph_phase_rehearses_on_cpu(tmp_path):
    """Phase 11 of chip_smoke.py at TINY on the CPU, chunks of 4 over 12
    new tokens (nothing is graphed here: each chunk runs eagerly): (a) and
    (b) the graphed and eager engines in turns with equal tokens, (c) a
    sampled round, (d) a push at step 4, (e) the int4 base against its eager
    round, (f) one ``Trainer.train()`` step with ``decode_scan_chunk``."""
    import chip_smoke

    cfg = dataclasses.replace(TTINY, vocab_size=1024)  # the BPE needs 259 ids
    shape = dict(max_prompt_tokens=96, max_new_tokens=12, n=2, page_size=8, rank=4, chunk=4)
    w = chip_smoke.make_weights(cfg, "cpu", seed=0, rank=4)
    ab = {engine: chip_smoke.graph_ab(cfg, "cpu", w, engine=engine, seed=0, **shape)
          for engine in ("dense", "paged")}
    np.testing.assert_array_equal(ab["dense"]["tokens"], ab["paged"]["tokens"])
    assert all(r["steps"] == 12 for _, r in ab["dense"]["rounds"])
    assert ab["dense"]["g"].scan_chunk_active and ab["dense"]["e"].scan_chunk_active is None
    chip_smoke.graph_sampled(ab["dense"], w, seed=0, layers=cfg.num_layers)
    chip_smoke.graph_swap(ab["dense"], w, cfg, seed=0, step=4, rank=4)
    qw = chip_smoke.make_qlora_weights(cfg, "cpu", seed=0, bits=4, group=16, rank=4)
    eager = chip_smoke.rollout(cfg, "cpu", seed=0, max_prompt_tokens=96, max_new_tokens=12,
                               n=2, rank=4, weights=qw, greedy_rounds=1)["greedy_tokens"]
    rs = chip_smoke.graph_qlora(cfg, "cpu", qw, seed=0, eager_tokens=eager, **shape)
    assert all(r["forwards"] == 12 and r["prefills"] == 1 for r in rs)
    tok = chip_smoke.write_bpe_tokenizer(tmp_path / "tok", cfg.vocab_size)
    f = chip_smoke.graph_trainer(cfg, "cpu", seed=0, workdir=tmp_path / "f", tokenizer_dir=tok,
                                 max_prompt_tokens=96, max_new_tokens=8, num_candidates=4,
                                 topk=4, train_batch_size=4, eval_n=2)
    chip_smoke.check_trainer_run(f, cfg.num_layers, steps=1, lr=f["config"].lr, cuda=False)
    assert f["trainer"].engine.scan_chunk == chip_smoke.GRAPH_CHUNK
    assert f["trainer"].engine.scan_chunk_active
