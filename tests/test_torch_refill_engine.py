"""Parity of the port's refill scheduler and speculative decoding
(``engine/paged_engine.py``, ``scheduler="refill"``) with the JAX package's.

One numpy param tree and one numpy adapter (non-zero B) feed the JAX
``PagedGenerationEngine`` (no autotune, no scan chunks, f32 pages, the
reference paged attention) and the port's (``device="cpu"``: the plain
versions of K1, K2 and K5) on ``TINY`` with 8-token pages, at fewer slots
than candidates so that slots refill. Greedy tokens and lengths must be
identical; captured behavior logprobs agree within ``LOGP_ATOL`` (f32), or
``LOGP_ATOL_INT8`` with int8 pages (``test_torch_paged_engine.py`` states
why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig
from distrl_llm_tpu.engine import paged_engine as jpe
from distrl_llm_tpu.models import lora as jlora
from distrl_llm_tpu.models import transformer as jtf
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu.ops import quant as jq
from distrl_llm_tpu_torch import PagedGenerationEngine
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, params_from_numpy
from distrl_llm_tpu_torch.ops import paged_native

LOGP_ATOL = 1e-4
LOGP_ATOL_INT8 = 1e-3
PAD = 0
NO_EOS = 999  # outside TINY's vocabulary: never sampled
LORA_SCALE = 0.5
PS = 8
P = 16  # two prompt pages


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(seed=0):
    tree = _np_tree(jtf.init_params(jax.random.PRNGKey(seed), TINY))
    rng = np.random.default_rng(seed)
    for name, arr in list(tree["layers"].items()):
        if name.endswith("norm") or name.startswith("b"):
            tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
    return tree


def _lora(seed=1, scale=0.05):
    tree = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(seed), TINY, 4))
    rng = np.random.default_rng(seed)
    for ab in tree["layers"].values():
        ab["b"] = (scale * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def weights():
    tree, lora = _params(), _lora()
    cfg = ModelConfig(**dataclasses.asdict(TINY))
    return {
        "jparams": jax.tree_util.tree_map(jnp.asarray, tree),
        "jlora": jax.tree_util.tree_map(jnp.asarray, lora),
        "model": params_from_numpy(tree, cfg, device="cpu"),
        "lora": lora_from_numpy(lora, cfg, device="cpu"),
        "cfg": cfg,
    }


def _prompts(lengths, p=P, seed=7):
    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), p), PAD, np.int32)
    mask = np.zeros((len(lengths), p), np.int32)
    for i, n in enumerate(lengths):
        if n:
            ids[i, p - n:] = rng.integers(4, TINY.vocab_size, n)
            mask[i, p - n:] = 1
    return ids, mask


def _common(t, eos=NO_EOS, **kw):
    return dict(max_prompt_tokens=P, max_new_tokens=t, eos_token_ids=[eos],
                pad_token_id=PAD, lora_scale=LORA_SCALE, capture_logprobs=True,
                page_size=PS, **kw)


def _refill(**kw):
    return dict(scheduler="refill", max_concurrent_rows=4, **kw)


def _jengine(t, **kw):
    return jpe.PagedGenerationEngine(TINY, cache_dtype=jnp.float32, autotune=False,
                                     scan_chunk=0, paged_impl="reference",
                                     **_common(t, **kw))


def _tengine(weights, t, **kw):
    return PagedGenerationEngine(weights["cfg"], cache_dtype=torch.float32,
                                 device="cpu", **_common(t, **kw))


def _greedy(t, n):
    return (JSamplingConfig(max_tokens=t, temperature=0.0, n=n),
            SamplingConfig(max_tokens=t, temperature=0.0, n=n))


def _run_both(weights, jeng, teng, ids, mask, t, n, seed=0):
    js, ts = _greedy(t, n)
    jres = jeng.generate(weights["jparams"], weights["jlora"], ids, mask, js,
                         jax.random.PRNGKey(seed))
    tres = teng.generate(weights["model"], weights["lora"], ids, mask, ts, seed)
    return jres, tres


def _assert_same(jres, tres, logp_atol=LOGP_ATOL):
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.lengths, jres.lengths)
    np.testing.assert_allclose(tres.logprobs, jres.logprobs, atol=logp_atol, rtol=0)


def _run(weights, teng, ids, mask, t, n, seed=0):
    return teng.generate(weights["model"], weights["lora"], ids, mask, _greedy(t, n)[1], seed)


@pytest.mark.parametrize("bits,d,kv_quant", [(4, 3, "none"), (8, 3, "int8"), (4, 0, "none")])
def test_refill_over_a_quantized_base_matches_jax(monkeypatch, weights, bits, d, kv_quant):
    """The refill scheduler, speculative (d = 3) and plain, over a TINY base
    quantized in groups of 16 (int4 or int8): the JAX engine runs its K3
    interpreted, the port K3's plain version; the file's prompts, 3
    candidates through 4 slots."""
    monkeypatch.setenv("DISTRL_QUANT_MATMUL", "interpret")
    t, n = 10, 3
    jparams = jq.quantize_params(weights["jparams"], bits=bits, group_size=16)
    tree = _np_tree(jq.pack_params_int4(jparams) if bits == 4 else jparams)
    qweights = dict(weights, jparams=jparams,
                    model=params_from_numpy(tree, weights["cfg"], device="cpu"))
    assert qweights["model"].quant == (bits, 16)
    ids, mask = _prompts([5, 8, 16, 0, 11])
    kw = _refill(spec_draft=d, kv_quant=kv_quant)
    jeng, teng = _jengine(t, **kw), _tengine(qweights, t, **kw)
    jres, tres = _run_both(qweights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres, LOGP_ATOL_INT8 if kv_quant == "int8" else LOGP_ATOL)
    assert tres.steps_dispatched == jres.steps_dispatched
    if d:
        assert teng.last_spec_stats["emit_hist"] == jeng.last_spec_stats["emit_hist"]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("d", [0, 1, 3])
def test_greedy_matches_jax(weights, d, kv_quant):
    """5 prompts (one an empty padding row, two page-aligned) x 3 candidates
    = 15 candidates through 4 slots: slots refill."""
    t, n = 12, 3
    ids, mask = _prompts([5, 8, 16, 0, 11])
    kw = _refill(spec_draft=d, kv_quant=kv_quant)
    jeng, teng = _jengine(t, **kw), _tengine(weights, t, **kw)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres, LOGP_ATOL_INT8 if kv_quant == "int8" else LOGP_ATOL)
    assert tres.steps_dispatched == jres.steps_dispatched
    assert tres.alive_slot_steps == jres.alive_slot_steps
    assert (tres.lengths[3] == 0).all() and (tres.tokens[3] == PAD).all()
    stats = teng.last_round_stats
    assert stats["gen_rows"] == 15 and stats["decode_forwards"] == tres.steps_dispatched
    if d:
        ts, js = teng.last_spec_stats, jeng.last_spec_stats
        for key in ("emit_hist", "drafted"):
            assert ts[key] == js[key], key
        assert ts["accept_rate"] == pytest.approx(js["accept_rate"], abs=1e-4)
        assert ts["tokens_per_verify_step"] == pytest.approx(js["tokens_per_verify_step"],
                                                             abs=1e-4)
        # the spec round's K1 calls are its admissions, not its steps
        assert stats["sampler_calls"] < tres.steps_dispatched
    else:
        assert teng.last_spec_stats is None
        assert stats["sampler_calls"] == tres.steps_dispatched


@pytest.mark.parametrize("d", [1, 2, 4])
def test_spec_equals_plain_refill_and_the_wave_engine(weights, d):
    """Greedy speculative decoding emits exactly what plain decoding does:
    the same tokens as the plain refill round and as the port's wave
    engine, in fewer slot-steps (the host's snapshot cadence rounds the
    step count itself)."""
    t, n = 16, 2
    ids, mask = _prompts([5, 12, 16, 3, 9], seed=2)
    spec = _run(weights, _tengine(weights, t, **_refill(spec_draft=d)), ids, mask, t, n)
    plain = _run(weights, _tengine(weights, t, **_refill()), ids, mask, t, n)
    waves = _run(weights, _tengine(weights, t), ids, mask, t, n)
    for other in (plain, waves):
        np.testing.assert_array_equal(spec.tokens, other.tokens)
        np.testing.assert_array_equal(spec.lengths, other.lengths)
        np.testing.assert_allclose(spec.logprobs, other.logprobs, atol=LOGP_ATOL, rtol=0)
    assert spec.alive_slot_steps < plain.alive_slot_steps


def test_small_batch_routes_through_spec(weights):
    """Fewer candidates than slots still runs the speculative scheduler."""
    t, n = 10, 2
    ids, mask = _prompts([6, 13], seed=3)
    teng = _tengine(weights, t, **_refill(spec_draft=3))
    teng.max_concurrent_rows = 64
    res = _run(weights, teng, ids, mask, t, n)
    assert teng.last_spec_stats is not None and teng.last_pool_stats is not None
    waves = _run(weights, _tengine(weights, t), ids, mask, t, n)
    np.testing.assert_array_equal(res.tokens, waves.tokens)


@pytest.mark.parametrize("d", [0, 3])
def test_eos_inside_a_draft_block_matches_jax(weights, d):
    t, n = 14, 2
    ids, mask = _prompts([10, 6, 16, 4], seed=9)
    probe = _run(weights, _tengine(weights, t, **_refill()), ids, mask, t, n)
    eos = int(probe.tokens[0, 0, 3])  # row 0 meets it by step 3
    kw = _refill(spec_draft=d)
    jres, tres = _run_both(weights, _jengine(t, eos=eos, **kw),
                           _tengine(weights, t, eos=eos, **kw), ids, mask, t, n)
    _assert_same(jres, tres)
    assert tres.lengths[0, 0] <= 4 and (tres.lengths < t).any()
    # nothing after a row's EOS
    tok = tres.tokens.reshape(-1, t)
    for row, ln in zip(tok, tres.lengths.reshape(-1)):
        assert (row[ln:] == PAD).all()
        assert eos not in row[:max(ln - 1, 0)]


@pytest.mark.parametrize("seed", range(4))
def test_near_budget_draft_writes_do_not_corrupt_the_cache(seed):
    """The verify writes d+1 tokens' K/V even when a row is within d tokens
    of its budget; they must land in its own spare pages, never clamp onto
    resident KV. Page size 4, prompts of 7 tokens (one short of a page
    boundary), d = 4: speculative greedy equals plain greedy."""
    cfg = ModelConfig(**dataclasses.asdict(TINY))
    tree = _np_tree(jtf.init_params(jax.random.PRNGKey(3), TINY))
    model = params_from_numpy(tree, cfg, device="cpu")
    r = np.random.default_rng(seed)
    ids = r.integers(1, TINY.vocab_size, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[:, :1] = 0
    ids[:, :1] = 0
    kw = dict(max_prompt_tokens=8, max_new_tokens=8, eos_token_ids=[TINY.vocab_size - 1],
              pad_token_id=0, cache_dtype=torch.float32, page_size=4, device="cpu",
              scheduler="refill", max_concurrent_rows=2)
    sc = SamplingConfig(max_tokens=8, temperature=0.0, n=1)
    plain = PagedGenerationEngine(cfg, **kw).generate(model, None, ids, mask, sc, 0)
    spec = PagedGenerationEngine(cfg, **kw, spec_draft=4).generate(model, None, ids, mask, sc, 0)
    np.testing.assert_array_equal(spec.tokens, plain.tokens)


def _swap_at(engine, step, lora, version):
    take = engine._take_pending_lora

    def patched(cell, dispatched):
        if dispatched == step:
            engine.push_lora(lora, version=version)
        take(cell, dispatched)

    engine._take_pending_lora = patched


@pytest.mark.parametrize("d", [0, 2])
def test_push_lora_mid_round_matches_jax(weights, d):
    t, n = 12, 3
    ids, mask = _prompts([9, 16, 4], seed=14)
    new = _lora(seed=5, scale=0.5)
    kw = _refill(spec_draft=d)
    jeng, teng = _jengine(t, **kw), _tengine(weights, t, **kw)
    _swap_at(jeng, 3, jax.tree_util.tree_map(jnp.asarray, new), 7)
    _swap_at(teng, 3, lora_from_numpy(new, weights["cfg"], device="cpu"), 7)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres)
    assert teng.last_swap_steps == jeng.last_swap_steps == [3]
    assert teng.last_swap_versions == [7]
    plain = _run(weights, _tengine(weights, t, **kw), ids, mask, t, n)
    assert not np.array_equal(tres.tokens, plain.tokens)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_unrolled_verify_equals_fused(weights, kv_quant):
    t, n = 12, 3
    ids, mask = _prompts([5, 8, 16, 11], seed=4)
    fused = _tengine(weights, t, **_refill(spec_draft=3, kv_quant=kv_quant))
    unrolled = _tengine(weights, t, **_refill(spec_draft=3, spec_verify="unrolled",
                                              kv_quant=kv_quant))
    a = _run(weights, fused, ids, mask, t, n)
    b = _run(weights, unrolled, ids, mask, t, n)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_allclose(a.logprobs, b.logprobs, atol=LOGP_ATOL, rtol=0)
    assert unrolled.last_spec_stats["verify_impl"] == "unrolled"
    assert fused.last_spec_stats["emit_hist"] == unrolled.last_spec_stats["emit_hist"]


def test_cpu_rounds_launch_no_kernel(weights):
    before = (paged_native.paged_verify_launches, paged_native.paged_attention_launches)
    t, n = 8, 2
    ids, mask = _prompts([5, 9, 16], seed=5)
    for kw in (_refill(spec_draft=2), _refill()):
        _run(weights, _tengine(weights, t, **kw), ids, mask, t, n)
    assert (paged_native.paged_verify_launches, paged_native.paged_attention_launches) == before


@pytest.mark.parametrize("knob,err", [
    ({"scheduler": "refill"}, ValueError),  # no slot count
    ({"spec_draft": 2}, ValueError),  # speculative decoding needs the refill scheduler
    ({**_refill(), "spec_draft": 17}, ValueError),
    ({**_refill(), "spec_draft": 2, "spec_ngram": 0}, ValueError),
    ({**_refill(), "spec_draft": 2, "spec_verify": "blocked"}, ValueError),
    ({**_refill(), "max_kv_pages": 2}, ValueError),  # cannot fit one sequence
    ({**_refill(), "spec_drafter": "draft_model"}, ValueError),
    ({**_refill(), "spec_draft": 0, "spec_adapt": True}, ValueError),  # nothing to adapt
    ({**_refill(), "prefix_cache": True}, ValueError),  # needs continuous_admission
    ({"continuous_admission": True}, ValueError),  # needs the refill scheduler
])
def test_engine_checks_its_knobs(weights, knob, err):
    with pytest.raises(err, match="ROADMAP" if err is NotImplementedError else None):
        _tengine(weights, 8, **knob)
