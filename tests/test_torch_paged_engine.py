"""Parity of the port's paged rollout engine (wave scheduler) with the JAX
package's.

One numpy param tree and one numpy adapter tree (non-zero B) feed the JAX
``PagedGenerationEngine`` (no autotune, no scan chunks, f32 pages, the
reference paged attention) and the port's ``PagedGenerationEngine(device=
"cpu")`` (the plain version of kernel K2) on ``TINY`` with 8-token pages.
Greedy tokens and lengths must be identical; captured behavior logprobs
agree within ``LOGP_ATOL`` (f32 forwards over widths <= 128 and an online
against a one-shot softmax).
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
from distrl_llm_tpu_torch import PagedGenerationEngine
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine import paged_engine as tpe
from distrl_llm_tpu_torch.engine.engine import GenerationEngine
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, params_from_numpy

LOGP_ATOL = 1e-4
LOGIT_ATOL = 1e-4
# int8 pages: a token's absmax element lands at ±127.5 up to f32 rounding,
# so the packages' f32 noise decides -127 or -128 for a negative absmax
# (+128 saturates to 127 either way); one such step moves TINY's behavior
# logprobs by ~3e-4
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
    """Left-padded prompt ids/mask [B, p]; a length of 0 is a batch-padding
    row (empty prompt)."""
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


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("n", [1, 3])
def test_greedy_matches_jax(weights, n, kv_quant):
    """Left-padded prompts of 5 and 11 tokens, two page-aligned ones (8: one
    full page; 16: both prompt pages full, so the copied partial page is
    never read) and an empty padding row, born done."""
    t = 10
    ids, mask = _prompts([5, 8, 16, 0, 11])
    jeng, teng = _jengine(t, kv_quant=kv_quant), _tengine(weights, t, kv_quant=kv_quant)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres, LOGP_ATOL_INT8 if kv_quant == "int8" else LOGP_ATOL)
    assert tres.tokens.shape == (5, n, t)
    assert (tres.lengths[3] == 0).all() and (tres.tokens[3] == PAD).all()
    assert tres.steps_dispatched == t
    for key in ("prefill_tokens", "prompt_rows", "gen_tokens", "gen_rows"):
        assert teng.last_round_stats[key] == jeng.last_round_stats[key], key
    # the round's last step skips the forward nothing reads
    assert teng.last_round_stats["decode_forwards"] == t - 1


def test_greedy_matches_jax_in_waves_with_dead_tail_and_empty_prompt(weights):
    """5 prompts x 2 candidates at max 4 concurrent rows: 3 waves of 2
    prompts, the tail wave padded with a dead row; prompt 1 is empty."""
    t, n = 8, 2
    ids, mask = _prompts([7, 0, 16, 3, 9], seed=8)
    jeng = _jengine(t, max_concurrent_rows=4)
    teng = _tengine(weights, t, max_concurrent_rows=4)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n, seed=3)
    _assert_same(jres, tres)
    assert tres.tokens.shape == (5, n, t)
    assert (tres.lengths[1] == 0).all()
    assert tres.steps_dispatched == 3 * t
    assert teng.last_round_stats["prompt_rows"] == 6
    assert teng.last_round_stats["decode_forwards"] == 3 * (t - 1)


def test_greedy_matches_jax_when_eos_is_hit(weights):
    t, n = 12, 2
    ids, mask = _prompts([10, 6, 16], seed=9)
    probe = _tengine(weights, t)
    base = probe.generate(weights["model"], weights["lora"], ids, mask, _greedy(t, n)[1], 0)
    eos = int(base.tokens[0, 0, 2])  # row 0 meets it at step 2 at the latest
    jres, tres = _run_both(weights, _jengine(t, eos=eos), _tengine(weights, t, eos=eos),
                           ids, mask, t, n)
    _assert_same(jres, tres)
    assert tres.lengths[0, 0] <= 3 and (tres.lengths < t).any()


def test_prefill_and_fanout_match_jax(weights):
    """The packed prefill's last-position logits and pages, the fan-out's
    page table (shared full prompt pages, private partial copies) and its
    pool, against the JAX functions directly."""
    b, n, t = 3, 2, 8
    ids, mask = _prompts([5, 16, 9], seed=10)
    pp, priv = 2, 1 + -(-t // PS)
    kw = dict(prompt_pages=pp, page_size=PS, lora_scale=LORA_SCALE, attn_impl="reference")
    jk, jv, jlog, jlen = jpe._paged_prefill(
        weights["jparams"], weights["jlora"], jnp.asarray(ids), jnp.asarray(mask),
        cfg=TINY, cache_dtype=jnp.float32, **kw)
    with torch.inference_mode():
        tk, tv, tlog, tlen = tpe._paged_prefill(
            weights["model"], weights["lora"], torch.from_numpy(ids), torch.from_numpy(mask),
            cache_dtype=torch.float32, total_pages=b * pp + b * n * priv, **kw)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for i in range(TINY.num_layers):
        np.testing.assert_allclose(tk[i][:, :b * pp].numpy(), np.asarray(jk[i]),
                                   atol=LOGIT_ATOL, rtol=0)
    alive = mask.sum(-1) > 0
    jstate, jtable = jpe._paged_fanout(
        jk, jv, jlog, jlen, jnp.asarray(alive), n=n, b=b, prompt_pages=pp,
        private_pages=priv, page_size=PS, max_steps=t)
    with torch.inference_mode():
        tstate, ttable = tpe._paged_fanout(
            tk, tv, tlog, tlen, torch.from_numpy(alive), n=n, b=b, prompt_pages=pp,
            private_pages=priv, page_size=PS, max_steps=t, pad_id=PAD)
    np.testing.assert_array_equal(ttable.numpy(), np.asarray(jtable))
    assert ttable[0, 0] != ttable[1, 0]  # prompt 0 has no full page
    np.testing.assert_array_equal(ttable[2, :2].numpy(), ttable[3, :2].numpy())  # all shared
    assert ttable[4, 0] == ttable[5, 0] and ttable[4, 1] != ttable[5, 1]
    for i in range(TINY.num_layers):
        np.testing.assert_allclose(tstate.v_pages[i].numpy(), np.asarray(jstate.v_pages[i]),
                                   atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(tstate.seq_lengths.numpy(), np.asarray(jstate.seq_lengths))
    np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))


def test_int8_prefill_pages_hold_the_jax_quantization(weights):
    """int8 pools: the prefill's scales equal the JAX ones to f32 rounding,
    and the weights exactly, except for one step at a token's absmax element
    (±127.5 before rounding, see ``LOGP_ATOL_INT8``)."""
    ids, mask = _prompts([5, 16, 9], seed=11)
    kw = dict(prompt_pages=2, page_size=PS, lora_scale=LORA_SCALE, attn_impl="reference",
              kv_quant="int8")
    jk, _, jlog, _ = jpe._paged_prefill(
        weights["jparams"], weights["jlora"], jnp.asarray(ids), jnp.asarray(mask),
        cfg=TINY, cache_dtype=jnp.float32, **kw)
    with torch.inference_mode():
        tk, _, tlog, _ = tpe._paged_prefill(
            weights["model"], weights["lora"], torch.from_numpy(ids), torch.from_numpy(mask),
            cache_dtype=torch.float32, **kw)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    for i in range(TINY.num_layers):
        tw, jw = tk[i].weight.numpy().astype(int), np.asarray(jk[i].weight).astype(int)
        moved = tw != jw
        assert np.abs(tw - jw).max() <= 1 and moved.mean() < 0.02
        assert (np.minimum(np.abs(tw), np.abs(jw))[moved] == 127).all()
        np.testing.assert_allclose(tk[i].scales.numpy(), np.asarray(jk[i].scales),
                                   atol=LOGIT_ATOL, rtol=0)


def test_paged_greedy_equals_the_ports_dense_engine(weights):
    """Packing only shifts RoPE positions, which relative attention cancels:
    greedy tokens equal the dense engine's in f32."""
    t, n = 10, 2
    ids, mask = _prompts([5, 16, 9, 1], seed=12)
    paged = _tengine(weights, t)
    dense = GenerationEngine(weights["cfg"], cache_dtype=torch.float32, device="cpu",
                             **{k: v for k, v in _common(t).items() if k != "page_size"})
    ts = _greedy(t, n)[1]
    a = paged.generate(weights["model"], weights["lora"], ids, mask, ts, 0)
    b = dense.generate(weights["model"], weights["lora"], ids, mask, ts, 0)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_allclose(a.logprobs, b.logprobs, atol=LOGP_ATOL, rtol=0)


def test_sampled_path_invariants_and_reproducibility(weights):
    t, n = 12, 3
    ids, mask = _prompts([10, 4, 16], seed=13)
    teng = _tengine(weights, t, eos=5, kv_quant="int8")
    sc = SamplingConfig(max_tokens=t, temperature=1.2, top_p=0.95, n=n)
    a = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 11)
    b = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 11)
    c = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 12)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert not np.array_equal(a.tokens, c.tokens)
    assert not np.array_equal(a.tokens[0, 0], a.tokens[0, 1])
    tok, lengths = a.tokens.reshape(-1, t), a.lengths.reshape(-1)
    after = np.arange(t)[None, :] >= lengths[:, None]
    assert ((tok >= 0) & (tok < TINY.vocab_size)).all() and (tok[after] == PAD).all()
    assert (a.logprobs.reshape(-1, t)[after] == 0.0).all()
    assert np.isfinite(a.logprobs).all() and (a.logprobs <= 1e-6).all()


def _swap_at(engine, step, lora, version):
    """Push ``lora`` just before decode step ``step`` is dispatched."""
    take = engine._take_pending_lora

    def patched(cell, dispatched):
        if dispatched == step:
            engine.push_lora(lora, version=version)
        take(cell, dispatched)

    engine._take_pending_lora = patched


def test_push_lora_mid_round_matches_jax(weights):
    t, n = 10, 2
    ids, mask = _prompts([9, 16], seed=14)
    new = _lora(seed=5, scale=0.5)
    jeng, teng = _jengine(t), _tengine(weights, t)
    _swap_at(jeng, 3, jax.tree_util.tree_map(jnp.asarray, new), 7)
    _swap_at(teng, 3, lora_from_numpy(new, weights["cfg"], device="cpu"), 7)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres)
    assert teng.last_swap_steps == jeng.last_swap_steps == [3]
    assert teng.last_swap_versions == [7]
    plain = _tengine(weights, t).generate(weights["model"], weights["lora"], ids, mask,
                                          _greedy(t, n)[1], 0)
    np.testing.assert_array_equal(tres.tokens[..., :4], plain.tokens[..., :4])
    assert not np.array_equal(tres.tokens, plain.tokens)


@pytest.mark.parametrize("knob", [
    {"scheduler": "refill", "max_concurrent_rows": 4, "prefix_sharing": True},
    {"prefix_sharing": True},
    {"continuous_admission": True}, {"prefix_cache": True}, {"kv_spill": True},
    {"scheduler": "refill", "max_concurrent_rows": 4, "spec_draft": 2, "spec_drafter": "self"},
    {"spec_drafter": "self"}, {"spec_adapt": True},
    {"scan_chunk": 8},
])
def test_unported_knobs_raise_naming_roadmap(weights, knob):
    """Scan chunks run on both schedulers (CUDA graphs over the decode
    steps); every other knob here is ported and the port's engine accepts
    or refuses it (ValueError) exactly as the JAX engine does."""
    if "scan_chunk" in knob:
        assert _tengine(weights, 4, **knob).scan_chunk == knob["scan_chunk"]
        refill = _tengine(weights, 4, scheduler="refill", max_concurrent_rows=4, **knob)
        assert refill.scan_chunk == knob["scan_chunk"] and refill.scan_chunk_active is None
        return
    try:
        _jengine(4, **knob)
    except ValueError:
        with pytest.raises(ValueError):
            _tengine(weights, 4, **knob)
        return
    eng = _tengine(weights, 4, **knob)
    assert eng.prefix_sharing == bool(knob.get("prefix_sharing"))
    assert eng.spec_drafter == knob.get("spec_drafter", "ngram")


def test_engine_checks_its_inputs(weights):
    with pytest.raises(ValueError, match="kv_quant"):
        _tengine(weights, 4, kv_quant="fp8")
    # the TPU package's choice among its paged launches: K2 is the one kernel
    for knob in ({"paged_impl": "native_blocked"}, {"pages_per_block": 3}):
        with pytest.raises(NotImplementedError, match="K2"):
            _tengine(weights, 4, **knob)
    teng = _tengine(weights, 4, scan_chunk=0, spec_draft=0, continuous_admission=False,
                    paged_impl="auto", pages_per_block=0)
    assert (teng.prompt_pages, teng.private_pages) == (2, 2)
    ids, mask = _prompts([3], p=8)
    with pytest.raises(ValueError, match="padded to 16"):
        teng.generate(weights["model"], None, ids, mask, _greedy(4, 1)[1], 0)


def test_chip_smoke_paged_rollout_rehearses_on_cpu(weights):
    """chip_smoke.py's paged phases at TINY size on the CPU (plain versions,
    so no launch is counted): f32 pages, then int8 pages, its teacher-forced
    paged-vs-dense logits comparison and its greedy yardsticks."""
    import chip_smoke

    cfg = weights["cfg"]
    for kv_quant in ("none", "int8"):
        out = chip_smoke.rollout(cfg, "cpu", seed=0, max_prompt_tokens=96,
                                 max_new_tokens=12, n=2, rank=4, engine="paged",
                                 kv_quant=kv_quant, page_size=PS)
        assert out["steps"] == 3 * 12 and out["forwards"] == 3 * 11
        assert out["counts"] == {k["name"]: 0 for k in chip_smoke.KERNELS}  # CPU: no launch
    w = (weights["model"], weights["lora"])
    lc = chip_smoke.compare_engine_logits(w, chip_smoke.widen(w), seed=0, steps=3, n=2,
                                          max_prompt_tokens=P, max_new_tokens=8,
                                          page_size=PS, rank=4)
    assert lc["f32"] <= 1e-4 and lc["low"] == lc["f32"] and lc["noise"] == 0.0
    # int8 pages move the logits; on the CPU K2 is its plain version
    assert 0 < lc["int8"] == lc["int8_plain"] and lc["int8_k2"] == 0.0
    assert lc["plain_launches"] == 0
    ref = chip_smoke.rollout(cfg, "cpu", seed=0, max_prompt_tokens=96, max_new_tokens=12,
                             n=2, rank=4, engine="dense", weights=w)["greedy_tokens"]
    ga = chip_smoke.greedy_agreement(cfg, "cpu", w, ref, seed=0, max_prompt_tokens=96,
                                     max_new_tokens=12, n=2, page_size=PS, rank=4)
    assert ga == {"dense_low_vs_f32": 1.0, "paged_vs_dense_f32": 1.0}
