"""Parity of the PyTorch port's decoder with the JAX package's ``forward``.

One numpy param tree (from the JAX ``init_params``) and one numpy adapter
tree feed both packages; everything runs in f32 on the CPU. Logits agree
within ``ATOL`` (f32 sums over widths <= 128, taken in a different order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.models import lora as jlora
from distrl_llm_tpu.models import transformer as jtf
from distrl_llm_tpu.models.configs import QWEN2_7B, TINY
from distrl_llm_tpu_torch.models import transformer as ttf
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, params_from_numpy

ATOL = 1e-4

VARIANTS = {
    "tiny": TINY,
    "tied": dataclasses.replace(TINY, tie_word_embeddings=True),
    "gemma": dataclasses.replace(
        TINY, hidden_act="gelu_tanh", rmsnorm_offset=True, scale_embeddings=True,
        attention_bias=False, tie_word_embeddings=True),
    "no_bias": dataclasses.replace(TINY, attention_bias=False),
}


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(cfg, seed=0):
    """Numpy param tree with non-trivial norms and biases (the JAX init sets
    them to ones/zeros, which would hide a mis-wired norm or bias)."""
    tree = _np_tree(jtf.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name, arr in list(tree["layers"].items()):
        if name.endswith("norm") or name.startswith("b"):
            tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
    tree["final_norm"] = (tree["final_norm"]
                          + 0.1 * rng.standard_normal(tree["final_norm"].shape)).astype(np.float32)
    return tree


def _lora(cfg, seed=1, rank=4):
    tree = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(seed), cfg, rank))
    rng = np.random.default_rng(seed)
    for ab in tree["layers"].values():  # non-zero B so the delta is exercised
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return tree


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _inputs(b, s, vocab, seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :3] = 0  # left padding on one row
    ids[1, :3] = 0
    return ids, mask


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("with_lora", [False, True])
def test_no_cache_forward_matches_jax(variant, with_lora):
    cfg = VARIANTS[variant]
    tree = _params(cfg)
    lora = _lora(cfg) if with_lora else None
    ids, mask = _inputs(3, 9, cfg.vocab_size)
    want, _ = jtf.forward(_jax_tree(tree), cfg, jnp.asarray(ids),
                          attention_mask=jnp.asarray(mask),
                          lora=_jax_tree(lora) if lora else None, lora_scale=0.5)
    model = params_from_numpy(tree, _port_cfg(cfg), device="cpu")
    tl = lora_from_numpy(lora, _port_cfg(cfg), device="cpu") if lora else None
    got, cache = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                       lora=tl, lora_scale=0.5)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_then_cached_decode_matches_jax(variant):
    """A left-padded prefill into a dense cache, then 4 single-token decode
    steps that each extend the key mask — the engine's exact call pattern."""
    cfg = VARIANTS[variant]
    tree, lora = _params(cfg, seed=3), _lora(cfg, seed=4)
    b, p, steps = 3, 7, 4
    smax = p + steps
    ids, mask = _inputs(b, p, cfg.vocab_size, seed=5)
    key_mask = np.pad(mask, ((0, 0), (0, smax - p)))
    jt, jl = _jax_tree(tree), _jax_tree(lora)
    jcache = jtf.init_kv_cache(cfg, b, smax, dtype=jnp.float32)
    jlog, jcache = jtf.forward(jt, cfg, jnp.asarray(ids), attention_mask=jnp.asarray(key_mask),
                               lora=jl, lora_scale=0.5, kv_cache=jcache,
                               cache_offset=0, logits_slice=(p - 1, 1))
    pc = _port_cfg(cfg)
    model = params_from_numpy(tree, pc, device="cpu")
    tl = lora_from_numpy(lora, pc, device="cpu")
    tcache = ttf.init_kv_cache(pc, b, smax, dtype=torch.float32, device="cpu")
    tmask = torch.from_numpy(key_mask.copy())
    tlog, tcache = model(torch.from_numpy(ids), attention_mask=tmask, lora=tl,
                         lora_scale=0.5, kv_cache=tcache, cache_offset=0,
                         logits_slice=(p - 1, 1))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    tok = np.asarray(jlog[:, 0]).argmax(-1).astype(np.int32)
    for step in range(steps):
        key_mask[:, p + step] = 1
        tmask[:, p + step] = 1
        jlog, jcache = jtf.forward(jt, cfg, jnp.asarray(tok[:, None]),
                                   attention_mask=jnp.asarray(key_mask), lora=jl,
                                   lora_scale=0.5, kv_cache=jcache, cache_offset=p + step)
        tlog, tcache = model(torch.from_numpy(tok[:, None].copy()), attention_mask=tmask,
                             lora=tl, lora_scale=0.5, kv_cache=tcache,
                             cache_offset=p + step)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
        tok = np.asarray(jlog[:, 0]).argmax(-1).astype(np.int32)
    # the cache was updated in place, in the port's [B, K, S, hd] layout
    for i in range(cfg.num_layers):
        np.testing.assert_allclose(tcache["k"][i].numpy(),
                                   np.asarray(jcache["k"][i]).transpose(0, 1, 3, 2),
                                   atol=ATOL, rtol=0)


def test_sliding_window_refusal():
    cfg = _port_cfg(dataclasses.replace(TINY, sliding_window=8))
    model = params_from_numpy(_params(TINY), cfg, device="cpu")
    model(torch.zeros((1, 8), dtype=torch.int32))  # within the window
    with pytest.raises(ValueError, match="sliding_window"):
        model(torch.zeros((1, 9), dtype=torch.int32))


def test_unported_branches_raise_naming_roadmap():
    """ring/ulysses raise naming ROADMAP; flash and splash run (on the CPU
    through K4's plain version) and equal "reference" on every position
    with a valid key (a left-pad position has none: K4 gives it 0, the
    reference a uniform average, and no real position reads it)."""
    cfg = _port_cfg(TINY)
    model = params_from_numpy(_params(TINY), cfg, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int32)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model(ids, attn_impl=impl)
    with pytest.raises(ValueError, match="attn_impl"):
        model(ids, attn_impl="nope")
    ids, mask = _inputs(3, 9, cfg.vocab_size)
    tl = lora_from_numpy(_lora(TINY), cfg, device="cpu")
    kw = dict(attention_mask=torch.from_numpy(mask), lora=tl, lora_scale=0.5)
    want, _ = model(torch.from_numpy(ids), **kw)
    real = torch.from_numpy(mask).bool()
    for impl in ("flash", "splash"):
        got, _ = model(torch.from_numpy(ids), attn_impl=impl, **kw)
        np.testing.assert_allclose(got[real].numpy(), want[real].numpy(), atol=1e-5, rtol=0)
    # the int8 dense cache is ported (tests/test_torch_dense_int8.py): its
    # prefill over the whole window equals the uncached forward within the
    # int8 rounding of k and v
    cache = ttf.init_kv_cache_int8(cfg, ids.shape[0], ids.shape[1], device="cpu")
    got, _ = model(torch.from_numpy(ids), kv_cache=cache, **kw)
    assert cache["k_scale"][0].shape == (ids.shape[0], cfg.num_kv_heads, ids.shape[1], 1)
    np.testing.assert_allclose(got[real].numpy(), want[real].numpy(), atol=2e-2, rtol=0)
    # the paged cache is ported (tests/test_torch_paged*.py)


def test_params_from_numpy_rejects_mismatched_trees():
    tree = _params(TINY)
    cfg = _port_cfg(TINY)
    bad = dict(tree, layers=dict(tree["layers"]))
    del bad["layers"]["bq"]
    with pytest.raises(ValueError, match="layer keys"):
        params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, dataclasses.replace(cfg, hidden_size=32), device="cpu")
    tied = _port_cfg(VARIANTS["tied"])
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tree, tied, device="cpu")  # lm_head is extra


def test_converted_params_are_the_tree():
    tree, lora = _params(TINY), _lora(TINY)
    cfg = _port_cfg(TINY)
    model = params_from_numpy(tree, cfg, device="cpu")
    np.testing.assert_array_equal(model.embed.numpy(), tree["embed"])
    np.testing.assert_array_equal(model.layers[1].w_down.numpy(), tree["layers"]["w_down"][1])
    np.testing.assert_array_equal(model.layers[0].bk.numpy(), tree["layers"]["bk"][0])
    assert not any(p.requires_grad for p in model.parameters())  # frozen base
    tl = lora_from_numpy(lora, cfg, dtype=torch.bfloat16, device="cpu")
    assert tl["layers"]["wq"]["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tl["layers"]["wo"]["b"].float().numpy(),
                                  torch.from_numpy(lora["layers"]["wo"]["b"]).bfloat16().float().numpy())


def test_init_params_and_lora_shapes():
    cfg = _port_cfg(TINY)
    gen = torch.Generator().manual_seed(0)
    model = ttf.init_params(gen, cfg)
    assert model.layers[0].wq.shape == (cfg.hidden_size, cfg.q_dim)
    assert float(model.layers[0].attn_norm.mean()) == 1.0
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.1)
    from distrl_llm_tpu_torch.models.lora import init_lora_params

    lora = init_lora_params(torch.Generator().manual_seed(1), cfg, rank=8)
    assert lora["layers"]["w_down"]["a"].shape == (cfg.num_layers, cfg.intermediate_size, 8)
    assert float(lora["layers"]["wq"]["b"].abs().sum()) == 0.0  # step 0 = base


def test_qwen2_7b_geometry_shapes_on_meta():
    """Full Qwen2.5-7B widths, one layer, shapes only (the meta device
    allocates nothing): a left-padded prefill into the dense cache and one
    cached decode step."""
    cfg = _port_cfg(dataclasses.replace(QWEN2_7B, num_layers=1))
    model = ttf.Decoder(cfg, dtype=torch.bfloat16, device="meta")
    b, p, smax = 2, 350, 478
    cache = ttf.init_kv_cache(cfg, b, smax, dtype=torch.bfloat16, device="meta")
    mask = torch.ones((b, smax), dtype=torch.int32, device="meta")
    ids = torch.zeros((b, p), dtype=torch.int32, device="meta")
    logits, cache = model(ids, attention_mask=mask, kv_cache=cache, logits_slice=(p - 1, 1))
    assert logits.shape == (b, 1, 152064) and logits.dtype == torch.float32
    assert cache["k"][0].shape == (b, 4, smax, 128)
    logits, _ = model(ids[:, :1], attention_mask=mask, kv_cache=cache, cache_offset=p)
    assert logits.shape == (b, 1, 152064)
