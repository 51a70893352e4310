"""The port's QLoRA base (``ops/quant.py``, kernel K3's plain version and its
gradient, the quantized ``Decoder``, engines and learner) against the JAX
package, on the CPU at small size.

Seeded numpy inputs feed both packages. The JAX side runs its Pallas K3 in
interpret mode (``quant_matmul(..., interpret=True)``, or
``DISTRL_QUANT_MATMUL=interpret`` for the model, engines and learner).

Tolerances:

* ``quantize``, ``pack_int4``/``unpack_int4``, ``dequantize``: bit for bit;
* K3's plain version and the port's gradients against the interpreted
  kernel and ``jax.grad`` of it, in f32: ``QMM_RTOL`` times the largest
  value (sums of up to 128 products in another order);
* a quantized ``Decoder`` against a dense one holding the dequantized
  weights: bit for bit (the same f32 operations);
* TINY logits against the JAX forward: ``LOGIT_ATOL``, as
  ``tests/test_torch_model.py``; greedy tokens exactly;
* the learner: the step tolerances of ``tests/test_torch_learner.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig
from distrl_llm_tpu.engine import paged_engine as jpe
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.learner import optim as joptim
from distrl_llm_tpu.learner import train_step as jts
from distrl_llm_tpu.models import lora as jlora
from distrl_llm_tpu.models import transformer as jtf
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu.ops import quant as jq
from distrl_llm_tpu.ops.quant_matmul import quant_matmul as jquant_matmul
from distrl_llm_tpu_torch import PagedGenerationEngine
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.engine import GenerationEngine
from distrl_llm_tpu_torch.learner import optim, train_step as ts
from distrl_llm_tpu_torch.models import transformer as ttf
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import (
    lora_from_numpy, lora_to_numpy, params_from_numpy,
)
from distrl_llm_tpu_torch.ops import quant, quant_matmul as qmm
from distrl_llm_tpu_torch.tokenizer import CharTokenizer

QMM_RTOL = 1e-5
LOGIT_ATOL = 1e-4
LOGP_ATOL = 1e-4
STEP_ATOL = 1e-5
LR = 1e-3
ADAPTER_STEP1_ATOL = 2 * LR
ADAPTER_STEP2_ATOL = 10 * LR
FLIP_SHARE = 0.01
SCALE = 0.5
CFG = ModelConfig(**dataclasses.asdict(TINY))
PAD, NO_EOS = 0, 999


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _weight(rng, shape):
    w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    w[..., 3] = 0.0  # a zero column: scale 0, q 0
    return w


def _jax_q(port_w: dict):
    """The port's container as the JAX package's live one (int4 unpacked)."""
    if "q4" in port_w:
        return {"q": jq.unpack_int4(jnp.asarray(port_w["q4"].numpy())),
                "scale": jnp.asarray(port_w["scale"].numpy())}
    return {"q": jnp.asarray(port_w["q"].numpy()), "scale": jnp.asarray(port_w["scale"].numpy())}


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------------------------------------ quantize


@pytest.mark.parametrize("bits,group,lead", [
    (8, None, ()), (8, 16, ()), (8, 32, ()), (4, 16, ()), (4, 64, ()),
    (8, 16, (3, 2)), (4, 16, (2,))],
    ids=["int8_col", "int8_g16", "int8_g32", "int4_g16", "int4_g64", "int8_g16_stacked",
         "int4_g16_stacked"])
def test_quantize_matches_jax_bit_for_bit(bits, group, lead):
    w = _weight(np.random.default_rng(bits + (group or 0)), lead + (128, 48))
    got = quant.quantize(torch.from_numpy(w), bits=bits, group_size=group)
    want = jq.quantize(jnp.asarray(w), bits=bits, group_size=group)
    assert _bits_equal(got["scale"].numpy(), want["scale"])
    if bits == 8:
        assert _bits_equal(got["q"].numpy(), want["q"])
    else:
        assert _bits_equal(got["q4"].numpy(), jq.pack_int4(want["q"]))
    zero = (got["q4"] if bits == 4 else got["q"])[..., 3]
    assert not zero.any() and not got["scale"][..., 3].any()
    for dtype in (torch.float32, torch.bfloat16):
        jd = jq.dequantize(want, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
        td = quant.dequantize(got, dtype)
        assert _bits_equal(td.float().numpy(), np.asarray(jd).astype(np.float32))


def test_quantize_error_cases_match_jax():
    w = np.zeros((48, 8), np.float32)
    for kw, match in ((dict(bits=3), "bits"), (dict(bits=8, group_size=32), "divide")):
        with pytest.raises(ValueError, match=match):
            quant.quantize(torch.from_numpy(w), **kw)
        with pytest.raises(ValueError, match=match):
            jq.quantize(jnp.asarray(w), **kw)
    with pytest.raises(ValueError, match="even"):  # the nibble form packs pairs
        quant.quantize(torch.from_numpy(np.zeros((45, 8), np.float32)), bits=4, group_size=15)


def test_pack_and_unpack_int4_match_jax_and_round_trip():
    vals = np.random.default_rng(0).integers(-8, 8, (2, 4, 6, 10)).astype(np.int8)
    packed = quant.pack_int4(torch.from_numpy(vals))
    assert packed.dtype == torch.int8 and packed.shape == (2, 4, 3, 10)
    assert _bits_equal(packed.numpy(), jq.pack_int4(jnp.asarray(vals)))
    back = quant.unpack_int4(packed)
    assert _bits_equal(back.numpy(), vals)
    assert _bits_equal(back.numpy(), np.asarray(jq.unpack_int4(jnp.asarray(packed.numpy())),
                                                np.int8))
    with pytest.raises(ValueError, match="even"):
        quant.pack_int4(torch.zeros((3, 5), dtype=torch.int8))


def test_quant_helpers():
    assert [quant.quant_bits_for(v) for v in ("none", "int8", "int4")] == [None, 8, 4]
    assert quant.default_group_size(4) == 64 and quant.default_group_size(8) is None
    assert quant.QUANT_TARGETS == jq.QUANT_TARGETS
    w = quant.quantize(torch.randn(64, 8), bits=4, group_size=16)
    assert quant.is_quantized(w) and not quant.is_quantized(torch.zeros(2))
    assert quant.quant_bits(w) == 4 and quant.group_size_of(w) == 16
    assert quant.is_quantized_tree({"layers": {"wq": w}})
    assert not quant.is_quantized_tree({"layers": {"wq": torch.zeros(2)}})


def test_base_quant_rules():
    """The JAX package's base_quant / quant_group_size validation."""
    def base(*args, **kw):
        return quant.quantize_base(ttf.init_params(torch.Generator().manual_seed(0), CFG),
                                   *args, **kw)

    assert base("none").quant is None
    assert base("int4").quant == (4, 64)
    assert base("int8").quant == (8, None)
    assert base("int8", 32).quant == (8, 32)
    for args, match in ((("nf4",), "none/int8/int4"), (("none", 16), "base_quant"),
                        (("int8", 0), ">= 1"), (("int8", 48), "divide")):
        with pytest.raises(ValueError, match=match):
            base(*args)
    with pytest.raises(ValueError, match="full fine-tuning"):
        base("int4", train_mode="full")
    with pytest.raises(ValueError, match="already quantized"):
        quant.quantize_params(base("int8", 16), 8)


# ------------------------------------------------------ K3's plain version


def _qmm_inputs(bits, m, lead=(), n=200, k=128, group=32, rank=8, seed=0):
    rng = np.random.default_rng(seed + m + bits)
    x = rng.standard_normal(lead + (m, k)).astype(np.float32)
    w = quant.quantize(torch.from_numpy(_weight(rng, (k, n))), bits=bits, group_size=group)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    a = (rng.standard_normal((k, rank)) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal((rank, n))).astype(np.float32)
    return x, w, bias, a, b


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("with_lora", [False, True], ids=["nolora", "lora"])
@pytest.mark.parametrize("m", [1, 7, 130])
def test_quant_matmul_reference_matches_jax_interpreted_kernel(bits, with_bias, with_lora, m):
    x, w, bias, a, b = _qmm_inputs(bits, m)
    bias = bias if with_bias else None
    a, b = (a, b) if with_lora else (None, None)
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    j = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    want = np.asarray(jquant_matmul(jnp.asarray(x), _jax_q(w), j(bias), j(a), j(b), SCALE,
                                    interpret=True))
    got = qmm.quant_matmul_reference(torch.from_numpy(x), w, t(bias), t(a), t(b), SCALE)
    np.testing.assert_allclose(got.numpy(), want, atol=QMM_RTOL * np.abs(want).max(), rtol=0)
    # the wrapper on CPU tensors runs the plain version, through the Function
    via = qmm.quant_matmul(torch.from_numpy(x), w, t(bias), t(a), t(b), SCALE)
    assert torch.equal(via, got)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_flattens_leading_dims(bits):
    x, w, bias, a, b = _qmm_inputs(bits, 5, lead=(2, 3))
    want = np.asarray(jquant_matmul(jnp.asarray(x), _jax_q(w), jnp.asarray(bias),
                                    jnp.asarray(a), jnp.asarray(b), SCALE, interpret=True))
    got = qmm.quant_matmul(torch.from_numpy(x), w, torch.from_numpy(bias),
                           torch.from_numpy(a), torch.from_numpy(b), SCALE)
    assert got.shape == (2, 3, 5, 200)
    np.testing.assert_allclose(got.numpy(), want, atol=QMM_RTOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_grads_match_jax(bits):
    """dx, dA, dB (and dbias) of the port's Function on the CPU against
    ``jax.grad`` of the interpreted kernel (its custom VJP), for a random
    cotangent."""
    x, w, bias, a, b = _qmm_inputs(bits, 9)
    ct = np.random.default_rng(1).standard_normal((9, 200)).astype(np.float32)
    jw = _jax_q(w)

    def jloss(x_, bias_, a_, b_):
        return jnp.sum(jquant_matmul(x_, jw, bias_, a_, b_, SCALE, interpret=True)
                       * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in (x, bias, a, b)))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, bias, a, b)]
    y = qmm.quant_matmul(leaves[0], w, *leaves[1:], lora_scale=SCALE)
    (y * torch.from_numpy(ct)).sum().backward()
    for name, leaf, jg in zip(("dx", "dbias", "dA", "dB"), leaves, want):
        jg = np.asarray(jg)
        np.testing.assert_allclose(leaf.grad.numpy(), jg, atol=QMM_RTOL * np.abs(jg).max(),
                                   rtol=0, err_msg=name)


def test_quant_matmul_checks_its_inputs():
    x, w, bias, a, b = _qmm_inputs(8, 4)
    stacked = {"q": w["q"][None], "scale": w["scale"][None]}
    with pytest.raises(ValueError, match="per-layer"):
        qmm.quant_matmul(torch.from_numpy(x), stacked)
    with pytest.raises(ValueError, match="input dim"):
        qmm.quant_matmul(torch.from_numpy(x[:, :64]), w)
    with pytest.raises(ValueError, match="both LoRA factors"):
        qmm.quant_matmul(torch.from_numpy(x), w, lora_a=torch.from_numpy(a))
    with pytest.raises(ValueError, match="cuda or cpu"):
        qmm.quant_matmul(torch.zeros((2, 128), device="meta"), w)


@pytest.mark.parametrize("case", ["bias_n", "a_k", "a_stacked", "b_rank", "b_n"])
def test_quant_matmul_checks_adapter_and_bias_shapes(case):
    """A mismatched bias or adapter raises the same error on every device,
    before K3 could read past its buffers."""
    x, w, bias, a, b = _qmm_inputs(8, 4)
    x, bias, a, b = (torch.from_numpy(v) for v in (x, bias, a, b))
    bad = {"bias_n": dict(bias=bias[:-1]),
           "a_k": dict(lora_a=a[:-32]),
           "a_stacked": dict(lora_a=a[None], lora_b=b[None]),
           "b_rank": dict(lora_b=b[:-1]),
           "b_n": dict(lora_b=b[:, :-1])}[case]
    kw = dict(bias=bias, lora_a=a, lora_b=b) | bad
    with pytest.raises(ValueError, match="must be"):
        qmm.quant_matmul(x, w, **kw)


# --------------------------------------------------- the quantized Decoder


def _params(seed=0):
    """Numpy param tree with non-trivial norms and biases."""
    tree = _np_tree(jtf.init_params(jax.random.PRNGKey(seed), TINY))
    rng = np.random.default_rng(seed)
    for name, arr in list(tree["layers"].items()):
        if name.endswith("norm") or name.startswith("b"):
            tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
    return tree


def _lora(seed=1, rank=4, scale=0.05):
    tree = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(seed), TINY, rank))
    rng = np.random.default_rng(seed)
    for ab in tree["layers"].values():
        ab["b"] = (scale * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return tree


def _quantized_trees(bits, group=16, seed=0):
    """(the JAX package's live quantized params, the port's numpy tree: int4
    through pack_params_int4, the transport form)."""
    jparams = jq.quantize_params(_jnp_tree(_params(seed)), bits=bits, group_size=group)
    port = jq.pack_params_int4(jparams) if bits == 4 else jparams
    return jparams, _np_tree(port)


def _dense_twin(model):
    """A dense Decoder holding ``model``'s weights, the projections
    dequantized to f32."""
    dense = ttf.Decoder(model.cfg, dtype=torch.float32, device="cpu")
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith(("_q", "_q4", "_scale"))}
    for i, layer in enumerate(model.layers):
        for name in quant.QUANT_TARGETS:
            state[f"layers.{i}.{name}"] = quant.dequantize(layer.weight(name), torch.float32)
    dense.load_state_dict(state)
    return dense


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("path", ["fused", "dropout_split", "no_lora"])
def test_quantized_decoder_logits_equal_a_dense_decoder_of_dequantized_weights(bits, path):
    model = quant.quantize_base(ttf.init_params(torch.Generator().manual_seed(0), CFG),
                                f"int{bits}", 16)
    dense = _dense_twin(model)
    lora = None if path == "no_lora" else lora_from_numpy(_lora(), CFG, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(1, CFG.vocab_size, (3, 9)))
    kw = dict(lora=lora, lora_scale=SCALE)
    if path == "dropout_split":
        kw.update(lora_dropout=0.3, dropout_seed=7)
    got, _ = model(ids, **kw)
    want, _ = dense(ids, **kw)
    assert torch.equal(got, want)


def test_quantize_base_quantizes_the_dense_init():
    dense = ttf.init_params(torch.Generator().manual_seed(0), CFG)
    model = quant.quantize_base(ttf.init_params(torch.Generator().manual_seed(0), CFG), "int4")
    assert model.quant == (4, 64) and model.layers[0].wq is None
    assert not any(p.requires_grad for p in model.parameters())
    want = quant.quantize(dense.layers[1].w_down, bits=4, group_size=64)
    got = model.layers[1].weight("w_down")
    assert torch.equal(got["q4"], want["q4"]) and torch.equal(got["scale"], want["scale"])
    assert torch.equal(model.embed, dense.embed)


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_numpy_takes_quantized_trees(bits):
    jparams, tree = _quantized_trees(bits)
    model = params_from_numpy(tree, CFG, device="cpu")
    assert model.quant == (bits, 16)
    key = "q4" if bits == 4 else "q"
    np.testing.assert_array_equal(model.layers[1].weight("wk")[key].numpy(),
                                  tree["layers"]["wk"][key][1])
    np.testing.assert_array_equal(model.layers[0].bq.numpy(), tree["layers"]["bq"][0])
    per_col = _np_tree(jq.quantize_params(_jnp_tree(_params()), bits=8))
    assert params_from_numpy(per_col, CFG, device="cpu").quant == (8, None)


def test_params_from_numpy_rejects_bad_quantized_trees():
    jparams, tree = _quantized_trees(8)
    live_int4 = _np_tree(jq.quantize_params(_jnp_tree(_params()), bits=4, group_size=16))
    with pytest.raises(ValueError, match="int8"):  # the unpacked int4 payload
        params_from_numpy(live_int4, CFG, device="cpu")
    mixed = dict(tree, layers=dict(tree["layers"], wq=_params()["layers"]["wq"]))
    with pytest.raises(ValueError, match="quantized layer keys"):
        params_from_numpy(mixed, CFG, device="cpu")
    odd = dict(tree, layers=dict(tree["layers"], wq={"q": tree["layers"]["wq"]["q"][..., :8],
                                                     "scale": tree["layers"]["wq"]["scale"]}))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(odd, CFG, device="cpu")


@pytest.fixture
def interpreted_k3(monkeypatch):
    """The JAX package's model path through its Pallas K3 in interpret mode."""
    monkeypatch.setenv("DISTRL_QUANT_MATMUL", "interpret")


def _inputs(b, s, seed=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :3] = 0
    ids[1, :3] = 0
    return ids, mask


@pytest.mark.parametrize("bits", [8, 4])
def test_tiny_forward_matches_jax_uncached_and_cached(interpreted_k3, bits):
    jparams, tree = _quantized_trees(bits)
    lora = _lora()
    jl = _jnp_tree(lora)
    model = params_from_numpy(tree, CFG, device="cpu")
    tl = lora_from_numpy(lora, CFG, device="cpu")
    ids, mask = _inputs(3, 9)
    want, _ = jtf.forward(jparams, TINY, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                          lora=jl, lora_scale=SCALE)
    got, _ = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), lora=tl,
                   lora_scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    # a left-padded prefill into the dense cache, then cached decode steps
    b, p, steps = 3, 7, 3
    smax = p + steps
    ids, mask = _inputs(b, p, seed=5)
    key_mask = np.pad(mask, ((0, 0), (0, smax - p)))
    jcache = jtf.init_kv_cache(TINY, b, smax, dtype=jnp.float32)
    tcache = ttf.init_kv_cache(CFG, b, smax, dtype=torch.float32, device="cpu")
    tmask = torch.from_numpy(key_mask.copy())
    tok, offset, seq = ids, 0, p
    for step in range(steps + 1):
        jlog, jcache = jtf.forward(jparams, TINY, jnp.asarray(tok),
                                   attention_mask=jnp.asarray(key_mask), lora=jl,
                                   lora_scale=SCALE, kv_cache=jcache, cache_offset=offset,
                                   logits_slice=(seq - 1, 1))
        tlog, tcache = model(torch.from_numpy(np.ascontiguousarray(tok)), attention_mask=tmask,
                             lora=tl, lora_scale=SCALE, kv_cache=tcache, cache_offset=offset,
                             logits_slice=(seq - 1, 1))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
        tok = np.asarray(jlog[:, -1]).argmax(-1).astype(np.int32)[:, None]
        offset, seq = p + step, 1
        if step < steps:
            key_mask[:, p + step] = 1
            tmask[:, p + step] = 1


# ------------------------------------------------------- engines, learner


def _prompts(lengths, p=16, seed=7):
    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), p), PAD, np.int32)
    mask = np.zeros((len(lengths), p), np.int32)
    for i, n in enumerate(lengths):
        if n:
            ids[i, p - n:] = rng.integers(4, TINY.vocab_size, n)
            mask[i, p - n:] = 1
    return ids, mask


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_engine_greedy_tokens_equal_the_jax_engine(interpreted_k3, bits, engine):
    """Greedy rounds over a quantized TINY base with an adapter: the JAX
    engine (its K3 interpreted) and the port's dense or paged engine (f32
    cache or pages) give the same tokens."""
    jparams, tree = _quantized_trees(bits)
    lora = _lora()
    t, n = 8, 2
    common = dict(max_prompt_tokens=16, max_new_tokens=t, eos_token_ids=[NO_EOS],
                  pad_token_id=PAD, lora_scale=SCALE, capture_logprobs=True)
    if engine == "dense":
        jeng = JEngine(TINY, cache_dtype=jnp.float32, autotune=False, scan_chunk=0, **common)
        teng = GenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", **common)
    else:
        jeng = jpe.PagedGenerationEngine(TINY, cache_dtype=jnp.float32, autotune=False,
                                         scan_chunk=0, paged_impl="reference", page_size=8,
                                         **common)
        teng = PagedGenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", page_size=8,
                                     **common)
    ids, mask = _prompts([5, 11, 16])
    jres = jeng.generate(jparams, _jnp_tree(lora), ids, mask,
                         JSamplingConfig(max_tokens=t, temperature=0.0, n=n),
                         jax.random.PRNGKey(0))
    tres = teng.generate(params_from_numpy(tree, CFG, device="cpu"),
                         lora_from_numpy(lora, CFG, device="cpu"), ids, mask,
                         SamplingConfig(max_tokens=t, temperature=0.0, n=n), 0)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.lengths, jres.lengths)
    np.testing.assert_allclose(tres.logprobs, jres.logprobs, atol=LOGP_ATOL, rtol=0)


def test_two_train_steps_over_an_int8_base_match_jax(interpreted_k3):
    """make_train_step over an int8 (group 16) TINY base in both packages:
    loss and adapter after each of two Adam8bit steps, within the
    learner tolerances of tests/test_torch_learner.py."""
    micro, p, t = 4, 14, 12
    jparams, tree = _quantized_trees(8)
    lora_tree = _lora(scale=0.05)
    rng = np.random.default_rng(6)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789 +-*/=?"))
    text = lambda k, hi: ["".join(rng.choice(letters, rng.integers(1, hi + 1)))  # noqa: E731
                          for _ in range(k)]
    coeffs = rng.standard_normal(2 * micro).astype(np.float32)
    batch = ts.prepare_update_batch(CharTokenizer(), text(2 * micro, p), text(2 * micro, t),
                                    coeffs, max_prompt_tokens=p, max_new_tokens=t,
                                    micro_size=micro, device="cpu")
    arrays = [None if x is None else x.numpy() for x in batch]
    jopt = joptim.make_optimizer(LR)
    jlo = _jnp_tree(lora_tree)
    jstate = jopt.init(jlo)
    jstep = jts.make_train_step(TINY, optimizer=jopt, lora_scale=SCALE, micro_size=micro,
                                attn_impl="splash", donate=False)
    jbatch = jts.UpdateBatch(*(None if x is None else jnp.asarray(x) for x in arrays))
    lora = lora_from_numpy(lora_tree, CFG, device="cpu")
    leaves = [x.requires_grad_(True) for t_ in sorted(lora["layers"])
              for x in (lora["layers"][t_]["a"], lora["layers"][t_]["b"])]
    step = ts.make_train_step(CFG, optimizer=optim.make_optimizer(leaves, LR),
                              lora_scale=SCALE, micro_size=micro, attn_impl="splash")
    model = params_from_numpy(tree, CFG, device="cpu")
    for atol in (ADAPTER_STEP1_ATOL, ADAPTER_STEP2_ATOL):
        jlo, jstate, jloss = jstep(jlo, jstate, jparams, jbatch)[:3]
        loss = step(lora, model, batch)
        np.testing.assert_allclose(float(loss), float(jloss), atol=STEP_ATOL, rtol=0)
        got, want = lora_to_numpy(lora), _np_tree(jlo)
        diffs = np.concatenate([np.abs(got["layers"][k][f] - want["layers"][k][f]).ravel()
                                for k in got["layers"] for f in ("a", "b")])
        assert diffs.max() <= atol
        assert (diffs > 1e-3 * LR).mean() <= FLIP_SHARE
    moved = np.abs(lora_to_numpy(lora)["layers"]["wq"]["a"] - lora_tree["layers"]["wq"]["a"])
    assert moved.max() > 0.5 * LR
    assert not any(p.grad is not None for p in model.buffers())  # the base takes no grad


def test_chip_smoke_qlora_phases_rehearse_on_cpu():
    """chip_smoke.py's QLoRA phases at TINY on the CPU (K3's plain version
    in its place): the K3 stanza's checks at small shapes, the dense and
    paged rounds over an int4 base (one greedy round each), the f32
    teacher-forced logits, two learner steps and the f32 learner parity
    run."""
    import chip_smoke

    stanza = chip_smoke.compare_quant_matmul(
        "cpu", 0, shapes=((64, 48), (128, 200)), rows=(1, 7, 64), group=16)
    assert stanza["onehot_exact"] and stanza["quantize_bits_equal"]
    qw = chip_smoke.make_qlora_weights(CFG, "cpu", seed=0, bits=4, group=16, rank=4)
    assert qw[0].quant == (4, 16)
    runs = chip_smoke.qlora_rollouts(CFG, "cpu", qw, seed=0, max_prompt_tokens=96,
                                     max_new_tokens=8, n=2, rank=4, greedy_rounds=1)
    for out in runs:
        assert out["steps"] > 0 and out["model_forwards"] > 0 and len(out["greedy"]) == 1
        assert out["plain_calls"] == 7 * CFG.num_layers * out["model_forwards"]
    dense_w = chip_smoke.make_weights(CFG, "cpu", seed=0, rank=4)
    lg = chip_smoke.qlora_logits(qw, dense_w, seed=0, steps=2, n=2, max_prompt_tokens=96,
                                 max_new_tokens=8, page_size=8, rank=4)
    assert lg["k3_vs_plain"] == 0.0 and lg["vs_dense"] > 0.0
    out = chip_smoke.rollout(CFG, "cpu", seed=0, max_prompt_tokens=96, max_new_tokens=12,
                             n=2, rank=4, weights=dense_w)
    batch, _ = chip_smoke.learner_batch(out, n=2, seed=0, device="cpu", max_prompt_tokens=96,
                                        max_new_tokens=20, micro=4)
    lrn = chip_smoke.learner_run(qw, batch, lr=LR, scale=1.0, micro=4, logit_chunk=8)
    assert all(np.isfinite(s["loss"]) and s["within_clip"] and s["moved_share"] > 0
               for s in lrn["steps"])
    lp = chip_smoke.qlora_learner_parity(CFG, "cpu", seed=0, n=2, max_prompt_tokens=96,
                                         max_new_tokens=30, gen_tokens=12, rank=4,
                                         logit_chunk=8, group=16)
    assert lp["loss_rel"] <= chip_smoke.LEARNER_REL and lp["grad_rel"] <= chip_smoke.LEARNER_REL
