"""Checkpoint and tokenizer loading in the port against the JAX package.

* (c) ``Trainer.from_pretrained`` in both packages on the synthesized local
  checkpoint of ``tests/test_from_pretrained.py`` (the JAX package's
  ``save_hf_checkpoint`` plus a Qwen2-configured BPE trained with the
  ``tokenizers`` library): equal parameters, equal token ids of the
  fixture corpus (and equal to the Rust tokenizer's), equal
  ``kv_pool_pages`` at a fixed memory size; a checkpoint written by the
  port's ``save_hf_checkpoint`` loads in the JAX package's
  ``load_pretrained`` exactly, in f32 and in bf16.
* (d) The port's safetensors codec against ``safetensors.numpy``, both
  ways, for every dtype it writes.
* ``merge_lora`` against the JAX package's: the same f32 sums in another
  order, within ``MERGE_ATOL``.
"""

import dataclasses
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distrl_llm_tpu.config import TrainConfig as JTrainConfig
from distrl_llm_tpu.engine import budget as jbudget
from distrl_llm_tpu.models import TINY, init_params
from distrl_llm_tpu.models import lora as jlora
from distrl_llm_tpu.models.loading import load_pretrained as jload_pretrained
from distrl_llm_tpu.models.loading import state_dict_from_params as jstate_dict
from distrl_llm_tpu.ops.quant import quantize_params as jquantize_params
from distrl_llm_tpu.tokenizer import load_tokenizer as jload_tokenizer
from distrl_llm_tpu_torch.config import TrainConfig
from distrl_llm_tpu_torch.engine import budget
from distrl_llm_tpu_torch.models import loading
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, params_from_numpy
from distrl_llm_tpu_torch.models.lora import merge_lora
from distrl_llm_tpu_torch.ops.quant import quantize_params
from distrl_llm_tpu_torch.rewards import reward_function
from distrl_llm_tpu_torch.tokenizer import load_tokenizer
from distrl_llm_tpu_torch.trainer import Trainer
from distrl_llm_tpu_torch.utils import safetensors_io

safetensors_numpy = pytest.importorskip("safetensors.numpy")

CFG = ModelConfig(**dataclasses.asdict(TINY))
MERGE_ATOL = 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bf16 as ml_dtypes' bfloat16 (same bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(f"u{a.dtype.itemsize}")


# ------------------------------------------------------------- (d) codec

def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "w.bf16": torch.from_numpy(f).to(torch.bfloat16),
        "w.f16": torch.from_numpy(f).to(torch.float16),
        "w.f32": torch.from_numpy(f),
        "q.i8": torch.from_numpy(rng.integers(-128, 128, (7,), dtype=np.int8)),
        "idx.i32": torch.from_numpy(rng.integers(-2**31, 2**31, (2, 2, 3), dtype=np.int32)),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros((0, 4), dtype=torch.bfloat16),
        "odd.i8": torch.from_numpy(rng.integers(-128, 128, (3,), dtype=np.int8)),
        "after.f32": torch.from_numpy(rng.standard_normal(5).astype(np.float32)),
    }


def test_codec_writes_what_safetensors_reads(tmp_path):
    tensors = _tensors()
    path = str(tmp_path / "a.safetensors")
    safetensors_io.save_file(tensors, path, metadata={"format": "pt"})
    got = safetensors_numpy.load_file(path)
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        want = _np(t)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want), err_msg=k)
    header, start = safetensors_io.read_header(path)
    assert start % 8 == 0
    for spec in header.values():  # every tensor aligned to its element size
        size = {"BF16": 2, "F16": 2, "F32": 4, "I8": 1, "I32": 4}[spec["dtype"]]
        assert spec["data_offsets"][0] % size == 0


def test_codec_reads_what_safetensors_writes(tmp_path):
    want = {k: _np(t) for k, t in _tensors(1).items()}
    path = str(tmp_path / "b.safetensors")
    safetensors_numpy.save_file(want, path)
    got = safetensors_io.load_file(path)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert _np(t).dtype == want[k].dtype and tuple(t.shape) == want[k].shape, k
        np.testing.assert_array_equal(_bits(_np(t)), _bits(want[k]), err_msg=k)


def test_codec_refuses_what_it_does_not_write(tmp_path):
    with pytest.raises(ValueError, match="dtype"):
        safetensors_io.save_file({"x": torch.zeros(2, dtype=torch.float64)},
                                 str(tmp_path / "c.safetensors"))
    path = str(tmp_path / "d.safetensors")
    safetensors_numpy.save_file({"x": np.zeros(2, np.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        safetensors_io.load_file(path)


def test_sharded_checkpoint_follows_its_index(tmp_path):
    tensors = _tensors(2)
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[:4],
              "model-00002-of-00002.safetensors": names[4:]}
    for shard, keys in shards.items():
        safetensors_io.save_file({k: tensors[k] for k in keys}, str(tmp_path / shard))
    # a stray file the index does not name is not read
    safetensors_io.save_file({"stray": torch.ones(1)}, str(tmp_path / "other.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: shard for shard, keys in shards.items() for k in keys}}))
    got = loading.load_safetensors_dir(str(tmp_path))
    assert sorted(got) == names
    assert all(torch.equal(got[k], tensors[k]) for k in names)


# ------------------------------------------------ (c) from_pretrained

from tests.test_from_pretrained import checkpoint_dir  # noqa: E402,F401  (the fixture)
from tests.test_native_tokenizer import CORPUS  # noqa: E402


@pytest.fixture(scope="module")
def port_trainer(checkpoint_dir):  # noqa: F811
    cfg = TrainConfig(model=checkpoint_dir, dtype="float32", episodes=1, batch_size=2,
                      num_candidates=2, topk=2, train_batch_size=2, max_prompt_tokens=16,
                      max_new_tokens=8, number_of_actors=1, learner_chunk_size=1,
                      metrics_backend="null", max_lora_rank=4, lora_alpha=8, learner="grpo")
    train = {"problem": ["1+1?", "2+2?"], "solution": ["2", "4"]}
    return Trainer.from_pretrained(train, train, reward_function, cfg, device="cpu")


def test_from_pretrained_loads_the_jax_package_params(checkpoint_dir, port_trainer):  # noqa: F811
    jparams, jcfg = jload_pretrained(checkpoint_dir)
    assert port_trainer.model_cfg == CFG and jcfg == TINY
    want = jstate_dict(jparams, jcfg)
    got = loading.state_dict_from_params(port_trainer.model)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert type(port_trainer.tokenizer).__name__ == "NativeBPETokenizer"
    assert port_trainer.device == torch.device("cpu")


def test_tokenizers_encode_the_corpus_alike(checkpoint_dir):  # noqa: F811
    from tokenizers import Tokenizer

    rust = Tokenizer.from_file(f"{checkpoint_dir}/tokenizer.json")
    tok, jtok = load_tokenizer(checkpoint_dir), jload_tokenizer(checkpoint_dir)
    assert (tok.eos_token_id, tok.pad_token_id) == (jtok.eos_token_id, jtok.pad_token_id)
    for text in CORPUS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text) == rust.encode(text).ids, text
        assert tok.decode(ids) == jtok.decode(ids)


def test_a_unigram_tokenizer_is_refused(tmp_path):
    """A Unigram tokenizer.json (Gemma's sentencepiece) is no longer refused:
    it loads into the native SPM tokenizer, whose ids equal the JAX
    package's (tests/test_torch_spm.py has the full parity cases)."""
    from distrl_llm_tpu.tokenizer import load_tokenizer as jload_tokenizer
    from distrl_llm_tpu_torch.native.spm import NativeSPMTokenizer

    vocab = [["<unk>", 0.0], ["▁a", -1.0], ["b", -2.0], ["▁", -3.0], ["a", -4.0]]
    (tmp_path / "tokenizer.json").write_text(json.dumps({
        "model": {"type": "Unigram", "unk_id": 0, "vocab": vocab},
        "added_tokens": [{"id": 5, "content": "<eos>", "special": True}],
        "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}}))
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, NativeSPMTokenizer) and tok.eos_token_id == 5
    assert tok.encode(" ab a") == jload_tokenizer(str(tmp_path)).encode(" ab a")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kv_quant="int8"),
    dict(spec_draft=4),
    dict(batch_prompts=30, max_new_tokens=1200, max_prompt_tokens=350),
    dict(hbm_bytes=10**6),  # below one sequence: the clamp
], ids=["defaults", "int8", "spec", "reference_shape", "clamped"])
@pytest.mark.parametrize("quant", [None, 4], ids=["f32", "int4"])
def test_kv_pool_pages_match_jax(kw, quant):
    tree = init_params(jax.random.PRNGKey(0), TINY)
    model = params_from_numpy(_np_tree(tree), CFG, device="cpu")
    if quant:
        tree = jquantize_params(tree, bits=quant, group_size=16)
        quantize_params(model, quant, 16)
    param_bytes = budget.tree_bytes(model)
    # an int4 base: the JAX tree holds one int8 per weight (its nibble form
    # is a transport format), the port holds the packed nibbles, half of it
    payload = sum(np.prod(np.shape(w["q"])) for w in tree["layers"].values()
                  if isinstance(w, dict)) if quant else 0
    assert param_bytes == jbudget.tree_bytes(tree) - payload // 2
    args = dict(gpu_usage=0.35, param_bytes=param_bytes, batch_prompts=4,
                max_prompt_tokens=16, max_new_tokens=8, page_size=8, hbm_bytes=2**26)
    args.update(kw)
    got = budget.kv_pool_pages(CFG, **args)
    assert got == jbudget.kv_pool_pages(TINY, **args)
    assert budget.page_bytes(CFG, 8, args.get("kv_quant", "none")) == jbudget.page_bytes(
        TINY, 8, args.get("kv_quant", "none"))


def test_device_memory_needs_a_card():
    with pytest.raises(ValueError, match="no device-memory budget"):
        budget.device_hbm_bytes("cpu")


def test_from_pretrained_budgets_the_pool_as_jax_does(checkpoint_dir):  # noqa: F811
    kw = dict(model=checkpoint_dir, dtype="float32", batch_size=2, num_candidates=2, topk=2,
              max_prompt_tokens=16, max_new_tokens=8, engine_impl="paged",
              continuous_batching=True, max_concurrent_sequences=4, number_of_actors=1,
              learner_chunk_size=1)
    tr = Trainer.from_pretrained({"problem": ["1+1?"], "solution": ["2"]},
                                 {"problem": ["1+1?"], "solution": ["2"]}, reward_function,
                                 TrainConfig(**kw), device="cpu", hbm_bytes=2**26)
    jparams, _ = jload_pretrained(checkpoint_dir)
    jcfg = JTrainConfig(**kw)
    want = jbudget.kv_pool_pages(
        TINY, gpu_usage=jcfg.learner_gpu_usage, param_bytes=jbudget.tree_bytes(jparams),
        batch_prompts=jcfg.batch_size, max_prompt_tokens=jcfg.max_prompt_tokens,
        max_new_tokens=jcfg.max_new_tokens, page_size=128, hbm_bytes=2**26)
    assert tr.engine.max_kv_pages == want
    assert tr.engine.scheduler == "refill"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_port_checkpoint_loads_in_jax_exactly(tmp_path, dtype):
    rng = np.random.default_rng(3)
    tree = _np_tree(init_params(jax.random.PRNGKey(1), TINY))
    for name, arr in tree["layers"].items():  # norms and biases off their init values
        tree["layers"][name] = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
    model = params_from_numpy(tree, CFG, dtype=dtype, device="cpu")
    loading.save_hf_checkpoint(model, str(tmp_path))
    hf = json.loads((tmp_path / "config.json").read_text())
    assert hf["torch_dtype"] == str(dtype).removeprefix("torch.")
    assert hf["model_type"] == "qwen2" and hf["architectures"] == ["Qwen2ForCausalLM"]
    jdtype = np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16
    jparams, jcfg = jload_pretrained(str(tmp_path), dtype=jdtype)
    assert jcfg == TINY
    want = loading.state_dict_from_params(model)
    got = jstate_dict(jparams, jcfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(_bits(np.ascontiguousarray(got[k])), _bits(_np(v)),
                                      err_msg=k)
    # and back through the port's own loader
    back, cfg = loading.load_pretrained(str(tmp_path), dtype=dtype, device="cpu")
    assert cfg == CFG
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(), model.parameters()))


def test_quantized_base_is_not_exported(tmp_path):
    model = params_from_numpy(_np_tree(init_params(jax.random.PRNGKey(0), TINY)), CFG,
                              device="cpu")
    quantize_params(model, 8)
    with pytest.raises(NotImplementedError, match="quantized"):
        loading.save_hf_checkpoint(model, str(tmp_path))


def test_merge_lora_matches_jax():
    tree = _np_tree(init_params(jax.random.PRNGKey(0), TINY))
    ltree = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(1), TINY, 4))
    rng = np.random.default_rng(0)
    for ab in ltree["layers"].values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    model = params_from_numpy(tree, CFG, device="cpu")
    lora = lora_from_numpy(ltree, CFG, device="cpu")
    merged = merge_lora(model, lora, alpha=8.0)
    want = jstate_dict(_np_tree(jlora.merge_lora(tree, ltree, 8.0)), TINY)
    got = loading.state_dict_from_params(merged)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=MERGE_ATOL, rtol=0, err_msg=k)
    moved = max(float((a - b).abs().max()) for a, b in zip(merged.parameters(),
                                                            model.parameters()))
    assert moved > 1e-3  # the delta was folded in; the base itself is untouched
    assert torch.equal(model.layers[0].wq, torch.tensor(tree["layers"]["wq"][0]))
    quantize_params(model, 4, 16)
    with pytest.raises(NotImplementedError, match="quantized"):
        merge_lora(model, lora, alpha=8.0)


def test_chip_smoke_tokenizer_file_matches_the_rust_tokenizer(tmp_path):
    """chip_smoke.py writes its tokenizer.json by hand; the Rust tokenizer
    and the port's native one must read it alike."""
    import sys
    from pathlib import Path

    from tokenizers import Tokenizer

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    for vocab in (1024, 152064):
        d = chip_smoke.write_bpe_tokenizer(tmp_path / str(vocab), vocab)
        rust = Tokenizer.from_file(str(d / "tokenizer.json"))
        tok = load_tokenizer(str(d))
        assert rust.get_vocab_size() <= vocab
        assert tok.eos_token_id == rust.token_to_id("<|im_end|>")
        for text in CORPUS:
            assert tok.encode(text) == rust.encode(text).ids, text
