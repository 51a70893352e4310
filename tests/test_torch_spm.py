"""Parity of the port's sentencepiece Unigram tokenizer
(``distrl_llm_tpu_torch/native/spm.py`` over ``csrc/spm_tokenizer.cc``)
with the JAX package's ``NativeSPMTokenizer`` and the Rust ``tokenizers``
Unigram.

The fixtures are those of ``tests/test_native_spm.py`` (built with the Rust
library: Gemma-shaped ▁-escaped pieces, byte-fallback pieces, a Replace
normalizer, special tokens), serialized to the ``tokenizer.json`` the Rust
library writes and loaded by both packages from that one dict. Ids must be
identical on every input; decoded text too.
"""

import json

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")

from distrl_llm_tpu.native.spm import NativeSPMTokenizer as JSPM  # noqa: E402
from distrl_llm_tpu.tokenizer import load_tokenizer as jload_tokenizer  # noqa: E402
from distrl_llm_tpu_torch.native import native_available  # noqa: E402
from distrl_llm_tpu_torch.native.spm import NativeSPMTokenizer as TSPM  # noqa: E402
from distrl_llm_tpu_torch.tokenizer import load_tokenizer  # noqa: E402
from tests.test_native_spm import CASES, WORDS, _build_pair  # noqa: E402

if not native_available():  # pragma: no cover
    pytest.skip("g++ unavailable", allow_module_level=True)


def _three(byte_fallback=True, prepend=False):
    """(Rust, JAX native, port native) over one Unigram tokenizer.json."""
    rust, _ = _build_pair(byte_fallback=byte_fallback)
    if prepend:  # Llama-2's dummy prefix: Prepend(▁) then Replace(" " -> ▁)
        from tokenizers.normalizers import Prepend, Replace, Sequence

        rust.normalizer = Sequence([Prepend("▁"), Replace(" ", "▁")])
    tj = json.loads(rust.to_str())
    return rust, JSPM.from_hf_dict(tj), TSPM.from_hf_dict(tj)


@pytest.mark.parametrize("byte_fallback,prepend", [(True, False), (False, False),
                                                   (True, True)])
def test_ids_and_text_match_jax_and_rust(byte_fallback, prepend):
    rust, jtok, ttok = _three(byte_fallback, prepend)
    rng = np.random.default_rng(7)
    alphabet = list("abcdefghij xyz.,!?é日🙂▁<>0x") + WORDS
    fuzz = ["".join(str(alphabet[int(k)]) for k in rng.integers(0, len(alphabet), n))
            for n in rng.integers(0, 24, 100)]
    # the specials string is pinned against Rust only with byte fallback
    # and no Prepend (test_native_spm.py: Rust normalizes each segment
    # between special tokens, the native cores the whole text); elsewhere
    # the port must do what the JAX core does
    specials = ["the<eos>quick <bos> fox"]
    for text in CASES + fuzz + specials + ["▁pre", " lead"]:
        ids = ttok.encode(text)
        assert ids == jtok.encode(text), text
        if (byte_fallback and not prepend) or text not in specials:
            assert ids == rust.encode(text).ids, text
        for skip in (True, False):
            assert ttok.decode(ids, skip_special_tokens=skip) == jtok.decode(
                ids, skip_special_tokens=skip), text
    assert (ttok.eos_token_id, ttok.pad_token_id) == (jtok.eos_token_id, jtok.pad_token_id)


def test_load_tokenizer_routes_unigram_to_the_native_core(tmp_path):
    """A checkpoint directory with a Unigram tokenizer.json and a chat
    template loads into the port's SPM tokenizer, as JAX's load_tokenizer
    loads its own: same ids, same rendered chat."""
    rust, _ = _build_pair()
    (tmp_path / "tokenizer.json").write_text(rust.to_str())
    template = ("{% for m in messages %}<start_of_turn>{{ m['role'] }}\n"
                "{{ m['content'] }}<end_of_turn>\n{% endfor %}")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"chat_template": template}))
    tok, jtok = load_tokenizer(str(tmp_path)), jload_tokenizer(str(tmp_path))
    assert isinstance(tok, TSPM)
    msgs = [{"role": "user", "content": "solve the equation"}]
    assert tok.apply_chat_template(msgs) == jtok.apply_chat_template(msgs)
    for text in CASES:
        assert tok.encode(text) == jtok.encode(text), text
