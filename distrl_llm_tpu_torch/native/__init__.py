"""Native (C++) host components: the byte-level BPE tokenizer's core
(``native/tokenizer.py``, ``csrc/bpe_tokenizer.cc``) and the sentencepiece
Unigram core (``native/spm.py``, ``csrc/spm_tokenizer.cc``), built with
``g++`` at first use by ``native/build.py``."""

from distrl_llm_tpu_torch.native.build import build_library, native_available  # noqa: F401
