"""Native (C++) host components: the byte-level BPE tokenizer's core
(``native/tokenizer.py``, ``csrc/bpe_tokenizer.cc``) and the sentencepiece
Unigram core (``native/spm.py``, ``csrc/spm_tokenizer.cc``) and the control
plane's TCP transport (``distributed/control_plane.py``,
``csrc/control_plane.cc``, the JAX package's source copied), built with
``g++`` at first use by ``native/build.py``."""

from distrl_llm_tpu_torch.native.build import build_library, native_available  # noqa: F401
