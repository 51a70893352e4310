"""Tokenizer adapter: fixed-shape encoding, batch decode, checkpoint loading.

Host code copied from the JAX package's ``tokenizer.py`` (the port imports
nothing of that package): fixed-length encode with an explicit pad side (the
learner contract) and id→text decode for rollouts, over any HF-style
tokenizer or the download-free ``CharTokenizer``; ``load_tokenizer`` reads a
checkpoint directory's ``tokenizer.json`` into the C++ byte-level BPE core
(``native/tokenizer.py``).
"""

from __future__ import annotations

import inspect
from typing import Sequence

import numpy as np


def encode_fixed(
    tokenizer,
    texts: Sequence[str],
    max_length: int,
    side: str = "left",
    add_special_tokens: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode to exactly [N, max_length] (ids, mask), truncating and padding on
    ``side``. Works with HF fast/slow tokenizers and test doubles exposing
    ``encode(text) -> list[int]``."""
    pad_id = getattr(tokenizer, "pad_token_id", None)
    if pad_id is None:
        pad_id = getattr(tokenizer, "eos_token_id", 0) or 0

    takes_special = _accepts_kwarg(tokenizer.encode, "add_special_tokens")
    ids = np.full((len(texts), max_length), pad_id, dtype=np.int32)
    mask = np.zeros((len(texts), max_length), dtype=np.int32)
    for i, text in enumerate(texts):
        toks = tokenizer.encode(text, add_special_tokens=add_special_tokens) \
            if takes_special else tokenizer.encode(text)
        # HF default truncation_side="right": keep the leading tokens
        toks = toks[:max_length]
        if side == "left":
            ids[i, max_length - len(toks):] = toks
            mask[i, max_length - len(toks):] = 1
        else:
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
    return ids, mask


def _accepts_kwarg(method, name: str) -> bool:
    try:
        return name in inspect.signature(method).parameters
    except (TypeError, ValueError):
        return False


def decode_batch(tokenizer, ids: np.ndarray, lengths: np.ndarray) -> list[str]:
    """Decode each row's first ``lengths[i]`` tokens (rollout answers)."""
    takes_skip = _accepts_kwarg(tokenizer.decode, "skip_special_tokens")
    return [
        tokenizer.decode(row[:n].tolist(), skip_special_tokens=True)
        if takes_skip
        else tokenizer.decode(row[:n].tolist())
        for row, n in zip(ids, lengths)
    ]


def load_tokenizer(model_name_or_path: str):
    """Load a checkpoint's tokenizer (the reference's load_correct_tokenizer,
    train_distributed.py:46).

    A directory with a ``tokenizer.json`` of byte-level BPE type loads into
    ``NativeBPETokenizer``, a Unigram one (Gemma's sentencepiece) into
    ``NativeSPMTokenizer`` (either with ``tokenizer_config.json``'s chat
    template, when it has one); a native build that fails raises: nothing
    falls back quietly. Without a
    local ``tokenizer.json`` (a hub model id), HF ``AutoTokenizer`` loads
    it, imported only then."""
    import json
    import os

    tj = os.path.join(model_name_or_path, "tokenizer.json")
    if os.path.isfile(tj):
        kw = {}
        cfg_path = os.path.join(model_name_or_path, "tokenizer_config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                tok_cfg = json.load(f)
            if tok_cfg.get("chat_template"):
                kw["chat_template"] = tok_cfg["chat_template"]
        with open(tj, encoding="utf-8") as f:
            tj_dict = json.load(f)
        if (tj_dict.get("model") or {}).get("type") == "Unigram":
            from distrl_llm_tpu_torch.native.spm import NativeSPMTokenizer

            return NativeSPMTokenizer.from_hf_dict(tj_dict, **kw)
        from distrl_llm_tpu_torch.native.tokenizer import NativeBPETokenizer

        return NativeBPETokenizer.from_hf_dict(tj_dict, **kw)
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_name_or_path)


class CharTokenizer:
    """Byte-level tokenizer with the surface the framework touches (encode/
    decode/pad/eos + chat template via data.py's fallback), for hosts where
    no HF tokenizer is downloadable."""

    pad_token_id = 0
    eos_token_id = 3
    chat_template = None

    def __init__(self, vocab_size: int = 256):
        self.vocab_size = vocab_size

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return [min(b, self.vocab_size - 1) for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        # ids past the byte range (a model whose vocab is wider than 256
        # driven through this tokenizer) decode to nothing
        specials = {self.pad_token_id, self.eos_token_id}
        kept = [i for i in ids
                if i < 256 and not (skip_special_tokens and i in specials)]
        return bytes(kept).decode("utf-8", errors="ignore")

    def apply_chat_template(
        self, messages, add_generation_prompt=False, tokenize=False, chat_template=None
    ) -> str:
        out = "".join(
            f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages
        )
        if add_generation_prompt:
            out += "<|im_start|>assistant\n"
        return out
