"""ctypes binding and HF-format loading for the C++ sentencepiece Unigram
core (``csrc/spm_tokenizer.cc``, built by ``native/build.py``).

Copied from the JAX package's ``native/spm.py`` (the port imports nothing
of it). Gemma-family checkpoints tokenize with a sentencepiece Unigram
model, which HF serializes into ``tokenizer.json`` as ``{"model": {"type":
"Unigram", ...}}``. The Viterbi encode and the decode run in C++; this
module parses the JSON, applies the normalizer chain (Prepend and Replace,
the only normalizers sentencepiece-converted tokenizers carry) and exposes
the framework's tokenizer protocol. Held against the JAX package's
tokenizer and the Rust ``tokenizers`` Unigram in
``tests/test_torch_spm.py``.
"""

from __future__ import annotations

import ctypes
import json
import re
from typing import Any, Sequence

from distrl_llm_tpu_torch.native.build import build_library

_BYTE_PIECE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")
_SPACE = "▁"  # ▁ — sentencepiece's whitespace escape


def _parse_normalizer(tokenizer_json: dict[str, Any]) -> list[tuple[str, str, str]]:
    """Flatten the normalizer spec into ("prepend"|"replace", a, b) ops.

    Sentencepiece-converted tokenizers use exactly Prepend("▁") (Llama's
    add_dummy_prefix) and Replace(" "→"▁") (whitespace escaping), possibly
    inside a Sequence. Anything else raises — silently skipping a normalizer
    would desync ids from the Rust implementation."""
    ops: list[tuple[str, str, str]] = []

    def walk(node):
        if not node:
            return
        kind = node.get("type")
        if kind == "Sequence":
            for sub in node.get("normalizers", []):
                walk(sub)
        elif kind == "Prepend":
            ops.append(("prepend", node["prepend"], ""))
        elif kind == "Replace":
            pat = node.get("pattern", {})
            if "String" not in pat:
                raise ValueError(f"unsupported Replace pattern: {pat}")
            ops.append(("replace", pat["String"], node["content"]))
        else:
            raise ValueError(f"unsupported normalizer for Unigram: {kind}")

    walk(tokenizer_json.get("normalizer"))
    return ops


def serialize_hf_unigram(tokenizer_json: dict[str, Any]) -> bytes:
    """HF tokenizer.json dict → the C core's model format (.cc header)."""
    model = tokenizer_json["model"]
    if model.get("type") != "Unigram":
        raise ValueError(f"not a Unigram model: {model.get('type')!r}")
    vocab: list = model["vocab"]  # [[piece, score], ...], id = index
    byte_fallback = bool(model.get("byte_fallback", False))
    unk_id = int(model.get("unk_id") or 0)
    added = tokenizer_json.get("added_tokens", [])

    size = max(
        len(vocab), max((t["id"] + 1 for t in added), default=0)
    )
    pieces: list[str] = [""] * size
    scores: list[float] = [0.0] * size
    for i, (piece, score) in enumerate(vocab):
        pieces[i] = piece
        scores[i] = float(score)
    special_ids = []
    for tok in added:
        pieces[tok["id"]] = tok["content"]
        if tok.get("special", True):
            special_ids.append(tok["id"])

    lines = [f"{size} {unk_id} {int(byte_fallback)} {len(special_ids)}"]
    for piece, score in zip(pieces, scores):
        mm = _BYTE_PIECE.match(piece) if byte_fallback else None
        bv = int(mm.group(1), 16) if mm else -1
        lines.append(f"{piece.encode('utf-8').hex()} {score!r} {bv}")
    lines += [str(i) for i in special_ids]
    return ("\n".join(lines) + "\n").encode("utf-8")


class _Lib:
    _inst = None

    @classmethod
    def get(cls):
        if cls._inst is None:
            lib = ctypes.CDLL(build_library("spm_tokenizer.cc"))
            lib.spm_create.restype = ctypes.c_void_p
            lib.spm_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.spm_free.argtypes = [ctypes.c_void_p]
            lib.spm_encode.restype = ctypes.c_int64
            lib.spm_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ]
            lib.spm_decode.restype = ctypes.c_int64
            lib.spm_decode.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
            ]
            cls._inst = lib
        return cls._inst


class NativeSPMTokenizer:
    """Sentencepiece Unigram with the C++ core; drop-in for the framework's
    tokenizer protocol (encode / decode / apply_chat_template / *_token_id).
    """

    def __init__(
        self,
        serialized_model: bytes,
        *,
        eos_token_id: int,
        pad_token_id: int | None = None,
        chat_template: str | None = None,
        normalizer_ops: Sequence[tuple[str, str, str]] = (),
        eos_token_ids: Sequence[int] | None = None,
    ):
        self._lib = _Lib.get()
        self._h = self._lib.spm_create(serialized_model, len(serialized_model))
        if not self._h:
            raise ValueError("malformed sentencepiece model data")
        self.eos_token_id = eos_token_id
        self.pad_token_id = (
            pad_token_id if pad_token_id is not None else eos_token_id
        )
        self.chat_template = chat_template
        self._norm_ops = list(normalizer_ops)
        if eos_token_ids:
            self.eos_token_ids = list(eos_token_ids)

    @classmethod
    def from_hf_file(cls, path: str, **kw) -> "NativeSPMTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls.from_hf_dict(json.load(f), **kw)

    @classmethod
    def from_hf_dict(cls, tj: dict, **kw) -> "NativeSPMTokenizer":
        data = serialize_hf_unigram(tj)
        kw.setdefault("normalizer_ops", _parse_normalizer(tj))
        specials = {t["content"]: t["id"] for t in tj.get("added_tokens", [])}
        if "eos_token_id" not in kw:
            for name in ("<eos>", "</s>", "<end_of_turn>", "<|endoftext|>"):
                if name in specials:
                    kw["eos_token_id"] = specials[name]
                    break
            else:
                raise ValueError(
                    "no conventional EOS token found among special tokens "
                    f"{sorted(specials)}; pass eos_token_id explicitly"
                )
        if "eos_token_ids" not in kw and "<end_of_turn>" in specials:
            # Gemma chat turns end with <end_of_turn>, not <eos> — rollouts
            # must stop on either (the HF path exposes the same pair)
            kw["eos_token_ids"] = sorted(
                {kw["eos_token_id"], specials["<end_of_turn>"]}
            )
        if "pad_token_id" not in kw and "<pad>" in specials:
            kw["pad_token_id"] = specials["<pad>"]
        return cls(data, **kw)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.spm_free(h)
            self._h = None

    def _normalize(self, text: str) -> str:
        for kind, a, b in self._norm_ops:
            if kind == "prepend":
                # HF Prepend is UNCONDITIONAL on non-empty text (verified
                # against the Rust lib: "▁hi" → "▁▁hi"), and applies per
                # added-token-free segment — for the framework's inputs
                # (whole prompts) once at the start is the same thing
                if text:
                    text = a + text
            else:
                text = text.replace(a, b)
        return text

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        raw = self._normalize(text).encode("utf-8")
        cap = max(16, 4 * len(raw) + 16)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.spm_encode(self._h, raw, len(raw), buf, cap)
        if n < 0:
            raise RuntimeError("encode failed")
        if n > cap:  # can't happen (≤1 id per byte + specials), but be safe
            buf = (ctypes.c_int32 * n)()
            n = self._lib.spm_encode(self._h, raw, len(raw), buf, n)
        return list(buf[:n])

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        arr = (ctypes.c_int32 * len(ids))(*[int(i) for i in ids])
        cap = 16
        for _ in range(2):
            out = ctypes.create_string_buffer(cap)
            n = self._lib.spm_decode(
                self._h, arr, len(ids), int(skip_special_tokens), out, cap
            )
            if n < 0:
                raise RuntimeError("decode failed")
            if n <= cap:
                text = out.raw[:n].decode("utf-8", errors="replace")
                return text.replace(_SPACE, " ")
            cap = n
        raise RuntimeError("decode buffer negotiation failed")


# chat rendering does not depend on the model format (Jinja over the
# checkpoint's template): the BPE wrapper's implementation serves both
from distrl_llm_tpu_torch.native.tokenizer import NativeBPETokenizer as _BPE  # noqa: E402

NativeSPMTokenizer.apply_chat_template = _BPE.apply_chat_template
