"""ctypes binding + HF-format loading for the C++ byte-level BPE tokenizer.

Copied from the JAX package's ``native/tokenizer.py`` (the port imports
nothing of that package). The reference tokenizes through HF's Rust
tokenizers (`load_correct_tokenizer`, train_distributed.py:46;
`batch_encode_plus`, distributed_actor.py:217/:222). Here the encode/decode
path is C++ (csrc/bpe_tokenizer.cc, built by ``native/build.py``); this
module

* converts an HF ``tokenizer.json`` into the C core's raw-bytes model format
  (undoing the GPT-2 byte→unicode remapping of byte-level BPE vocabularies),
* exposes a ``NativeBPETokenizer`` with the small tokenizer protocol the rest
  of the framework uses (encode/decode/apply_chat_template/pad & eos ids —
  see distrl_llm_tpu_torch/tokenizer.py).
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Any, Sequence

from distrl_llm_tpu_torch.native.build import build_library


def _gpt2_byte_decoder() -> dict[str, int]:
    """Inverse of the GPT-2 bytes_to_unicode table used by byte-level BPE."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTE_DECODER = _gpt2_byte_decoder()


def token_to_bytes(token: str) -> bytes:
    """Map a byte-level-BPE vocab token (unicode-remapped) to raw bytes."""
    try:
        return bytes(_BYTE_DECODER[ch] for ch in token)
    except KeyError:
        # not byte-remapped (added/special tokens) — use UTF-8 of the literal
        return token.encode("utf-8")


def _detect_pretok_kind(tokenizer_json: dict[str, Any]) -> int:
    """0 = GPT-2 pattern, 1 = Qwen2/cl100k pattern (the default for the model
    families this framework trains). Detection keys off the digit-chunking
    alternative ``\\p{N}{1,3}`` that distinguishes the cl100k-style regex."""
    pt = tokenizer_json.get("pre_tokenizer") or {}
    frags: list[str] = []

    def collect(node):
        if isinstance(node, dict):
            pat = node.get("pattern")
            if isinstance(pat, dict) and "Regex" in pat:
                frags.append(pat["Regex"])
            for v in node.values():
                collect(v)
        elif isinstance(node, list):
            for v in node:
                collect(v)

    collect(pt)
    pattern = " ".join(frags)
    if pattern:
        return 1 if "{1,3}" in pattern else 0

    # No explicit Regex. A ByteLevel pre_tokenizer with use_regex (the
    # tokenizers default is true) splits with its BUILT-IN GPT-2 pattern;
    # only regex-less configs (use_regex false everywhere, as Qwen2-style
    # Sequence[Split, ByteLevel(use_regex=false)] files always pair with an
    # explicit Split) default to the modern cl100k rules.
    uses_builtin_gpt2 = []

    def check_bytelevel(node):
        if isinstance(node, dict):
            if node.get("type") == "ByteLevel":
                uses_builtin_gpt2.append(node.get("use_regex", True))
            for v in node.values():
                check_bytelevel(v)
        elif isinstance(node, list):
            for v in node:
                check_bytelevel(v)

    check_bytelevel(pt)
    if any(uses_builtin_gpt2):
        return 0
    return 1


def serialize_hf_tokenizer(tokenizer_json: dict[str, Any]) -> bytes:
    """HF tokenizer.json dict → the C core's model format (see .cc header)."""
    model = tokenizer_json["model"]
    vocab: dict[str, int] = model["vocab"]
    merges = model.get("merges", [])
    added = tokenizer_json.get("added_tokens", [])

    size = max(vocab.values(), default=-1) + 1
    for tok in added:
        size = max(size, tok["id"] + 1)
    id_to_bytes: list[bytes] = [b""] * size
    for tok, i in vocab.items():
        id_to_bytes[i] = token_to_bytes(tok)
    special_ids = []
    for tok in added:
        id_to_bytes[tok["id"]] = tok["content"].encode("utf-8")
        if tok.get("special", True):
            special_ids.append(tok["id"])

    kind = _detect_pretok_kind(tokenizer_json)
    lines = [f"{size} {len(merges)} {len(special_ids)} {kind}"]
    lines += [t.hex() for t in id_to_bytes]
    for m in merges:
        l, r = m if isinstance(m, (list, tuple)) else m.split(" ", 1)
        lines.append(f"{token_to_bytes(l).hex()} {token_to_bytes(r).hex()}")
    lines += [str(i) for i in special_ids]
    return ("\n".join(lines) + "\n").encode("utf-8")


class _Lib:
    _inst = None

    @classmethod
    def get(cls):
        if cls._inst is None:
            lib = ctypes.CDLL(build_library("bpe_tokenizer.cc"))
            lib.bpe_create.restype = ctypes.c_void_p
            lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.bpe_free.argtypes = [ctypes.c_void_p]
            lib.bpe_encode.restype = ctypes.c_int64
            lib.bpe_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ]
            lib.bpe_decode.restype = ctypes.c_int64
            lib.bpe_decode.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
            ]
            cls._inst = lib
        return cls._inst


class NativeBPETokenizer:
    """Byte-level BPE with the C++ core; drop-in for the framework's
    tokenizer protocol (encode / decode / apply_chat_template / *_token_id).
    """

    def __init__(
        self,
        serialized_model: bytes,
        *,
        eos_token_id: int,
        pad_token_id: int | None = None,
        chat_template: str | None = None,
        nfc_normalize: bool = True,
    ):
        self._lib = _Lib.get()
        self._h = self._lib.bpe_create(serialized_model, len(serialized_model))
        if not self._h:
            raise ValueError("malformed tokenizer model data")
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id if pad_token_id is not None else eos_token_id
        self.chat_template = chat_template
        # Qwen2-family tokenizer.json carries an NFC normalizer; GPT-2's has
        # none. Normalization runs host-side in Python (unicodedata) — the C
        # core sees NFC bytes.
        self._nfc = nfc_normalize

    @classmethod
    def from_hf_file(cls, path: str, **kw) -> "NativeBPETokenizer":
        with open(path, encoding="utf-8") as f:
            return cls.from_hf_dict(json.load(f), **kw)

    @classmethod
    def from_hf_dict(cls, tj: dict, **kw) -> "NativeBPETokenizer":
        data = serialize_hf_tokenizer(tj)
        if "nfc_normalize" not in kw:
            kw["nfc_normalize"] = "NFC" in json.dumps(tj.get("normalizer") or {})
        if "eos_token_id" not in kw:
            # conventional names only; a silently-wrong eos breaks generation
            # termination (rollouts would always run to max_tokens), so an
            # unrecognized vocabulary must fail loudly
            specials = {t["content"]: t["id"] for t in tj.get("added_tokens", [])}
            for name in ("<|im_end|>", "</s>", "<|eot_id|>", "<|endoftext|>"):
                if name in specials:
                    kw["eos_token_id"] = specials[name]
                    break
            else:
                raise ValueError(
                    "no conventional EOS token found among special tokens "
                    f"{sorted(specials)}; pass eos_token_id explicitly"
                )
        return cls(data, **kw)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.bpe_free(h)
            self._h = None

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        if self._nfc:
            import unicodedata

            text = unicodedata.normalize("NFC", text)
        raw = text.encode("utf-8")
        cap = max(16, len(raw) + 16)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.bpe_encode(self._h, raw, len(raw), buf, cap)
        if n < 0:
            raise RuntimeError("encode failed")
        if n > cap:  # can't happen (≤1 id per byte + specials), but be safe
            buf = (ctypes.c_int32 * n)()
            n = self._lib.bpe_encode(self._h, raw, len(raw), buf, n)
        return list(buf[:n])

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        arr = (ctypes.c_int32 * len(ids))(*[int(i) for i in ids])
        cap = 16
        for _ in range(2):
            out = ctypes.create_string_buffer(cap)
            n = self._lib.bpe_decode(
                self._h, arr, len(ids), int(skip_special_tokens), out, cap
            )
            if n < 0:
                raise RuntimeError("decode failed")
            if n <= cap:
                return out.raw[:n].decode("utf-8", errors="replace")
            cap = n
        raise RuntimeError("decode buffer negotiation failed")

    def apply_chat_template(
        self, messages, tokenize: bool = False, add_generation_prompt: bool = True,
        chat_template: str | None = None,
    ):
        """Chat rendering (helper.py:15–19 relies on the HF template). A
        Jinja template (from tokenizer_config.json or the caller) renders via
        jinja2 when available; otherwise explicit ChatML — the Qwen2 format
        the reference's models use."""
        template = chat_template or self.chat_template
        if template:
            try:
                import jinja2

                env = jinja2.Environment(keep_trailing_newline=True)
                env.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(
                    ValueError(msg)
                )
                text = env.from_string(template).render(
                    messages=messages,
                    add_generation_prompt=add_generation_prompt,
                    eos_token="",
                    bos_token="",
                )
                return self.encode(text) if tokenize else text
            except Exception as e:  # noqa: BLE001 — template quirks → ChatML fallback
                import logging

                logging.getLogger(__name__).warning(
                    "chat template failed to render (%s: %s); falling back to "
                    "ChatML — WRONG for non-ChatML checkpoints", type(e).__name__, e,
                )
        parts = []
        for m in messages:
            parts.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
        if add_generation_prompt:
            parts.append("<|im_start|>assistant\n")
        text = "".join(parts)
        return self.encode(text) if tokenize else text
