"""Model architecture configs for the dense decoder families the reference
trains through unsloth (train_distributed.py:11 — any FastLanguageModel
checkpoint; BASELINE.json configs name Qwen2.5 and Llama-3).

One ``ModelConfig`` covers the supported families — Qwen2.5, Llama-3,
Mistral, Gemma — via the knobs where they actually differ: GQA attention
with optional QKV bias (Qwen2 yes), gated MLP with SiLU or tanh-GELU
(Gemma), RMSNorm with optional +1 weight offset (Gemma), optional
sqrt(hidden) embedding scaling (Gemma), optional tied embeddings, and a
recorded sliding window (Mistral v0.1 — full attention is exact for
sequences within the window; the engines enforce that).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False  # Qwen2: bias on q/k/v only
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 32768
    hidden_act: str = "silu"  # "silu" | "gelu_tanh" (Gemma)
    rmsnorm_offset: bool = False  # Gemma: norm scales by (1 + weight)
    scale_embeddings: bool = False  # Gemma: embeddings × sqrt(hidden_size)
    # Mistral v0.1 sliding-window size; recorded so the forward/engines can
    # REFUSE sequences longer than the window (full attention ≡ SWA within
    # it) rather than silently change the model's semantics
    sliding_window: int | None = None

    def __post_init__(self):
        if self.hidden_act not in ("silu", "gelu_tanh"):
            raise ValueError(
                f"hidden_act must be silu/gelu_tanh, got {self.hidden_act!r}"
            )

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def check_within_window(self, key_span: int) -> None:
        """Raise if attending over ``key_span`` keys would exceed the
        checkpoint's sliding window — full attention ≡ SWA only within it;
        running past it would silently change the model (Mistral v0.1).
        Single owner of the check for the forward and both engines."""
        if self.sliding_window is not None and key_span > self.sliding_window:
            raise ValueError(
                f"key window {key_span} exceeds the checkpoint's "
                f"sliding_window {self.sliding_window}; sliding-window "
                "attention is not implemented — keep prompt+generation "
                "within the window"
            )

    @property
    def matmul_param_count(self) -> int:
        """Parameters participating in matmuls (projections + MLP + lm_head;
        biases/norms excluded as FLOP-negligible, embedding lookups are not
        matmuls). The 2·N term of every FLOPs-per-token estimate — the
        single owner for bench.py and the telemetry MFU series."""
        per_layer = (
            self.hidden_size * self.q_dim          # q proj
            + 2 * self.hidden_size * self.kv_dim   # k, v proj
            + self.q_dim * self.hidden_size        # o proj
            + 3 * self.hidden_size * self.intermediate_size  # gate, up, down
        )
        return self.num_layers * per_layer + self.hidden_size * self.vocab_size

    @property
    def param_count(self) -> int:
        """Every parameter of the model: embedding, final norm, LM head
        (none when tied) and each layer's projections, biases and norms."""
        per_layer = (
            self.hidden_size * self.q_dim + 2 * self.hidden_size * self.kv_dim
            + self.q_dim * self.hidden_size
            + 3 * self.hidden_size * self.intermediate_size
            + 2 * self.hidden_size  # attn_norm, mlp_norm
            + ((self.q_dim + 2 * self.kv_dim) if self.attention_bias else 0)
        )
        head = 0 if self.tie_word_embeddings else self.hidden_size * self.vocab_size
        return (self.num_layers * per_layer + self.vocab_size * self.hidden_size
                + self.hidden_size + head)

    def decode_flops_per_token(self, mean_kv_len: float = 0.0) -> float:
        """Model FLOPs per decoded token: 2·(matmul params) for the dense
        path plus the attention score/value dot-products (2 FLOPs × q_dim
        keys-side + values-side) at the mean resident KV length."""
        attn = 4.0 * self.num_layers * self.q_dim * mean_kv_len
        return 2.0 * self.matmul_param_count + attn

    def train_flops_per_token(self, seq_len: int) -> float:
        """Model FLOPs per trained token: 3× the forward's cost (fwd + ~2×
        for backward through frozen base + LoRA), causal attention at mean
        key length ``seq_len / 2``."""
        return 3.0 * self.decode_flops_per_token(seq_len / 2.0)

    @property
    def model_type(self) -> str:
        """The HF model_type this config round-trips through
        ``from_hf_config`` as (used by HF-format snapshot export)."""
        if self.rmsnorm_offset:
            return "gemma"
        if self.sliding_window is not None:
            return "mistral"
        return "qwen2" if self.attention_bias else "llama"

    @staticmethod
    def from_hf_config(hf) -> "ModelConfig":
        """Build from a transformers PretrainedConfig (Qwen2/Llama/Mistral/
        Gemma Config)."""
        get = lambda k, d=None: getattr(hf, k, d)
        num_heads = hf.num_attention_heads
        mt = str(get("model_type", ""))
        if mt.startswith("gemma") and mt != "gemma":
            # Gemma-2/3 add pre/post-FFN norms, logit softcapping, and
            # alternating SWA — loading them as Gemma-1 would silently
            # produce wrong logits (the state-dict mapper ignores keys it
            # doesn't know)
            raise ValueError(
                f"model_type {mt!r} is not supported (Gemma-1 only); "
                "its extra norms/softcapping would be silently dropped"
            )
        gemma = mt == "gemma"
        act = str(get("hidden_activation", None) or get("hidden_act", "silu"))
        # Qwen2 configs carry sliding_window but gate it off by default
        window = get("sliding_window") if get("use_sliding_window", True) else None
        return ModelConfig(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers,
            num_heads=num_heads,
            num_kv_heads=get("num_key_value_heads", num_heads),
            head_dim=get("head_dim", None) or hf.hidden_size // num_heads,
            rope_theta=get("rope_theta", 10000.0),
            rms_norm_eps=get("rms_norm_eps", 1e-6),
            attention_bias=hf.model_type == "qwen2" or bool(get("attention_bias", False)),
            tie_word_embeddings=bool(get("tie_word_embeddings", False)),
            max_position_embeddings=get("max_position_embeddings", 32768),
            hidden_act="gelu_tanh" if "gelu" in act else "silu",
            rmsnorm_offset=gemma,
            scale_embeddings=gemma,
            sliding_window=int(window) if window else None,
        )


# Tiny config for unit/golden tests — shapes chosen to exercise GQA (heads !=
# kv_heads) while staying sub-millisecond on CPU.
TINY = ModelConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    rope_theta=10000.0,
    attention_bias=True,
    tie_word_embeddings=False,
)

QWEN2_0_5B = ModelConfig(
    vocab_size=151936, hidden_size=896, intermediate_size=4864, num_layers=24,
    num_heads=14, num_kv_heads=2, head_dim=64, rope_theta=1000000.0,
    attention_bias=True, tie_word_embeddings=True,
)

QWEN2_7B = ModelConfig(
    vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_layers=28,
    num_heads=28, num_kv_heads=4, head_dim=128, rope_theta=1000000.0,
    attention_bias=True, tie_word_embeddings=False,
)

QWEN2_72B = ModelConfig(
    vocab_size=152064, hidden_size=8192, intermediate_size=29568, num_layers=80,
    num_heads=64, num_kv_heads=8, head_dim=128, rope_theta=1000000.0,
    attention_bias=True, tie_word_embeddings=False,
)

LLAMA3_8B = ModelConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=500000.0,
    rms_norm_eps=1e-5, attention_bias=False, tie_word_embeddings=False,
)

MISTRAL_7B = ModelConfig(  # v0.1: 4k sliding window (v0.2+ configs drop it)
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=10000.0,
    rms_norm_eps=1e-5, attention_bias=False, tie_word_embeddings=False,
    sliding_window=4096,
)

GEMMA_2B = ModelConfig(  # MQA (1 kv head), GeGLU, +1 norm offset, tied
    vocab_size=256000, hidden_size=2048, intermediate_size=16384, num_layers=18,
    num_heads=8, num_kv_heads=1, head_dim=256, rope_theta=10000.0,
    rms_norm_eps=1e-6, attention_bias=False, tie_word_embeddings=True,
    hidden_act="gelu_tanh", rmsnorm_offset=True, scale_embeddings=True,
    max_position_embeddings=8192,
)

GEMMA_7B = ModelConfig(
    vocab_size=256000, hidden_size=3072, intermediate_size=24576, num_layers=28,
    num_heads=16, num_kv_heads=16, head_dim=256, rope_theta=10000.0,
    rms_norm_eps=1e-6, attention_bias=False, tie_word_embeddings=True,
    hidden_act="gelu_tanh", rmsnorm_offset=True, scale_embeddings=True,
    max_position_embeddings=8192,
)

PRESETS: dict[str, ModelConfig] = {
    "tiny": TINY,
    "qwen2.5-0.5b": QWEN2_0_5B,
    "qwen2.5-7b": QWEN2_7B,
    "qwen2.5-72b": QWEN2_72B,
    "llama-3-8b": LLAMA3_8B,
    "mistral-7b": MISTRAL_7B,
    "gemma-2b": GEMMA_2B,
    "gemma-7b": GEMMA_7B,
}


def preset_for_model_name(name: str) -> ModelConfig | None:
    """Map an HF-style model id (e.g. 'Qwen/Qwen2.5-7B-Instruct') to a preset."""
    low = name.lower()
    if low == "tiny":  # exact only — "tiny" substrings occur in real model ids
        return TINY
    if "r1-distill" in low:
        # BASELINE config 4's model family: tensor dims match the Qwen2/Llama
        # presets but NOT the RoPE config (R1-Distill-Qwen-7B derives from
        # Qwen2.5-MATH-7B: rope_theta 1e4 vs the preset's 1e6, 131k context).
        # A preset would silently rotate positions at the wrong frequencies —
        # force config.json-driven loading instead.
        return None
    for key, cfg in PRESETS.items():
        # tiny: exact-match only; mistral-7b: guarded below (the v0.1 preset
        # must not claim v0.2/v0.3 checkpoints, which drop the window)
        if key in ("tiny", "mistral-7b"):
            continue
        if key in low.replace("_", "-"):
            return cfg
    if "0.5b" in low and "qwen" in low:
        return QWEN2_0_5B
    if "7b" in low and "qwen" in low:
        return QWEN2_7B
    if "72b" in low and "qwen" in low:
        return QWEN2_72B
    if "8b" in low and "llama" in low:
        return LLAMA3_8B
    if (
        "mistral-7b" in low.replace("_", "-")
        and "mixtral" not in low
        and not any(v in low for v in ("v0.2", "v0.3"))
        # v0.2/v0.3 drop the sliding window (and v0.3 grows the vocab);
        # the v0.1 preset would wrongly cap their sequence length — let
        # those fall through to config.json-driven loading
    ):
        return MISTRAL_7B
    if "gemma-2b" in low.replace("_", "-"):
        return GEMMA_2B
    if "gemma-7b" in low.replace("_", "-"):
        return GEMMA_7B
    return None
