"""FakeEngine: a scripted stand-in for the generation engine.

The JAX package's ``engine/fake.py`` on the port's engine signature,
``generate(model, lora, prompt_ids, prompt_mask, sampling, seed) ->
GenerationResult``: completions come from a host-side script function,
tokenized to the fixed shapes the real engines emit. The trainer's tests run
the loop on it without a model forward.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.engine import GenerationResult

# script(prompt, candidate_index) -> completion text
ScriptFn = Callable[[str, int], str]


class FakeEngine:
    """Deterministic engine double. ``calls`` records each call's batch size,
    ``n`` and adapter, so tests can check rollout and weight-sync behavior."""

    def __init__(self, tokenizer, script: ScriptFn, *, max_new_tokens: int = 64):
        self.tokenizer = tokenizer
        self.script = script
        self.max_new_tokens = max_new_tokens
        self.calls: list[dict] = []

    def generate(self, model, lora, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                 sampling: SamplingConfig, seed: int) -> GenerationResult:
        b = prompt_ids.shape[0]
        n = sampling.n
        max_steps = min(sampling.max_tokens, self.max_new_tokens)
        self.calls.append({"batch": b, "n": n, "lora": lora})

        pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
        tokens = np.full((b, n, max_steps), pad_id, np.int32)
        lengths = np.zeros((b, n), np.int32)
        for i in range(b):
            # recover the prompt text to feed the script
            real = prompt_ids[i][prompt_mask[i].astype(bool)]
            prompt = self.tokenizer.decode(real.tolist())
            for j in range(n):
                toks = self.tokenizer.encode(self.script(prompt, j))[:max_steps]
                tokens[i, j, :len(toks)] = toks
                lengths[i, j] = len(toks)
        return GenerationResult(tokens=tokens, lengths=lengths)
