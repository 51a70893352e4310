"""Name -> environment class, for config validation and the CLI."""

from __future__ import annotations

from distrl_llm_tpu_torch.env.code_env import CodeToolEnv
from distrl_llm_tpu_torch.env.math_env import MathSingleTurnEnv
from distrl_llm_tpu_torch.env.verifier_env import VerifierFeedbackEnv

ENV_REGISTRY: dict[str, type] = {
    MathSingleTurnEnv.name: MathSingleTurnEnv,
    CodeToolEnv.name: CodeToolEnv,
    VerifierFeedbackEnv.name: VerifierFeedbackEnv,
}


def env_names() -> tuple[str, ...]:
    return tuple(sorted(ENV_REGISTRY))


def get_env_class(name: str) -> type:
    try:
        return ENV_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown environment {name!r}; available: {', '.join(env_names())}"
        ) from None
