"""Pluggable multi-turn environments (the JAX package's ``env/``).

The :class:`Environment` protocol and the episode records (``base``), the
three shipped environments, the name registry that config validation and
the CLI read, and :class:`EnvRolloutDriver`, the engine's turn hook that
the trainer arms for ``env != "math"``. Nothing here touches a tensor.
"""

from distrl_llm_tpu_torch.env.base import Environment, EnvStep, EpisodeState, TurnRecord
from distrl_llm_tpu_torch.env.code_env import CodeToolEnv, run_sandboxed
from distrl_llm_tpu_torch.env.driver import EnvRolloutDriver, EnvRoundResult, EnvRoundStats
from distrl_llm_tpu_torch.env.math_env import MathSingleTurnEnv
from distrl_llm_tpu_torch.env.registry import ENV_REGISTRY, env_names, get_env_class
from distrl_llm_tpu_torch.env.verifier_env import VerifierFeedbackEnv

__all__ = [
    "ENV_REGISTRY",
    "CodeToolEnv",
    "Environment",
    "EnvRolloutDriver",
    "EnvRoundResult",
    "EnvRoundStats",
    "EnvStep",
    "EpisodeState",
    "MathSingleTurnEnv",
    "TurnRecord",
    "VerifierFeedbackEnv",
    "env_names",
    "get_env_class",
    "run_sandboxed",
]
