"""Rollout engines: dense (``engine.py``) and paged, wave scheduler
(``paged_engine.py``)."""

from distrl_llm_tpu_torch.engine.engine import GenerationEngine, GenerationResult  # noqa: F401
from distrl_llm_tpu_torch.engine.paged_engine import PagedGenerationEngine  # noqa: F401
