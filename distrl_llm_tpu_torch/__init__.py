"""distrl_llm_tpu_torch — the PyTorch/CUDA port of ``distrl_llm_tpu``.

The JAX package stays the reference; this package mirrors its module layout
so each file has a counterpart there, and imports nothing of it. Plain tensor
code is PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a
hand-written Hopper kernel here (``csrc/``), built at first use.

Entry points run on the GPU: ``device=None`` means ``"cuda"`` and raises when
no GPU is present (``utils.device.resolve_device``). Pass ``device="cpu"``
explicitly to run the plain PyTorch versions on the CPU, as the tests do.
"""

__version__ = "0.1.0"

from distrl_llm_tpu_torch.config import SamplingConfig  # noqa: F401
from distrl_llm_tpu_torch.engine import (  # noqa: F401
    GenerationEngine, GenerationResult, PagedGenerationEngine,
)
