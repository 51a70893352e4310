"""The learner: answer logprobs and PG/GRPO losses, Adam8bit, and the
grad-accumulated train step (the JAX package's ``learner/``)."""

from distrl_llm_tpu_torch.learner.losses import (  # noqa: F401
    answer_logprobs,
    entropy_bonus,
    grpo_loss,
    pg_loss,
)
from distrl_llm_tpu_torch.learner.optim import Adam8bit, make_optimizer  # noqa: F401
from distrl_llm_tpu_torch.learner.train_step import (  # noqa: F401
    UpdateBatch,
    make_train_step,
    prepare_update_batch,
)
