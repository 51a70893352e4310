"""Batch-chunking math for dispatching prompts across rollout workers.

``chunk_sizes`` is the JAX package's ``utils/chunking.py`` function, copied:
per-worker batch sizes — actors first, then learners at a fixed
``learner_chunk_size`` — with the reference's degradation policy when the
batch is smaller than the worker pool (distributed_trainer.py:77-124). The
trainer calls it for its validation (distributed_trainer.py:34-36).
``even_chunks`` splits a round over the remote engine's workers.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


def chunk_sizes(
    batch_size: int,
    num_actors: int,
    num_learners: int = 1,
    learner_chunk_size: int = 1,
) -> list[int]:
    """Per-worker chunk sizes: ``num_actors`` near-even actor chunks followed by
    ``num_learners`` chunks of ``learner_chunk_size``.

    Under-provisioned batches (batch < actors + learners·chunk) follow the
    reference's policy: give every actor at least one item if possible, then
    fit learners into the remainder with a shrunken chunk size; if even the
    actors don't fit, the batch is spread over the first ``batch_size``
    actors and learners get nothing.
    """
    if batch_size <= 0 or num_learners <= 0 or num_actors < 0:
        raise ValueError("Batch size, number of learners and number of actors must be positive")

    learner_total = learner_chunk_size * num_learners

    if batch_size < num_actors + learner_total:
        log.warning(
            "batch size (%d) is smaller than actors + learners need (%d)",
            batch_size,
            num_actors + learner_total,
        )
        if batch_size >= num_actors:
            remaining = batch_size - num_actors
            if remaining > 0 and num_learners > 0:
                learner_chunk_size = max(1, remaining // num_learners)
                num_learners = min(num_learners, remaining // learner_chunk_size)
                learner_total = learner_chunk_size * num_learners
            else:
                num_learners, learner_total = 0, 0
        else:
            num_actors = batch_size
            num_learners, learner_total = 0, 0

    actor_total = batch_size - learner_total
    sizes: list[int] = []
    if num_actors > 0:
        base, extra = divmod(actor_total, num_actors)
        sizes = [base + (1 if i < extra else 0) for i in range(num_actors)]
    sizes.extend([learner_chunk_size] * num_learners)
    return sizes


def even_chunks(total: int, parts: int) -> list[int]:
    """Split ``total`` items into ``parts`` near-even chunk sizes, the
    remainder spread over the leading chunks (distributed_trainer.py:312-314)."""
    base, extra = divmod(total, parts)
    return [base + (1 if i < extra else 0) for i in range(parts)]
