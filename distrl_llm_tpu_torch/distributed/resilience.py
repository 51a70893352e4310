"""``RetryPolicy``: seeded exponential backoff (JAX
``distributed/resilience.py:155-207``).

The async rollout service retries a failed produce round with this backoff
(``rollout/service.py``). The JAX policy's retry counts and deadline budgets
serve its control plane, and its error classification and fault injection
with them: ROADMAP queue 1 item 9. A policy built from the same backoff
fields replays the same delays in both packages.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field


@dataclass
class RetryPolicy:
    """Seeded exponential backoff: ``backoff(attempt)`` draws its jitter from
    a private, lock-guarded ``random.Random(seed)``, so two policies with the
    same fields replay the same delays for the same call order."""

    base_s: float = 0.05            # first backoff delay
    multiplier: float = 2.0
    max_backoff_s: float = 2.0      # delay cap
    jitter: float = 0.1             # +/- fraction applied to each delay
    seed: int = 0

    _rng: random.Random = field(init=False, repr=False, compare=False)
    _rng_mu: threading.Lock = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.base_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff delays must be >= 0")
        self._rng = random.Random(self.seed)
        self._rng_mu = threading.Lock()

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based): exponential with the
        seeded jitter, capped at ``max_backoff_s``."""
        d = min(self.base_s * self.multiplier ** max(attempt, 0), self.max_backoff_s)
        if self.jitter:
            with self._rng_mu:
                jitter_draw = self._rng.random()
            d *= 1.0 + self.jitter * (2.0 * jitter_draw - 1.0)
        return max(d, 0.0)
