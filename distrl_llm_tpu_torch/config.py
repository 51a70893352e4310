"""Sampling configuration for a generation round (the part of the JAX
package's ``config.py`` the rollout path reads)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

#: every top-p filter name the JAX package knows (ops/sampling.py TOP_P_IMPLS);
#: the port implements "exact" and "bisect" — ops.sampling raises on the rest
TOP_P_IMPL_NAMES = ("exact", "bisect", "bisect_mw")


@dataclass
class SamplingConfig:
    """Sampling parameters for a generation round: train-time 1.2/0.95,
    eval-time 0.6/0.95, ``n`` candidates per prompt."""

    max_tokens: int = 1200
    temperature: float = 1.2
    top_p: float = 0.95
    n: int = 16  # candidates per prompt
    # top-p filter: False = sort-free bisection (the fused kernel),
    # True = exact rank-based sort filter (reference vLLM semantics)
    top_p_exact: bool = False
    # explicit filter name (one of TOP_P_IMPL_NAMES); None derives from
    # top_p_exact
    top_p_impl: str | None = None

    def resolved_top_p_impl(self) -> str:
        """Effective top-p implementation. Priority: an explicit
        ``top_p_impl`` pin, then ``top_p_exact``, then "bisect" (the JAX
        package's autotune plan default has no counterpart here)."""
        if self.top_p_impl:  # "" and None both mean "derive"
            if self.top_p_impl not in TOP_P_IMPL_NAMES:
                raise ValueError(
                    f"top_p_impl must be one of {sorted(TOP_P_IMPL_NAMES)}, "
                    f"got {self.top_p_impl!r}"
                )
            return self.top_p_impl
        return "exact" if self.top_p_exact else "bisect"

    def replace(self, **kw) -> "SamplingConfig":
        return dataclasses.replace(self, **kw)
