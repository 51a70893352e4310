"""The port's refill scheduler under a small page budget against the JAX
package's: preemption of the least-advanced occupant and its resume by
recompute (``engine/paged_engine.py``, ``max_kv_pages``), on ``TINY`` with
8-token pages, the JAX engine beside the port's (``device="cpu"``, the
plain versions of the kernels) as in ``test_torch_refill_engine.py``,
whose helpers and weights this file shares. A file of its own because its
cases are the slowest of the refill scheduler's, and the test run takes
one file per worker.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from distrl_llm_tpu.engine import paged_engine as jpe
from tests.test_torch_refill_engine import (  # noqa: F401  (weights: the fixture)
    LOGP_ATOL, _assert_same, _jengine, _prompts, _refill, _run, _run_both, _tengine, weights,
)


class _SnapshotJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy array. On the CPU,
    ``jnp.asarray`` of a numpy array shares its memory, and the JAX refill
    engine passes its page pool's host table (``jnp.asarray(pool.table)``)
    to asynchronously dispatched steps, then edits that table in place at
    the next grant or preemption: a step still queued then reads the edited
    table, and the round's logprobs depend on the host's timing (0.0217
    apart on one prompt's candidates in 2 of 12 runs made four at a time,
    none in 12 with copies). Copying is what the engine means by the call:
    the table as it stands when the step is dispatched."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        return jnp.asarray(x.copy() if isinstance(x, np.ndarray) else x, *args, **kwargs)


@pytest.mark.parametrize("d,t,chunk,pages", [(0, 24, 4, 9), (0, 24, 4, 12), (1, 40, 2, 10),
                                              (2, 48, 1, 12)])
def test_preemption_under_a_small_page_budget_matches_jax(weights, d, t, chunk, pages,
                                                          monkeypatch):
    """A budgeted pool (max_kv_pages well under the worst case) preempts
    the least-advanced occupant and resumes it by recompute; tokens,
    lengths, behavior logprobs, steps and preemptions equal the JAX
    engine's (its host arrays snapshotted at dispatch, see
    ``_SnapshotJnp``), and tokens and logprobs equal the port's unbudgeted
    round (the resume restores the first token's logprob and recomputes
    the prefix's KV), which equals the JAX engine's unbudgeted round."""
    monkeypatch.setattr(jpe, "jnp", _SnapshotJnp())
    n = 2
    ids, mask = _prompts([5, 8, 16, 11], seed=3)
    kw = _refill(spec_draft=d, max_kv_pages=pages, decode_chunk=chunk)
    jeng, teng = _jengine(t, **kw), _tengine(weights, t, **kw)
    jres, tres = _run_both(weights, jeng, teng, ids, mask, t, n)
    _assert_same(jres, tres)
    assert tres.steps_dispatched == jres.steps_dispatched
    pool = teng.last_pool_stats
    assert pool["budgeted"] and pool["pool_pages"] == pages
    assert pool["preemptions"] == jeng.last_pool_stats["preemptions"] > 0
    assert pool["resumes"] > 0 and pool["peak_pages_used"] <= pages - 1
    jfree, free = _run_both(weights, _jengine(t, **_refill(spec_draft=d)),
                            _tengine(weights, t, **_refill(spec_draft=d)), ids, mask, t, n)
    _assert_same(jfree, free)
    np.testing.assert_array_equal(tres.tokens, free.tokens)
    np.testing.assert_allclose(tres.logprobs, free.logprobs, atol=LOGP_ATOL, rtol=0)
    again = _run(weights, _tengine(weights, t, **kw), ids, mask, t, n)
    np.testing.assert_array_equal(again.logprobs, tres.logprobs)
