"""Parity of the port's host page pool (``engine/page_pool.py``) with the JAX
package's ``PagePool`` on its unshared path.

Both pools are driven through the same seeded sequence of admissions,
grants (``ensure``), releases and preemptions, as the refill scheduler
makes them; after every operation the return values, the page table, the
owned lists, the free list and the counters must be equal, and both pools'
``check_invariants`` must hold.
"""

import numpy as np
import pytest

from distrl_llm_tpu.engine.page_pool import PagePool as JPool
from distrl_llm_tpu_torch.engine.page_pool import PagePool as TPool


def _pools(**kw):
    return JPool(**kw), TPool(**kw)


def _same(jp, tp):
    np.testing.assert_array_equal(tp.table, jp.table)
    assert tp.owned == jp.owned
    assert tp.free == jp.free
    assert tp.free_pages == jp.free_pages and tp.used_pages == jp.used_pages
    assert tp.peak_pages_used == jp.peak_pages_used
    assert tp.preemptions == jp.preemptions
    assert tp.total_admissions == jp.total_admissions
    np.testing.assert_array_equal(tp.full, jp.full)
    jp.check_invariants()
    tp.check_invariants()


@pytest.mark.parametrize("seed", range(6))
def test_seeded_admit_ensure_release_sequences_match_jax(seed):
    rng = np.random.default_rng(seed)
    ps, prompt_pages, r = 8, 3, 5
    private = int(rng.integers(2, 5))
    n_pages = int(rng.integers(2 + private, 1 + r * private + 1))
    kw = dict(first_page=4 * prompt_pages, n_pages=n_pages, r_slots=r,
              width=prompt_pages + private, page_size=ps, prompt_pages=prompt_pages)
    jp, tp = _pools(**kw)
    _same(jp, tp)
    frontier = np.zeros(r, np.int64)
    real_len = np.zeros(r, np.int64)
    ops = {"admit": 0, "declined": 0, "ensure": 0, "short": 0, "release": 0}
    for _ in range(300):
        s = int(rng.integers(r))
        if not jp.owned[s]:
            prompt = int(rng.integers(4))
            rl = int(rng.integers(1, prompt_pages * ps + 1))
            last = rl + int(rng.integers(0, (private - 1) * ps))
            got = tp.admit(s, prompt, rl, last)
            assert got == jp.admit(s, prompt, rl, last)
            ops["admit" if got else "declined"] += 1
            if got:
                frontier[s], real_len[s] = rl, rl
        elif rng.random() < 0.6:
            frontier[s] = min(frontier[s] + int(rng.integers(1, 2 * ps)),
                              real_len[s] + (private - 1) * ps - 1)
            missing = tp.ensure(s, int(frontier[s]))
            assert missing == jp.ensure(s, int(frontier[s]))
            ops["ensure"] += 1
            ops["short"] += missing > 0
        else:
            if rng.random() < 0.3:  # a preemption: counted, then released
                tp.preemptions += 1
                jp.preemptions += 1
            tp.release(s)
            jp.release(s)
            ops["release"] += 1
        _same(jp, tp)
        assert tp.pages_to_cover(s, int(frontier[s])) == jp.pages_to_cover(s, int(frontier[s]))
    assert ops["admit"] and ops["ensure"] and ops["release"], ops


def test_dead_rows_and_clamped_columns():
    """Released and never-admitted slots point every column at scratch;
    an admitted row holds its prompt's full pages, its grant, then the last
    owned page repeated."""
    kw = dict(first_page=6, n_pages=8, r_slots=3, width=5, page_size=4, prompt_pages=2)
    jp, tp = _pools(**kw)
    assert tp.admit(1, 1, 5, 9) and jp.admit(1, 1, 5, 9)
    _same(jp, tp)
    assert tp.scratch == 6 and (tp.table[0] == 6).all()
    np.testing.assert_array_equal(tp.table[1], [2, 7, 8, 8, 8])  # LIFO grants
    assert tp.ensure(1, 14) == jp.ensure(1, 14) == 0
    np.testing.assert_array_equal(tp.table[1], [2, 7, 8, 9, 9])
    tp.release(1)
    jp.release(1)
    _same(jp, tp)
    assert (tp.table == 6).all()


def test_unported_arguments_raise_naming_roadmap():
    """Prefix sharing, the radix cache and the host store are ported
    (tests/test_torch_prefix_cache.py): the arguments the pool once refused
    now construct, a cache without sharing is refused as the JAX pool
    refuses it, and a donor slot's prefix is aliased as in the JAX pool."""
    from distrl_llm_tpu.engine.page_pool import RadixCache as JRadix
    from distrl_llm_tpu_torch.engine.page_pool import RadixCache as TRadix

    kw = dict(first_page=0, n_pages=6, r_slots=2, width=3, page_size=4, prompt_pages=1)
    for jextra, textra in (({"prefix_sharing": True}, {"prefix_sharing": True}),
                           ({"prefix_sharing": True, "radix": JRadix(4)},
                            {"prefix_sharing": True, "radix": TRadix(4)})):
        JPool(**kw, **jextra).check_invariants()
        TPool(**kw, **textra).check_invariants()
    with pytest.raises(ValueError, match="prefix_sharing"):
        JPool(**kw, radix=JRadix(4))
    with pytest.raises(ValueError, match="prefix_sharing"):
        TPool(**kw, radix=TRadix(4))
    with pytest.raises(ValueError, match=">= 2 pages"):
        TPool(**{**kw, "n_pages": 1})
    jp, tp = JPool(**kw, prefix_sharing=True), TPool(**kw, prefix_sharing=True)
    for pool in (jp, tp):
        pool.register_prefix(0, [0], 1)
        assert pool.admit(1, 0, 6, 7, first_write=6)
        assert pool.admit(0, 0, 6, 7, donor=1)
    np.testing.assert_array_equal(tp.table, jp.table)
    assert (tp.shared, tp.owned, tp.ref) == (jp.shared, jp.owned, jp.ref)
