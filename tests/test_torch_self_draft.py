"""Parity of the self-drafter and the adaptive draft length (speculative
decoding on the refill scheduler, ``spec_drafter="self"``,
``spec_adapt=True``) with the JAX package's.

The self-drafter proposes with the policy's PREVIOUS adapter, which the
engine's mailbox keeps when a pushed adapter supersedes it. Both packages'
engines get the same two pushes: round 1 opens with adapter v0 and takes
the push of v1 at its first step (v0 becomes the drafter), round 2 opens
with v1 and takes v2 (v1 drafts for v2). Greedy (temperature 0) is exact:
tokens, lengths, dispatched steps, accepted drafts, the emit histogram and
the draft length the controller chose for every verify step must equal
the JAX engine's; logprobs agree within ``LOGP_ATOL``; and the tokens equal
plain refill decoding given the same pushes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distrl_llm_tpu_torch.engine import paged_engine as tpe
from distrl_llm_tpu_torch.models.convert import lora_from_numpy
from tests.test_torch_refill_engine import (  # noqa: F401  (weights: the fixture)
    LOGP_ATOL, _assert_same, _jengine, _lora, _prompts, _refill, _run, _run_both,
    _tengine, weights,
)
from tests.test_torch_prefix_cache import _one_torch_thread  # noqa: F401  (autouse)


def _perturbed(base: dict, seed: int, scale: float) -> dict:
    """``base`` with every B factor moved by ``scale`` x a normal draw: a
    near neighbour, as the next optimizer step's adapter is."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.array, base)
    for ab in out["layers"].values():
        ab["b"] = (ab["b"] + scale * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return out


_JENGINES: dict = {}


def _shared_jengine(t: int, **kw):
    """One JAX engine per configuration for this module's cases: its jitted
    steps belong to the instance, so a second engine would compile them all
    again. Its mailbox goes back to a new engine's (no pending push, no
    carried swap, no superseded adapter, an empty swap log), the only state
    a round leaves behind besides its ``last_*`` stats."""
    key = (t, repr(sorted(kw.items())))
    if key not in _JENGINES:
        _JENGINES[key] = _jengine(t, **kw)
    jeng = _JENGINES[key]
    for name in ("_pending", "_swapped_lora", "_prev_lora", "_prev_lora_version"):
        jeng.__dict__.pop(name, None)
    jeng.last_swap_steps, jeng.last_swap_versions = [], []
    return jeng


def _record_draft_lens(monkeypatch, jeng):
    """Wrap both packages' speculative step to log the draft length each
    verify step ran with."""
    jlens, tlens = [], []
    jstep = jeng._spec_step

    def jwrapped(*args, **kw):
        jlens.append(kw["draft_len"])
        return jstep(*args, **kw)

    monkeypatch.setattr(jeng, "_spec_step", jwrapped)
    tstep = tpe._spec_step

    def twrapped(*args, **kw):
        tlens.append(kw["draft_len"])
        return tstep(*args, **kw)

    monkeypatch.setattr(tpe, "_spec_step", twrapped)
    return jlens, tlens


@pytest.mark.parametrize("scale", [0.005, 0.6])
def test_self_drafter_with_adaptive_length_matches_jax(monkeypatch, weights, scale):
    """Two adapter pushes through both mailboxes, greedy, d = 4 with the
    controller on. A near neighbour (scale 0.005) keeps most drafts; a far
    one (0.6) wastes them, so the controller halves d and grows it back."""
    t, n = 24, 2
    ids, mask = _prompts([5, 8, 16, 11], seed=3)
    kw = _refill(spec_draft=4, spec_drafter="self", spec_adapt=True, decode_chunk=4)
    jeng, teng = _shared_jengine(t, **kw), _tengine(weights, t, **kw)
    jlens, tlens = _record_draft_lens(monkeypatch, jeng)
    v0 = jax.tree_util.tree_map(np.asarray, _lora())
    v1 = _perturbed(v0, 11, scale)
    v2 = _perturbed(v1, 12, scale)
    cfg = weights["cfg"]
    as_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    as_t = lambda tree: lora_from_numpy(tree, cfg, device="cpu")  # noqa: E731
    from distrl_llm_tpu.config import SamplingConfig as JS
    from distrl_llm_tpu_torch.config import SamplingConfig as TS

    plain = _tengine(weights, t, **_refill(decode_chunk=4))
    for version, (entry, pushed) in enumerate(((v0, v1), (v1, v2)), start=1):
        jeng.push_lora(as_j(pushed), version)
        teng.push_lora(as_t(pushed), version)
        jres = jeng.generate(weights["jparams"], as_j(entry), ids, mask,
                             JS(max_tokens=t, temperature=0.0, n=n), jax.random.PRNGKey(0))
        tres = teng.generate(weights["model"], as_t(entry), ids, mask,
                             TS(max_tokens=t, temperature=0.0, n=n), 0)
        _assert_same(jres, tres, logp_atol=LOGP_ATOL)
        assert tres.steps_dispatched == jres.steps_dispatched
        ts, js = teng.last_spec_stats, jeng.last_spec_stats
        for key in ("drafted", "emit_hist", "draft_len_final", "draft_len_switches",
                    "drafter_version", "target_version"):
            assert ts[key] == js[key], (version, key, ts[key], js[key])
        assert ts["accepted"] == round(js["accept_rate"] * js["drafted"])
        assert teng.last_swap_steps == jeng.last_swap_steps
        assert tlens == jlens, (version, tlens, jlens)
        assert ts["draft_forwards"] == sum(tlens)
        # greedy speculative decoding emits what plain refill decoding with
        # the same push emits
        plain.push_lora(as_t(pushed), version)
        want = plain.generate(weights["model"], as_t(entry), ids, mask,
                              TS(max_tokens=t, temperature=0.0, n=n), 0)
        np.testing.assert_array_equal(tres.tokens, want.tokens)
        jlens.clear()
        tlens.clear()
    assert ts["drafter_version"] == 1 and ts["target_version"] == 2
    if scale > 0.5:
        assert ts["draft_len_switches"] >= 2, ts
    else:
        assert ts["accept_rate"] > 0.5, ts


def test_self_drafter_before_any_swap_drafts_with_the_current_adapter(weights):
    """No adapter was ever superseded: the current adapter drafts for
    itself, so every greedy draft is accepted (q = p), as in the JAX
    engine."""
    t, n = 12, 2
    ids, mask = _prompts([9, 16], seed=14)
    kw = _refill(spec_draft=3, spec_drafter="self")
    jres, tres = _run_both(weights, _jengine(t, **kw), teng := _tengine(weights, t, **kw),
                           ids, mask, t, n)
    _assert_same(jres, tres)
    st = teng.last_spec_stats
    assert st["accept_rate"] == 1.0 and st["drafter_version"] is None
    np.testing.assert_array_equal(
        tres.tokens, _run(weights, _tengine(weights, t, **_refill()), ids, mask, t, n).tokens)
