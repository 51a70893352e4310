"""Two cases of ``tests/test_torch_refill_engine.py``, moved unchanged to a
file of their own so that the test run, which takes one file per worker,
spreads them over another worker: the refill scheduler's sampled rounds
(reproducible and well formed, plain and speculative) and ``chip_smoke.py``'s
phase 7 rehearsed on the CPU. The engines, weights and prompts are that
file's.
"""

import numpy as np
import pytest
import torch

from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu_torch.config import SamplingConfig
from tests.test_torch_refill_engine import (  # noqa: F401  (weights: the fixture)
    PAD, _prompts, _refill, _tengine, weights,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """TINY's tensors are too small for torch's intra-op threads to pay."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [0, 3])
def test_sampled_rounds_are_reproducible_and_well_formed(weights, d):
    t, n = 12, 3
    ids, mask = _prompts([10, 4, 16], seed=13)
    teng = _tengine(weights, t, eos=5, **_refill(spec_draft=d, kv_quant="int8"))
    sc = SamplingConfig(max_tokens=t, temperature=1.2, top_p=0.95, n=n)
    a = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 11)
    b = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 11)
    c = teng.generate(weights["model"], weights["lora"], ids, mask, sc, 12)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert not np.array_equal(a.tokens, c.tokens)
    tok, lengths = a.tokens.reshape(-1, t), a.lengths.reshape(-1)
    after = np.arange(t)[None, :] >= lengths[:, None]
    assert ((tok >= 0) & (tok < TINY.vocab_size)).all() and (tok[after] == PAD).all()
    assert (lengths >= 1).all()
    assert (a.logprobs.reshape(-1, t)[after] == 0.0).all()
    assert np.isfinite(a.logprobs).all() and (a.logprobs <= 1e-6).all()



def test_chip_smoke_spec_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 7 at TINY size on the CPU (plain versions, so
    no launch is counted): K5's stanza inputs at full geometry through the
    plain version, the bound, speculative and plain refill rounds, the
    launch-count check, and the f32 verify-vs-decode logits."""
    import chip_smoke

    from distrl_llm_tpu_torch.models.configs import TINY as TTINY

    assert chip_smoke.compare_paged_verify("cpu", 0, ppbs=(2,),
                                           cases=(("bfloat16", "int8"),)) == 0.0
    lengths = chip_smoke.verify_lengths(0)
    assert len(lengths) == 64 and min(lengths) == 0 and 124 in lengths
    args, _ = chip_smoke.verify_case("cpu", 0, q_dtype=torch.bfloat16, kv="bfloat16",
                                     lengths=[600] * 64, prompt_lens=(350,) * 4)
    ms, by = chip_smoke.paged_verify_bound_ms([600] * 64, args[4], q_dtype=torch.bfloat16,
                                              kv_dtype=torch.bfloat16)
    k2_ms, _ = chip_smoke.paged_attention_bound_ms([600] * 64, args[4],
                                                   q_dtype=torch.bfloat16,
                                                   kv_dtype=torch.bfloat16)
    assert by == "bytes" and k2_ms < ms < 1.2 * k2_ms  # the same pages, 5x the q
    weights = chip_smoke.make_weights(TTINY, "cpu", seed=0, rank=4)
    kw = dict(seed=0, n=2, max_new_tokens=12, slots=4, page_size=8, max_prompt_tokens=96)
    spec = chip_smoke.spec_round(TTINY, "cpu", weights, spec_draft=4, kv_quant="none", **kw)
    plain = chip_smoke.spec_round(TTINY, "cpu", weights, spec_draft=0, kv_quant="none", **kw)
    np.testing.assert_array_equal(spec["res"].tokens, plain["res"].tokens)
    for out in (spec, plain):
        assert out["counts"] == {k["name"]: 0 for k in chip_smoke.KERNELS}  # CPU: no launch
        with pytest.raises(chip_smoke.SmokeFailure, match="launched"):
            chip_smoke.check_spec_counts(out, TTINY.num_layers)
    assert spec["spec"]["verify_forwards"] == spec["forwards"] > 0
    ex = chip_smoke.spec_exactness("cpu", 0, max_new_tokens=16)
    np.testing.assert_array_equal(ex["spec"]["res"].tokens, ex["plain"]["res"].tokens)
    assert ex["spec"]["spec"]["accept_rate"] > 0
    lg = chip_smoke.verify_logits(chip_smoke.widen(weights), seed=0, n=2, page_size=8,
                                  max_prompt_tokens=96, max_new_tokens=12)
    assert lg["err"] <= 1e-4 and lg["k5"] == lg["k2"] == 0
    assert lg["shape"] == (8, chip_smoke.VF_S, TTINY.vocab_size)
