"""The port's host modules (tokenizer, prompts, rewards) are copies of the
JAX package's: the same inputs give the same outputs."""

import numpy as np
import pytest

from distrl_llm_tpu import data as jdata
from distrl_llm_tpu import rewards as jrewards
from distrl_llm_tpu import tokenizer as jtok
from distrl_llm_tpu_torch import data as tdata
from distrl_llm_tpu_torch import rewards as trewards
from distrl_llm_tpu_torch import tokenizer as ttok

PROBLEMS = ["What is 7 * 8?", "Compute 2^10.", "x", "Simplify (x^2 - 1)/(x - 1)."]

COMPLETIONS = [
    "<think> 7 times 8 </think> <answer> 56 </answer>",
    "<think>\nreason\n</think>\n<answer>\n1024\n</answer>\n",
    "<think>\nmulti\nline\n</think>\n<answer>\n55\n</answer>\ntrailing text",
    "no tags at all",
    "<answer> x+1 </answer><answer>x+2</answer>",
    "",
]
SOLUTIONS = ["56", "1024", "55", "0", "x+2", ""]


@pytest.mark.parametrize("preprompt", ["", jdata.R1_PREPROMPT])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("max_length", [16, 200])
def test_prompts_encode_like_the_jax_package(preprompt, side, max_length):
    jt, tt = jtok.CharTokenizer(), ttok.CharTokenizer()
    want = jdata.process_dataset(jt, {"problem": PROBLEMS}, preprompt, "Answer:")
    got = tdata.process_dataset(tt, {"problem": PROBLEMS}, preprompt, "Answer:")
    assert got["problem"] == want["problem"]
    wids, wmask = jtok.encode_fixed(jt, want["problem"], max_length, side=side)
    ids, mask = ttok.encode_fixed(tt, got["problem"], max_length, side=side)
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(mask, wmask)
    lengths = mask.sum(-1)
    rows = ids if side == "right" else np.stack(
        [np.roll(r, n) for r, n in zip(ids, lengths)])  # real tokens first
    assert ttok.decode_batch(tt, rows, lengths) == jtok.decode_batch(jt, rows, lengths)


def test_char_tokenizer_drops_ids_past_the_byte_range():
    """A model whose vocabulary is wider than 256 driven through the byte
    tokenizer: ids past the byte range decode to nothing."""
    tt = ttok.CharTokenizer()
    assert tt.decode([104, 105, 3, 70000, 0, 33]) == "hi!"
    assert tt.decode([104, 3], skip_special_tokens=False) == "h\x03"


@pytest.mark.parametrize("name", ["soft", "strict"])
def test_rewards_score_like_the_jax_package(name):
    want = jrewards.make_reward_function(name)(COMPLETIONS, SOLUTIONS)
    got = trewards.make_reward_function(name)(COMPLETIONS, SOLUTIONS)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(COMPLETIONS), 2)
    np.testing.assert_array_equal(trewards.make_format_scorer(name)(COMPLETIONS),
                                  jrewards.make_format_scorer(name)(COMPLETIONS))


def test_reward_computer_scores_groups_like_the_jax_package():
    groups = [(COMPLETIONS[:3], SOLUTIONS[:3]), (COMPLETIONS[3:], SOLUTIONS[3:])]
    want = jrewards.RewardComputer()(groups)
    got = trewards.RewardComputer()(groups)
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="available"):
        trewards.make_reward_function("lenient")
