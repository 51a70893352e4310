"""The port's learner sharded over gloo ranks (ROADMAP item 10a) against the
live JAX learner on a learner mesh of the 8 CPU devices, and against the
port's own one-rank run, at TINY size in f32.

Each case takes two steps over one batch of text through ``CharTokenizer``
(3 microbatches of 4 rows, the first all-zero so that it is skipped but
counted): dp 2, fsdp 2 and dp 2 x fsdp 2 in LoRA mode (rank 4, non-zero B),
and full fine-tuning at fsdp 2. The port's ranks run in processes of their
own (``tests/torch_mesh_ranks.py``), all four cases in one launch of four
ranks: dp 2 x fsdp 2 over all of them, then LoRA dp 2 and fsdp 2 one after
the other on ranks 0-1 beside full fine-tuning at fsdp 2 on ranks 2-3. Its
one-rank run (once a mode) and the JAX side run here. Every case is held to the port's one-rank run bit for
bit; dp 2 x fsdp 2 and full fine-tuning at fsdp 2 are also held to JAX on a
mesh of the same shape, which holds dp 2 and fsdp 2 to it as well (they
equal dp 2 x fsdp 2 bit for bit; JAX's own meshes differ by its summation
order only), at a JAX compile less each.

Tolerances:

* against JAX: those of ``tests/test_torch_learner.py`` for the adapter
  (each loss within ``STEP_ATOL``; the adapter within 2 lr after step 1 and
  10 lr after step 2, past 1e-3 lr on at most ``FLIP_SHARE`` of it) and of
  ``tests/test_torch_full_finetune.py`` for full fine-tuning (each leaf
  within ``REL`` of its scale but on ``FLIP_SHARE``, within 10 lr there);
  Adam8bit's int8 codes equal but on ``FLIP_SHARE`` of each leaf and its
  block scales within ``SCALE_RTOL`` (the two packages sum each grad in
  another order, and a code at a decision boundary can round one step
  apart); the forward logits before the first step within ``LOGIT_ATOL``
  (f32 forwards summed in another order);
* against the port's one-rank run: bit for bit, whatever the mesh. fsdp
  ranks each run the one-rank step over whole gathered tensors and keep
  their range; dp ranks each sum their own whole microbatches, and the
  merge adds those sums in the one-rank run's order on these inputs (two
  dp groups: the first's two microbatches, then the second's). In general
  the dp merge may round differently in the last place.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu import config as jconfig
from distrl_llm_tpu.learner import optim as joptim
from distrl_llm_tpu.learner import train_step as jts
from distrl_llm_tpu.models import transformer as jtf
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu.parallel import partition as jpartition
from distrl_llm_tpu.parallel.mesh import build_role_meshes as jbuild_role_meshes
from distrl_llm_tpu_torch.learner import train_step as ts
from distrl_llm_tpu_torch.tokenizer import CharTokenizer
from tests import torch_mesh_ranks as ranks
from tests.test_torch_full_finetune import REL, SCALE_RTOL, _close
from tests.test_torch_learner import (
    ADAPTER_STEP2_ATOL, FLIP_SHARE, LR, MICRO, P, SCALE, STEP_ATOL, T, _text,
    trees,  # noqa: F401 — a fixture
)

LOGIT_ATOL = 1e-5
CASES = {  # name: (dp, fsdp, first rank, full, held to JAX too), in launch order
    "lora_dp2_fsdp2": (2, 2, 0, False, True),
    "lora_dp2": (2, 1, 0, False, False),
    "full_fsdp2": (1, 2, 2, True, True),
    "lora_fsdp2": (1, 2, 0, False, False),
}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """(the inputs, {mode: the port's one-rank run}, {case: the results of
    its ranks in rank order}): one launch of four ranks for every case."""
    tree, lora_tree = trees
    problems, answers, coeffs = _inputs()
    arrays = ts.update_arrays(CharTokenizer(), problems, answers, coeffs,
                              max_prompt_tokens=P, max_new_tokens=T)
    kw = dict(params=tree, arrays=arrays, cfg=dataclasses.asdict(TINY), steps=2, lr=LR,
              micro=MICRO)
    got = ranks.launch(ranks.learner_job, 4, tmp_path_factory.mktemp("learner"), lora=lora_tree,
                       layouts={n: c[:4] for n, c in CASES.items()}, **kw)
    by_case = {n: [r[n] for r in got if n in r] for n in CASES}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: CPU sums run in one thread's order
    try:
        one = {mode: ranks.learn(0, None, lora=None if mode == "full" else lora_tree, **kw)
               for mode in ("lora", "full")}
    finally:
        torch.set_num_threads(threads)
    return (problems, answers, coeffs), one, by_case


def _inputs():
    rng = np.random.default_rng(3)
    n = 3 * MICRO
    problems, answers = _text(rng, n, 1, P), _text(rng, n, 1, T)
    coeffs = rng.standard_normal(n).astype(np.float32)
    coeffs[:MICRO] = 0.0  # an all-zero microbatch: skipped, counted in the divisor
    return problems, answers, coeffs


def _jax_run(mode, dp, fsdp, tree, lora_tree, problems, answers, coeffs):
    mesh = jbuild_role_meshes(jconfig.MeshConfig(number_of_actors=0, number_of_learners=dp,
                                                 fsdp=fsdp),
                              devices=jax.devices()[:dp * fsdp]).learner
    assert dict(mesh.shape) == {"dp": dp, "fsdp": fsdp, "sp": 1, "tp": 1}
    opt = joptim.make_optimizer(LR)
    base = jpartition.shard_tree(jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    trained = base if mode == "full" else jpartition.shard_tree(
        jax.tree_util.tree_map(jnp.asarray, lora_tree), mesh)
    state = jpartition.shard_opt_state(opt.init(trained), mesh)
    step = jts.make_train_step(TINY, optimizer=opt, lora_scale=1.0 if mode == "full" else SCALE,
                               micro_size=MICRO, attn_impl="splash", donate=False,
                               train_mode=mode)
    batch = jts.prepare_update_batch(CharTokenizer(), problems, answers, coeffs,
                                     max_prompt_tokens=P, max_new_tokens=T, micro_size=MICRO,
                                     mesh=mesh)
    ids = jnp.concatenate([batch.prompt_ids, batch.answer_ids], 1)[:len(problems)]
    logits = np.asarray(jtf.forward(trained if mode == "full" else base, TINY, ids,
                                    lora=None if mode == "full" else trained,
                                    lora_scale=SCALE)[0])
    losses, after = [], []
    for _ in range(2):
        trained, state, loss = step(trained, state, None if mode == "full" else base, batch)
        losses.append(float(loss))
        after.append(jax.tree_util.tree_map(np.asarray, trained))
    return losses, after, state, logits


def _jax_value(tree, name):
    """The JAX tree's value of port parameter ``name`` ("layers.1.wq",
    "embed") or adapter factor ("wq.a")."""
    parts = name.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]][int(parts[1])]
    if len(parts) == 2:
        return tree["layers"][parts[0]][parts[1]]
    return tree[name]


def _state_leaves(mode, tree, jstate):
    """(mu, nu) of each JAX leaf in the port's optimizer leaf order: the
    adapter's factors by sorted target, a model's leaves as ``param_stacks``
    lists them."""
    if mode == "lora":
        return [(jstate.mu["layers"][t][k], jstate.nu["layers"][t][k])
                for t in sorted(tree["layers"]) for k in "ab"]
    keys = ["embed", "final_norm", *(f"layers.{n}" for n in sorted(tree["layers"])), "lm_head"]

    def leaf(jt, key):
        return jt["layers"][key[len("layers."):]] if key.startswith("layers.") else jt[key]

    return [(leaf(jstate.mu, k), leaf(jstate.nu, k)) for k in keys]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_learner_matches_jax_and_one_rank(name, trees, runs):
    dp, fsdp, _, full, with_jax = CASES[name]
    mode = "full" if full else "lora"
    tree, lora_tree = trees
    (problems, answers, coeffs), ones, by_case = runs
    one, got = ones[mode], by_case[name]
    assert len(got) == dp * fsdp
    mesh = got[0]

    # the port's mesh against its one-rank run: bit for bit
    assert mesh["losses"] == one["losses"]
    for key in one["trained"]:
        np.testing.assert_array_equal(mesh["trained"][key], one["trained"][key], err_msg=key)
        for i in range(2):
            np.testing.assert_array_equal(mesh["grads"][i][key], one["grads"][i][key],
                                          err_msg=f"grad {i} {key}")
    np.testing.assert_array_equal(mesh["logits"], one["logits"])
    for i, entry in one["opt_state"].items():
        for k, v in entry.items():
            np.testing.assert_array_equal(mesh["opt_state"][i][k], v, err_msg=f"{i} {k}")
    # fsdp shards the trained state: each rank holds about 1 / fsdp of it
    if fsdp > 1:
        assert all(r["local_bytes"] < one["local_bytes"] for r in got)

    if not with_jax:
        return
    # against the live JAX learner on a learner mesh of the same shape
    jlosses, jafter, jstate, jlogits = _jax_run(mode, dp, fsdp, tree, lora_tree, problems,
                                                answers, coeffs)
    np.testing.assert_allclose(mesh["logits"], jlogits, atol=LOGIT_ATOL, rtol=0)
    if mode == "full":
        np.testing.assert_allclose(mesh["losses"], jlosses, rtol=REL, atol=REL)
    else:
        np.testing.assert_allclose(mesh["losses"], jlosses, atol=STEP_ATOL, rtol=0)
    final = mesh["trained"]
    if mode == "full":
        for name in final:
            _close(final[name], _jax_value(jafter[1], name), f"step 2 {name}")
    else:
        diffs = np.concatenate([np.abs(final[n] - _jax_value(jafter[1], n)).ravel()
                                for n in final])
        assert diffs.max() <= ADAPTER_STEP2_ATOL, diffs.max()
        assert (diffs > 1e-3 * LR).mean() <= FLIP_SHARE
    start = tree if mode == "full" else lora_tree
    assert max(np.abs(final[n] - _jax_value(start, n)).max() for n in final) > 0.5 * LR
    for i, (jmu, jnu) in enumerate(_state_leaves(mode, start, jstate)):
        for m, jz in (("mu", jmu), ("nu", jnu)):
            q = np.asarray(mesh["opt_state"][i][f"{m}_q"]).astype(np.int32)
            jq = np.asarray(jz.q).astype(np.int32).reshape(-1)
            assert q.shape == jq.shape, (i, m)
            assert (q != jq).mean() <= FLIP_SHARE, (i, m, int((q != jq).sum()))
            np.testing.assert_allclose(mesh["opt_state"][i][f"{m}_scale"],
                                       np.asarray(jz.scale).reshape(-1), rtol=SCALE_RTOL,
                                       atol=0, err_msg=f"{i} {m}")
