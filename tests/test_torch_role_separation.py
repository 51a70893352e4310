"""The actor/learner role split over gloo ranks (ROADMAP item 10a): the
port's ``Trainer`` on a rank mesh against the live JAX trainer on a device
mesh of the 8 CPU devices, the cases of ``tests/test_role_separation.py``
without its tensor parallelism (item 10b).

Both trainers run TINY in f32 over real dense engines at temperature 0
(``position_reward`` scores identical greedy candidates apart), from the
JAX trainer's initial adapter, one episode of two steps after the initial
eval. The port's ranks are processes of their own
(``tests/torch_mesh_ranks.py``): rank 0 drives, the other follows.

* Disjoint roles (one actor rank, one learner rank): the hybrid split
  sends ``chunk_sizes(4, 1, 1, 1)`` = 3 rows to the actor rank and 1 to
  the learner rank (JAX: two engine calls of 3 and 1 rows); the eval round
  and round 1 equal JAX's token for token; the records equal JAX's (losses
  within ``STEP_ATOL``), the adapter after each step within the learner's
  tolerances; each push lands the learner's adapter in the actor rank's
  copy, version 2 on both; a round with the learner a version ahead is
  refused with ``StaleWeightsError`` on every rank; the resume state
  reaches rank 0 from the learner rank a tensor at a time.
* Timeshared dp 2 (two learner ranks, no actors): every round on rank 0,
  each update's rows split over the two ranks and the grads merged; the
  same checks against the JAX trainer on a dp-2 learner mesh.

The tolerances are ``tests/test_torch_trainer.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from distrl_llm_tpu import config as jconfig
from distrl_llm_tpu import trainer as jtrainer
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.models import TINY
from distrl_llm_tpu.parallel.mesh import build_role_meshes as jbuild_role_meshes
from distrl_llm_tpu.parallel.partition import param_specs, shard_tree
from distrl_llm_tpu.tokenizer import CharTokenizer as JCharTokenizer
from tests import torch_mesh_ranks as ranks
from tests.test_torch_learner import (
    ADAPTER_STEP1_ATOL, ADAPTER_STEP2_ATOL, FLIP_SHARE, LR, STEP_ATOL,
)
from tests.test_torch_trainer import (
    ROUND2_ROWS_SHARE, _adapter_diffs, _Recorder, _np_tree,
    base_tree,  # noqa: F401 — a fixture
)
from tests.test_trainer import make_config, make_datasets

ENGINE_KW = dict(max_prompt_tokens=16, max_new_tokens=12, eos_token_ids=[3], pad_token_id=0,
                 lora_scale=8 / 4, capture_logprobs=False, scan_chunk=0)
CFG_KW = dict(learner="pg", topk=2, max_new_tokens=12, temperature=0.0, eval_temperature=0.0,
              decode_scan_chunk=0)


def _jax_run(base_tree, actors, learners):
    cfg = make_config(number_of_actors=actors, number_of_learners=learners,
                      mesh=jconfig.MeshConfig(), **CFG_KW)
    meshes = jbuild_role_meshes(cfg.mesh)
    base = jax.tree_util.tree_map(jnp.asarray, base_tree)
    specs = param_specs(base)
    rollout = shard_tree(base, meshes.rollout, specs)
    learner = rollout if meshes.timeshared else shard_tree(base, meshes.learner, specs)
    eng = JEngine(TINY, cache_dtype=jnp.float32, autotune=False, **ENGINE_KW)
    train, test = make_datasets()
    jtr = jtrainer.Trainer(train, test, ranks.position_reward, cfg, tokenizer=JCharTokenizer(),
                           engine=eng, base_params=rollout, base_params_learner=learner,
                           model_cfg=TINY, meshes=meshes)
    lora0 = _np_tree(jtr.lora)
    jtr.sink = _Recorder(lambda: _np_tree(jtr.lora))
    calls, generate = [], eng.generate

    def recorded(*a):
        res = generate(*a)
        calls.append((np.asarray(res.tokens), np.asarray(res.lengths)))
        return res

    eng.generate = recorded
    jtr.train()
    return jtr, calls, lora0


def _port_run(base_tree, lora0, actors, learners, tmp_path, **extra):
    train, test = make_datasets()
    jcfg = make_config(number_of_actors=actors, number_of_learners=learners, **CFG_KW)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name in ranks.port_fields()}
    fields.update(print_samples=False)
    return ranks.launch(ranks.trainer_job, 2, tmp_path, fields=fields, mesh_kw={},
                        base=base_tree, lora0=lora0, cfg=dataclasses.asdict(TINY),
                        engine="dense", engine_kw=ENGINE_KW, train=train, test=test, **extra)


def _check_records(jrecs, recs):
    """``test_torch_trainer.py``'s record check, but that the JAX records
    may also carry its telemetry registry's namespaced series (``engine/*``,
    ``rollout/*``, ...): the registry is the process's, so the series other
    tests left in this worker ride every later record. The reference's flat
    metric names are the same on both sides."""
    assert [s for s, _ in recs] == [s for s, _ in jrecs]
    for (_, m), (_, jm) in zip(recs, jrecs):
        assert set(m) <= set(jm) and all("/" in k for k in set(jm) - set(m)), (
            sorted(m), sorted(jm))
        for k in m:
            if k.startswith(("timing/", "engine/")):  # times and rates
                assert m[k] >= 0
            elif k == "loss":
                np.testing.assert_allclose(m[k], jm[k], atol=STEP_ATOL, rtol=0)
            else:
                assert m[k] == jm[k], k


def _check_against_jax(jtr, got):
    recs = got[0]["records"]
    _check_records(jtr.sink.records, recs)
    for i, atol in enumerate((ADAPTER_STEP1_ATOL, ADAPTER_STEP2_ATOL)):
        diffs = _adapter_diffs(got[0]["adapters"][i], jtr.sink.adapters[i])
        assert diffs.max() <= atol, (i, diffs.max())
        assert (diffs > 1e-3 * LR).mean() <= FLIP_SHARE
    assert got[0]["weight_version"] == jtr.weight_version == 2
    assert [r["rollout_version"] for r in got] == [2, 2]
    assert all(m["loss"] != 0 for _, m in recs if "loss" in m)


def test_disjoint_roles_split_rounds_push_and_refuse_stale_weights(base_tree, tmp_path):
    jtr, jcalls, lora0 = _jax_run(base_tree, 1, 1)
    assert not jtr.meshes.timeshared
    got = _port_run(base_tree, lora0, 1, 1, tmp_path, stale=True)
    actor, learner = got[0]["calls"], got[1]["calls"]
    # the hybrid split: 3 rows on the actor rank, 1 on the learner rank a round
    assert [c["rows"] for c in actor] == [3, 3, 3] and [c["rows"] for c in learner] == [1, 1, 1]
    # JAX runs the two shares of a round on two threads: each pair in any order
    jpairs = [sorted(jcalls[2 * i:2 * i + 2], key=lambda c: -c[0].shape[0]) for i in range(3)]
    assert [[c[0].shape[0] for c in pair] for pair in jpairs] == [[3, 1]] * 3
    for i in range(3):
        tokens = np.concatenate([actor[i]["tokens"], learner[i]["tokens"]])
        want = np.concatenate([jpairs[i][0][0], jpairs[i][1][0]])
        if i < 2:  # the eval round and round 1
            np.testing.assert_array_equal(tokens, want)
        else:  # after one update a fraction of lr apart: near-tied tokens flip
            rows = (tokens == want).reshape(-1, tokens.shape[-1]).all(axis=1)
            assert rows.mean() >= ROUND2_ROWS_SHARE
    _check_against_jax(jtr, got)
    # the push across roles: the actor rank samples the learner's adapter
    for t, ab in got[1]["lora_learner"]["layers"].items():
        for k, x in ab.items():
            np.testing.assert_array_equal(got[0]["lora_rollout"]["layers"][t][k], x)
    assert "lora_rollout" not in got[1]
    assert [r["stale"] for r in got] == [True, True]
    # the resume state reaches rank 0, off the learner mesh, a tensor at a
    # time from the learner rank's host
    state = got[0]["state"]
    for t, ab in got[0]["adapters"][-1]["layers"].items():
        for k, x in ab.items():
            np.testing.assert_array_equal(state["lora"]["layers"][t][k], x)
    assert len(state["opt_state"]["state"]) == 2 * len(state["lora"]["layers"])
    tensors, objects = got[0]["traffic"]["save"]
    assert tensors and {name for name, _ in tensors} == {"recv"}
    assert [name for name, _ in objects] == ["recv_object_list"]


def test_timeshared_dp2_matches_jax(base_tree, tmp_path):
    jtr, jcalls, lora0 = _jax_run(base_tree, 0, 2)
    assert jtr.meshes.timeshared and jtr.meshes.learner_dp == 2
    got = _port_run(base_tree, lora0, 0, 2, tmp_path)
    assert [c["rows"] for c in got[0]["calls"]] == [4, 4, 4] and got[1]["calls"] == []
    for i in range(2):
        np.testing.assert_array_equal(got[0]["calls"][i]["tokens"], jcalls[i][0])
    _check_against_jax(jtr, got)
