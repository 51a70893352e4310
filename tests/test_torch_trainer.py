"""The port's synchronous trainer against the JAX package's, on the CPU at TINY.

* (a) Both trainers on the ``FakeEngine`` script of ``tests/test_trainer.py``
  (pg and grpo, topk 4 and 2 of 4), the port's initial adapter copied from
  the JAX trainer's in place: per-step rewards and learner batches equal,
  metric records equal (names, and values but the losses and timings), the
  losses within ``STEP_ATOL`` and the adapter after step 1 and step 2 within
  ``ADAPTER_STEP1_ATOL`` / ``ADAPTER_STEP2_ATOL`` and ``FLIP_SHARE`` — the
  learner's tolerances of ``tests/test_torch_learner.py`` and its reasons.
* (b) Both trainers with their real dense engines at temperature 0, f32, 2
  steps. Greedy candidates of a prompt are identical, so the reward here is
  scripted by position within the group (``position_reward``) and topk keeps
  2 of 4, which leaves non-zero coefficients that do not cancel. Round 1's
  tokens are identical; rewards and coefficients equal; losses within
  ``STEP_ATOL``. Round 2 samples with the pushed adapters, which differ by up
  to ``ADAPTER_STEP1_ATOL``: its greedy tokens may flip where two logits lie
  within that of each other, so it is held to ``ROUND2_ROWS_SHARE`` of its
  rows identical (measured: all of them).
* (f) ``engine_kwargs_from_config``, every ported ``TrainConfig`` default,
  derived value and validation rule equal the JAX package's; a value only an
  unported path takes raises ``NotImplementedError`` naming its ROADMAP item.
* (g) ``python -m distrl_llm_tpu_torch.train_distributed --smoke --device cpu``.
* The host pieces the trainer calls (``chunk_sizes``, ``DictDataset``, the
  metric sinks, ``PhaseSpans``, ``FakeEngine``) against the JAX package's,
  and ``chip_smoke.py``'s phase 8 rehearsed at a small shape.
"""

import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu import config as jconfig
from distrl_llm_tpu import data as jdata
from distrl_llm_tpu import metrics as jmetrics
from distrl_llm_tpu import trainer as jtrainer
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.engine.fake import FakeEngine as JFakeEngine
from distrl_llm_tpu.models import TINY, init_params
from distrl_llm_tpu.rewards import reward_function as jreward_function
from distrl_llm_tpu.tokenizer import CharTokenizer as JCharTokenizer
from distrl_llm_tpu.utils.chunking import chunk_sizes as jchunk_sizes
from distrl_llm_tpu_torch import config, data, metrics, telemetry, trainer
from distrl_llm_tpu_torch.engine.engine import GenerationEngine
from distrl_llm_tpu_torch.engine.fake import FakeEngine
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_to_numpy, params_from_numpy
from distrl_llm_tpu_torch.rewards import reward_function
from distrl_llm_tpu_torch.tokenizer import CharTokenizer
from distrl_llm_tpu_torch.utils.chunking import chunk_sizes
from tests.test_torch_learner import (
    ADAPTER_STEP1_ATOL, ADAPTER_STEP2_ATOL, FLIP_SHARE, LR, STEP_ATOL,
)
from tests.test_trainer import make_config, make_datasets, script

ROOT = Path(__file__).resolve().parents[1]
CFG = ModelConfig(**dataclasses.asdict(TINY))
ROUND2_ROWS_SHARE = 0.9
assert LR == make_config().lr  # the learner's tolerances are stated for this lr


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def base_tree():
    return _np_tree(init_params(jax.random.PRNGKey(0), TINY))


def _port_config(**kw):
    """The port's TrainConfig with the JAX test config's values."""
    jcfg = make_config(**kw)
    return config.TrainConfig(**{f: getattr(jcfg, f)
                                 for f in config.TrainConfig.__dataclass_fields__})


class _Recorder:
    """Sink that keeps each record and, at each train record, the adapter
    (after that step's update) as numpy."""

    def __init__(self, adapter):
        self.records, self.adapters, self._adapter = [], [], adapter

    def log(self, m, step):
        self.records.append((step, dict(m)))
        if "loss" in m:
            self.adapters.append(self._adapter())

    def finish(self):
        pass


def _record_learner_batches(tr, index):
    """Wrap ``tr.train_step`` to keep each update batch (argument ``index``)
    as numpy."""
    batches, step = [], tr.train_step

    def wrapped(*a):
        batches.append({k: None if v is None else np.asarray(v)
                        for k, v in a[index]._asdict().items()})
        return step(*a)

    tr.train_step = wrapped
    return batches


def _record_rewards(tr):
    rewards, compute = [], tr._compute_round_rewards

    def wrapped(candidates):
        compute(candidates)
        rewards.append([np.asarray(r) for c in candidates for r in c["rewards"]])

    tr._compute_round_rewards = wrapped
    return rewards


def _trainers(base_tree, *, jengine, engine, reward_fns, **cfg_kw):
    """The JAX trainer and the port's on one config, base and initial
    adapter (the JAX trainer's, copied into the port's tensors in place)."""
    tok, jtok = CharTokenizer(), JCharTokenizer()
    train, test = make_datasets()
    jtr = jtrainer.Trainer(train, test, reward_fns[0], make_config(**cfg_kw), tokenizer=jtok,
                           engine=jengine, base_params=jax.tree_util.tree_map(
                               jnp.asarray, base_tree), model_cfg=TINY)
    model = params_from_numpy(base_tree, CFG, device="cpu")
    tr = trainer.Trainer(train, test, reward_fns[1], _port_config(**cfg_kw), tokenizer=tok,
                         engine=engine, model=model)
    j0 = _np_tree(jtr.lora)
    with torch.no_grad():
        for t, ab in tr.lora["layers"].items():
            for k, x in ab.items():
                x.copy_(torch.tensor(j0["layers"][t][k]))
    jtr.sink = _Recorder(lambda: _np_tree(jtr.lora))
    tr.sink = _Recorder(lambda: lora_to_numpy(tr.lora))
    return jtr, tr


def _adapter_diffs(got, want):
    return np.concatenate([np.abs(got["layers"][t][f] - want["layers"][t][f]).ravel()
                           for t in got["layers"] for f in ("a", "b")])


# the JAX trainer merges its telemetry registry's series into each record
# (autotune plan resolution, XLA compiles, generated-token counters); the
# registry is ROADMAP queue 1 item 11 of the port
REGISTRY_PREFIXES = ("autotune/", "obs/")


def _check_records(jrecs, recs):
    """Equal names (but the JAX registry's); equal values except losses
    (STEP_ATOL), timings and rates."""
    assert [s for s, _ in recs] == [s for s, _ in jrecs]
    for (_, m), (_, jm) in zip(recs, jrecs):
        jm = {k: v for k, v in jm.items() if not k.startswith(REGISTRY_PREFIXES)}
        assert sorted(m) == sorted(jm)
        for k in m:
            if k.startswith(("timing/", "engine/")):  # times and rates
                assert m[k] >= 0
            elif k == "loss":
                np.testing.assert_allclose(m[k], jm[k], atol=STEP_ATOL, rtol=0)
            else:
                assert m[k] == jm[k], k


def _check_adapters(tr, jtr):
    for i, atol in enumerate((ADAPTER_STEP1_ATOL, ADAPTER_STEP2_ATOL)):
        diffs = _adapter_diffs(tr.sink.adapters[i], jtr.sink.adapters[i])
        assert diffs.max() <= atol, (i, diffs.max())
        assert (diffs > 1e-3 * LR).mean() <= FLIP_SHARE, (i, (diffs > 1e-3 * LR).mean())


@pytest.mark.parametrize("learner", ["pg", "grpo"])
@pytest.mark.parametrize("topk", [4, 2])
def test_trainer_on_the_fake_engine_matches_jax(base_tree, learner, topk):
    jtr, tr = _trainers(
        base_tree, jengine=JFakeEngine(JCharTokenizer(), script, max_new_tokens=24),
        engine=FakeEngine(CharTokenizer(), script, max_new_tokens=24),
        reward_fns=(jreward_function, reward_function), learner=learner, topk=topk)
    jbatches, batches = _record_learner_batches(jtr, 3), _record_learner_batches(tr, 2)
    jrewards, rewards = _record_rewards(jtr), _record_rewards(tr)
    jtr.train()
    tr.train()
    assert len(rewards) == len(jrewards) == 3  # the eval round and two steps
    for got, want in zip(rewards, jrewards):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert len(batches) == len(jbatches) == 2
    for got, want in zip(batches, jbatches):
        assert sorted(k for k, v in got.items() if v is not None) == sorted(
            k for k, v in want.items() if v is not None)
        for k, v in got.items():
            if v is not None:
                np.testing.assert_array_equal(v, want[k], err_msg=k)
    _check_records(jtr.sink.records, tr.sink.records)
    assert [m["mean_accuracy_reward"] for _, m in tr.sink.records if "loss" in m] == [0.5, 0.5]
    _check_adapters(tr, jtr)
    assert tr.weight_version == jtr.weight_version == 2
    assert tr._rollout_weight_version == 2


def position_reward(completions, solutions):
    """Format 0; accuracy by the candidate's position in its group, so
    identical greedy candidates still score apart."""
    n = len(completions)
    return np.column_stack((np.zeros(n), np.arange(n) / n)).astype(np.float64)


def _train_with_real_dense_engines(base_tree, scan_chunk: int):
    """Both trainers over real dense engines at ``decode_scan_chunk =
    scan_chunk`` (0: one step a dispatch), greedy; returns the trainers,
    each engine round's (tokens, lengths) and each step's learner batch."""
    kw = dict(max_prompt_tokens=16, max_new_tokens=12, eos_token_ids=[3], pad_token_id=0,
              lora_scale=8 / 4, capture_logprobs=False, scan_chunk=scan_chunk)
    jeng = JEngine(TINY, cache_dtype=jnp.float32, autotune=False, **kw)
    eng = GenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", **kw)
    jtr, tr = _trainers(base_tree, jengine=jeng, engine=eng,
                        reward_fns=(position_reward, position_reward), learner="pg", topk=2,
                        max_new_tokens=12, temperature=0.0, eval_temperature=0.0,
                        decode_scan_chunk=scan_chunk)
    rounds = {}
    for name, e in (("jax", jeng), ("port", eng)):
        rounds[name] = []
        gen = e.generate

        def recorded(*a, _gen=gen, _out=rounds[name]):
            res = _gen(*a)
            _out.append((np.asarray(res.tokens), np.asarray(res.lengths)))
            return res

        e.generate = recorded
    jbatches, batches = _record_learner_batches(jtr, 3), _record_learner_batches(tr, 2)
    jtr.train()
    tr.train()
    return jtr, tr, rounds, jbatches, batches


def test_trainer_with_real_dense_engines_matches_jax(base_tree):
    jtr, tr, rounds, jbatches, batches = _train_with_real_dense_engines(base_tree, 0)
    (jev, j1, j2), (ev, r1, r2) = rounds["jax"], rounds["port"]
    for got, want in ((ev, jev), (r1, j1)):  # the eval round and round 1
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (r1[1] > 0).all()
    rows_same = (r2[0] == j2[0]).reshape(-1, r2[0].shape[-1]).all(axis=1)
    assert rows_same.mean() >= ROUND2_ROWS_SHARE, rows_same.mean()
    for got, want in zip(batches, jbatches):
        for k in ("coeffs", "sample_mask", "prompt_ids", "prompt_mask"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.any(got["coeffs"] != 0)
    np.testing.assert_array_equal(batches[0]["answer_ids"], jbatches[0]["answer_ids"])
    _check_records(jtr.sink.records[:2], tr.sink.records[:2])
    recs, jrecs = ([m for _, m in r.sink.records if "loss" in m] for r in (tr, jtr))
    assert sorted(recs[1]) == sorted(k for k in jrecs[1] if not k.startswith(REGISTRY_PREFIXES))
    np.testing.assert_allclose([m["loss"] for m in recs], [m["loss"] for m in jrecs],
                               atol=STEP_ATOL, rtol=0)
    assert all(m["loss"] != 0 for m in recs)
    diffs = _adapter_diffs(tr.sink.adapters[0], jtr.sink.adapters[0])
    assert diffs.max() <= ADAPTER_STEP1_ATOL


def test_trainer_with_chunked_dense_engines_matches_jax(base_tree):
    """``decode_scan_chunk=4``: both trainers' engines decode in chunks (the
    JAX engine in one scanned program a chunk, the port's at the same
    cadence: on the CPU its chunk body runs eagerly). The eval round and
    step 1 are held as in the per-step test: tokens, lengths, the learner
    batch and every metric of step 1 equal (its loss within STEP_ATOL), the
    adapter after step 1 within ADAPTER_STEP1_ATOL."""
    jtr, tr, rounds, jbatches, batches = _train_with_real_dense_engines(base_tree, 4)
    assert tr.engine.scan_chunk_active and jtr.engine.scan_chunk_active
    assert tr.config.decode_scan_chunk == jtr.config.decode_scan_chunk == 4
    (jev, j1, _), (ev, r1, _) = rounds["jax"], rounds["port"]
    for got, want in ((ev, jev), (r1, j1)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for k in ("coeffs", "sample_mask", "prompt_ids", "prompt_mask", "answer_ids"):
        np.testing.assert_array_equal(batches[0][k], jbatches[0][k], err_msg=k)
    _check_records(jtr.sink.records[:2], tr.sink.records[:2])
    diffs = _adapter_diffs(tr.sink.adapters[0], jtr.sink.adapters[0])
    assert diffs.max() <= ADAPTER_STEP1_ATOL


# ------------------------------------------------------ (f) config parity

PORTED = sorted(config.TrainConfig.__dataclass_fields__)

VALID = [
    {},
    dict(learner="grpo", topk=8, lora_dropout=0.1, kl_coeff=0.05, clip_ratio=0.2),
    dict(engine_impl="paged", kv_cache_quant="int8", max_concurrent_sequences=32,
         continuous_batching=True, spec_draft=4, spec_ngram=3),
    dict(engine_impl="paged", continuous_batching=True, max_concurrent_sequences=8,
         spec_draft=0),
    dict(engine_impl="paged", decode_scan_chunk=0, kv_cache_quant="none"),
    dict(base_quant="int4", quant_group_size=32, attn_impl="splash"),
    dict(max_concurrent_sequences=16, prompt_buckets=(128, 256),
         learner_len_buckets=(256, 512), learner_prompt_buckets=(128,)),
    dict(run_name="r1", format_reward="strict", eval_n=4, top_p_exact=True),
    dict(rollout_mode="pipelined"),
    dict(rollout_mode="async", clip_ratio=0.2, max_staleness=3, inflight_weight_updates=True),
    # ROADMAP item 8b: full fine-tuning under the overlapped modes and the
    # multi-turn environments (once refused by the port, now taken by both)
    dict(rollout_mode="pipelined", full_finetune=True, model="tiny"),
    dict(rollout_mode="async", clip_ratio=0.2, full_finetune=True, model="tiny"),
    dict(env="code", engine_impl="paged", continuous_batching=True,
         max_concurrent_sequences=8, continuous_admission=True),
    # tests/test_config.py::TestEnvConfig's accepted shapes
    dict(env="code", max_turns=3, engine_impl="paged", continuous_batching=True,
         continuous_admission=True, max_concurrent_sequences=4),
    dict(env="verifier", max_turns=3, engine_impl="paged", continuous_batching=True,
         continuous_admission=True, max_concurrent_sequences=4, format_reward="strict"),
    # ROADMAP item 9: remote rollout workers (JAX config.py:770-775,
    # :1049-1052, :1115-1191)
    dict(rollout_workers=("h:1", "h:2"), weight_bus="dispatch", worker_rejoin=False,
         rpc_retries=0, rpc_backoff_s=0.0, poison_shard_k=1, degrade_on_poison=True),
    dict(rollout_workers=("h:1",), clip_ratio=0.2, workers_capture_logprobs=True,
         rollout_mode="async", inflight_weight_updates=True, max_staleness=2),
    dict(rollout_workers=("h:1",), kv_cache_quant="none", base_quant="int4", attn_impl="splash"),
    dict(weight_bus="dispatch", workers_capture_logprobs=True, rpc_retries=5),
    # ROADMAP item 10a: full fine-tuning at any width; the Trainer holds one
    # rank's fsdp share to the card it runs on (config.check_full_finetune_fits)
    dict(full_finetune=True, model="meta-llama/Meta-Llama-3-8B"),
]

# tests/test_config.py::TestEnvConfig's multi-turn shape, varied one knob at
# a time
_MULTI = dict(env="code", max_turns=3, engine_impl="paged", continuous_batching=True,
              continuous_admission=True, max_concurrent_sequences=4)

INVALID = [
    dict(learner="ppo"),
    dict(rollout_mode="streaming"),
    dict(base_quant="nf4"),
    dict(engine_impl="vllm"),
    dict(kv_cache_quant="fp8"),
    dict(quant_group_size=0, base_quant="int8"),
    dict(quant_group_size=64),
    dict(full_finetune=True, base_quant="int8"),
    dict(full_finetune=True, write_adapter_file=True),
    dict(full_finetune=True, lora_dropout=0.1),
    dict(full_finetune=True, kl_coeff=0.1),
    dict(decode_scan_chunk=-1),
    dict(env="chess"),
    dict(format_reward="lenient"),
    dict(env="math", max_turns=2),
    {**_MULTI, "max_turns": 0},
    dict(env="code"),
    {**_MULTI, "continuous_admission": False},
    {**_MULTI, "spec_draft": 2},
    {**_MULTI, "engine_impl": "dense"},
    dict(env="verifier", engine_impl="paged", continuous_batching=True,
         max_concurrent_sequences=4),
    dict(continuous_batching=True),
    dict(continuous_batching=True, engine_impl="paged"),
    dict(spec_draft=4),
    dict(engine_impl="paged", continuous_batching=True, max_concurrent_sequences=8,
         spec_draft=17),
    dict(engine_impl="paged", continuous_batching=True, max_concurrent_sequences=8,
         spec_ngram=0),
    dict(spec_ngram=2),
    dict(engine_impl="paged", continuous_batching=True, max_concurrent_sequences=8,
         spec_draft=0, spec_ngram=2),
    dict(batch_size=0),
    dict(learner_len_buckets=(0,)),
    dict(learner_len_buckets=(1201,)),
    dict(learner_prompt_buckets=(351,)),
    dict(number_of_learners=0),
    dict(number_of_actors=-1),
    dict(weight_bus="carrier"),
    dict(rpc_retries=-1),
    dict(poison_shard_k=0),
    dict(rpc_backoff_s=-0.1),
    dict(rollout_workers=("h:1",), clip_ratio=0.2),
    dict(rollout_workers=("h:1",), clip_ratio=0.2, workers_capture_logprobs=True,
         rollout_mode="async", inflight_weight_updates=True, weight_bus="dispatch"),
    dict(rollout_workers=("h:1",), engine_impl="paged"),
    dict(rollout_workers=("h:1",), kv_cache_quant="int8"),
    dict(rollout_workers=("h:1",), full_finetune=True, model="tiny"),
    {**_MULTI, "engine_impl": "dense", "rollout_workers": ("h:1",)},
]

# values only an unported path takes: the JAX package accepts them (with
# the unported knobs they need there), the port raises NotImplementedError
# naming the ROADMAP item
UNPORTED = [
    (dict(attn_impl="ring"), {}, "item 10b"),
    (dict(attn_impl="ulysses"), {}, "item 10b"),
]


def test_config_defaults_match_jax():
    j, p = jconfig.TrainConfig(), config.TrainConfig()
    for f in PORTED:
        if f == "mesh":  # each package's own MeshConfig class
            assert dataclasses.asdict(p.mesh) == dataclasses.asdict(j.mesh)
            continue
        assert getattr(p, f) == getattr(j, f), f
        assert type(getattr(p, f)) is type(getattr(j, f)), f


@pytest.mark.parametrize("kw", VALID, ids=lambda kw: ",".join(kw) or "defaults")
def test_config_derived_values_and_engine_kwargs_match_jax(kw):
    j, p = jconfig.TrainConfig(**kw), config.TrainConfig(**kw)
    for name in ("max_seq_length", "allowed_weight_lag", "run_directory"):
        assert getattr(p, name) == getattr(j, name), name
    assert dataclasses.asdict(p.train_sampling()) == dataclasses.asdict(j.train_sampling())
    assert dataclasses.asdict(p.eval_sampling()) == dataclasses.asdict(j.eval_sampling())
    assert p.to_flat_dict() == j.to_flat_dict()
    assert trainer.engine_kwargs_from_config(p) == jtrainer.engine_kwargs_from_config(j)


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jconfig.TrainConfig(**kw)
    with pytest.raises(ValueError):
        config.TrainConfig(**kw)


@pytest.mark.parametrize("kw,jax_extra,item", UNPORTED, ids=lambda v: str(v))
def test_unported_values_raise_naming_their_item(kw, jax_extra, item):
    jconfig.TrainConfig(**kw, **jax_extra)  # the JAX package takes it
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        config.TrainConfig(**kw)


@pytest.mark.parametrize("spec", ["", "128", "128,256", " 64 , 512 ,", "12x"])
def test_parse_buckets_matches_jax(spec):
    try:
        want = jconfig.parse_buckets(spec, field="f")
    except ValueError:
        with pytest.raises(ValueError, match="f must be"):
            config.parse_buckets(spec, field="f")
        return
    assert config.parse_buckets(spec, field="f") == want


def test_dense_engine_refuses_what_it_cannot_take(base_tree):
    model = params_from_numpy(base_tree, CFG, device="cpu")
    # the int8 dense cache is ported: the dense engine takes the format
    assert trainer.make_engine(_port_config(kv_cache_quant="int8"), model,
                               CharTokenizer()).kv_quant == "int8"
    chunked = trainer.make_engine(_port_config(decode_scan_chunk=4), model, CharTokenizer())
    assert isinstance(chunked, GenerationEngine) and chunked.scan_chunk == 4
    assert chunked.scan_chunk_active is None  # no chunk has run yet
    eng = trainer.make_engine(_port_config(max_concurrent_sequences=8, clip_ratio=0.2),
                              model, CharTokenizer())
    assert isinstance(eng, GenerationEngine)
    assert (eng.max_concurrent_rows, eng.capture_logprobs, eng.device.type) == (8, True, "cpu")
    with pytest.raises(ValueError, match="no device-memory budget"):
        trainer.make_engine(_port_config(engine_impl="paged"), model, CharTokenizer())
    paged = trainer.make_engine(
        _port_config(engine_impl="paged", continuous_batching=True, max_concurrent_sequences=8,
                     kv_cache_quant="int8"), model, CharTokenizer(), hbm_bytes=2**30)
    assert (paged.scheduler, paged.kv_quant, paged.max_concurrent_rows) == ("refill", "int8", 8)
    assert paged.max_kv_pages > 0


# ---------------------------------------------- the host pieces it calls

@pytest.mark.parametrize("args", [(30, 2, 1, 8), (4, 2, 1, 8), (1, 2, 1, 8), (8, 0, 2, 3),
                                  (3, 3, 1, 1), (100, 7, 3, 5)])
def test_chunk_sizes_match_jax(args):
    assert chunk_sizes(*args) == jchunk_sizes(*args)


def test_chunk_sizes_refuse_what_jax_refuses():
    for args in ((0, 1, 1, 1), (4, -1, 1, 1), (4, 1, 0, 1)):
        with pytest.raises(ValueError):
            jchunk_sizes(*args)
        with pytest.raises(ValueError):
            chunk_sizes(*args)


@pytest.mark.parametrize("seed", [0, 3407, 3407 + 1000])
def test_dict_dataset_order_matches_jax(seed):
    cols = {"problem": [f"p{i}" for i in range(13)], "solution": list(range(13))}
    got = data.DictDataset(cols).shuffle(seed=seed)
    want = jdata.DictDataset(cols).shuffle(seed=seed)
    assert got.data == want.data
    assert list(got.iter(4)) == list(want.iter(4))
    with pytest.raises(ValueError, match="ragged"):
        data.DictDataset({"a": [1], "b": []})
    assert data.DictDataset.wrap(got) is got


def test_metric_sinks_match_jax(tmp_path):
    rec = {"loss": np.float32(0.25), "episode": 1, "timing/update_duration": 0.5,
           "obj": torch.tensor(2.0)}
    for mod, d in ((metrics, tmp_path / "port"), (jmetrics, tmp_path / "jax")):
        sink = mod.make_sink("jsonl", run_name=None, project="p", config={}, run_dir=str(d))
        sink.log(rec, step=3)
        sink.finish()
    got = json.loads((tmp_path / "port" / "metrics.jsonl").read_text())
    want = json.loads((tmp_path / "jax" / "metrics.jsonl").read_text())
    for line in (got, want):
        line.pop("_ts")
    assert got == want == {"_step": 3, "loss": 0.25, "episode": 1,
                           "timing/update_duration": 0.5, "obj": 2.0}
    mem = metrics.MemorySink()
    mem.log({"a": 1}, step=2)
    assert mem.records == [(2, {"a": 1})]
    assert isinstance(metrics.make_sink("null", run_name=None, project="p", config={}),
                      metrics.NullSink)
    # wandb is imported only when asked for; "auto" falls back to JSONL
    auto = metrics.make_sink("auto", run_name=None, project="p", config={},
                             run_dir=str(tmp_path / "auto"))
    assert isinstance(auto, (metrics.JsonlSink, metrics.WandbSink))
    auto.finish()
    with pytest.raises(ValueError, match="unknown metrics backend"):
        metrics.make_sink("csv", run_name=None, project="p", config={})


def test_phase_spans_names_and_profiler_ranges():
    timer = telemetry.PhaseSpans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for phase in ("generation", "reward", "update"):
            with timer(phase):
                torch.ones(4).sum()
    assert sorted(timer.metrics()) == [f"timing/{p}_duration"
                                       for p in ("generation", "reward", "update")]
    assert all(v >= 0 for v in timer.metrics().values())
    names = {e.key for e in prof.key_averages()}
    assert {"driver/generation", "driver/reward", "driver/update"} <= names


def test_fake_engine_matches_jax():
    from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig
    from distrl_llm_tpu.tokenizer import encode_fixed

    tok = JCharTokenizer()
    ids, mask = encode_fixed(tok, ["q a", "q bb", ""], 8, side="left")
    want = JFakeEngine(tok, script, max_new_tokens=10).generate(
        None, None, ids, mask, JSamplingConfig(max_tokens=12, n=3), None)
    eng = FakeEngine(CharTokenizer(), script, max_new_tokens=10)
    got = eng.generate(None, "lora", ids, mask, config.SamplingConfig(max_tokens=12, n=3), 0)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert eng.calls == [{"batch": 3, "n": 3, "lora": "lora"}]


# ------------------------------------------------------------- the loop

def test_stale_weights_and_format_gate_are_refused(base_tree):
    model = params_from_numpy(base_tree, CFG, device="cpu")
    tok = CharTokenizer()
    train, test = make_datasets()
    tr = trainer.Trainer(train, test, reward_function, _port_config(), tokenizer=tok,
                         engine=FakeEngine(tok, script), model=model)
    tr.weight_version += 1  # an update whose adapter was never pushed
    with pytest.raises(trainer.StaleWeightsError):
        tr._generate_round(next(tr.test_dataset.iter(4)), tr.config.train_sampling())
    with pytest.raises(ValueError, match="ambiguous"):
        trainer.Trainer(train, test, position_reward, _port_config(format_reward="strict"),
                        tokenizer=tok, engine=FakeEngine(tok, script), model=model)


def test_hang_detector_raises_and_checkpoints(base_tree, tmp_path):
    """A round past generation_timeout_s raises EngineHangError; train()
    checkpoints before it propagates. The first round of a shape is exempt."""
    import threading

    model = params_from_numpy(base_tree, CFG, device="cpu")
    tok = CharTokenizer()
    release = threading.Event()

    class Slow(FakeEngine):
        def generate(self, *a):
            if len(self.calls) >= 2:  # the eval round and step 1 are quick
                release.wait(5)
            return super().generate(*a)

    train, test = make_datasets()
    eng = Slow(tok, script, max_new_tokens=24)
    tr = trainer.Trainer(train, test, reward_function,
                         _port_config(generation_timeout_s=0.2, checkpoint_dir=str(tmp_path)),
                         tokenizer=tok, engine=eng, model=model,
                         sink=metrics.MemorySink())
    with pytest.raises(trainer.EngineHangError):
        tr.train()
    release.set()
    assert tr.ckpt.latest_step() == 1


def test_cli_parses_every_ported_field():
    from distrl_llm_tpu_torch import train_distributed as cli

    args = cli.build_parser().parse_args([
        "--learner", "grpo", "--engine_impl", "paged", "--continuous_batching",
        "--max_concurrent_sequences", "8", "--prompt_buckets", "64,128",
        "--learner_len_buckets", "256", "--base_quant", "int4", "--no_optimizer_8bit",
        "--no_print_samples", "--device", "cpu"])
    cfg = cli.config_from_args(args)
    assert (cfg.learner, cfg.engine_impl, cfg.continuous_batching) == ("grpo", "paged", True)
    assert cfg.prompt_buckets == (64, 128) and cfg.learner_len_buckets == (256,)
    assert (cfg.optimizer_8bit, cfg.print_samples, args.device) == (False, False, "cpu")
    defaults = cli.config_from_args(cli.build_parser().parse_args([]))
    assert defaults == config.TrainConfig()


@pytest.mark.parametrize("flags", [
    [],
    ["--engine_impl", "paged", "--continuous_batching", "--max_concurrent_sequences", "4",
     "--base_quant", "int4", "--attn_impl", "splash"],
    ["--learner", "grpo", "--clip_ratio", "0.2"],
], ids=["dense", "paged_refill_int4_splash", "grpo_clip"])
def test_smoke_entry_point_runs_on_the_cpu(flags):
    proc = subprocess.run(
        [sys.executable, "-m", "distrl_llm_tpu_torch.train_distributed", "--smoke",
         "--device", "cpu", *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SMOKE OK — 2 train steps on cpu" in proc.stdout


REHEARSAL = """
import dataclasses, sys, tempfile
from pathlib import Path
for name in ("safetensors", "tokenizers", "transformers", "datasets", "jax"):
    sys.modules[name] = None  # importing any of them now raises
sys.path.insert(0, ".")
import chip_smoke
from distrl_llm_tpu_torch.models.configs import TINY

cfg = dataclasses.replace(TINY, vocab_size=1024)
kw = dict(max_prompt_tokens=96, max_new_tokens=8, max_concurrent_sequences=8,
          num_candidates=4, topk=4, train_batch_size=4, eval_n=2)
with tempfile.TemporaryDirectory() as tmp:
    work = Path(tmp)
    tok = chip_smoke.write_bpe_tokenizer(work / "tok", cfg.vocab_size)
    a = chip_smoke.trainer_smoke(cfg, "cpu", seed=0, workdir=work / "a", tokenizer_dir=tok,
                                 group=16, hbm_bytes=2**30, config_kw=kw)
    chip_smoke.check_trainer_run(a, cfg.num_layers, steps=2, lr=a["config"].lr, cuda=False)
    assert a["adapter_equal"] and a["resume_state"] == (2, True)
    assert [r["refill"] for r in a["rounds"]] == [False, True, True]
    assert a["learner_forwards"] == 2 * 4 * 4 // 4
    assert len(chip_smoke.trainer_step_lines(a, "")) == 2
    b = chip_smoke.from_pretrained_smoke(dataclasses.replace(cfg, num_layers=2), "cpu",
                                         seed=0, workdir=work / "b", tokenizer_dir=tok,
                                         group=16, hbm_bytes=2**30, config_kw=kw)
    chip_smoke.check_trainer_run(b, 2, steps=1, lr=b["trainer"].config.lr, cuda=False)
    assert b["equal"] and b["tokenizer"] == "NativeBPETokenizer"
print("REHEARSAL OK")
"""


def test_chip_smoke_trainer_phase_rehearses_on_cpu():
    """Phase 8 of chip_smoke.py at a small shape on the CPU — TINY's widths
    with a 1024-token vocabulary (the hand-written BPE needs 259 ids), the
    trainer configuration cut to 8 new tokens and 8 slots — in a process
    where ``safetensors``, ``tokenizers``, ``transformers``, ``datasets``
    and ``jax`` cannot be imported: the phase's path needs none of them."""
    proc = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REHEARSAL OK" in proc.stdout
