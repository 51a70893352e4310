"""``engine_impl="paged_sharded"``: the port's paged wave engine with each
round's rows split over the rollout ranks (``engine/sharded_paged.py``),
against the JAX package's ``ShardedPagedEngine`` over a dp mesh of 4 CPU
devices and against one port paged engine, at TINY size in f32 (ROADMAP
item 10a).

The port's ranks are gloo processes (``tests/torch_mesh_ranks.py``); each
rank runs its own wave engine over its rows, with its own page pool and
page tables, and the shares are gathered in row order. What is held:

* greedy tokens and lengths bit-equal to JAX's sharded engine and to one
  engine, at dp 4 (dp 2 in the trainer case below), with rows that do not
  divide by dp (padded dead rows), and with int8 KV pages; the captured
  logprobs within
  ``LOGP_ATOL`` of one engine's (f32; the JAX test's 2e-4 against JAX);
* one pool per rank: each rank's pool holds its rows' pages, 1 / dp of
  one engine's;
* sampled rows on different ranks draw from different generators:
  identical prompts sample different tokens across ranks;
* the mesh validation: a mesh with another axis above 1 raises, and so
  does speculative decoding;
* ``Trainer.train`` with ``engine_impl="paged_sharded"`` over 2 timeshared
  ranks: its eval round's greedy tokens equal one paged wave engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distrl_llm_tpu.config import SamplingConfig as JSampling
from distrl_llm_tpu.engine.sharded_paged import ShardedPagedEngine as JSharded
from distrl_llm_tpu.models import TINY, init_params
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.paged_engine import PagedGenerationEngine
from distrl_llm_tpu_torch.engine.sharded_paged import ShardedPagedEngine
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_to_numpy, params_from_numpy
from distrl_llm_tpu_torch.models.lora import init_lora_params
from distrl_llm_tpu_torch.parallel.mesh import RoleMesh
from tests import torch_mesh_ranks as ranks

CFG = ModelConfig(**dataclasses.asdict(TINY))
PAGE = 8
LOGP_ATOL = 1e-5
ENGINE_KW = dict(max_prompt_tokens=16, max_new_tokens=12, eos_token_ids=[1], pad_token_id=0,
                 page_size=PAGE, decode_chunk=4)
GREEDY = dict(max_tokens=12, temperature=0.0, top_p=1.0, n=2)


@pytest.fixture(scope="module")
def base():
    return jax.tree_util.tree_map(np.asarray,
                                  init_params(jax.random.PRNGKey(0), TINY, dtype=jnp.float32))


def _prompts(b, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, TINY.vocab_size, size=(b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.int32)
    if ragged:
        for i in range(b):
            pad = rng.integers(0, 9)
            ids[i, :pad] = 0
            mask[i, :pad] = 0
    return ids, mask


CASES = [  # (rows, prompt seed, engine kwargs)
    (8, 0, {}),
    (6, 3, {}),  # 6 rows over dp 4: two dead rows pad the last rank
    (4, 7, {"kv_quant": "int8"}),
    (4, 5, {"capture_logprobs": True}),
]


def _cases():
    out = []
    for rows, seed, kw in CASES:
        ids, mask = _prompts(rows, seed)
        out.append(dict(ids=ids, mask=mask, sampling=GREEDY, seed=seed, engine=kw))
    ids, mask = _prompts(1, 11, ragged=False)
    out.append(dict(ids=np.repeat(ids, 8, 0), mask=np.repeat(mask, 8, 0), seed=5,
                    sampling=dict(max_tokens=12, temperature=1.0, top_p=1.0, n=1)))
    return out


def _one_engine(base, case):
    eng = PagedGenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", **ENGINE_KW,
                                **case.get("engine", {}))
    model = params_from_numpy(base, CFG, device="cpu")
    sampling = SamplingConfig(**case["sampling"])
    row_pages = eng.prompt_pages + sampling.n * eng.private_pages
    return eng.generate(model, None, case["ids"], case["mask"], sampling, case["seed"]), row_pages


def _jax_sharded(base, case):
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    eng = JSharded(TINY, mesh, cache_dtype=jnp.float32, autotune=False, **ENGINE_KW,
                   **case.get("engine", {}))
    return eng.generate(jax.tree_util.tree_map(jnp.asarray, base), None,
                        case["ids"], case["mask"], JSampling(**case["sampling"]),
                        jax.random.PRNGKey(case["seed"]))


def test_greedy_rounds_match_jax_and_one_engine(base, tmp_path):
    dp = 4
    cases = _cases()
    got = ranks.launch(ranks.sharded_engine_job, dp, tmp_path, base=base,
                       cfg=dataclasses.asdict(TINY), cases=cases, engine_kw=ENGINE_KW)
    for c, case in enumerate(cases[:len(CASES)]):
        one, row_pages = _one_engine(base, case)
        for r in got:  # every rank holds the gathered round
            np.testing.assert_array_equal(r[c]["tokens"], one.tokens, err_msg=str(c))
            np.testing.assert_array_equal(r[c]["lengths"], one.lengths, err_msg=str(c))
        assert (one.lengths > 0).all()
        jres = _jax_sharded(base, case)
        np.testing.assert_array_equal(got[0][c]["tokens"], np.asarray(jres.tokens))
        np.testing.assert_array_equal(got[0][c]["lengths"], np.asarray(jres.lengths))
        if one.logprobs is not None:
            valid = np.arange(12)[None, None, :] < one.lengths[..., None]
            np.testing.assert_allclose(np.where(valid, got[0][c]["logprobs"], 0.0),
                                       np.where(valid, one.logprobs, 0.0), atol=LOGP_ATOL)
        # one pool per rank, for its own rows: 1 / dp of one engine's (of the
        # rows padded to a multiple of dp)
        per = -(-case["ids"].shape[0] // dp)
        assert [r[c]["pages"] for r in got] == [[per * row_pages]] * dp
    # sampled: identical prompts on different ranks draw different tokens
    sampled = got[0][-1]["tokens"][:, 0, :]
    per = 8 // dp
    assert not all(np.array_equal(sampled[0], sampled[k]) for k in range(per, 8, per))


def test_mesh_validation():
    mesh = RoleMesh(np.arange(4).reshape(2, 2, 1, 1))  # fsdp 2 on the rollout mesh
    with pytest.raises(ValueError, match="dp only"):
        ShardedPagedEngine(CFG, mesh, device="cpu", **ENGINE_KW)
    with pytest.raises(NotImplementedError, match="refill"):
        ShardedPagedEngine(CFG, RoleMesh(np.arange(2).reshape(2, 1, 1, 1)), device="cpu",
                           spec_draft=4, **ENGINE_KW)


def test_trainer_eval_round_equals_one_paged_engine(base, tmp_path):
    lora = lora_to_numpy(init_lora_params(torch.Generator().manual_seed(1), CFG, 4))
    rng = np.random.default_rng(0)
    for ab in lora["layers"].values():
        ab["b"] = (0.1 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    problems = [f"q {c}" for c in "abcdefgh"]
    train = {"problem": problems, "solution": [p[-1].upper() for p in problems]}
    fields = dict(model="tiny", episodes=1, batch_size=4, num_candidates=2, topk=2,
                  train_batch_size=4, max_prompt_tokens=16, max_new_tokens=12,
                  learner_chunk_size=1, eval_every=0, save_every=0, metrics_backend="null",
                  lr=1e-3, max_lora_rank=4, lora_alpha=8, temperature=0.0, eval_temperature=0.0,
                  learner="pg", print_samples=False, number_of_actors=0, number_of_learners=2,
                  engine_impl="paged_sharded")
    ekw = dict(max_prompt_tokens=16, max_new_tokens=12, eos_token_ids=[3], pad_token_id=0,
               lora_scale=2.0, page_size=PAGE)
    common = dict(base=base, lora0=lora, cfg=dataclasses.asdict(TINY), engine_kw=ekw,
                  train=train, test={k: v[:4] for k, v in train.items()})
    got = ranks.launch(ranks.trainer_job, 2, tmp_path, fields=fields, mesh_kw={},
                       engine="paged_sharded", **common)
    one = ranks.trainer_job(0, 1, fields={**fields, "engine_impl": "paged"}, mesh_kw=None,
                            engine="paged", **common)
    eval_sharded, eval_one = got[0]["calls"][0], one["calls"][0]
    np.testing.assert_array_equal(eval_sharded["tokens"], eval_one["tokens"])
    np.testing.assert_array_equal(eval_sharded["lengths"], eval_one["lengths"])
    assert [len(r["calls"]) for r in got] == [len(one["calls"])] * 2  # every rank decoded
    assert got[0]["weight_version"] == one["weight_version"] == 2
    assert all(np.isfinite(m["loss"]) for _, m in got[0]["records"] if "loss" in m)


MESH_REHEARSAL = """
import sys, tempfile
for name in ("safetensors", "tokenizers", "transformers", "datasets", "jax"):
    sys.modules[name] = None  # importing any of them now raises
sys.path.insert(0, ".")
import chip_smoke as cs

with tempfile.TemporaryDirectory() as tmp:
    lines, counts = cs.mesh_rehearsal(tmp)
assert len(counts) == 4 and all(c == {k["name"]: 0 for k in cs.KERNELS} for c in counts)
assert any("bit for bit" in line for line in lines), lines
print("REHEARSAL OK")
"""


def test_chip_smoke_mesh_phase_rehearses_on_cpu():
    """Phase 17 of chip_smoke.py on the CPU at TINY over a one-rank gloo
    group, in a process where ``jax`` (and the tokenizer packages) cannot be
    imported: (a) the QLoRA trainer over the learner mesh equal to the run
    without a group, bit for bit; (b) ``paged_sharded``'s eval round equal to
    one paged wave engine's; (c) full fine-tuning over the mesh, every master
    moved and the rollout copy the masters cast; every run's records checked
    as on the card (no launch on the CPU)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", MESH_REHEARSAL], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REHEARSAL OK" in proc.stdout
