"""The port's rank meshes, partition rules and launch against the JAX
package's (ROADMAP item 10a), on the CPU.

* The role carving: ``parallel/mesh.py::carve_roles`` over a rank list
  against JAX's ``build_role_meshes`` over as many of the 8 CPU devices
  (``tests/conftest.py``), rank for rank, and the same errors; over 4 gloo
  ranks (``tests/torch_mesh_ranks.py``) the ``DeviceMesh`` groups of each
  role hold the ranks the carving says.
* The partition rules: ``spec_for_path`` equals JAX's ``_spec_for_path`` on
  every leaf of the adapter, the dense and the quantized param trees; the
  block-aligned ranges tile a leaf.
* ``initialize_distributed`` makes no group for one process unless asked,
  and refuses a multi-process job without a coordinator.
* ``check_full_finetune_fits`` per fsdp shard: Llama-3-8B's 32 layers raise
  at fsdp 1 on an 80 GB card and pass at fsdp 4.
* Every item-10b value raises ``NotImplementedError`` naming it.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from distrl_llm_tpu import config as jconfig
from distrl_llm_tpu.models import TINY as JTINY, init_lora_params, init_params
from distrl_llm_tpu.ops.quant import quantize_params
from distrl_llm_tpu.parallel import partition as jpartition
from distrl_llm_tpu.parallel.mesh import build_role_meshes as jbuild_role_meshes
from distrl_llm_tpu_torch import config
from distrl_llm_tpu_torch.distributed.launch import initialize_distributed
from distrl_llm_tpu_torch.learner import train_step as ts
from distrl_llm_tpu_torch.models.configs import LLAMA3_8B
from distrl_llm_tpu_torch.parallel import carve_roles, spec_for_path
from distrl_llm_tpu_torch.parallel.mesh import RoleMesh
from distrl_llm_tpu_torch.parallel.partition import shard_range
from tests import torch_mesh_ranks as ranks

CARVINGS = [  # (actors, learners, tp, sp, fsdp, ranks, allow_timeshare)
    (2, 1, 1, 1, 1, 8, True),
    (2, 2, 2, 1, 1, 8, True),
    (4, 4, 2, 1, 1, 8, True),
    (0, 2, 1, 1, 1, 8, True),
    (1, 1, 1, 1, 2, 4, True),
    (1, 2, 1, 1, 2, 6, True),
    (2, 1, 1, 1, 1, 2, True),
    (1, 1, 1, 2, 2, 8, True),
    (2, 1, 1, 1, 2, 5, True),
]


def _mesh_ranks(jmesh) -> list:
    return np.vectorize(lambda d: d.id)(jmesh.devices).tolist()


@pytest.mark.parametrize("case", CARVINGS, ids=str)
def test_role_carving_matches_jax(case):
    actors, learners, tp, sp, fsdp, n, share = case
    kw = dict(number_of_actors=actors, number_of_learners=learners, tp=tp, sp=sp, fsdp=fsdp,
              allow_timeshare=share)
    jm = jbuild_role_meshes(jconfig.MeshConfig(**kw), devices=jax.devices()[:n])
    rollout, learner, timeshared = carve_roles(config.MeshConfig(**kw), list(range(n)))
    assert timeshared == jm.timeshared
    assert rollout.tolist() == _mesh_ranks(jm.rollout)
    assert learner.tolist() == _mesh_ranks(jm.learner)
    assert dict(zip(("dp", "fsdp", "sp", "tp"), rollout.shape)) == dict(jm.rollout.shape)


@pytest.mark.parametrize("kw,n", [(dict(tp=16), 8), (dict(tp=2, allow_timeshare=False), 4)],
                         ids=str)
def test_role_carving_refuses_what_jax_refuses(kw, n):
    with pytest.raises(RuntimeError) as jerr:
        jbuild_role_meshes(jconfig.MeshConfig(**kw), devices=jax.devices()[:n])
    with pytest.raises(RuntimeError) as err:
        carve_roles(config.MeshConfig(**kw), list(range(n)))
    assert str(err.value) == str(jerr.value)


def test_mesh_config_matches_jax():
    assert dataclasses.asdict(config.MeshConfig()) == dataclasses.asdict(jconfig.MeshConfig())
    p = config.TrainConfig(number_of_actors=3, number_of_learners=2)
    j = jconfig.TrainConfig(number_of_actors=3, number_of_learners=2)
    assert dataclasses.asdict(p.mesh) == dataclasses.asdict(j.mesh)
    for cfg in (config, jconfig):
        with pytest.raises(ValueError, match="conflict"):
            cfg.TrainConfig(mesh=cfg.MeshConfig(number_of_actors=5))


def test_role_meshes_over_gloo_ranks(tmp_path):
    """One actor and one learner group of 2 fsdp ranks over 4 ranks: every
    rank's dp and fsdp groups hold the ranks of its row and column."""
    out = ranks.launch(ranks.carve_job, 4, tmp_path, mesh_kw=dict(fsdp=2), actors=1,
                       learners=1)
    for r, o in enumerate(out):
        assert o["rollout"] == [[[[0]], [[1]]]] and o["learner"] == [[[[2]], [[3]]]]
        assert not o["timeshared"]
        role = "rollout" if r < 2 else "learner"
        assert o[f"{role}_coord"] == (0, r % 2, 0, 0)
        assert o[f"{role}_sums"] == {"dp": r, "fsdp": 1 if r < 2 else 5}
        assert f"{'learner' if r < 2 else 'rollout'}_coord" not in o


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tuple(np.shape(tree))


@pytest.mark.parametrize("tree", ["lora", "dense", "int4", "int8"])
def test_partition_specs_match_jax(tree):
    key = jax.random.PRNGKey(0)
    t = (init_lora_params(key, JTINY, rank=4) if tree == "lora" else init_params(key, JTINY))
    if tree in ("int4", "int8"):
        t = quantize_params(t, bits=int(tree[3]), group_size=16 if tree == "int4" else None)
    t = jax.tree_util.tree_map(np.asarray, t)
    seen = 0
    for path, shape in _paths(t):
        want = tuple(jpartition._spec_for_path(path, shape))
        assert spec_for_path(path, shape) == want, path
        seen += 1
    assert seen > 4
    # and the cache leaves and the batch
    assert spec_for_path(("k",), (2, 2, 16, 8)) == tuple(jpartition._spec_for_path(
        ("k",), (2, 2, 16, 8)))


@pytest.mark.parametrize("numel", [256, 512, 1280, 4096, 65536 + 256])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_shard_ranges_are_block_aligned_and_tile_the_leaf(numel, parts):
    ranges = [shard_range(numel, parts, i) for i in range(parts)]
    assert ranges[0][0] == 0 and ranges[-1][1] == numel
    for (lo, hi, chunk), (lo2, _, _) in zip(ranges, ranges[1:]):
        assert hi == lo2 and lo % 256 == 0 and hi % 256 == 0 and hi - lo <= chunk
    assert all(chunk == ranges[0][2] for _, _, chunk in ranges)


def test_initialize_distributed_without_a_group(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "DISTRL_COORDINATOR",
                 "DISTRL_NUM_PROCESSES", "DISTRL_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    info = initialize_distributed(device="cpu")
    assert (info.process_id, info.num_processes, info.backend) == (0, 1, None)
    assert info.is_driver and info.device == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("DISTRL_NUM_PROCESSES", "2")
    monkeypatch.setenv("DISTRL_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("fsdp,fits", [(1, False), (2, True), (4, True), (8, True)])
def test_full_finetune_fits_per_fsdp_shard(fsdp, fits):
    """BASELINE config 3, Llama-3-8B bf16 full-rank: 32 layers on 80 GB."""
    need = config.full_finetune_bytes(LLAMA3_8B, "bfloat16", fsdp)
    assert need["masters"] == 4 * LLAMA3_8B.param_count // fsdp
    assert need["rollout"] == 2 * LLAMA3_8B.param_count
    if fits:
        config.check_full_finetune_fits(LLAMA3_8B, hbm_bytes=80 * 10**9, fsdp=fsdp)
        assert config.TrainConfig(full_finetune=True, model="meta-llama/Meta-Llama-3-8B",
                                  mesh=config.MeshConfig(fsdp=fsdp)).full_finetune
    else:
        with pytest.raises(ValueError, match=f"fsdp={fsdp}"):
            config.check_full_finetune_fits(LLAMA3_8B, hbm_bytes=80 * 10**9, fsdp=fsdp)


ITEM_10B = [
    dict(mesh=config.MeshConfig(tp=2)),
    dict(mesh=config.MeshConfig(sp=2)),
    dict(attn_impl="ring"),
    dict(attn_impl="ulysses"),
]


@pytest.mark.parametrize("kw", ITEM_10B, ids=str)
def test_item_10b_values_raise_naming_it(kw):
    jkw = dict(kw)
    if "mesh" in jkw:
        jkw["mesh"] = jconfig.MeshConfig(**dataclasses.asdict(kw["mesh"]))
    jconfig.TrainConfig(**jkw)  # the JAX package takes it
    with pytest.raises(NotImplementedError, match="item 10b"):
        config.TrainConfig(**kw)


@pytest.mark.parametrize("kw", [dict(rollout_mode="pipelined"),
                                dict(rollout_mode="async", clip_ratio=0.2),
                                dict(rollout_workers=("h:1",)),
                                dict(env="code", max_turns=2, engine_impl="paged",
                                     continuous_batching=True, continuous_admission=True,
                                     max_concurrent_sequences=4)], ids=str)
def test_a_mesh_under_unported_modes_raises_naming_item_10b(kw):
    cfg = config.TrainConfig(**kw)  # valid on one card without a mesh
    with pytest.raises(NotImplementedError, match="item 10b"):
        config.check_mesh_supported(cfg)


def test_the_learner_refuses_a_tp_mesh():
    tp = RoleMesh(np.arange(2).reshape(1, 1, 1, 2))
    with pytest.raises(NotImplementedError, match="item 10b"):
        ts.place_update_batch({f: None for f in ts.UpdateBatch._fields} | {
            "coeffs": np.zeros(2, np.float32)}, micro_size=2, device="cpu", mesh=tp)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0)
    with pytest.raises(NotImplementedError, match="item 10b"):
        ts.make_train_step(None, optimizer=opt, lora_scale=1.0, micro_size=2,
                           attn_mesh=object())


@pytest.fixture(scope="module", params=[False, True], ids=["lora", "full"])
def checkpoint_runs(request, tmp_path_factory):
    """fsdp 2 over 2 ranks, one episode of two sampled steps, and the same
    run on one rank without a mesh, each writing its checkpoint, HF snapshot
    and (LoRA) adapter file; then, in the same launch, a trainer resumed
    from the mesh's checkpoint. Returns (full, the run directory, the
    one-rank run, the mesh's ranks)."""
    full, tmp_path = request.param, tmp_path_factory.mktemp("ckpt")
    base = jax.tree_util.tree_map(np.asarray, init_params(jax.random.PRNGKey(0), JTINY,
                                                          dtype=jax.numpy.float32))
    lora = None if full else jax.tree_util.tree_map(
        np.asarray, init_lora_params(jax.random.PRNGKey(1), JTINY, rank=4))
    if lora is not None:
        for ab in lora["layers"].values():
            ab["b"] = np.full(ab["b"].shape, 0.05, np.float32)
    problems = [f"q {c}" for c in "abcdefgh"]
    train = {"problem": problems, "solution": [p[-1].upper() for p in problems]}
    fields = dict(model="tiny", episodes=1, batch_size=4, num_candidates=2, topk=2,
                  train_batch_size=4, max_prompt_tokens=16, max_new_tokens=8, eval_every=0,
                  save_every=0, metrics_backend="null", lr=1e-3, max_lora_rank=4,
                  lora_alpha=8, temperature=1.0, eval_temperature=0.0, learner="pg",
                  print_samples=False, number_of_actors=0, number_of_learners=1,
                  full_finetune=full, run_name="r", export_hf_snapshots=True,
                  write_adapter_file=not full, lora_save_path="adapter")
    common = dict(base=base, lora0=lora, cfg=dataclasses.asdict(JTINY), engine="dense",
                  engine_kw=dict(max_prompt_tokens=16, max_new_tokens=8, eos_token_ids=[3],
                                 pad_token_id=0, lora_scale=2.0),
                  train=train, test={k: v[:4] for k, v in train.items()})
    for run in ("one", "mesh"):
        (tmp_path / run).mkdir()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: CPU sums run in one thread's order
    cwd = os.getcwd()
    try:
        one = ranks.trainer_job(0, 1, fields={**fields, "checkpoint_dir": "ckpt"},
                                mesh_kw=None, cwd=str(tmp_path / "one"), **common)
    finally:
        torch.set_num_threads(threads)
        os.chdir(cwd)
    mesh_dir = str(tmp_path / "mesh" / "ckpt")
    got = ranks.launch(ranks.trainer_job, 2, tmp_path, fields={**fields,
                                                               "checkpoint_dir": mesh_dir},
                       mesh_kw=dict(fsdp=2), cwd=str(tmp_path / "mesh"), resume_after=True,
                       **common)
    return full, tmp_path, one, got


def test_checkpoint_is_a_one_rank_runs_bytes_and_resumes(checkpoint_runs):
    """Rank 0 writes the gathered state, the HF snapshot and (LoRA) the
    adapter file, byte for byte the files a one-rank run writes; a resumed
    trainer takes the state back, each rank its shards."""
    full, tmp_path, one, got = checkpoint_runs
    assert got[0]["weight_version"] == one["weight_version"] == 2
    want = got[0]["state"]
    written = sorted(str(f.relative_to(tmp_path / "one")) for f in (tmp_path / "one").rglob("*")
                     if f.is_file() and "rollout_state" not in f.name)
    assert "ckpt/step_2.pt" in written and any(w.startswith("run_r/model_2/") for w in written)
    assert ("adapter/adapter_model.safetensors" in written) == (not full)
    for name in written:
        assert (tmp_path / "mesh" / name).read_bytes() == (tmp_path / "one" / name).read_bytes(), \
            name
    # the run trained: its sampled candidates differ, so the gradients are
    # not zero (greedy twins would cancel each other's) and the first
    # moments moved off zero
    mu = [e[k] for e in want["opt_state"]["state"].values() for k in ("mu_q", "exp_avg")
          if k in e]
    assert mu and any(np.any(m != 0) for m in mu)
    before = got[0]["resumed"]
    assert before["step"] == want["step"] == 2
    for part in ("lora", "opt_state"):
        a, b = jax.tree_util.tree_leaves(before[part]), jax.tree_util.tree_leaves(want[part])
        assert len(a) == len(b) > 4
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_save_and_resume_move_no_whole_state_between_ranks(checkpoint_runs):
    """No rank ever holds the whole sharded state at once: saving gathers a
    member at a time into rank 0 (rank 1 receives nothing), every object
    sent is a few bytes (no pickled state), and a resume moves no state at
    all (each rank reads its own ranges of the file, the push after it
    gathering a member at a time); each resumed rank keeps less than the
    whole trained state (the members whose size is a multiple of 256 are
    split)."""
    full, _, one, got = checkpoint_runs
    members = (list(jax.tree_util.tree_leaves(got[0]["state"]["lora"])) if not full else
               list(got[0]["state"]["lora"].values()))
    largest = max(x.size for x in members)
    whole = sum(x.size for x in members)
    assert largest < whole / 2
    for phase in ("save", "resume"):
        for r, run in enumerate(got):
            tensors, objects = run["traffic"][phase]
            assert all(n <= 1024 for _, n in objects), (phase, r, objects)
            assert all(n <= largest for _, n in tensors), (phase, r, largest, tensors)
            if phase == "save" and r == 1:
                assert tensors == [], tensors
            if phase == "save" and r == 0:
                assert any(name == "gather" for name, _ in tensors)
    for run in got:
        assert 0 < run["local_bytes"] < 4 * whole  # f32


def test_page_budget_by_role():
    """The paged engine's KV pool a rank: learner_gpu_usage where the roles
    timeshare the rank, actor_gpu_usage on a rank of a disjoint rollout mesh
    (JAX trainer.py:728-733); full fine-tuning charges the learner state's
    fsdp share beside the rollout weights."""
    from distrl_llm_tpu_torch.engine.budget import kv_pool_pages, tree_bytes
    from distrl_llm_tpu_torch.models.configs import ModelConfig
    from distrl_llm_tpu_torch.models.convert import params_from_numpy
    from distrl_llm_tpu_torch.parallel.mesh import RoleMeshes
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer
    from distrl_llm_tpu_torch.trainer import make_engine

    cfg = ModelConfig(**dataclasses.asdict(JTINY))
    model = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(0), JTINY, dtype=jax.numpy.float32)), cfg,
        device="cpu")
    rank0, rank1 = RoleMesh(np.zeros((1, 1, 1, 1), int)), RoleMesh(np.ones((1, 1, 1, 1), int))
    hbm = 2**24
    kw = dict(batch_prompts=4, max_prompt_tokens=16, max_new_tokens=8, page_size=128,
              hbm_bytes=hbm, device="cpu")
    for meshes, usage in ((RoleMeshes(rank0, rank0, True), "learner_gpu_usage"),
                          (RoleMeshes(rank0, rank1, False), "actor_gpu_usage")):
        for full, fsdp in ((False, 1), (True, 2)):
            train_cfg = config.TrainConfig(
                model="tiny", engine_impl="paged", max_prompt_tokens=16, max_new_tokens=8,
                batch_size=4, full_finetune=full, mesh=config.MeshConfig(fsdp=fsdp),
                actor_gpu_usage=0.9, learner_gpu_usage=0.6)
            eng = make_engine(train_cfg, model, CharTokenizer(), hbm_bytes=hbm, meshes=meshes)
            learner = 0
            if full and usage == "learner_gpu_usage":
                need = config.full_finetune_bytes(cfg, "float32", fsdp)
                learner = need["masters"] + need["grads"] + need["moments"]
            want = kv_pool_pages(cfg, gpu_usage=getattr(train_cfg, usage),
                                 param_bytes=tree_bytes(model) + learner, **kw)
            assert eng.max_kv_pages == want, (usage, full)
