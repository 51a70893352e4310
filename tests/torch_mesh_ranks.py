"""Rank processes for the port's mesh tests (``tests/test_torch_mesh.py``,
``test_torch_sharded_learner.py``, ``test_torch_sharded_paged.py``,
``test_torch_role_separation.py``).

``launch(job, world, tmp_path, **kw)`` spawns ``world`` CPU ranks, each one
thread, joined in one gloo process group through a ``FileStore`` under
``tmp_path`` (no port, so parallel test workers never collide), runs
``job(rank, world, **kw)`` on each and returns their results in rank order.
This module and the jobs import the port and never JAX: the inputs arrive
as numpy arrays, made in the test process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import pickle
import traceback
from pathlib import Path

import numpy as np

TIMEOUT_S = 120


def launch(job, world: int, tmp_path: Path, timeout: float = TIMEOUT_S, **kw) -> list:
    ctx = multiprocessing.get_context("spawn")
    tmp_path = Path(tmp_path)
    store = tmp_path / f"store_{job.__name__}_{os.getpid()}_{len(list(tmp_path.iterdir()))}"
    outs = [tmp_path / f"{store.name}.rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_main, args=(job, r, world, str(store), str(outs[r]), kw))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    results, errors = [], []
    for r, path in enumerate(outs):
        if not path.exists():
            errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status == "error":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if hung or errors:
        raise RuntimeError(f"ranks hung: {hung}; " + "\n".join(errors))
    return results


def _main(job, rank: int, world: int, store: str, out: str, kw: dict) -> None:
    import torch
    import torch.distributed as dist

    from distrl_llm_tpu_torch.distributed.launch import initialize_distributed

    torch.set_num_threads(1)
    try:
        initialize_distributed(process_id=rank, num_processes=world, device="cpu",
                               store=dist.FileStore(store, world))
        result = ("ok", job(rank, world, **kw))
    except BaseException:  # noqa: BLE001 — reported to the test process
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------------ helpers


def _np(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", torch.float32 if tree.is_floating_point() else None,
                                copy=True).numpy()
    return tree


def _meshes(mesh_kw: dict, actors: int = 0, learners: int = 1):
    from distrl_llm_tpu_torch.config import MeshConfig
    from distrl_llm_tpu_torch.parallel import build_role_meshes

    return build_role_meshes(MeshConfig(number_of_actors=actors, number_of_learners=learners,
                                        **mesh_kw))


class Traffic:
    """What this rank receives through ``torch.distributed`` while inside
    ``with traffic:``: the elements of each tensor a collective or a
    receive fills here (``tensors``), and the pickled bytes of each object
    list this rank sends or takes part in (``objects``)."""

    _TENSOR = ("all_gather", "all_gather_into_tensor", "gather", "broadcast", "recv",
               "all_reduce", "reduce_scatter_tensor", "scatter")
    _OBJECT = ("broadcast_object_list", "all_gather_object", "send_object_list",
               "recv_object_list", "gather_object", "scatter_object_list")

    def __init__(self):
        self.tensors: list[tuple[str, int]] = []
        self.objects: list[tuple[str, int]] = []
        self._saved: dict = {}

    def __enter__(self):
        import torch.distributed as dist

        rank = dist.get_rank()
        for name in self._TENSOR + self._OBJECT:
            fn = getattr(dist, name)
            self._saved[name] = fn
            setattr(dist, name, self._wrap(name, fn, rank))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)

    def _wrap(self, name, fn, rank):
        def run(*a, **k):
            if name in self._OBJECT:
                self.objects.append((name, len(pickle.dumps(a[0]))))
                return fn(*a, **k)
            out = fn(*a, **k)
            if name == "gather":  # only the destination receives
                got = a[1] if len(a) > 1 else k.get("gather_list")
                if got:
                    self.tensors.append((name, sum(t.numel() for t in got)))
            elif name == "all_gather":
                self.tensors.append((name, sum(t.numel() for t in a[0])))
            elif name == "broadcast":
                src = a[1] if len(a) > 1 else k["src"]
                if src != rank:
                    self.tensors.append((name, a[0].numel()))
            else:
                self.tensors.append((name, a[0].numel()))
            return out

        return run


# --------------------------------------------------------------------- jobs


def carve_job(rank, world, *, mesh_kw: dict, actors: int, learners: int) -> dict:
    """Each role's ranks, this rank's coordinates, and the sums of the rank
    ids over its dp and fsdp groups."""
    import torch
    import torch.distributed as dist

    m = _meshes(mesh_kw, actors, learners)
    out = {"rollout": m.rollout.ranks.tolist(), "learner": m.learner.ranks.tolist(),
           "timeshared": m.timeshared}
    for role in ("rollout", "learner"):
        mesh = getattr(m, role)
        if rank in mesh:
            sums = {}
            for axis in ("dp", "fsdp"):
                t = torch.tensor([rank])
                dist.all_reduce(t, group=mesh.group(axis))
                sums[axis] = int(t)
            out[f"{role}_coord"] = mesh.coordinate()
            out[f"{role}_sums"] = sums
    return out


def learner_job(rank, world, *, layouts: dict, lora: dict, **kw) -> dict:
    """The learner on several meshes in one launch. ``layouts``: {name:
    (dp, fsdp, first rank, full)}, run in order, each on the ``dp * fsdp``
    ranks from its first rank (LoRA from ``lora``, or full fine-tuning).
    Every rank builds every layout's mesh (building one makes its groups, a
    collective) and runs the layouts it belongs to, so layouts on disjoint
    ranks run side by side. Each rank returns {name: ``learn``'s result}
    for the layouts it ran."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from distrl_llm_tpu_torch.parallel.mesh import AXES, RoleMesh

    meshes = {}
    for name, (dp, fsdp, first, full) in layouts.items():
        arr = np.arange(first, first + dp * fsdp).reshape(dp, fsdp, 1, 1)
        meshes[name] = (RoleMesh(arr, DeviceMesh("cpu", arr.tolist(), mesh_dim_names=AXES)),
                        full)
    out = {}
    for name, (mesh, full) in meshes.items():
        if rank in mesh:
            out[name] = learn(rank, mesh, lora=None if full else lora, **kw)
    dist.barrier()
    return out


def learn(rank, mesh, *, params: dict, lora: dict | None,
          arrays: dict, cfg: dict, steps: int, lr: float, micro: int,
          learner: str = "pg", clip_ratio: float = 0.0, use_8bit: bool = True,
          logit_chunk: int = 0, dropout: float = 0.0) -> dict:
    """``steps`` train steps of the port's learner over ``arrays`` (the
    update batch's rows, ``update_arrays`` layout) on the learner mesh
    ``mesh`` (None: one rank, no mesh). LoRA when ``lora`` is given, else
    full fine-tuning of ``params``. The mesh's first rank returns the whole
    trained tree, the losses, the merged grads of each step (before the
    optimizer), the gathered optimizer state, the forward logits before
    the first step and the bytes of this rank's trained state; the other
    ranks only those bytes."""
    import torch

    from distrl_llm_tpu_torch.learner.optim import make_optimizer
    from distrl_llm_tpu_torch.learner.train_step import make_train_step, place_update_batch
    from distrl_llm_tpu_torch.models.configs import ModelConfig
    from distrl_llm_tpu_torch.models.convert import (
        lora_from_numpy, param_stacks, params_from_numpy,
    )
    from distrl_llm_tpu_torch.parallel import gather_opt_state, shard_tree

    mcfg = ModelConfig(**cfg)
    model = params_from_numpy(params, mcfg, dtype=torch.float32, device="cpu")
    first = mesh.first_rank if mesh is not None else rank
    full = lora is None
    if full:
        trained = shard_tree(model, mesh) if mesh is not None else model
        if mesh is None:
            for p in model.parameters():
                p.requires_grad_(True)
        leaves = (trained.leaf_groups(param_stacks(trained)) if mesh is not None
                  else list(param_stacks(model).values()))
        base = None
    else:
        trained = lora_from_numpy(lora, mcfg, device="cpu", mesh=mesh)
        if mesh is not None:
            leaves = trained.trainable()
        else:
            leaves = [trained["layers"][t][k] for t in sorted(trained["layers"]) for k in "ab"]
            for x in leaves:
                x.requires_grad_(True)
        base = model
    opt = make_optimizer(leaves, lr, use_8bit=use_8bit)
    step = make_train_step(mcfg, learner_type=learner, optimizer=opt, lora_scale=0.5,
                           micro_size=micro, attn_impl="splash", clip_ratio=clip_ratio,
                           train_mode="full" if full else "lora", mesh=mesh,
                           logit_chunk=logit_chunk, lora_dropout=dropout)
    flat = [t for leaf in leaves for t in (leaf if isinstance(leaf, list) else [leaf])]
    grads: list = []
    inner = opt.step

    def spy(*a, **k):
        grads.append([p.grad.detach().clone() for p in flat])
        return inner(*a, **k)

    opt.step = spy
    # the forward before any step: whole tensors gathered on every rank
    ids = torch.as_tensor(np.concatenate([arrays["prompt_ids"], arrays["answer_ids"]], 1))
    with torch.no_grad():
        if full:
            logits = trained(ids, attn_impl="splash")[0]
        else:
            logits = model(ids, lora=trained.gather() if mesh is not None else trained,
                           lora_scale=0.5, attn_impl="splash")[0]
    batch = place_update_batch(arrays, micro_size=micro, device="cpu", mesh=mesh)
    losses = [float(step(trained, base, batch, 7 if dropout else None)) for _ in range(steps)]
    if full:  # each trained tensor by its parameter name, "target.a" for an adapter
        named = (trained.shards if mesh is not None else dict(model.named_parameters()))
    else:
        named = {f"{t}.{k}": (trained.shards[t][k] if mesh is not None else trained["layers"][t][k])
                 for t in sorted(lora["layers"]) for k in "ab"}
    if mesh is not None:
        name_of = {id(s.data): n for n, s in named.items()}
        whole = {n: s.full() for n, s in named.items()}
        grads = [{name_of[id(p)]: named[name_of[id(p)]].full_flat(g).view(named[name_of[id(p)]].shape)
                  for p, g in zip(flat, gs)} for gs in grads]
        opt_state = gather_opt_state(opt, trained, first)
        local_bytes = sum(t.numel() * t.element_size() for t in trained.trainable())
    else:
        name_of = {id(x): n for n, x in named.items()}
        whole = named
        grads = [{name_of[id(p)]: g for p, g in zip(flat, gs)} for gs in grads]
        opt_state = opt.state_dict()
        local_bytes = sum(t.numel() * t.element_size() for t in flat)
    if rank != first:
        return {"local_bytes": local_bytes}
    return {"losses": losses, "trained": _np(whole), "grads": [_np(g) for g in grads],
            "opt_state": _np(opt_state["state"]), "logits": _np(logits),
            "local_bytes": local_bytes}


def position_reward(completions, solutions):
    """Format 0; accuracy by the candidate's position in its group, so
    identical greedy candidates still score apart (the trainer tests')."""
    n = len(completions)
    return np.column_stack((np.zeros(n), np.arange(n) / n)).astype(np.float64)


def _engine(kind: str, mcfg, meshes, engine_kw: dict):
    import torch

    from distrl_llm_tpu_torch.engine import GenerationEngine, PagedGenerationEngine
    from distrl_llm_tpu_torch.engine.sharded_paged import ShardedPagedEngine

    kw = dict(cache_dtype=torch.float32, device="cpu", **engine_kw)
    if kind == "dense":
        return GenerationEngine(mcfg, **kw)
    if kind == "paged":
        return PagedGenerationEngine(mcfg, **kw)
    return ShardedPagedEngine(mcfg, meshes.rollout, **kw)


def trainer_job(rank, world, *, fields: dict, mesh_kw: dict | None, base: dict,
                lora0: dict | None, cfg: dict, engine: str, engine_kw: dict, train: dict,
                test: dict, stale: bool = False, resume_after: bool = False,
                cwd: str | None = None) -> dict:
    """``Trainer.train()`` on every rank (rank 0 drives, the others follow)
    over ``engine`` ("dense", "paged" or "paged_sharded") from the base
    ``base`` and, in LoRA mode, the initial adapter ``lora0`` (both numpy),
    greedy as the config says. Every rank returns the rows and tokens of
    each engine call it made, the version its rollout copy holds and the
    adapter it samples with (rollout ranks) or last gathered (learner
    ranks); rank 0 also the records, the adapter after each step and the
    resume state (``Trainer._state_tree``, which every rank enters).
    ``stale``: then one more round with the learner a version ahead of the
    rollout, which every rank reports refusing. ``resume_after``: then a
    second trainer on the same ranks resumes from the run's checkpoint
    (rank 0 returns its resume state, every rank what its constructor moved
    through ``torch.distributed``). ``cwd``: the directory the
    run's relative paths (``run_<name>``, the adapter file) land in."""
    import torch

    from distrl_llm_tpu_torch import trainer as ptrainer
    from distrl_llm_tpu_torch.config import MeshConfig, TrainConfig
    from distrl_llm_tpu_torch.models.configs import ModelConfig
    from distrl_llm_tpu_torch.models.convert import (
        lora_from_numpy, lora_to_numpy, params_from_numpy,
    )
    from distrl_llm_tpu_torch.parallel import build_role_meshes
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer

    if cwd is not None:
        os.chdir(cwd)
    config = TrainConfig(**fields, mesh=MeshConfig(**(mesh_kw or {})))
    meshes = build_role_meshes(config.mesh) if mesh_kw is not None else None
    mcfg = ModelConfig(**cfg)
    model = params_from_numpy(base, mcfg, device="cpu")
    eng = _engine(engine, mcfg, meshes, engine_kw)
    tr = ptrainer.Trainer(train, test, position_reward, config, tokenizer=CharTokenizer(),
                          engine=eng, model=model, meshes=meshes)
    # the test's initial adapter on every learner rank, pushed again to the
    # rollout copies (every rank, as the constructor's push)
    with torch.no_grad():
        if lora0 is None:
            pass
        elif meshes is None:
            for t, ab in tr.lora["layers"].items():
                for k, x in ab.items():
                    x.copy_(torch.tensor(lora0["layers"][t][k]))
        elif tr._learner:
            tr.lora.load_full(lora_from_numpy(lora0, mcfg, device="cpu"))
    tr._push_weights()
    calls = []
    gen = eng.generate

    def recorded(model_, lora_, ids, mask, sampling, seed):
        res = gen(model_, lora_, ids, mask, sampling, seed)
        calls.append({"rows": int(ids.shape[0]), "tokens": np.asarray(res.tokens),
                      "lengths": np.asarray(res.lengths), "seed": int(seed)})
        return res

    eng.generate = recorded
    records, adapters = [], []

    class Sink:
        def log(self, m, step):
            records.append((step, dict(m)))
            if "loss" in m and lora0 is not None:
                adapter = (lora_to_numpy(tr.lora) if meshes is None
                           else lora_to_numpy(tr._collective("state", False)["lora"]))
                adapters.append(adapter)

        def finish(self):
            pass

    tr.sink = Sink() if rank == 0 else None
    tr.train()
    out = {"calls": calls, "rollout_version": tr._rollout_weight_version}
    if getattr(tr, "_lora_rollout", None) is not None and (meshes is None or rank in meshes.rollout):
        out["lora_rollout"] = lora_to_numpy(tr._lora_rollout)
    if getattr(tr, "_lora_learner", None) is not None:
        out["lora_learner"] = lora_to_numpy(tr._lora_learner)
    save_traffic = Traffic()
    with save_traffic if meshes is not None else contextlib.nullcontext():
        state = tr._state_tree() if meshes is not None or rank == 0 else None
    if meshes is not None:
        out["traffic"] = {"save": (save_traffic.tensors, save_traffic.objects)}
    if stale:
        out["stale"] = _stale_round(tr, rank, test)
    if rank == 0:
        out.update(records=records, adapters=adapters, weight_version=tr.weight_version,
                   state=_np(state))
    if resume_after:
        resume_traffic = Traffic()
        with resume_traffic if meshes is not None else contextlib.nullcontext():
            again = ptrainer.Trainer(train, test, position_reward,
                                     dataclasses.replace(config, resume=True),
                                     tokenizer=CharTokenizer(),
                                     engine=_engine(engine, mcfg, meshes, engine_kw),
                                     model=params_from_numpy(base, mcfg, device="cpu"),
                                     meshes=meshes)
        resumed = again._state_tree() if meshes is not None or rank == 0 else None
        if meshes is not None:
            out["traffic"]["resume"] = (resume_traffic.tensors, resume_traffic.objects)
            out["local_bytes"] = (sum(t.numel() * t.element_size()
                                      for t in again.lora.trainable()) if again._learner else 0)
        if rank == 0:
            out["resumed"] = _np(resumed)
    return out


def _stale_round(tr, rank: int, test: dict) -> bool:
    """One round with the learner a version ahead of the rollout: whether
    this rank refused it with ``StaleWeightsError``."""
    from distrl_llm_tpu_torch.trainer import StaleWeightsError

    if rank == 0:
        with tr.lead():
            tr.weight_version += 1
            try:
                tr._generate_round(test, tr.config.train_sampling())
            except StaleWeightsError:
                return True
            finally:
                tr.weight_version -= 1
        return False
    refused, round_op = [], tr._round_op

    def spy(payload):
        try:
            return round_op(payload)
        except StaleWeightsError:
            refused.append(True)
            raise

    tr._round_op = spy
    tr.follow()
    return bool(refused)


def sharded_engine_job(rank, world, *, base: dict, cfg: dict, cases: list[dict],
                       engine_kw: dict) -> list[dict]:
    """``ShardedPagedEngine`` rounds over a dp mesh of all ranks, one per
    case (``ids``, ``mask``, ``sampling`` kwargs, ``seed``, engine kwargs
    in ``engine``): every rank returns each round's tokens, lengths and
    logprobs and the pages its own pool held."""
    import torch

    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.engine import paged_engine
    from distrl_llm_tpu_torch.engine.sharded_paged import ShardedPagedEngine
    from distrl_llm_tpu_torch.models.configs import ModelConfig
    from distrl_llm_tpu_torch.models.convert import params_from_numpy

    mcfg = ModelConfig(**cfg)
    model = params_from_numpy(base, mcfg, device="cpu")
    mesh = _meshes({}, 0, world).rollout
    pages: list[int] = []
    prefill = paged_engine._paged_prefill

    def counting(*a, **k):
        pages.append(k["total_pages"])
        return prefill(*a, **k)

    paged_engine._paged_prefill = counting
    out = []
    for case in cases:
        eng = ShardedPagedEngine(mcfg, mesh, cache_dtype=torch.float32, device="cpu",
                                 **engine_kw, **case.get("engine", {}))
        del pages[:]
        res = eng.generate(model, None, case["ids"], case["mask"],
                           SamplingConfig(**case["sampling"]), case["seed"])
        out.append({"tokens": res.tokens, "lengths": res.lengths, "logprobs": res.logprobs,
                    "pages": list(pages), "steps": res.steps_dispatched})
    return out


def port_fields() -> set[str]:
    """The port's ``TrainConfig`` fields but the mesh (each package has its
    own ``MeshConfig``; the jobs take the mesh's axes apart)."""
    from distrl_llm_tpu_torch.config import TrainConfig

    return set(TrainConfig.__dataclass_fields__) - {"mesh"}
