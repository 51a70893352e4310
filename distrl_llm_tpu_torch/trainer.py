"""The training loop: the PG/GRPO loop on one card, synchronous or with
generation overlapping the update.

Counterpart of the JAX package's ``trainer.py`` (the reference's Trainer,
distributed_trainer.py:13-416) on one card, one learner:

* **Rollout**: one ``engine.generate`` call per round over ``batch_size``
  prompts (padded rows discarded after), ``num_candidates`` completions
  each, decoded and scored by the reward function.
* **Shaping and update**: ``shape_rewards`` (PG baselines or GRPO
  advantages), ``topk_filter``, ``flatten_for_update``,
  ``prepare_update_batch``, then the grad-accumulated train step
  (``learner/train_step.py``) with Adam8bit updating the adapter in place.
* **Weight sync**: the engine and the learner share one ``Decoder`` (the
  JAX package's timeshared roles); the learner's adapter is passed to the
  engine each round, ``weight_version`` counts updates and each round
  checks that it lags the version the learner last published by no more
  than its mode allows.
* **Rollout modes** (``rollout_mode``): "sync" serializes generation and
  update; "pipelined" generates batch t+1 on a one-thread pool while batch
  t updates (one step stale); "async" runs a producer thread
  (``rollout/service.py``) into a bounded trajectory buffer that the learner
  pulls from, bounded by ``max_staleness`` and corrected by the AIPO
  objective over per-token version tags; ``inflight_weight_updates`` pushes
  each step's adapter into the round in flight. In the overlapped modes a
  round runs on a CUDA stream of its own while the learner keeps the main
  thread's, and each push copies the adapter into a ring of persistent
  buffers ordered against that stream by events (``rollout/adapter_ring.py``).
* **Full fine-tuning** (``full_finetune``, the JAX package's
  ``train_mode="full"``): the whole model trains as f32 master weights (a
  ``Decoder`` built from the base), and the base becomes the rollout copy:
  each push casts the masters into it in place, at the base's dtype, and
  bumps its ``weights_version``; the engine samples it with no adapter.
  Under the overlapped modes the rollout copy is a ring of two such
  ``Decoder``s (the base and one more), and each push casts into the one
  no round in flight holds, as the adapter ring does for adapters.
* **Multi-turn environments** (``env`` "code" or "verifier",
  ``env/driver.py``): the driver is the paged engine's turn hook for each
  round; each candidate carries its loss mask (0 on injected observation
  tokens), the environment's (n, 2) rewards (the reward pass does not score
  such a round again), its turns' provenance and the ``env/*`` metrics.
* **Remote rollout workers** (``rollout_workers``): generation runs in
  worker processes (``distributed/worker_main.py``) behind a
  ``RemoteEngine`` over the control plane; ``from_pretrained`` then builds
  no local engine, and the base it loads serves the learner only. Each push
  is a host copy of the adapter, handed once per version to the versioned
  weight bus (``weight_bus="broadcast"``) or shipped in every shard
  ("dispatch"); a round a quarantined shard degraded drops its lost prompts
  with exact accounting.
* **Metrics**: the reference's exact names (distributed_trainer.py:348-366,
  :412-415) through a pluggable sink (``metrics.py``); each phase's
  ``timing/*_duration`` ends on finished device work.
* **Checkpointing**: the resume state (``checkpoint.py``) and the per-step
  adapter artifact.

* **Learners sharded over ranks** (``meshes``, ROADMAP item 10a): one
  process a card in a ``torch.distributed`` job, the ranks carved into
  rollout and learner meshes (``parallel/mesh.py``). Rank 0 is the driver:
  it runs this loop, the rewards, the metrics and the checkpoints; every
  other rank's ``train()`` follows it (``follow``), taking each collective
  step rank 0 announces over the process group: a round (the stale-weights
  check on every rollout rank, then the engine: one replica on the rollout
  mesh's first rank, the rows split over the rollout ranks with
  ``engine_impl="paged_sharded"``, or the hybrid actor/learner split on
  disjoint roles), an update (each learner rank its dp group's rows, the
  grads merged over dp, the state sharded over fsdp by
  ``parallel/partition.py``), a push (the adapter, or full fine-tuning's
  masters cast to the rollout copy, gathered over fsdp and broadcast from
  the learners to the rollout ranks), and the gathers behind a checkpoint
  and an HF export, which rank 0 alone writes.

Not ported (each raises where a config would reach it): tensor and
sequence parallelism, and a mesh under the overlapped modes, remote
workers or multi-turn environments (ROADMAP queue 1 item 10b); the
observability, lineage, control, gateway and elastic-fleet planes (item
11).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import os
import threading
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.checkpoint import (
    CheckpointManager, load_rollout_state, save_adapter_file, save_rollout_state,
)
from distrl_llm_tpu_torch.config import (
    SamplingConfig, TrainConfig, check_full_finetune_fits, check_mesh_supported,
    full_finetune_bytes,
)
from distrl_llm_tpu_torch.data import DictDataset
from distrl_llm_tpu_torch.learner.optim import check_state_format, make_optimizer
from distrl_llm_tpu_torch.learner.train_step import (
    make_train_step, place_update_batch, update_arrays,
)
from distrl_llm_tpu_torch.metrics import MetricsSink, make_sink
from distrl_llm_tpu_torch.models.convert import lora_to_numpy, param_stacks
from distrl_llm_tpu_torch.models.lora import init_lora_params, lora_scale
from distrl_llm_tpu_torch.models.transformer import Decoder
from distrl_llm_tpu_torch.rewards import (
    RewardComputer,
    make_reward_function,
    reward_function as parity_reward_function,
)
from distrl_llm_tpu_torch.rollout.adapter_ring import AdapterRing
from distrl_llm_tpu_torch.rollout.trajectory import version_tags_for_round
from distrl_llm_tpu_torch.shaping import flatten_for_update, shape_rewards, topk_filter
from distrl_llm_tpu_torch.tokenizer import decode_batch, encode_fixed
from distrl_llm_tpu_torch.utils.chunking import chunk_sizes

log = logging.getLogger(__name__)

RewardFn = Callable[[Sequence[str], Sequence[str]], np.ndarray]

def engine_kwargs_from_config(config: TrainConfig) -> dict[str, Any]:
    """Engine-constructor kwargs derived from the config (the engines'
    knobs: KV format, the refill scheduler with prefix sharing, continuous
    admission, the prefix cache and host spill, speculative decoding, the
    row cap, behavior-logprob capture); module level so the config ->
    engine wiring is testable without a checkpoint. An unset knob is left
    out, an explicit one passed as a pin (the JAX package's convention)."""
    kwargs: dict[str, Any] = {"kv_quant": config.kv_cache_quant}
    if config.decode_scan_chunk is not None:
        # an explicit value, 0 included, reaches the engine as a pin
        kwargs["scan_chunk"] = config.decode_scan_chunk
    if config.engine_impl == "paged" and config.continuous_batching:
        kwargs["scheduler"] = "refill"
        if config.prefix_sharing:
            kwargs["prefix_sharing"] = True
        if config.continuous_admission:
            kwargs["continuous_admission"] = True
        for name in ("spec_draft", "spec_ngram", "spec_drafter", "spec_verify"):
            if getattr(config, name) is not None:
                kwargs[name] = getattr(config, name)
        if config.spec_adapt:
            kwargs["spec_adapt"] = True
        if config.prefix_cache is not None:
            kwargs["prefix_cache"] = config.prefix_cache
        if config.kv_spill:
            kwargs["kv_spill"] = True
            if config.kv_spill_host_mb:
                kwargs["kv_spill_host_mb"] = config.kv_spill_host_mb
    if config.max_concurrent_sequences and config.engine_impl != "paged_sharded":
        # the sharded engine runs whole waves a rank; a row cap is the
        # per-replica engines' admission knob
        kwargs["max_concurrent_rows"] = config.max_concurrent_sequences
    if config.clip_ratio > 0.0:
        # behavior-logprob capture costs a vocab logsumexp a step: only when
        # the clip objective needs it
        kwargs["capture_logprobs"] = True
    return kwargs


def stop_token_ids(tokenizer) -> list[int]:
    """The tokenizer's EOS id with its extra stop ids (Qwen's ``<|im_end|>``
    beside ``<|endoftext|>``), as every engine of the trainer stops on."""
    eos = [tokenizer.eos_token_id]
    extra_eos = getattr(tokenizer, "eos_token_ids", None)
    if extra_eos:
        eos = sorted(set(eos) | set(extra_eos))
    return eos


def make_engine(config: TrainConfig, model: Decoder, tokenizer, *,
                hbm_bytes: int | None = None, meshes=None):
    """The rollout engine ``Trainer.from_pretrained`` builds for ``model``
    (the JAX package's local-engine branch, trainer.py:711-782), on the
    model's device. The paged engine's KV pool is budgeted by
    ``engine/budget.py::kv_pool_pages`` under ``learner_gpu_usage`` where
    the engine and the learner share the card (``hbm_bytes`` defaults to the
    card's memory), so with ``full_finetune`` the learner's f32 masters,
    grads and moments (this rank's fsdp share) are charged beside the
    rollout weights (and, under the overlapped modes, the second rollout
    copy of the trainer's ring); a rank of a disjoint rollout mesh is the
    reference's actor GPU, budgeted under ``actor_gpu_usage`` (JAX
    trainer.py:728-733). ``engine_impl="paged_sharded"`` splits each round's
    rows over ``meshes.rollout``'s ranks."""
    from distrl_llm_tpu_torch.engine import GenerationEngine, PagedGenerationEngine

    dev = model.embed.device
    common = dict(
        max_prompt_tokens=config.max_prompt_tokens,
        max_new_tokens=config.max_new_tokens,
        eos_token_ids=stop_token_ids(tokenizer),
        pad_token_id=(tokenizer.pad_token_id if tokenizer.pad_token_id is not None
                      else tokenizer.eos_token_id),
        lora_scale=lora_scale(config.max_lora_rank, config.lora_alpha),
        attn_impl=config.attn_impl,
        prompt_buckets=config.prompt_buckets or None,
        device=dev,
    )
    kwargs = engine_kwargs_from_config(config)
    if config.engine_impl == "paged_sharded":
        from distrl_llm_tpu_torch.engine.sharded_paged import ShardedPagedEngine
        from distrl_llm_tpu_torch.parallel.mesh import build_role_meshes

        mesh = (meshes or build_role_meshes(config.mesh)).rollout
        return ShardedPagedEngine(model.cfg, mesh, **common, **kwargs)
    if config.engine_impl == "paged":
        from distrl_llm_tpu_torch.engine.budget import kv_pool_pages, tree_bytes
        from distrl_llm_tpu_torch.ops.paged import DEFAULT_PAGE_SIZE

        actor = meshes is not None and not meshes.timeshared
        if actor and _rank() in meshes.learner:
            actor = False  # a learner rank's engine serves the hybrid learner share
        learner_bytes = 0
        if config.full_finetune and not actor:
            need = full_finetune_bytes(model.cfg, str(model.embed.dtype).removeprefix("torch."),
                                       config.mesh.fsdp if meshes is not None else 1)
            learner_bytes = need["masters"] + need["grads"] + need["moments"]
            if config.async_rollout:
                # the overlapped modes' second rollout copy (the trainer's ring)
                learner_bytes += need["rollout"]
        usage = config.actor_gpu_usage if actor else config.learner_gpu_usage
        kwargs["max_kv_pages"] = kv_pool_pages(
            model.cfg,
            gpu_usage=usage,
            param_bytes=tree_bytes(model) + learner_bytes,
            batch_prompts=config.batch_size,
            max_prompt_tokens=config.max_prompt_tokens,
            max_new_tokens=config.max_new_tokens,
            page_size=DEFAULT_PAGE_SIZE,
            kv_quant=config.kv_cache_quant or "none",
            spec_draft=(config.spec_draft or 0) if config.continuous_batching else 0,
            hbm_bytes=hbm_bytes,
            device=dev,
            # continuous admission draws prompt chains from the pool, and the
            # prefix cache keeps one more resident there
            continuous=config.continuous_admission,
            prefix_cache=bool(config.prefix_cache),
        )
        log.info("paged engine: %d KV pages of %d tokens under %s_gpu_usage=%.2f",
                 kwargs["max_kv_pages"], DEFAULT_PAGE_SIZE, "actor" if actor else "learner",
                 usage)
        return PagedGenerationEngine(model.cfg, **common, **kwargs)
    # the dense engine (a bf16 or int8 cache); decode_scan_chunk > 1 runs its
    # decode steps as CUDA graph chunks
    return GenerationEngine(model.cfg, **common, **kwargs)


def remote_engine(config: TrainConfig, tokenizer):
    """The ``RemoteEngine`` over ``config.rollout_workers`` that
    ``Trainer.from_pretrained`` connects (JAX trainer.py:644-681): the
    trainer's stop-token set and LoRA scale, the control plane's seeded
    retry policy, quarantine threshold, rejoin and degradation, and the
    configured weight bus."""
    from distrl_llm_tpu_torch.distributed import connect_remote_engine
    from distrl_llm_tpu_torch.distributed.resilience import RetryPolicy

    addresses = []
    for spec in config.rollout_workers:
        host, _, port = spec.rpartition(":")
        addresses.append((host or "127.0.0.1", int(port)))
    return connect_remote_engine(
        addresses,
        max_prompt_tokens=config.max_prompt_tokens,
        max_new_tokens=config.max_new_tokens,
        # generation_timeout_s <= 0 turns the hang detector off; the control
        # plane still needs a deadline: a day
        timeout_ms=(int(config.generation_timeout_s * 1000)
                    if config.generation_timeout_s > 0 else 86_400_000),
        lora_scale=lora_scale(config.max_lora_rank, config.lora_alpha),
        eos_token_ids=stop_token_ids(tokenizer),
        retry_policy=RetryPolicy(max_call_retries=config.rpc_retries,
                                 base_s=config.rpc_backoff_s, seed=config.seed),
        poison_threshold=config.poison_shard_k,
        rejoin=config.worker_rejoin,
        degrade_on_shard_failure=config.degrade_on_poison,
        weight_bus=config.weight_bus,
    )


class StaleWeightsError(RuntimeError):
    """The rollout holds an adapter older than the learner's — the race the
    reference prevents with its synchronous barrier, detected here with
    asserted weight-version counters."""


class EngineHangError(RuntimeError):
    """A generation round exceeded ``generation_timeout_s`` — the hang
    detector matching the reference's ``ray.get(timeout=240)``
    (distributed_trainer.py:200). The trainer checkpoints before raising;
    restart with ``resume=True`` to continue from the last completed step."""


def _leaves(lora: dict) -> list[torch.Tensor]:
    return [lora["layers"][t][k] for t in sorted(lora["layers"]) for k in ("a", "b")]


def _rank() -> int:
    return torch.distributed.get_rank() if torch.distributed.is_initialized() else 0


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if torch.is_tensor(tree) else tree


class _Slot(NamedTuple):
    """A tensor's place in a tree sent a tensor at a time."""
    shape: tuple
    dtype: torch.dtype


def _skeleton(tree, leaves: list):
    """``tree`` with each tensor replaced by its ``_Slot``, the tensors
    appended to ``leaves`` in order."""
    if isinstance(tree, dict):
        return {k: _skeleton(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v, leaves) for v in tree]
    if torch.is_tensor(tree):
        leaves.append(tree)
        return _Slot(tuple(tree.shape), tree.dtype)
    return tree


def _fill(skeleton, take):
    """The inverse of ``_skeleton``: each ``_Slot`` replaced by ``take(slot)``
    in the same order."""
    if isinstance(skeleton, dict):
        return {k: _fill(v, take) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_fill(v, take) for v in skeleton]
    return take(skeleton) if isinstance(skeleton, _Slot) else skeleton


def _decoder_from(cfg, named: dict) -> Decoder:
    """An f32 ``Decoder`` on the host holding ``named``'s whole tensors (a
    gathered full fine-tuning tree, for the HF export)."""
    model = Decoder(cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(named[name])
    return model


def _env_turn_counts(candidates: list[dict]) -> list[int]:
    """Per-episode turn counts from the provenance that rode a consumed
    batch (the async learner's: the round's stats stayed with the
    producer). ``cand["turns"]`` nests group-major: per group, per
    candidate row, that episode's turn records; the count is the innermost
    length."""
    return [len(row or ()) for c in candidates if "turns" in c
            for grp in c["turns"] for row in (grp or ())]


class Trainer:
    """Owns the episode/batch loop. The tokenizer, the model and the engine
    are injected, so the loop runs on test doubles (``engine/fake.py``);
    ``from_pretrained`` assembles the real thing from a checkpoint
    directory. The learner runs on ``model``'s device.

    ``meshes`` (``parallel/mesh.py::build_role_meshes``, in a
    ``torch.distributed`` job): every rank builds its Trainer with its own
    engine and a whole copy of ``model`` (the frozen base, or full
    fine-tuning's starting weights) and calls ``train()``; rank 0 drives and
    the others follow it (module docstring)."""

    def __init__(
        self,
        train_dataset,
        test_dataset,
        reward_function: RewardFn,
        config: TrainConfig,
        *,
        tokenizer,
        engine,
        model: Decoder,
        sink: MetricsSink | None = None,
        reward_computer: RewardComputer | None = None,
        meshes=None,
    ):
        self.config = config
        self.train_dataset = DictDataset.wrap(train_dataset)
        self.test_dataset = DictDataset.wrap(test_dataset)
        self.tokenizer = tokenizer
        self.engine = engine
        # the frozen base, shared by the engine and the learner (one card:
        # the JAX package's timeshared roles); None in full mode, where the
        # base becomes the rollout copy
        self.model = model
        self.model_cfg = model.cfg
        self.device = model.embed.device
        self._full = config.full_finetune
        self.sink = sink
        # a learner mesh: this rank's roles (every rank is both without one)
        self.meshes = meshes
        self._rank = _rank() if meshes is not None else 0
        self._world = (torch.distributed.get_world_size()
                       if meshes is not None and torch.distributed.is_initialized() else 1)
        if meshes is not None:
            check_mesh_supported(config)
        self._learner = meshes is None or self._rank in meshes.learner
        self._announce = False  # rank 0 inside lead(): collective steps go to the followers
        # format-reward gate: "strict" swaps the scorer in the parity
        # reward; with a custom reward_function it would be ambiguous
        if config.format_reward != "soft":
            if reward_function is not parity_reward_function:
                raise ValueError(
                    "format_reward != 'soft' with a custom reward_function "
                    "is ambiguous — encode the gate inside the custom fn, "
                    "or drop one of the two")
            reward_function = make_reward_function(config.format_reward)
        if reward_computer is None:
            reward_computer = RewardComputer(reward_fn=reward_function)
        elif reward_computer.fn_explicit and reward_computer.reward_fn is not reward_function:
            raise ValueError(
                "reward_computer was built with a different reward_fn than "
                "the one passed to Trainer — pass the fn in exactly one place")
        self.rewards = reward_computer
        self._reward_fn = reward_function

        # a multi-turn environment arms the engine's turn hook each round:
        # finished turns step the environment and continuing conversations
        # resume on their resident KV; env="math" keeps the single-turn path
        self._env_driver: Any = None
        if config.env != "math":
            from distrl_llm_tpu_torch.env import EnvRolloutDriver

            if not hasattr(engine, "turn_hook"):
                raise ValueError(
                    f"env={config.env!r} needs an engine with a turn_hook (the paged "
                    f"refill engine); {type(engine).__name__} has none")
            self._env_driver = EnvRolloutDriver(
                config.env, tokenizer, max_turns=config.max_turns,
                max_new_tokens=config.max_new_tokens, format_scorer=config.format_reward)

        # inflight_weight_updates needs an engine that can swap a round in
        # flight: one without a real push_lora is refused here, never a
        # silent no-op; a RemoteEngine can only over the broadcast bus
        if config.inflight_weight_updates:
            push = getattr(engine, "push_lora", None)
            if not callable(push) or not getattr(engine, "supports_inflight_push", True):
                raise ValueError(
                    "inflight_weight_updates requires an engine with a real push_lora "
                    f"(in-flight weight-update mailbox); {type(engine).__name__} cannot "
                    "swap a round in flight — use a local engine or a RemoteEngine with "
                    "weight_bus='broadcast'")

        # chunk-composition validation parity (distributed_trainer.py:34-36)
        chunk_sizes(config.batch_size, config.number_of_actors,
                    config.number_of_learners, config.learner_chunk_size)

        self.scale = lora_scale(config.max_lora_rank, config.lora_alpha)
        # every seed the trainer hands out (the adapter's init, each engine
        # round, each LoRA-dropout update) is drawn from this generator
        self._gen = torch.Generator().manual_seed(config.seed)
        # the rollout thread draws round seeds while the learner's draws
        # dropout seeds (pipelined and async)
        self._rng_mu = threading.Lock()
        # drawn in full mode too, as the JAX trainer splits its adapter key
        # in both modes: the later seeds stay the same
        lora_gen = torch.Generator(device=self.device).manual_seed(self._next_rng())
        if self._full:
            self.lora = self._master_weights(model)
            opt_leaves = (None if self.lora is None else
                          self.lora.leaf_groups(param_stacks(self.lora)) if meshes is not None
                          else list(param_stacks(self.lora).values()))
        else:
            # adapters train in f32; the base stays at its dtype
            self.lora = init_lora_params(lora_gen, self.model_cfg, config.max_lora_rank,
                                         dtype=torch.float32)
            if meshes is not None:
                from distrl_llm_tpu_torch.parallel.partition import shard_tree

                # the drawn adapter becomes the rollout copy's buffers, which
                # each push overwrites; the learner ranks train its shards
                self._lora_buf = self.lora
                self.lora = shard_tree(self.lora, meshes.learner) if self._learner else None
            else:
                for leaf in _leaves(self.lora):
                    leaf.requires_grad_(True)
            opt_leaves = (None if self.lora is None else self.lora.trainable()
                          if meshes is not None else _leaves(self.lora))
        self.optimizer = self.train_step = None
        if opt_leaves is not None:  # a learner rank
            self.optimizer = make_optimizer(opt_leaves, config.lr, use_8bit=config.optimizer_8bit)
            self.train_step = make_train_step(
                self.model_cfg,
                learner_type=config.learner,
                optimizer=self.optimizer,
                lora_scale=self.scale,
                micro_size=config.train_batch_size,
                skip_semantics="all_zero" if config.skip_all_zero_reward_batches else "any_zero",
                attn_impl=config.attn_impl,
                lora_dropout=config.lora_dropout,
                logit_chunk=config.logprob_chunk,
                clip_ratio=config.clip_ratio,
                kl_coeff=config.kl_coeff,
                train_mode="full" if self._full else "lora",
                # async trains on data up to max_staleness steps old: the
                # truncated-IS objective (AIPO) with its per-token version-lag
                # mask; the mask stays off (0) under the downweight policy, whose
                # fade trains the beyond-K tokens on purpose
                off_policy="aipo" if config.rollout_mode == "async" else "clip",
                is_cap=config.rollout_is_cap,
                max_staleness=config.max_staleness if config.staleness_policy == "drop" else 0,
                mesh=self.meshes.learner if self.meshes is not None else None,
            )

        self.total_batch_steps = 0
        self.total_samples_processed = 0
        self.episode = 0
        self.batch_in_episode = 0  # mid-episode resume cursor
        self.weight_version = 0  # incremented per optimizer step
        self._rollout_weight_version = -1  # version the rollout samples with
        # (bucket, rows, n) shapes seen — a first round is exempt from
        # the hang detector (kernel builds and allocator warm-up are slow,
        # not hung)
        self._warm_engine_keys: set[tuple] = set()
        self._last_hf_export_step = -1
        if config.export_hf_snapshots and not config.run_name:
            log.warning("export_hf_snapshots is set but run_name is not — no "
                        "snapshots will be written (run_dir is derived from run_name)")

        # the overlapped modes' pushes go through a ring of persistent
        # adapter copies (three when the self-drafter keeps the previous one
        # resident), which the engine's mailbox tells of each swap; full
        # fine-tuning's ring holds two rollout copies, the base and one more.
        # A remote engine's rounds read host copies (``_push_weights``), so
        # it needs none
        self._remote = getattr(engine, "is_remote", False)
        self._ring: AdapterRing | None = None
        if config.async_rollout and self._full:
            base = self._rollout_model
            self._ring = AdapterRing(2, self.device, buffers=[
                base, Decoder(base.cfg, dtype=base.embed.dtype, device=self.device)])
        elif config.async_rollout and not self._remote:
            self._ring = AdapterRing(3 if getattr(engine, "_track_prev_lora", False) else 2,
                                     self.device)
        if hasattr(engine, "lora_swap_hook"):
            engine.lora_swap_hook = self._ring.swap_hook if self._ring is not None else None
        self._rollout_stream = None  # the overlapped modes' CUDA stream, made in train()
        self._gen_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._rollout_service = None
        self._rollout_buffer = None
        self._staleness_policy = None
        self._rollout_dropped_stale = 0
        self._resume_rollout_state: dict | None = None

        self.ckpt: CheckpointManager | None = None
        if config.checkpoint_dir:
            self.ckpt = CheckpointManager(config.checkpoint_dir)
            if config.resume:
                self._try_resume()
        self._push_weights()

    # ------------------------------------------------------------------ setup

    def _master_weights(self, model: Decoder) -> Decoder | None:
        """Full fine-tuning's trainable tree (JAX trainer.py:298-322): an f32
        copy of ``model`` whose every parameter trains (with lr ~2e-5 a
        step is below bf16's ~0.4% resolution, so bf16 weights would round
        many updates away). ``model`` stays as the rollout copy, which each
        push overwrites, and the trainer keeps no frozen base. On a learner
        mesh the masters are this rank's fsdp shards of that copy
        (``ShardedDecoder``); a rank off the learner mesh holds none."""
        if model.quant is not None:
            raise ValueError("full_finetune requires an unquantized base")
        fsdp = self.config.mesh.fsdp if self.meshes is not None else 1
        if self.device.type == "cuda":
            from distrl_llm_tpu_torch.engine.budget import device_hbm_bytes

            check_full_finetune_fits(model.cfg, str(model.embed.dtype).removeprefix("torch."),
                                     self.config.model, device_hbm_bytes(self.device), fsdp=fsdp)
        # a rank of the learner mesh alone keeps no rollout copy
        learner_only = (self.meshes is not None and self._learner
                        and self._rank not in self.meshes.rollout)
        self._rollout_model = None if learner_only else model
        self.model = None
        if self.meshes is not None:
            from distrl_llm_tpu_torch.parallel.partition import shard_tree

            return shard_tree(model, self.meshes.learner) if self._learner else None
        masters = Decoder(model.cfg, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for p, src in zip(masters.parameters(), model.parameters(), strict=True):
                p.copy_(src)
                p.requires_grad_(True)
        return masters

    @classmethod
    def from_pretrained(
        cls,
        train_dataset,
        test_dataset,
        reward_function: RewardFn,
        config: TrainConfig,
        *,
        checkpoint_path: str | None = None,
        tokenizer=None,
        sink: MetricsSink | None = None,
        device: str | torch.device | None = None,  # None = the GPU
        hbm_bytes: int | None = None,  # the KV budget's memory; default the card's
    ) -> "Trainer":
        """Assemble the real thing: tokenizer, HF weights (at
        ``config.dtype``, quantized per ``base_quant``) and the engine, on
        ``device``. ``checkpoint_path`` is a local HF checkpoint directory
        (default ``config.model`` as a path: no hub download). Pass
        ``tokenizer`` if the caller already loaded it. In a
        ``torch.distributed`` job (``distributed/launch.py``) every rank
        calls it: the ranks are carved into role meshes by ``config.mesh``
        and each loads the base whole onto its own card (JAX
        trainer.py:596-735)."""
        from distrl_llm_tpu_torch.models.loading import load_pretrained
        from distrl_llm_tpu_torch.ops.quant import quantize_base
        from distrl_llm_tpu_torch.tokenizer import load_tokenizer
        from distrl_llm_tpu_torch.utils.device import resolve_device

        path = checkpoint_path or config.model
        meshes = None
        if torch.distributed.is_initialized():
            from distrl_llm_tpu_torch.parallel.mesh import build_role_meshes

            check_mesh_supported(config)
            meshes = build_role_meshes(config.mesh)
        if tokenizer is None:
            tokenizer = load_tokenizer(path)
        model, _ = load_pretrained(path, dtype=getattr(torch, config.dtype),
                                   device=resolve_device(device))
        # the reference's 4-bit base (LOAD_IN_4BIT): the seven projections
        # quantized in place, layer by layer
        quantize_base(model, config.base_quant, config.quant_group_size)
        if config.rollout_workers:
            # generation runs in the worker processes: no local engine, and
            # the base serves the learner only (JAX trainer.py:629-681)
            engine = remote_engine(config, tokenizer)
        else:
            engine = make_engine(config, model, tokenizer, hbm_bytes=hbm_bytes, meshes=meshes)
        return cls(train_dataset, test_dataset, reward_function, config,
                   tokenizer=tokenizer, engine=engine, model=model, sink=sink, meshes=meshes)

    # ------------------------------------------------------------- checkpoint

    def _state_tree(self) -> dict | None:
        if self.meshes is not None:  # gathered to rank 0 in a one-rank run's layout
            learner = self._collective("state", True)
            if learner is None:  # every rank but 0
                return None
            trained, opt_state = learner["lora"], learner["opt_state"]
        elif self._full:  # the f32 master weights by parameter name
            trained = {n: p.detach() for n, p in self.lora.named_parameters()}
            opt_state = self.optimizer.state_dict()
        else:
            trained = {"layers": {t: {k: x.detach() for k, x in ab.items()}
                                  for t, ab in self.lora["layers"].items()}}
            opt_state = self.optimizer.state_dict()
        return {
            "lora": trained,
            "opt_state": opt_state,
            "step": self.total_batch_steps,
            "episode": self.episode,
            "batch_in_episode": self.batch_in_episode,
            "samples": self.total_samples_processed,
            "rng": self._gen.get_state(),
        }

    def _try_resume(self) -> None:
        assert self.ckpt is not None
        if self.meshes is not None:
            # rank 0 names the step; every rank reads that checkpoint itself
            # (the checkpoint directory must be visible to every rank, as on
            # one host or a shared file system) and takes its shards (all
            # ranks are here, in the constructor)
            box = [self.ckpt.latest_step() if self._rank == 0 else None]
            if self._world > 1:
                torch.distributed.broadcast_object_list(box, src=0)
            restored = self._load_shards(box[0])
        else:
            restored = self._load_local(self.ckpt.restore())
        if restored is None:
            return
        self.total_batch_steps = int(restored["step"])
        self.episode = int(restored["episode"])
        self.batch_in_episode = int(restored["batch_in_episode"])
        self.total_samples_processed = int(restored["samples"])
        self._gen.set_state(restored["rng"])
        self.weight_version = self.total_batch_steps
        if self.config.rollout_mode == "async":
            # buffered but unconsumed trajectories and the producer's cursor;
            # an absent or corrupt sidecar degrades to a fresh buffer
            self._resume_rollout_state = load_rollout_state(self.config.checkpoint_dir,
                                                            self.total_batch_steps)
        log.info("resumed from step %d (episode %d, batch %d)",
                 self.total_batch_steps, self.episode, self.batch_in_episode)

    def _load_local(self, restored: dict | None) -> dict | None:
        if restored is None:
            return None
        # in place: the optimizer holds these very tensors
        with torch.no_grad():
            if self._full:
                saved = restored["lora"]
                params = dict(self.lora.named_parameters())
                if sorted(saved) != sorted(params):
                    raise ValueError("the checkpoint holds another model's weights")
                for n, p in params.items():
                    p.copy_(saved[n])
            else:
                for t, ab in self.lora["layers"].items():
                    for k, x in ab.items():
                        x.copy_(restored["lora"]["layers"][t][k])
        self.optimizer.load_state_dict(restored["opt_state"])
        check_state_format(self.optimizer)
        return restored

    def save_checkpoint(self) -> None:
        if self.ckpt is None:
            return
        state = self._state_tree()
        if self._rank != 0:
            return
        # on the host, as a learner mesh gathers it: the same bytes either way
        self.ckpt.save(self.total_batch_steps, _to_cpu(state))
        buffer = self._rollout_buffer
        if buffer is not None:
            # async: the queued trajectories and the producer's cursor ride as
            # a sidecar of the same step. The cursor is read BEFORE the
            # buffer: a round landing between the two reads is re-produced on
            # resume (benign duplicates) instead of losing its tail
            service, policy = self._rollout_service, self._staleness_policy
            cursor = service.cursor if service is not None else None
            save_rollout_state(self.config.checkpoint_dir, self.total_batch_steps, {
                "buffer": buffer.state_dict(),
                "cursor": cursor,
                # the cumulative rollout_dropped_stale never goes backwards
                # across a resume
                "policy_dropped": policy.dropped if policy else 0,
                "policy_admitted": policy.admitted if policy else 0,
            })

    def export_hf_snapshot(self) -> None:
        """The reference's ``save_pretrained`` artifact: an HF-format
        checkpoint of the MERGED model at run_dir/model_{step}
        (distributed_trainer.py:372-380). A quantized base cannot be merged:
        the snapshot is skipped with a warning."""
        if self.total_batch_steps == self._last_hf_export_step:
            return  # episode end landing on a save_every step: already written
        from distrl_llm_tpu_torch.models.loading import save_hf_checkpoint

        path = os.path.join(self.config.run_directory, f"model_{self.total_batch_steps}")
        trained = self.lora
        if self.meshes is not None:  # gathered to rank 0's host, which alone writes
            trained = self._collective("state", False)["lora"]
            if self._full:
                trained = _decoder_from(self.model_cfg, trained)
            else:  # merged into the base on its device
                trained = {"layers": {t: {k: x.to(self.device) for k, x in ab.items()}
                                      for t, ab in trained["layers"].items()}}
        try:
            if self._full:  # the trained tree itself (its f32 master weights)
                save_hf_checkpoint(trained, path)
            else:
                save_hf_checkpoint(self.model, path, lora=trained,
                                   lora_alpha=self.config.lora_alpha)
            self._last_hf_export_step = self.total_batch_steps
        except NotImplementedError as e:
            log.warning("HF snapshot skipped: %s", e)

    def save_adapter(self) -> None:
        """The reference's per-step adapter artifact (distributed_trainer.py:346
        -> save_lora). Export only: weight sync is in memory."""
        if self._full:
            raise RuntimeError("full_finetune has no LoRA adapter to export")
        lora = self.lora if self.meshes is None else self._collective("state", False)["lora"]
        save_adapter_file(lora, self.config.lora_save_path,
                          rank=self.config.max_lora_rank, alpha=self.config.lora_alpha,
                          model_name=self.config.model)

    # ------------------------------------------------------------ weight sync

    def _push_weights(self) -> None:
        """Learner -> rollout weight sync, replacing the reference's adapter
        file bus (save_lora distributed_actor.py:85 / load_lora :150): the
        adapter the next round passes to the engine, and the version it
        carries, which ``_generate_round`` checks before sampling.

        Synchronous: the pushed adapter IS ``self.lora``, not a copy (Adam8bit
        updates those tensors in place, and no round overlaps an update).
        Pipelined and async: a round in flight must not read tensors the
        optimizer is writing, so the adapter is copied, on the learner's
        stream, into the ring of persistent buffers
        (``rollout/adapter_ring.py``): at fixed addresses, so the engine's
        graphs stay keyed by at most the ring's buffers.

        Full mode (JAX trainer.py:939-943): the f32 masters are cast into
        the rollout copy in place, at its dtype (one persistent ``Decoder``,
        no allocation per push), and its ``weights_version`` goes up by one:
        the engine's prefix cache keys its cached KV on it, so KV written
        under the weights before a push is never served after it. Pipelined
        and async: a round in flight reads its copy while the learner
        pushes, so the masters are cast into the ring's other copy, which
        becomes the published rollout copy.

        On a learner mesh every rank takes part (``_push_op``)."""
        if self.meshes is not None:
            self._collective("push", self.weight_version)
            return
        if self._remote:
            # a host copy made here, on the learner's thread (the optimizer
            # updates self.lora in place), in the JAX tree's layout; the bus
            # broadcasts it once per version, and the round's dispatch names
            # the version (or, without the bus, carries the tree)
            self._lora_rollout = lora_to_numpy(self.lora)
            if getattr(self.engine, "bus", None) is not None:
                self.engine.push_lora(self._lora_rollout, version=self.weight_version)
        elif self._full and self._ring is not None:
            self._rollout_model = self._ring.push(self.lora, self.weight_version)
            self._lora_rollout = None
        elif self._full:
            with torch.no_grad():
                for p, src in zip(self._rollout_model.parameters(), self.lora.parameters(),
                                  strict=True):
                    p.copy_(src)
            self._rollout_model.weights_version += 1
            self._lora_rollout = None
        elif self._ring is not None:
            self._lora_rollout = self._ring.push(self.lora, self.weight_version)
        else:
            # a new dict over the same tensors for each push: the engine's
            # prefix cache keys its cached KV on the adapter object's
            # identity (the JAX package hands the engine a new adapter each
            # step)
            self._lora_rollout = {"layers": {t: dict(ab)
                                             for t, ab in self.lora["layers"].items()}}
        self._rollout_weight_version = self.weight_version

    # ------------------------------------------------------------ learner mesh

    @contextlib.contextmanager
    def lead(self):
        """Rank 0's side of a learner mesh: inside, each collective step
        (``_collective``) is announced to the followers, and leaving tells
        them to stop. Without a mesh, or on one rank, it does nothing."""
        announce = self.meshes is not None and self._world > 1 and not self._announce
        self._announce = self._announce or announce
        try:
            yield self
        finally:
            if announce:
                self._collective("stop")
                self._announce = False

    def follow(self) -> None:
        """A follower rank's ``train()``: run each collective step rank 0
        announces (``lead``) until it stops. A round refused as stale is
        refused on rank 0 too, which raises it; the follower goes on."""
        while True:
            msg = [None, None]
            torch.distributed.broadcast_object_list(msg, src=0)
            op, payload = msg
            if op == "stop":
                return
            try:
                getattr(self, f"_{op}_op")(payload)
            except StaleWeightsError as e:
                log.warning("rank %d: %s", self._rank, e)

    def _collective(self, op: str, payload=None):
        """Run step ``op`` here; inside ``lead`` announce it first, so that
        every rank enters its collectives together."""
        if self._announce:
            torch.distributed.broadcast_object_list([op, payload], src=0)
        return getattr(self, f"_{op}_op")(payload)

    def _stop_op(self, _) -> None:
        return None

    def _from_learners(self, value):
        """``value`` from the learner mesh's first rank to every rank (rank 0
        is off the learner mesh on disjoint roles)."""
        if self.meshes is None or 0 in self.meshes.learner:
            return value
        box = [value]
        torch.distributed.broadcast_object_list(box, src=self.meshes.learner.first_rank)
        return box[0]

    def _check_lag(self, learner_version: int, rollout_version: int) -> None:
        allowed = self.config.allowed_weight_lag
        if not 0 <= learner_version - rollout_version <= allowed:
            raise StaleWeightsError(
                f"rollout holds adapter v{rollout_version} but learner is at "
                f"v{learner_version} — rollout_mode={self.config.rollout_mode!r} "
                f"allows lag <= {allowed}; _push_weights() was not called after "
                "the last optimizer step, or the staleness bound is misconfigured")

    def _hybrid_rows(self, rows: int, n_real: int) -> int:
        """The actors' rows of the hybrid actor/learner split (JAX
        trainer.py:1038-1110), 0 for no split: disjoint roles split the round
        by ``chunk_sizes``, the learners' ``learner_chunk_size`` share
        decoding on the learner mesh's first rank with the learner-resident
        adapter. No split when the learners' share would be padding only,
        for a mesh-bound engine (``paged_sharded``), or in full mode (the
        learner ranks hold only shards of the weights)."""
        cfg = self.config
        if (self.meshes.timeshared or cfg.number_of_actors == 0 or cfg.learner_chunk_size <= 0
                or self._full or getattr(self.engine, "mesh", None) is not None):
            return 0
        sizes = chunk_sizes(rows, cfg.number_of_actors, cfg.number_of_learners,
                            cfg.learner_chunk_size)
        actor_rows = sum(sizes[:cfg.number_of_actors])
        return 0 if actor_rows >= n_real else actor_rows

    def _round_op(self, payload):
        """Every rank: one generation round. The stale-weights check first
        (every rank tracks the pushed version), then the engine: every
        rollout rank with ``paged_sharded``, else the rollout mesh's first
        rank (rank 0) over the actors' rows and, on a hybrid split, the
        learner mesh's first rank over the rest. The result is rank 0's."""
        ids, mask, sampling, seeds, version, split = payload
        self._check_lag(version, self._rollout_weight_version)
        m = self.meshes
        if getattr(self.engine, "mesh", None) is not None:
            if self._rank not in m.rollout:
                return None
            return self._call_engine(*self._engine_params(), ids, mask, sampling, seeds[0])
        res = None
        if self._rank == m.rollout.first_rank:
            rows = split or ids.shape[0]
            res = self._call_engine(*self._engine_params(), ids[:rows], mask[:rows], sampling,
                                    seeds[0])
        if not split:
            return res
        share = None
        if self._rank == m.learner.first_rank:
            share = self._call_engine(self.model, self._lora_learner, ids[split:], mask[split:],
                                      sampling, seeds[1])
        box = [share]
        torch.distributed.broadcast_object_list(box, src=m.learner.first_rank)
        if res is None:
            return None
        share = box[0]
        both = res.logprobs is not None and share.logprobs is not None
        return type(res)(
            tokens=np.concatenate([res.tokens, share.tokens]),
            lengths=np.concatenate([res.lengths, share.lengths]),
            steps_dispatched=(res.steps_dispatched or 0) + (share.steps_dispatched or 0),
            logprobs=np.concatenate([res.logprobs, share.logprobs]) if both else None)

    def _update_op(self, payload) -> float | None:
        """The optimizer step over ``update_arrays``' rows: on a learner mesh
        each learner rank takes its dp group's rows and the loss comes back
        from the learners."""
        arrays, dropout_seed = payload
        loss = None
        if self._learner:
            update = place_update_batch(
                arrays, micro_size=self.config.train_batch_size, device=self.device,
                mesh=self.meshes.learner if self.meshes is not None else None)
            loss = float(self.train_step(self.lora, self.model, update, dropout_seed))
        return self._from_learners(loss)

    def _push_op(self, version: int) -> None:
        """Every rank: the learners gather the trained tree over fsdp and it
        lands in each rollout rank's copy, broadcast from the learner mesh's
        first rank on disjoint roles. LoRA: into persistent buffers (a new
        dict over them each push, which the prefix cache keys on); full
        fine-tuning: each master cast into the rollout copy in place, then
        its ``weights_version`` bumped."""
        m = self.meshes
        send = None if m.timeshared else m.learner.first_rank
        with torch.no_grad():
            if self._full:
                if self._learner:
                    named = self.lora.full_named()
                else:
                    named = ((n, torch.empty(p.shape, dtype=torch.float32, device=self.device))
                             for n, p in self._rollout_model.named_parameters())
                dst = (dict(self._rollout_model.named_parameters())
                       if self._rollout_model is not None else {})
                for name, t in named:
                    if send is not None:
                        torch.distributed.broadcast(t, src=send)
                    if name in dst:
                        dst[name].copy_(t)
                if self._rollout_model is not None:
                    self._rollout_model.weights_version += 1
                self._lora_rollout = None
            else:
                full = self.lora.full() if self._learner else None
                self._lora_learner = full
                buf = self._lora_buf
                for t in sorted(buf["layers"]):
                    for k in ("a", "b"):
                        x = full["layers"][t][k] if full is not None else buf["layers"][t][k]
                        if send is not None:
                            torch.distributed.broadcast(x, src=send)
                        buf["layers"][t][k].copy_(x)
                self._lora_rollout = {"layers": {t: dict(ab) for t, ab in buf["layers"].items()}}
        self._rollout_weight_version = version

    def _state_op(self, with_opt: bool) -> dict | None:
        """The trained tree (and the optimizer state) in a one-rank run's
        layout on rank 0's host: what a checkpoint and an HF export write.
        Gathered a member at a time into the learner mesh's first rank and
        copied to its host (``to_host``), then sent on to rank 0 where rank
        0 is off the learner mesh. No card ever holds more than one member
        whole, and no other rank receives any of it."""
        from distrl_llm_tpu_torch.parallel.partition import gather_opt_state

        out = None
        if self._learner:
            dst = self.meshes.learner.first_rank
            trained = self.lora.to_host(dst)
            opt_state = gather_opt_state(self.optimizer, self.lora, dst) if with_opt else None
            if trained is not None:
                out = {"lora": trained, **({"opt_state": opt_state} if with_opt else {})}
        return self._host_to_rank0(out)

    def _host_to_rank0(self, tree):
        """``tree`` (host tensors and plain values) from the learner mesh's
        first rank to rank 0's host: its skeleton as an object, then one
        tensor at a time through the two ranks' devices (NCCL moves device
        tensors). Other ranks take no part and get None."""
        src = self.meshes.learner.first_rank
        if src == 0 or self._rank not in (0, src):
            return tree if self._rank == 0 else None
        if self._rank == src:
            leaves: list[torch.Tensor] = []
            torch.distributed.send_object_list([_skeleton(tree, leaves)], dst=0)
            for t in leaves:
                torch.distributed.send(t.to(self.device), dst=0)
            return None
        box = [None]
        torch.distributed.recv_object_list(box, src=src)

        def recv(slot: _Slot) -> torch.Tensor:
            buf = torch.empty(slot.shape, dtype=slot.dtype, device=self.device)
            torch.distributed.recv(buf, src=src)
            return buf.to("cpu", copy=True)

        return _fill(box[0], recv)

    def _load_shards(self, step: int | None) -> dict | None:
        """Every rank: the checkpoint of ``step`` read memory-mapped, each
        learner rank copying in only its shards' ranges of the trained tree
        and of the optimizer state (the rest of the file is never read)."""
        from distrl_llm_tpu_torch.parallel.partition import shard_opt_state

        if step is None:
            return None
        restored = self.ckpt.restore(step, mmap=True)
        if self._learner:
            self.lora.load_full(restored["lora"])
            self.optimizer.load_state_dict(shard_opt_state(restored["opt_state"],
                                                           self.optimizer, self.lora))
            check_state_format(self.optimizer)
        return restored

    # ---------------------------------------------------------------- rollout

    def _next_rng(self) -> int:
        """The next seed from the trainer's generator, drawn under a lock
        (the rollout thread draws round seeds while the learner's draws
        dropout seeds; the hang detector's thread gets its seed as an
        argument)."""
        with self._rng_mu:
            return int(torch.randint(2**62, (), generator=self._gen))

    def _dispatch_rollout(self, prompt_ids, prompt_mask, sampling: SamplingConfig,
                          model: Decoder, lora, n_real: int):
        """One generation round: one engine call over the whole batch, or on a
        learner mesh the collective round (``_round_op``), with the hybrid
        actor/learner split of the JAX package on disjoint roles."""
        if self.meshes is None:
            return self._call_engine(model, lora, prompt_ids, prompt_mask, sampling,
                                     self._next_rng())
        split = self._hybrid_rows(prompt_ids.shape[0], n_real)
        seeds = [self._next_rng() for _ in range(2 if split else 1)]
        return self._collective("round", (prompt_ids, prompt_mask, sampling, seeds,
                                          self.weight_version, split))

    def _on_rollout_stream(self, fn, *args):
        """``fn(*args)`` on the overlapped modes' rollout thread: on the card,
        with the device set and the rollout's own stream current, so the
        round's kernels queue beside the learner's, never behind them."""
        if self._rollout_stream is None:
            return fn(*args)
        with torch.cuda.device(self.device), torch.cuda.stream(self._rollout_stream):
            return fn(*args)

    def _engine_params(self) -> tuple:
        """(model, adapter) for an engine call: the shared base with the
        pushed adapter, or in full mode the rollout copy with none."""
        if self._full:
            return self._rollout_model, None
        return self.model, self._lora_rollout

    def _call_engine(self, *args):
        """Engine call with the configured hang detector: the generation runs
        in a watchdog thread and exceeding ``generation_timeout_s`` raises
        ``EngineHangError``. The hung device work itself cannot be
        interrupted — the recovery unit is the process (checkpoint and
        restart with resume=True). A shape's first round is exempt."""
        timeout = self.config.generation_timeout_s
        warm_key = None
        if timeout > 0:
            ids, mask, sampling = args[2], args[3], args[4]
            bucket = self.engine.bucket_for(mask) if hasattr(self.engine, "bucket_for") else 0
            warm_key = (bucket, ids.shape[0], sampling.n)
            if warm_key not in self._warm_engine_keys:
                timeout = 0.0
        if timeout <= 0:
            result = self.engine.generate(*args)
            if warm_key is not None:
                self._warm_engine_keys.add(warm_key)
            return result

        result: dict[str, Any] = {}
        # the watchdog thread runs the round on the caller's stream
        stream = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                  else None)

        def run() -> None:
            try:
                if stream is None:
                    result["value"] = self.engine.generate(*args)
                    return
                with torch.cuda.device(self.device), torch.cuda.stream(stream):
                    result["value"] = self.engine.generate(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised on the caller
                result["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            raise EngineHangError(
                f"generation round exceeded {timeout:.0f}s "
                f"(step {self.total_batch_steps}, weights v{self.weight_version})")
        if "error" in result:
            raise result["error"]
        return result["value"]

    def _generate_round(self, batch: Mapping[str, Sequence[str]],
                        sampling: SamplingConfig) -> list[dict[str, Any]]:
        """One rollout round -> candidate dicts shaped like the reference's
        ``vllm_generate`` output (distributed_actor.py:147-172): per task
        group, n candidate strings, the prompt/solution tiled x n, token
        lengths. Prompts are padded to ``batch_size`` rows (padding rows are
        discarded after), so every round has one shape."""
        problems = list(batch["problem"])
        solutions = list(batch["solution"])
        b_real = len(problems)
        b_pad = self.config.batch_size
        prompt_ids, prompt_mask = encode_fixed(
            self.tokenizer, problems + [""] * (b_pad - b_real),
            self.config.max_prompt_tokens, side="left")
        # race detector: the adapter the round samples lags the learner by no
        # more than the mode allows (sync 0, pipelined 1, async
        # max_staleness). The rollout's version is read FIRST: a learner
        # step landing between the two reads is a benign positive lag
        hold = None
        if self._ring is not None:  # holds the published copy until released
            held, rollout_version, hold = self._ring.acquire()
            model, lora = (held, None) if self._full else (self.model, held)
        else:
            (model, lora), rollout_version = self._engine_params(), self._rollout_weight_version
        driver = self._env_driver
        try:
            if self.meshes is None:  # on a mesh every rollout rank checks (_round_op)
                self._check_lag(self.weight_version, rollout_version)
            # the mailbox's swap log before dispatch, so this round's
            # in-flight swaps (and their versions) can be sliced out after
            swaps_before = len(getattr(self.engine, "last_swap_steps", ()))
            if driver is not None:
                # one environment per candidate row (padding rows get born-done
                # episodes); the driver is the engine's turn hook for the round
                driver.begin_round(problems + [""] * (b_pad - b_real),
                                   solutions + [""] * (b_pad - b_real), sampling.n)
                self.engine.turn_hook = driver
            result = self._dispatch_rollout(prompt_ids, prompt_mask, sampling, model, lora,
                                            b_real)
        except EngineHangError:
            hold = None  # the hung round still reads its adapter: the hold stays
            raise
        finally:
            if driver is not None:
                self.engine.turn_hook = None
            if hold is not None:
                self._ring.release_round(hold)
        # a degraded remote round (a quarantined shard under
        # degrade_on_poison): its rows came back zero-filled; their prompts
        # are dropped, never trained on, with exact accounting
        lost = {int(r) for r in getattr(self.engine, "last_lost_rows", ()) or ()}
        kept = [i for i in range(b_real) if i not in lost]
        if len(kept) < b_real:
            if not kept:
                raise RuntimeError("every group in the round was lost to quarantined "
                                   "shards — nothing survives to train on")
            assert len(kept) + len(lost & set(range(b_real))) == b_real  # conservation
            log.warning("dropping %d/%d group(s) lost to quarantined shards",
                        b_real - len(kept), b_real)
        n = sampling.n
        cand: dict[str, Any] = {
            "answers": [decode_batch(self.tokenizer, result.tokens[i], result.lengths[i])
                        for i in kept],
            "problem": [[problems[i]] * n for i in kept],
            "solution": [[solutions[i]] * n for i in kept],
            "token_lengths": [[int(x) for x in result.lengths[i]] for i in kept],
        }
        # the engine's own tokens and behavior logprobs (when it captures
        # them): the clip objective trains on these ids, not on retokenized
        # text, whose token boundaries can shift
        if result.logprobs is not None:
            cand["answer_tokens"] = [result.tokens[i] for i in kept]
            cand["behavior_logps"] = [result.logprobs[i] for i in kept]
            cand["gen_lengths"] = [result.lengths[i] for i in kept]
            # per-token policy-version tags (rollout/trajectory.py): the
            # round opens at the version it acquired; each in-flight swap it
            # consumed advances the tag from its recorded step on (a swap
            # pushed without a version counts one step past the one before)
            steps = list(getattr(self.engine, "last_swap_steps", ()))[swaps_before:]
            versions = list(getattr(self.engine, "last_swap_versions", ()))[swaps_before:]
            events: list[tuple[int, int]] = []
            inferred = rollout_version
            for k, step in enumerate(steps):
                v = versions[k] if k < len(versions) else None
                inferred = int(v) if v is not None else inferred + 1
                events.append((int(step), inferred))
            tags = version_tags_for_round(n, result.tokens.shape[2], rollout_version, events)
            cand["version_tags"] = [tags for _ in kept]
            cand["base_version"] = rollout_version
            cand["swap_events"] = events
        if driver is not None:
            # score the turns the engine finished without consulting the hook
            # and assemble the loss masks (1 on policy spans, 0 on injected
            # observations), the environment's (n, 2) rewards (each turn was
            # scored live: the reward pass must not score them again) and
            # the turns' provenance
            width = result.tokens.shape[-1]
            env_round = driver.finish_round(np.asarray(result.tokens).reshape(-1, width),
                                            np.asarray(result.lengths).reshape(-1))
            cand["loss_mask"] = [env_round.loss_mask[i * n:(i + 1) * n] for i in range(b_real)]
            cand["rewards"] = [env_round.group_rewards[i] for i in range(b_real)]
            cand["turns"] = [env_round.turn_provenance[i * n:(i + 1) * n]
                             for i in range(b_real)]
            cand["env_name"] = driver.env_name
            cand["env_stats"] = env_round.stats
        # pool and round stats snapshotted here, on the thread that ran the
        # round: the next round (or an eval) may overwrite the engine's
        # attributes before the update logs them
        pool = getattr(self.engine, "last_pool_stats", None)
        if pool:
            cand["pool_stats"] = dict(pool)
        rstats = getattr(self.engine, "last_round_stats", None)
        if rstats:
            cand["round_stats"] = dict(rstats)
        return [cand]

    def _compute_round_rewards(self, candidates: list[dict[str, Any]]) -> None:
        """Per-task-group (n, 2) rewards (distributed_trainer.py:205-219); an
        environment's round brings its own."""
        for cand in candidates:
            if "rewards" in cand:
                continue
            groups = [(cand["answers"][j], cand["solution"][j])
                      for j in range(len(cand["answers"]))]
            cand["rewards"] = self.rewards(groups, reward_fn=self._reward_fn)

    def _generate_all_candidates(self, batch: Mapping[str, Sequence[str]],
                                 sampling: SamplingConfig | None = None) -> list[dict[str, Any]]:
        sampling = sampling or self.config.train_sampling()
        candidates = self._generate_round(batch, sampling)
        self._compute_round_rewards(candidates)
        return candidates

    # ------------------------------------------------------------------ train

    def train(self) -> None:
        """The training run. On a learner mesh every rank calls it: rank 0
        runs the loop below and each other rank follows it (``follow``)."""
        if self.meshes is not None and self._rank != 0:
            self.follow()
            return
        with self.lead():
            self._train()

    def _train(self) -> None:
        cfg = self.config
        if self.sink is None:
            self.sink = make_sink(cfg.metrics_backend, run_name=cfg.run_name,
                                  project=cfg.project_name, config=cfg.to_flat_dict(),
                                  run_dir=cfg.run_directory if cfg.run_name else ".")
        if cfg.run_name:
            os.makedirs(cfg.run_directory, exist_ok=True)
        if cfg.async_rollout and self.device.type == "cuda" and self._rollout_stream is None:
            # the overlapped modes' rounds queue on a stream of their own
            self._rollout_stream = torch.cuda.Stream(self.device)
        try:
            self.evaluate()  # initial eval (distributed_trainer.py:241-242)
            if cfg.rollout_mode == "async":
                # the decoupled regime: RolloutService, trajectory buffer,
                # bounded-staleness learner loop
                self._train_async()
                return
            # self.episode is the next episode to start (episode-end saves
            # store episode + 1, so a finished run resumes as a no-op);
            # batch_in_episode is the mid-episode cursor: the shuffle is
            # seeded by (seed, episode), so a resumed run re-derives the
            # batch order and skips the batches already trained
            start_episode = self.episode
            gen_pool = None
            if cfg.rollout_mode == "pipelined":
                gen_pool = self._gen_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="rollout")
            for episode in range(start_episode, cfg.episodes):
                self.episode = episode
                skip = self.batch_in_episode if episode == start_episode else 0
                # a one-batch lookahead: pipelined, batch t+1's round is
                # submitted BEFORE batch t's update, so it samples one step
                # stale while the learner works; the pipeline stays within
                # the episode (batch order and resume cursor unchanged)
                stream = self._episode_batch_stream(episode, skip)
                pending = next(stream, None)
                gen_future = None
                if gen_pool is not None and pending is not None:
                    gen_future = self._submit_round(gen_pool, pending[1])
                while pending is not None:
                    bi, batch = pending
                    pending = next(stream, None)
                    next_future = None
                    if gen_pool is not None and pending is not None:
                        next_future = self._submit_round(gen_pool, pending[1])
                    self._train_batch(batch, episode, gen_future=gen_future)
                    gen_future = next_future
                    self.batch_in_episode = bi + 1
                    if cfg.eval_every and self.total_batch_steps % cfg.eval_every == 0:
                        if gen_future is not None:
                            # the round in flight drains first: an eval beside
                            # it would hold two decode states at once and skew
                            # both timings
                            concurrent.futures.wait([gen_future])
                        self.evaluate()
                    if cfg.save_every and self.total_batch_steps % cfg.save_every == 0:
                        self.save_checkpoint()
                        if cfg.export_hf_snapshots and cfg.run_name:
                            self.export_hf_snapshot()
                self.episode = episode + 1
                self.batch_in_episode = 0
                self.save_checkpoint()
                if cfg.export_hf_snapshots and cfg.run_name:
                    self.export_hf_snapshot()
        except EngineHangError:
            # last-gasp state capture so the documented restart path
            # (resume=True) continues from the last completed step
            log.exception("generation round hung; checkpointing before exit")
            self.save_checkpoint()
            raise
        finally:
            service = self._rollout_service
            if service is not None:
                # closes the buffer and stops after the round in flight; never
                # joins a possibly hung round (the recovery unit is the process)
                service.stop()
                self._rollout_service = None
            if self._gen_pool is not None:
                # never join a possibly hung round, and cancel a queued one:
                # started against a hung engine it would wedge the exit
                self._gen_pool.shutdown(wait=False, cancel_futures=True)
                self._gen_pool = None
            self.sink.finish()
            self.rewards.close()

    def _submit_round(self, pool, batch) -> concurrent.futures.Future:
        return pool.submit(self._on_rollout_stream, self._generate_round, batch,
                           self.config.train_sampling())

    def _episode_batch_stream(self, episode: int, skip: int):
        """One episode's (batch_index, batch) stream: the single owner of
        the per-episode shuffle seed and the resume skip."""
        cfg = self.config
        dataset = self.train_dataset.shuffle(seed=cfg.seed + 1000 * episode)
        for bi, b in enumerate(dataset.iter(cfg.batch_size)):
            if bi >= skip:
                yield bi, b

    def _train_batch(self, batch: Mapping[str, Sequence[str]], episode: int,
                     gen_future: concurrent.futures.Future | None = None) -> None:
        timer = telemetry.PhaseSpans()
        with timer("generation"):
            # ends on host tokens: the round's device work is done. Pipelined
            # hands in the round's future: the phase then records the time
            # the learner was blocked (the overlap hides the rest)
            if gen_future is not None:
                candidates = gen_future.result()
            else:
                candidates = self._generate_round(batch, self.config.train_sampling())
        self._update_on_candidates(candidates, episode, timer,
                                   n_samples=len(batch["problem"]))

    # -------------------------------------------------------------- async RL

    def _episode_batches(self, start_episode: int, start_batch: int):
        """(episode, batch_index, batch) in exactly the sync loop's order: the
        async regime changes when batches train, never which ones."""
        for episode in range(start_episode, self.config.episodes):
            skip = start_batch if episode == start_episode else 0
            for bi, b in self._episode_batch_stream(episode, skip):
                yield episode, bi, b

    def _train_async(self) -> None:
        """The decoupled regime (JAX ``trainer.py:1601-1776``): a
        ``RolloutService`` thread generates continuously, on the rollout
        stream, into a bounded ``TrajectoryBuffer`` while this loop pulls
        ``batch_size`` groups an update. Staleness control is layered: the
        buffer evicts queued groups already beyond ``max_staleness`` (drop
        policy), the ``StalenessPolicy`` drops or down-weights at admission,
        and the AIPO objective masks per token by version lag. Every drop is
        counted."""
        from distrl_llm_tpu_torch.distributed.resilience import RetryPolicy
        from distrl_llm_tpu_torch.rollout import (
            RolloutService, StalenessPolicy, TrajectoryBuffer, round_to_trajectories,
            trajectories_to_candidates,
        )

        cfg = self.config
        # capacity floor 2 x the pull: a get_batch(batch_size) must always be
        # satisfiable below the backpressure gate, or the learner and a gated
        # producer would wait on each other
        capacity = max(cfg.rollout_buffer_groups or 4 * cfg.batch_size, 2 * cfg.batch_size)
        buffer = self._rollout_buffer = TrajectoryBuffer(capacity)
        policy = self._staleness_policy = StalenessPolicy(
            cfg.max_staleness, mode=cfg.staleness_policy, downweight=cfg.staleness_downweight)
        self._rollout_dropped_stale = 0
        start_episode, start_batch = self.episode, self.batch_in_episode
        restored = self._resume_rollout_state
        if restored:
            # the unconsumed trajectories and the producer's cursor
            buffer.load_state(restored.get("buffer", {}))
            cursor = restored.get("cursor")
            if cursor is not None:
                start_episode, start_batch = int(cursor[0]), int(cursor[1])
            policy.dropped = int(restored.get("policy_dropped", 0))
            policy.admitted = int(restored.get("policy_admitted", 0))
            self._rollout_dropped_stale = buffer.dropped_stale + policy.dropped

        def produce(episode: int, bi: int, batch) -> list:
            [cand] = self._on_rollout_stream(self._generate_round, batch, cfg.train_sampling())
            return round_to_trajectories(
                cand, base_version=cand.get("base_version", self._rollout_weight_version),
                swap_events=cand.get("swap_events", ()), episode=episode, batch_index=bi)

        service = self._rollout_service = RolloutService(
            produce, buffer, self._episode_batches(start_episode, start_batch),
            max_restarts=cfg.producer_restarts,
            retry_policy=RetryPolicy(base_s=cfg.rpc_backoff_s, seed=cfg.seed))
        service.start()
        while True:
            timer = telemetry.PhaseSpans()
            if cfg.staleness_policy == "drop":
                # groups admission would reject go before they cost an update;
                # not under downweight, whose admission trains them
                buffer.evict_stale(self.weight_version, policy.max_staleness)
            with timer("generation"):
                # the learner's time blocked on the buffer
                groups = buffer.get_batch(cfg.batch_size)
            service.raise_if_failed()
            if not groups:
                break  # producer done and buffer drained
            kept, weights = policy.admit(groups, self.weight_version)
            self._rollout_dropped_stale = buffer.dropped_stale + policy.dropped
            if not kept:
                continue
            cand = trajectories_to_candidates(kept, weights)
            episode = kept[0].episode
            self.episode = episode
            # metrics only: a save stores the producer's cursor and the buffer
            self.batch_in_episode = kept[-1].batch_index + 1
            self._update_on_candidates([cand], episode, timer, n_samples=len(kept))
            if cfg.eval_every and self.total_batch_steps % cfg.eval_every == 0:
                # the engine is not re-entrant: the producer parks at its next
                # round boundary while the eval runs
                service.pause()
                try:
                    self.evaluate()
                finally:
                    service.resume()
            if cfg.save_every and self.total_batch_steps % cfg.save_every == 0:
                self.save_checkpoint()
                if cfg.export_hf_snapshots and cfg.run_name:
                    self.export_hf_snapshot()
        service.raise_if_failed()
        self.episode = cfg.episodes
        self.batch_in_episode = 0
        self.save_checkpoint()
        if cfg.export_hf_snapshots and cfg.run_name:
            self.export_hf_snapshot()

    def _update_on_candidates(self, candidates: list[dict[str, Any]], episode: int,
                              timer: telemetry.PhaseSpans, n_samples: int) -> None:
        """Everything after generation: rewards, shaping, the optimizer step,
        the weight push and the metrics record."""
        cfg = self.config
        with timer("reward"):
            self._compute_round_rewards(candidates)

        if cfg.print_samples and candidates and candidates[0]["answers"]:
            # sample dump parity (distributed_trainer.py:297-299)
            c = candidates[0]
            log.info("sample problem: %.200s", c["problem"][0][0])
            log.info("sample completion: %.400s", c["answers"][0][0])
            log.info("sample reward: %s", np.asarray(c["rewards"][0])[0])

        # mean rollout-time logprob of the sampled tokens (when the engine
        # captures them): a steadily rising value = the policy concentrating
        extra_metrics: dict[str, float] = {}
        if candidates and "behavior_logps" in candidates[0]:
            tot, cnt = 0.0, 0
            for cand in candidates:
                for lp_g, len_g in zip(cand["behavior_logps"], cand["gen_lengths"]):
                    lp, ln = np.asarray(lp_g), np.asarray(len_g)
                    m = np.arange(lp.shape[1])[None, :] < ln[:, None]
                    tot += float(lp[m].sum())
                    cnt += int(m.sum())
            if cnt:
                extra_metrics["mean_behavior_logprob"] = tot / cnt

        # baselines / GRPO advantages and the metric lists
        # (distributed_trainer.py:262-279), then top-k (:281-294)
        stats = shape_rewards(candidates, cfg.learner)
        if cfg.topk < cfg.num_candidates:
            topk_filter(candidates, cfg.topk)

        with timer("update"):
            problems, answers, coeffs, raw = flatten_for_update(candidates, cfg.learner)
            if cfg.clip_ratio > 0.0 and raw is None:
                raise RuntimeError(
                    "clip_ratio requires engine-captured behavior logprobs; "
                    "this engine returned none (GenerationResult.logprobs)")
            arrays = update_arrays(
                self.tokenizer, problems, answers, coeffs,
                max_prompt_tokens=cfg.max_prompt_tokens,
                max_new_tokens=cfg.max_new_tokens,
                raw_rollout=raw if cfg.clip_ratio > 0.0 else None,
                answer_buckets=cfg.learner_len_buckets or None,
                prompt_buckets=cfg.learner_prompt_buckets or None,
                # async: per-token version lag (learner version minus each
                # token's sampling version) feeds AIPO's staleness mask
                current_version=self.weight_version if cfg.rollout_mode == "async" else None,
            )
            answer_width = int(arrays["answer_ids"].shape[1])
            prompt_width = int(arrays["prompt_ids"].shape[1])
            # LoRA dropout draws a fresh seed per update
            dropout_seed = self._next_rng() if cfg.lora_dropout > 0.0 else None
            # ends the phase on finished device work: the loss's copy to the
            # host waits for every kernel before it on the stream, the
            # optimizer's included
            loss = self._collective("update", (arrays, dropout_seed))
        self.weight_version += 1
        self._push_weights()
        if cfg.inflight_weight_updates:
            # the fresh adapter goes to the round in flight, which swaps at its
            # next step or chunk boundary; the version rides along so the round
            # tags every later position with the policy that sampled it
            self.engine.push_lora(self._lora_rollout, version=self.weight_version)
        if cfg.write_adapter_file:
            self.save_adapter()

        self.total_batch_steps += 1
        self.total_samples_processed += n_samples
        metrics = {
            "loss": loss,
            "mean_accuracy_reward": float(np.mean(stats.mean_acc)),
            "min_accuracy_reward": float(np.mean(stats.min_acc)),
            "max_accuracy_reward": float(np.mean(stats.max_acc)),
            "mean_format_reward": float(np.mean(stats.mean_format)),
            "mean_token_length": float(np.mean(stats.mean_token_length)),
            "episode": episode,
            "total_batch_steps": self.total_batch_steps,
            "total_samples_processed": self.total_samples_processed,
            # rollout-regime provenance on every record: the mode, its
            # staleness bound, cumulative stale drops (none when synchronous)
            "rollout_mode": cfg.rollout_mode,
            "max_staleness": cfg.allowed_weight_lag,
            "rollout_dropped_stale": self._rollout_dropped_stale,
        }
        if cfg.learner_len_buckets:
            metrics["learner/answer_width"] = answer_width
        if cfg.learner_prompt_buckets:
            metrics["learner/prompt_width"] = prompt_width
        # page pressure and preemptions of the paged engine's round; a stat
        # the engine did not produce is skipped, not logged as None
        pool = next((c["pool_stats"] for c in candidates if "pool_stats" in c), None)
        if pool:
            for name, key in (("pool/pages", "pool_pages"),
                              ("pool/peak_pages_used", "peak_pages_used"),
                              ("pool/preemptions", "preemptions")):
                if pool.get(key) is not None:
                    metrics[name] = pool[key]
        # an environment's rounds: the turn and tool series the driver
        # assembled; a batch the async learner pulled carries only the turns'
        # provenance, from which the turn counts follow
        env_stats = next((c["env_stats"] for c in candidates if "env_stats" in c), None)
        if env_stats is not None:
            metrics["env/turns_mean"] = env_stats.turns_mean
            metrics["env/turns_max"] = env_stats.turns_max
            metrics["env/step_ms_p50"] = env_stats.env_step_ms_p50
            metrics["env/round_tool_calls"] = env_stats.tool_calls
            metrics["env/round_resume_declined"] = env_stats.resume_declined
        elif any("turns" in c for c in candidates):
            counts = _env_turn_counts(candidates)
            if counts:
                metrics["env/turns_mean"] = float(np.mean(counts))
                metrics["env/turns_max"] = int(np.max(counts))
        metrics.update(self._engine_metrics(candidates))
        metrics.update(extra_metrics)
        metrics.update(timer.metrics())
        # the registry's series (rollout/buffer_occupancy, rollout/staleness,
        # ...) ride the same record
        metrics.update(telemetry.metrics_snapshot())
        self.sink.log(metrics, step=self.total_batch_steps)

    def _engine_metrics(self, candidates) -> dict[str, float]:
        """engine/prefill_tok_s and engine/decode_tok_s from the round stats
        the engines record (``accumulate_round_stats``). The JAX package's
        engine/mfu needs a table of device peaks (ROADMAP queue 1 item 11)."""
        stats = next((c["round_stats"] for c in candidates if "round_stats" in c), None)
        if not stats:
            return {}
        out: dict[str, float] = {}
        if stats["prefill_s"] > 0 and stats["prefill_tokens"]:
            out["engine/prefill_tok_s"] = stats["prefill_tokens"] / stats["prefill_s"]
        if stats["decode_s"] > 0 and stats["gen_tokens"]:
            out["engine/decode_tok_s"] = stats["gen_tokens"] / stats["decode_s"]
        return out

    # ------------------------------------------------------------------- eval

    def evaluate(self) -> dict[str, float]:
        """Best-of-n eval (distributed_trainer.py:384-416): pass@1 = mean
        accuracy over candidates, BoN = max; the rollout path with the eval
        sampling parameters."""
        cfg = self.config
        timer = telemetry.PhaseSpans()
        accs, bons, tok_lens = [], [], []
        with timer("eval"):
            for batch in self.test_dataset.iter(cfg.batch_size):
                for cand in self._generate_all_candidates(batch, cfg.eval_sampling()):
                    for rewards, lengths in zip(cand["rewards"], cand["token_lengths"]):
                        acc = np.asarray(rewards)[:, 1]
                        accs.append(float(np.mean(acc)))
                        bons.append(float(np.max(acc)))
                        tok_lens.append(float(np.mean(lengths)))
        n = cfg.eval_n
        metrics = {
            f"eval/pass@1(mean{n})": float(np.mean(accs)),
            f"eval/BoN({n})": float(np.mean(bons)),
            "eval/mean_token_length": float(np.mean(tok_lens)),
            **timer.metrics(),
        }
        if self.sink is not None:
            self.sink.log(metrics, step=self.total_batch_steps)
        return metrics
