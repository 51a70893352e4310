"""Typed configuration: sampling parameters and the trainer's config.

The part of the JAX package's ``config.py`` the synchronous trainer reads:
``SamplingConfig``, ``parse_buckets`` and ``TrainConfig`` with the fields
of the reference CLI contract and the knobs of the ported paths (dtype and
base quantization, the engines, the learner, checkpointing, metrics). Field
names, defaults and validation rules are the JAX package's. A value that
only an unported path accepts raises ``NotImplementedError`` naming its
ROADMAP item. The flags of planes that are not ported (observability,
control, lineage, gateway, the elastic fleet, autotune) are not fields
here. ``MeshConfig`` carves the ranks of a ``torch.distributed`` job into
rollout and learner roles (ROADMAP item 10a: dp and fsdp); tensor and
sequence parallelism, and a mesh under the overlapped modes, remote workers
or multi-turn environments, are item 10b.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


#: every top-p filter name the JAX package knows (ops/sampling.py TOP_P_IMPLS);
#: the port implements all three (ops/sampling.py)
TOP_P_IMPL_NAMES = ("exact", "bisect", "bisect_mw")

_ITEM_10B = "ROADMAP queue 1 item 10b: tensor and sequence parallelism"


@dataclass
class SamplingConfig:
    """Sampling parameters for a generation round: train-time 1.2/0.95,
    eval-time 0.6/0.95, ``n`` candidates per prompt."""

    max_tokens: int = 1200
    temperature: float = 1.2
    top_p: float = 0.95
    n: int = 16  # candidates per prompt
    # top-p filter: False = sort-free bisection (the fused kernel),
    # True = exact rank-based sort filter (reference vLLM semantics)
    top_p_exact: bool = False
    # explicit filter name (one of TOP_P_IMPL_NAMES); None derives from
    # top_p_exact
    top_p_impl: str | None = None

    def resolved_top_p_impl(self) -> str:
        """Effective top-p implementation. Priority: an explicit
        ``top_p_impl`` pin, then ``top_p_exact``, then "bisect" (the JAX
        package's autotune plan default has no counterpart here)."""
        if self.top_p_impl:  # "" and None both mean "derive"
            if self.top_p_impl not in TOP_P_IMPL_NAMES:
                raise ValueError(
                    f"top_p_impl must be one of {sorted(TOP_P_IMPL_NAMES)}, "
                    f"got {self.top_p_impl!r}"
                )
            return self.top_p_impl
        return "exact" if self.top_p_exact else "bisect"

    def replace(self, **kw) -> "SamplingConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class MeshConfig:
    """How ranks are carved into roles and parallelism axes (the JAX
    package's ``MeshConfig``, config.py:88-111): the first
    ``number_of_actors`` data-parallel groups of ``tp * sp * fsdp`` ranks
    are rollout ranks, the next ``number_of_learners`` groups learner ranks.
    With fewer ranks than roles (one card) the roles time-share them."""

    number_of_actors: int = 2
    number_of_learners: int = 1
    tp: int = 1  # tensor-parallel size within each role group (item 10b)
    sp: int = 1  # sequence-parallel (ring attention) size (item 10b)
    fsdp: int = 1  # sharding of the learner state
    allow_timeshare: bool = True

    @property
    def num_roles(self) -> int:
        return self.number_of_actors + self.number_of_learners


# the capacity a full-FT config is held to when no card is visible: the
# NVIDIA H100 80GB the port runs on
DEFAULT_CARD_BYTES = 80 * 10**9
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def full_finetune_bytes(model_cfg, dtype: str = "bfloat16", fsdp: int = 1) -> dict[str, int]:
    """Device bytes one rank holds for full fine-tuning of ``model_cfg`` (P
    parameters) with the learner state sharded over ``fsdp`` ranks: the f32
    master weights (4 P), their f32 grads (4 P) and Adam8bit's two int8
    moments with one f32 scale per 256-element block (2 P + P / 32), each
    divided by ``fsdp``, and the rollout copy at ``dtype``, whole on every
    rollout rank (the JAX trainer.py:298-322 and :939-943 layout); about
    12 P bytes at bf16 on one rank."""
    p = model_cfg.param_count
    out = {"masters": 4 * p // fsdp, "grads": 4 * p // fsdp,
           "moments": (2 * p + p // 32) // fsdp, "rollout": _DTYPE_BYTES[dtype] * p}
    out["total"] = sum(out.values())
    return out


def check_full_finetune_fits(model_cfg, dtype: str = "bfloat16", name: str = "this model",
                             hbm_bytes: int | None = None, fsdp: int = 1) -> None:
    """Raise ``ValueError`` when one rank's share of full fine-tuning's state
    (``full_finetune_bytes`` at ``fsdp``) and the learner's workspace (the
    share of the card ``engine/budget.py`` keeps for activations,
    ``ACTIVATION_RESERVE``) exceed one card of ``hbm_bytes`` (default
    ``DEFAULT_CARD_BYTES``)."""
    from distrl_llm_tpu_torch.engine.budget import ACTIVATION_RESERVE

    hbm = DEFAULT_CARD_BYTES if hbm_bytes is None else hbm_bytes
    need = full_finetune_bytes(model_cfg, dtype, fsdp)["total"]
    if need + ACTIVATION_RESERVE * hbm > hbm:
        raise ValueError(
            f"full_finetune of {name} ({model_cfg.param_count / 1e9:.2f} B parameters) "
            f"at fsdp={fsdp} needs {need / 1e9:.1f} GB a rank of f32 masters, grads, 8-bit "
            f"moments and the {dtype} rollout copy, plus the learner's workspace: more "
            f"than one card of {hbm / 1e9:.1f} GB; shard the learner state over more "
            "ranks (mesh.fsdp)")


def check_mesh_supported(config: "TrainConfig") -> None:
    """Raise ``NotImplementedError`` naming ROADMAP item 10b for what a
    learner mesh does not run yet: the overlapped rollout modes, remote
    rollout workers and multi-turn environments."""
    for bad, what in ((config.rollout_mode != "sync", f"rollout_mode={config.rollout_mode!r}"),
                      (bool(config.rollout_workers), "rollout_workers"),
                      (config.env != "math", f"env={config.env!r}")):
        if bad:
            raise NotImplementedError(
                f"{what} on a learner mesh is not ported yet ({_ITEM_10B}, and a mesh "
                "under the overlapped modes, remote workers or multi-turn envs)")


def parse_buckets(spec: str | None, field: str = "prompt_buckets") -> tuple[int, ...]:
    """Parse a comma-separated bucket list ("128,256") into a tuple; ``field``
    names the flag in the error message."""
    if not spec:
        return ()
    try:
        return tuple(int(x) for x in str(spec).split(",") if x.strip())
    except ValueError as e:
        raise ValueError(
            f"{field} must be comma-separated integers, got {spec!r}"
        ) from e


@dataclass
class TrainConfig:
    """Training configuration. Field names and defaults follow the reference
    CLI (train_distributed.py:10-35) and the JAX package."""

    # --- reference CLI contract -------------------------------------------
    model: str = "Qwen/Qwen2.5-7B-Instruct"
    dataset: str = "HuggingFaceH4/MATH-500"
    run_name: str | None = None
    project_name: str = "math-reasoning"
    lora_save_path: str = "lora_request_math"
    lr: float = 2e-5
    max_new_tokens: int = 1200
    max_prompt_tokens: int = 350
    temperature: float = 1.2
    episodes: int = 15
    num_candidates: int = 16
    batch_size: int = 30
    learner_chunk_size: int = 8
    train_batch_size: int = 8
    save_every: int = 100
    eval_every: int = 10
    number_of_actors: int = 2
    number_of_learners: int = 1
    learner: str = "pg"  # {"pg", "grpo"}
    max_lora_rank: int = 32
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    topk: int = 16
    # device-memory fraction for weights + KV (vLLM gpu_memory_utilization):
    # sizes the paged engine's KV page pool (engine/budget.py); the learner
    # fraction applies when the engine and the learner share the card
    actor_gpu_usage: float = 0.91
    learner_gpu_usage: float = 0.35

    # --- the ported paths' knobs --------------------------------------------
    seed: int = 3407  # the reference's random_state (helper.py:43)
    dtype: str = "bfloat16"
    # weight-only quantization of the frozen base: {"none","int8","int4"}
    # (the reference's 4-bit base is LOAD_IN_4BIT)
    base_quant: str = "none"
    # group size along the input dim for base_quant; None = per-format
    # default (int8 per column, int4 64)
    quant_group_size: int | None = None
    # 8-bit blockwise Adam state (the reference's bnb.optim.Adam8bit)
    optimizer_8bit: bool = True
    # skip microbatches whose coefficients are all zero (the reference's
    # intent); False = skip when any is zero (its `.all() == 0` bug)
    skip_all_zero_reward_batches: bool = True
    eval_temperature: float = 0.6
    eval_top_p: float = 0.95
    eval_n: int = 8
    # exact sort-based nucleus filter instead of the bisection filter
    top_p_exact: bool = False
    # learner logprobs: lm_head + logsumexp per chunk of this many answer
    # positions (0 = dense)
    logprob_chunk: int = 128
    # full-rank fine-tuning (BASELINE config 3): the whole model trains as
    # f32 master weights, sharded over mesh.fsdp ranks
    full_finetune: bool = False
    # prompt length buckets for the rollout engine; empty = one bucket
    prompt_buckets: tuple[int, ...] = ()
    # answer / prompt length buckets for the learner's update batch
    learner_len_buckets: tuple[int, ...] = ()
    learner_prompt_buckets: tuple[int, ...] = ()
    # rollout engine: "dense", "paged", or "paged_sharded" (the paged wave
    # engine with the round's rows split over the rollout ranks)
    engine_impl: str = "dense"
    # KV cache format: None or "none" (the cache dtype) or "int8"
    kv_cache_quant: str | None = None
    # decode steps per dispatch: k > 1 runs k-step chunks, each a CUDA graph
    # replay on the GPU (the dense engine, the paged wave scheduler, and the
    # refill scheduler's plain, speculative and self-drafted steps, where k
    # rounds down to a divisor of its host cadence)
    decode_scan_chunk: int | None = None
    # cap on concurrent candidate rows (vLLM max_num_seqs); 0 = unlimited
    max_concurrent_sequences: int = 0
    # the paged engine's refill scheduler (continuous batching)
    continuous_batching: bool = False
    # copy-on-write prompt-prefix sharing on the refill scheduler: a
    # group's candidates alias one refcounted prompt page chain
    prefix_sharing: bool = False
    # a group request queue with lazy per-group prefill into pool pages
    # (implies prefix_sharing)
    continuous_admission: bool = False
    # the radix prefix cache across rounds (needs continuous_admission and
    # an unquantized pool); None = unset, an explicit bool pins
    prefix_cache: bool | None = None
    # park preempted and evicted KV pages in host memory (needs
    # prefix_cache, excludes spec_draft); the store's cap in MiB (0 = none)
    kv_spill: bool = False
    kv_spill_host_mb: int = 0
    # speculative decoding on the refill scheduler: the draft length, the
    # n-gram size, the drafter ("ngram" or "self", the previous adapter),
    # the verify sweep ("fused" K5 or "unrolled" K2) and the adaptive draft
    # length
    spec_draft: int | None = None
    spec_ngram: int | None = None
    spec_drafter: str | None = None
    spec_verify: str | None = None
    spec_adapt: bool = False
    # PPO-clip epsilon (0 = the reference's objective); > 0 trains on the
    # engine's tokens against its captured behavior logprobs
    clip_ratio: float = 0.0
    # KL(pi || pi_ref) coefficient, pi_ref the frozen base
    kl_coeff: float = 0.0
    # rollout/learner coupling: "sync" (generation and learning serialize),
    # "pipelined" (batch t+1 generates while batch t updates, one step
    # stale), "async" (a producer thread fills a bounded trajectory buffer,
    # the learner pulls on its own cadence, staleness bounded by
    # max_staleness and corrected by the AIPO objective; needs clip_ratio)
    rollout_mode: str = "sync"
    # async staleness bound K: a group whose tokens all lag the learner by
    # more than K steps is dropped (or down-weighted: staleness_policy);
    # sync and pipelined derive their allowed lag (0 / 1) from the mode
    max_staleness: int = 2
    # async trajectory-buffer capacity in task groups; 0 = 4 x batch_size,
    # floor 2 x batch_size (a pull of batch_size must fit below the gate)
    rollout_buffer_groups: int = 0
    # a pulled group beyond max_staleness: "drop" or "downweight" (its
    # update coefficients scaled by staleness_downweight^(lag - K))
    staleness_policy: str = "drop"
    staleness_downweight: float = 0.5
    # AIPO's cap on the per-token importance ratio (async)
    rollout_is_cap: float = 2.0
    # the old spelling of rollout_mode="pipelined"; after __post_init__ it
    # reads as rollout_mode != "sync"
    async_rollout: bool = False
    # push each optimizer step's adapter into the round in flight (the
    # engine swaps at its next step or chunk boundary); needs an overlapped
    # mode and clip_ratio > 0
    inflight_weight_updates: bool = False
    # control-plane rollout workers ("host:port", ...): generation goes to
    # these worker processes (distributed/worker_main.py) over the C++
    # control plane instead of a local engine, which from_pretrained then
    # does not build; the learner runs here
    rollout_workers: tuple[str, ...] = ()
    # the driver's word that every worker was started with
    # --capture-logprobs (clip_ratio > 0 and async over workers need them)
    workers_capture_logprobs: bool = False
    # learner -> worker adapter transport: "broadcast" ships each optimizer
    # step's adapter once per version over the versioned weight bus
    # (delta-encoded out-of-band pushes; dispatches carry a version); it is
    # what delivers in-flight updates to workers. "dispatch" ships the
    # adapter in every shard
    weight_bus: str = "broadcast"
    # re-dial unhealthy workers with seeded backoff and re-admit them cold
    worker_rejoin: bool = True
    # transient worker errors retry this many times on the same worker with
    # seeded exponential backoff (base rpc_backoff_s, which the async
    # producer's restarts also use) before the shard is requeued
    rpc_retries: int = 2
    rpc_backoff_s: float = 0.25
    # a shard failing on this many distinct workers is quarantined
    poison_shard_k: int = 3
    # on a quarantined shard, drop its prompts (counted in
    # cp/degraded_groups) instead of failing the round
    degrade_on_poison: bool = False
    # the async producer's restart budget, with seeded exponential backoff
    # from rpc_backoff_s
    producer_restarts: int = 2
    # per-update sample dump (distributed_trainer.py:297-299)
    print_samples: bool = True
    # HF-format merged-model snapshots at run_dir/model_{step}; needs
    # run_name and an unquantized base
    export_hf_snapshots: bool = False
    checkpoint_dir: str | None = None
    resume: bool = False
    metrics_backend: str = "auto"  # {"auto","wandb","jsonl","null"}
    # attention for the learner and the prefill: "reference", "flash",
    # "splash" (kernel K4 on the GPU); "ring"/"ulysses": item 10b
    attn_impl: str = "reference"
    write_adapter_file: bool = False  # the reference's per-step adapter file
    # hang detector on generation rounds, seconds (0 = off; the reference's
    # ray.get(timeout=240))
    generation_timeout_s: float = 0.0
    # rollout environment: "math" (single-turn, the reference's task),
    # "code" (sandboxed <tool> execution, its output fed back) or
    # "verifier" (a critique and a retry, the improvement rewarded). The
    # multi-turn environments step between the turns of the paged refill
    # engine, whose turn hook continues each conversation on its resident
    # KV; the injected tokens are loss-masked in the learner
    env: str = "math"
    # conversation turns per episode of a multi-turn environment ("math" is
    # single-turn: > 1 there is a dead flag, refused)
    max_turns: int = 1
    # format-reward gate: "soft" (the reference's) or "strict"
    format_reward: str = "soft"
    # ranks -> roles and parallelism axes; its role counts follow
    # number_of_actors / number_of_learners
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def __post_init__(self):
        if self.learner not in ("pg", "grpo"):
            raise ValueError(f"learner must be 'pg' or 'grpo', got {self.learner!r}")
        if self.rollout_mode not in ("sync", "pipelined", "async"):
            raise ValueError(
                f"rollout_mode must be sync/pipelined/async, got {self.rollout_mode!r}")
        # async_rollout is the old spelling of rollout_mode="pipelined";
        # afterwards it reads as "any overlapped mode"
        if self.async_rollout and self.rollout_mode == "sync":
            self.rollout_mode = "pipelined"
        self.async_rollout = self.rollout_mode != "sync"
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {self.max_staleness}")
        if self.staleness_policy not in ("drop", "downweight"):
            raise ValueError(
                f"staleness_policy must be drop/downweight, got {self.staleness_policy!r}")
        if self.rollout_buffer_groups < 0:
            raise ValueError(
                f"rollout_buffer_groups must be >= 0, got {self.rollout_buffer_groups}")
        if self.rollout_mode == "async":
            if self.clip_ratio <= 0:
                raise ValueError(
                    "rollout_mode='async' requires clip_ratio > 0: the bounded-staleness "
                    "regime trains on trajectories up to max_staleness optimizer steps "
                    "old, and the truncated-IS correction consumes the engine-captured "
                    "behavior logprobs that clip_ratio enables")
            if self.max_staleness < 1:
                raise ValueError(
                    "rollout_mode='async' requires max_staleness >= 1 (0 would drop every "
                    "trajectory the moment the learner steps; use rollout_mode='sync' for "
                    "strict on-policy)")
        if self.base_quant not in ("none", "int8", "int4"):
            raise ValueError(f"base_quant must be none/int8/int4, got {self.base_quant!r}")
        if self.engine_impl not in ("dense", "paged", "paged_sharded"):
            raise ValueError(
                f"engine_impl must be dense/paged/paged_sharded, got {self.engine_impl!r}")
        if self.kv_cache_quant not in (None, "none", "int8"):
            raise ValueError(
                f"kv_cache_quant must be none/int8 (or unset), got {self.kv_cache_quant!r}")
        if self.quant_group_size is not None and self.quant_group_size < 1:
            raise ValueError(f"quant_group_size must be >= 1, got {self.quant_group_size}")
        if self.quant_group_size is not None and self.base_quant == "none":
            raise ValueError(
                "quant_group_size configures base_quant's groupwise scales "
                "— set base_quant int8/int4 (it would be silently ignored)")
        if self.full_finetune and self.base_quant != "none":
            raise ValueError(
                "full_finetune trains the base weights — they cannot be "
                "quantized (base_quant must be 'none')")
        if self.full_finetune and self.write_adapter_file:
            raise ValueError(
                "full_finetune has no LoRA adapter to export; use "
                "export_hf_snapshots for full-model artifacts")
        if self.full_finetune and self.lora_dropout:
            raise ValueError(
                "full_finetune has no adapter for lora_dropout to act on — "
                "set lora_dropout=0")
        if self.full_finetune and self.kl_coeff:
            raise ValueError(
                "kl_coeff uses the frozen base as the reference policy — "
                "full_finetune has no frozen base (keep a LoRA run, or 0)")
        if self.full_finetune and self.rollout_workers:
            raise ValueError(
                "full_finetune cannot ship full weights to rollout_workers "
                "(workers receive adapters only); run local rollout")
        if self.weight_bus not in ("broadcast", "dispatch"):
            raise ValueError(
                f"weight_bus must be 'broadcast' or 'dispatch', got {self.weight_bus!r}")
        if self.inflight_weight_updates:
            if not self.async_rollout:
                raise ValueError(
                    "inflight_weight_updates requires async_rollout (there must be an "
                    "in-flight generation round to update)")
            if self.clip_ratio <= 0:
                raise ValueError(
                    "inflight_weight_updates requires clip_ratio > 0: tokens sampled "
                    "pre-swap are off-policy for the update, and the clip objective is "
                    "the correction that consumes their captured behavior logprobs")
            if self.full_finetune:
                raise ValueError(
                    "inflight_weight_updates requires a LoRA run (full_finetune swaps "
                    "the whole param tree, not an adapter)")
            if self.rollout_workers and self.weight_bus != "broadcast":
                raise ValueError(
                    "inflight_weight_updates over rollout_workers requires "
                    "weight_bus='broadcast' (the weight bus delivers mid-round adapters "
                    "to workers; 'dispatch' ships weights only at round entry)")
        if self.clip_ratio > 0 and self.rollout_workers and not self.workers_capture_logprobs:
            raise ValueError(
                "clip_ratio > 0 with rollout_workers requires workers started with "
                "--capture-logprobs AND --workers_capture_logprobs on the driver")
        if self.rpc_retries < 0:
            raise ValueError(f"rpc_retries must be >= 0, got {self.rpc_retries}")
        if self.poison_shard_k < 1:
            raise ValueError(f"poison_shard_k must be >= 1, got {self.poison_shard_k}")
        if self.rollout_workers and (
            self.kv_cache_quant not in (None, "none") or self.engine_impl != "dense"
        ):
            raise ValueError(
                "engine_impl/kv_cache_quant are local-engine knobs; with "
                "rollout_workers, configure the workers via worker_main flags")
        if self.rpc_backoff_s < 0:
            raise ValueError(f"rpc_backoff_s must be >= 0, got {self.rpc_backoff_s}")
        if self.producer_restarts < 0:
            raise ValueError(f"producer_restarts must be >= 0, got {self.producer_restarts}")
        if self.decode_scan_chunk is not None and self.decode_scan_chunk < 0:
            raise ValueError(f"decode_scan_chunk must be >= 0, got {self.decode_scan_chunk}")
        from distrl_llm_tpu_torch.env.registry import env_names

        if self.env not in env_names():
            raise ValueError(f"env must be one of {', '.join(env_names())}, got {self.env!r}")
        if self.max_turns < 1:
            raise ValueError(f"max_turns must be >= 1, got {self.max_turns}")
        if self.format_reward not in ("soft", "strict"):
            raise ValueError(
                f"format_reward must be 'soft' or 'strict', got {self.format_reward!r}")
        if self.env == "math" and self.max_turns > 1:
            raise ValueError(
                "max_turns > 1 is a dead flag with env='math' (single-turn by "
                "construction) — pick env='code' or env='verifier'")
        if self.env != "math":
            # the turn hook lives in the refill scheduler's idle pass, and a
            # continuing conversation stays on its resident KV
            if not (self.continuous_batching and self.continuous_admission):
                raise ValueError(
                    f"env={self.env!r} (multi-turn) requires continuous_batching + "
                    "continuous_admission: turn continuations run on the refill "
                    "scheduler's slots over resident KV")
            if self.engine_impl != "paged":
                raise ValueError(
                    f"env={self.env!r} requires engine_impl='paged' (the turn hook "
                    "lives on the paged refill engine)")
            if self.spec_draft:
                raise ValueError(
                    f"env={self.env!r} is incompatible with spec_draft: the turn hook "
                    "and the speculative resume contend for the same slot state")
            if self.rollout_workers:
                raise ValueError(
                    f"env={self.env!r} runs driver-local only: rollout_workers have no "
                    "turn hook")
        if self.continuous_batching and (
            self.engine_impl != "paged" or not self.max_concurrent_sequences
        ):
            raise ValueError(
                "continuous_batching requires engine_impl='paged' and a "
                "max_concurrent_sequences cap (the decode slot count)")
        if self.spec_draft and not self.continuous_batching:
            raise ValueError(
                "spec_draft (speculative decoding) requires "
                "continuous_batching (the refill scheduler hosts it)")
        if (self.prefix_sharing or self.continuous_admission) and not self.continuous_batching:
            raise ValueError(
                "prefix_sharing/continuous_admission run on the refill scheduler: "
                "set continuous_batching (and a max_concurrent_sequences cap)")
        if self.prefix_cache and not self.continuous_admission:
            raise ValueError(
                "prefix_cache (the radix KV cache) aliases cached prompt chains out "
                "of the continuous-admission pool: set continuous_admission")
        if self.prefix_cache and self.kv_cache_quant == "int8":
            raise ValueError(
                "prefix_cache requires a lossless KV pool: int8 pages cannot "
                "reproduce the cold prefill's attention inputs bit-exactly")
        if self.kv_spill and not self.prefix_cache:
            raise ValueError(
                "kv_spill parks KV pages through the tiered cache's host store: "
                "it requires prefix_cache")
        if self.kv_spill and self.spec_draft:
            raise ValueError(
                "kv_spill restores raw decode cursors the speculative scheduler "
                "does not expose; drop kv_spill or spec_draft")
        if self.kv_spill_host_mb and not self.kv_spill:
            raise ValueError("kv_spill_host_mb caps the kv_spill host store: set kv_spill")
        if self.spec_draft is not None and not 0 <= self.spec_draft <= 16:
            raise ValueError(f"spec_draft must be in [0, 16], got {self.spec_draft}")
        if self.spec_ngram is not None and self.spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {self.spec_ngram}")
        if self.spec_drafter not in (None, "ngram", "self"):
            raise ValueError(f"spec_drafter must be 'ngram' or 'self', got {self.spec_drafter!r}")
        if self.spec_verify not in (None, "fused", "unrolled"):
            raise ValueError(
                f"spec_verify must be 'fused' or 'unrolled', got {self.spec_verify!r}")
        spec_knobs = (self.spec_ngram is not None or self.spec_drafter is not None
                      or self.spec_verify is not None)
        if not self.continuous_batching and (spec_knobs or self.spec_adapt):
            raise ValueError(
                "spec_ngram/spec_drafter/spec_verify/spec_adapt configure "
                "speculative decoding, which requires continuous_batching (the "
                "refill scheduler hosts it): they would be silently ignored")
        if self.spec_draft == 0 and spec_knobs:
            raise ValueError(
                "spec_ngram/spec_drafter/spec_verify with spec_draft=0: an explicit "
                "0 pins speculation off, so they would be silently ignored")
        if self.spec_drafter == "self" and self.spec_draft != 0 and self.full_finetune:
            raise ValueError(
                "spec_drafter='self' drafts with the policy's previous LoRA adapter: "
                "full_finetune has no adapter stream")
        if self.spec_adapt and self.spec_draft == 0:
            raise ValueError("spec_adapt adapts the speculative draft length: set "
                             "spec_draft > 0")
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if any(b <= 0 or b > self.max_new_tokens for b in self.learner_len_buckets):
            raise ValueError(
                f"learner_len_buckets must be in (0, max_new_tokens="
                f"{self.max_new_tokens}], got {self.learner_len_buckets}")
        if any(b <= 0 or b > self.max_prompt_tokens for b in self.learner_prompt_buckets):
            raise ValueError(
                f"learner_prompt_buckets must be in (0, max_prompt_tokens="
                f"{self.max_prompt_tokens}], got {self.learner_prompt_buckets}")
        if self.number_of_learners <= 0:
            raise ValueError("need at least one learner")
        if self.number_of_actors < 0:
            raise ValueError("number_of_actors must be >= 0")
        # the flat flags are authoritative for role counts (the reference CLI
        # contract); a custom MeshConfig may only restate them
        default_roles = (MeshConfig().number_of_actors, MeshConfig().number_of_learners)
        mesh_roles = (self.mesh.number_of_actors, self.mesh.number_of_learners)
        flat_roles = (self.number_of_actors, self.number_of_learners)
        if mesh_roles != default_roles and mesh_roles != flat_roles:
            raise ValueError(
                f"mesh role counts {mesh_roles} conflict with number_of_actors/"
                f"number_of_learners {flat_roles}; set the flat flags instead")
        self.mesh = MeshConfig(**{**dataclasses.asdict(self.mesh),
                                  "number_of_actors": self.number_of_actors,
                                  "number_of_learners": self.number_of_learners})
        if min(self.mesh.tp, self.mesh.sp, self.mesh.fsdp) < 1:
            raise ValueError(f"mesh axes must be >= 1, got {self.mesh}")
        for axis in ("tp", "sp"):
            if getattr(self.mesh, axis) > 1:
                raise NotImplementedError(
                    f"mesh.{axis}={getattr(self.mesh, axis)} is not ported yet ({_ITEM_10B})")
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r} is not ported yet ({_ITEM_10B})")

    @property
    def max_seq_length(self) -> int:
        # reference: max_seq_length = prompt + new tokens (distributed_actor.py:25)
        return self.max_prompt_tokens + self.max_new_tokens

    @property
    def allowed_weight_lag(self) -> int:
        """Optimizer steps the rollout-resident adapter may lag the learner
        before StaleWeightsError fires: sync serializes (0), pipelined
        overlaps exactly one step (1), async is bounded by the staleness
        policy (max_staleness)."""
        if self.rollout_mode == "sync":
            return 0
        if self.rollout_mode == "pipelined":
            return 1
        return max(self.max_staleness, 1)

    @property
    def run_directory(self) -> str:
        return f"run_{self.run_name}"

    def train_sampling(self) -> SamplingConfig:
        return SamplingConfig(
            max_tokens=self.max_new_tokens,
            temperature=self.temperature,
            top_p=0.95,  # the reference hardcodes top_p=0.95 (distributed_actor.py:47)
            n=self.num_candidates,
            top_p_exact=self.top_p_exact,
        )

    def eval_sampling(self) -> SamplingConfig:
        # reference eval params at distributed_trainer.py:53-58
        return SamplingConfig(
            max_tokens=self.max_new_tokens,
            temperature=self.eval_temperature,
            top_p=self.eval_top_p,
            n=self.eval_n,
            top_p_exact=self.top_p_exact,
        )

    def to_flat_dict(self) -> dict[str, Any]:
        """The reference-shaped flat config dict (train_distributed.py:54-81),
        logged as the wandb config."""
        return {
            "run_name": self.run_name,
            "project_name": self.project_name,
            "lora_save_path": self.lora_save_path,
            "lr": self.lr,
            "max_prompt_tokens": self.max_prompt_tokens,
            "max_new_tokens": self.max_new_tokens,
            "episodes": self.episodes,
            "num_candidates": self.num_candidates,
            "batch_size": self.batch_size,
            "train_batch_size": self.train_batch_size,
            "temperature": self.temperature,
            "save_every": self.save_every,
            "eval_every": self.eval_every,
            "model": self.model,
            "dataset": self.dataset,
            "number_of_actors": self.number_of_actors,
            "number_of_learners": self.number_of_learners,
            "learner": self.learner,
            "use_vllm": False,
            "max_lora_rank": self.max_lora_rank,
            "topk": self.topk,
            "learner_chunk_size": self.learner_chunk_size,
            "actor_gpu_usage": self.actor_gpu_usage,
            "learner_gpu_usage": self.learner_gpu_usage,
            "lora_alpha": self.lora_alpha,
            "lora_dropout": self.lora_dropout,
        }
