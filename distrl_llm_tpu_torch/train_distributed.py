"""CLI entry point of the port: the reference's flags (train_distributed.py:
10-35, names and defaults kept) and the ported knobs, run as

    python -m distrl_llm_tpu_torch.train_distributed --model /path/to/checkpoint \\
        --learner grpo --base_quant int4 --engine_impl paged
    python -m distrl_llm_tpu_torch.train_distributed --smoke [--device cpu]
    torchrun --nproc-per-node 4 -m distrl_llm_tpu_torch.train_distributed \
        --model /path/to/checkpoint --full_finetune --fsdp 4 --number_of_actors 0

The non-smoke path loads a LOCAL HF checkpoint directory (``--checkpoint_path``,
default ``--model`` as a path) and prepares the dataset through ``data.py``
(MATH-500: the 'test' split, answer -> solution, a 90/10 split, the R1 chat
template), then trains. ``--smoke`` needs no files: a random TINY model, the
byte-level ``CharTokenizer`` and 8 inline problems through the real engine,
learner and trainer. ``--device`` (default ``cuda``) is where everything runs.

Across ranks (ROADMAP item 10a): ``initialize_distributed`` runs first and
joins the job's process group when torchrun's ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` (or the JAX package's ``DISTRL_COORDINATOR`` /
``DISTRL_NUM_PROCESSES`` / ``DISTRL_PROCESS_ID``) are set, each rank on
``cuda:LOCAL_RANK``; ``--fsdp`` (and ``--tp`` / ``--sp``, item 10b) shape
the role meshes. Every rank runs the trainer; rank 0 drives it. ``--smoke``
keeps its one-process path.
"""

from __future__ import annotations

import argparse

from distrl_llm_tpu_torch.config import MeshConfig, TrainConfig, parse_buckets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RL fine-tuning of LLMs on one GPU (PyTorch)")
    # --- reference flags (train_distributed.py:10-35), names and defaults kept
    p.add_argument("--model", type=str, default="Qwen/Qwen2.5-7B-Instruct")
    p.add_argument("--dataset", type=str, default="HuggingFaceH4/MATH-500")
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--project_name", type=str, default="math-reasoning")
    p.add_argument("--lora_save_path", type=str, default="lora_request_math")
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--max_new_tokens", type=int, default=1200)
    p.add_argument("--max_prompt_tokens", type=int, default=350)
    p.add_argument("--temperature", type=float, default=1.2)
    p.add_argument("--episodes", type=int, default=15)
    p.add_argument("--num_candidates", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=30)
    p.add_argument("--learner_chunk_size", type=int, default=8)
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--number_of_actors", type=int, default=2)
    p.add_argument("--number_of_learners", type=int, default=1)
    p.add_argument("--learner", type=str, default="pg", choices=["pg", "grpo"])
    p.add_argument("--max_lora_rank", type=int, default=32)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--lora_dropout", type=float, default=0.0)
    p.add_argument("--topk", type=int, default=16)
    p.add_argument("--actor_gpu_usage", type=float, default=0.91)
    p.add_argument("--learner_gpu_usage", type=float, default=0.35)
    # --- the ported knobs
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--base_quant", type=str, default="none", choices=["none", "int8", "int4"])
    p.add_argument("--quant_group_size", type=int, default=None,
                   help="groupwise-scale width along the input dim for --base_quant "
                        "(must divide the projection input dims); unset = per-format "
                        "default (int8: per column, int4: 64)")
    p.add_argument("--no_optimizer_8bit", dest="optimizer_8bit", action="store_false",
                   help="plain Adam instead of Adam8bit (the reference's bnb optimizer)")
    p.add_argument("--eval_temperature", type=float, default=0.6)
    p.add_argument("--eval_top_p", type=float, default=0.95)
    p.add_argument("--eval_n", type=int, default=8)
    p.add_argument("--top_p_exact", action="store_true",
                   help="exact sort-based nucleus filter (reference vLLM semantics) "
                        "instead of the bisection filter")
    p.add_argument("--logprob_chunk", type=int, default=128,
                   help="learner logprobs: lm_head + logsumexp per this many answer "
                        "positions; 0 = dense")
    p.add_argument("--full_finetune", action="store_true",
                   help="full-rank fine-tuning: the whole model trains as f32 master "
                        "weights (models past one card: not ported)")
    p.add_argument("--attn_impl", type=str, default="reference",
                   choices=["reference", "flash", "splash", "ring", "ulysses"])
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks per role (item 10b)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks (ring/ulysses attention; item 10b)")
    p.add_argument("--fsdp", type=int, default=1, help="learner state sharding")
    p.add_argument("--engine_impl", type=str, default="dense",
                   choices=["dense", "paged", "paged_sharded"],
                   help="rollout engine: dense cache, or paged KV (kernel K2)")
    p.add_argument("--kv_cache_quant", type=str, default=None, choices=["none", "int8"],
                   help="paged KV page format; unset = the cache dtype")
    p.add_argument("--decode_scan_chunk", type=int, default=None,
                   help="decode steps per chunk, each chunk one CUDA graph replay "
                        "(dense engine and paged wave scheduler; not with "
                        "--continuous_batching)")
    p.add_argument("--max_concurrent_sequences", type=int, default=0,
                   help="cap on concurrent candidate rows (vLLM max_num_seqs); 0 = "
                        "unlimited")
    p.add_argument("--continuous_batching", action="store_true",
                   help="the paged engine's refill scheduler: keep "
                        "max_concurrent_sequences rows decoding, admit a pending "
                        "candidate whenever a row hits EOS")
    p.add_argument("--spec_draft", type=int, default=None,
                   help="speculative decoding: draft this many tokens a step and "
                        "verify them in one forward (kernel K5); requires "
                        "--continuous_batching")
    p.add_argument("--spec_ngram", type=int, default=None,
                   help="lookup n-gram size for --spec_draft (default 2)")
    p.add_argument("--spec_drafter", choices=["ngram", "self"], default=None,
                   help="draft source for --spec_draft: 'ngram' (prompt lookup) or "
                        "'self' (the policy's previous LoRA version)")
    p.add_argument("--spec_verify", choices=["fused", "unrolled"], default=None,
                   help="verify attention: one K5 sweep ('fused') or d+1 K2 calls")
    p.add_argument("--spec_adapt", action="store_true",
                   help="adapt the draft length to the accept rate (halve on waste, "
                        "floor 1; grow back on recovery)")
    p.add_argument("--prefix_sharing", action="store_true",
                   help="a group's candidates alias one refcounted prompt page chain "
                        "(copy-on-write tail); requires --continuous_batching")
    p.add_argument("--continuous_admission", action="store_true",
                   help="a group request queue with lazy per-group prefill into pool "
                        "pages (implies --prefix_sharing); requires "
                        "--continuous_batching")
    p.add_argument("--prefix_cache", choices=["on", "off"], default=None,
                   help="the radix prefix cache across rounds; requires "
                        "--continuous_admission and an unquantized KV pool")
    p.add_argument("--kv_spill", action="store_true",
                   help="park preempted and evicted KV pages in host memory and copy "
                        "them back on resume; requires --prefix_cache on, excludes "
                        "--spec_draft")
    p.add_argument("--kv_spill_host_mb", type=int, default=0,
                   help="host page store cap in MiB for --kv_spill (0 = unbounded)")
    p.add_argument("--clip_ratio", type=float, default=0.0,
                   help="PPO-clip epsilon over engine-captured behavior logprobs "
                        "(0 = the reference's objective)")
    p.add_argument("--kl_coeff", type=float, default=0.0,
                   help="KL(policy || frozen base) penalty coefficient (0 = reference)")
    p.add_argument("--rollout_mode", type=str, default="sync",
                   choices=["sync", "pipelined", "async"],
                   help="rollout/learner coupling: 'sync' serializes generation and "
                        "update; 'pipelined' generates batch t+1 while batch t updates "
                        "(one step stale); 'async' decouples them behind a bounded "
                        "trajectory buffer with --max_staleness admission and the AIPO "
                        "correction (requires --clip_ratio > 0)")
    p.add_argument("--max_staleness", type=int, default=2,
                   help="async staleness bound K in optimizer steps")
    p.add_argument("--staleness_policy", type=str, default="drop",
                   choices=["drop", "downweight"],
                   help="a pulled group beyond --max_staleness: discard it or train it "
                        "down-weighted by staleness_downweight^(lag-K)")
    p.add_argument("--staleness_downweight", type=float, default=0.5)
    p.add_argument("--rollout_is_cap", type=float, default=2.0,
                   help="AIPO's cap on the per-token importance ratio (async)")
    p.add_argument("--rollout_buffer_groups", type=int, default=0,
                   help="async trajectory-buffer capacity in task groups (0 = 4 x "
                        "batch_size; floor 2 x batch_size)")
    p.add_argument("--async_rollout", action="store_true",
                   help="the old spelling of --rollout_mode pipelined")
    p.add_argument("--inflight_weight_updates", action="store_true",
                   help="push each optimizer step's adapter into the round in flight "
                        "(requires an overlapped --rollout_mode and --clip_ratio > 0)")
    p.add_argument("--workers_capture_logprobs", action="store_true",
                   help="declare that every --rollout_workers process was started with "
                        "worker_main --capture-logprobs, enabling --clip_ratio/"
                        "--rollout_mode async over remote workers")
    p.add_argument("--rollout_workers", type=str, default="",
                   help="comma-separated control-plane workers (host:port,...) to "
                        "dispatch generation to; start them with python -m "
                        "distrl_llm_tpu_torch.distributed.worker_main --serve-model")
    p.add_argument("--weight_bus", type=str, default="broadcast",
                   choices=["broadcast", "dispatch"],
                   help="learner -> worker adapter transport for --rollout_workers: "
                        "'broadcast' ships each optimizer step's adapter once per version "
                        "over an out-of-band delta-encoded push (enables "
                        "--inflight_weight_updates over workers); 'dispatch' ships the "
                        "adapter in every shard")
    p.add_argument("--worker_rejoin", type=str, default="on", choices=["on", "off"],
                   help="re-dial unhealthy --rollout_workers with seeded backoff and "
                        "re-admit them after a PING")
    p.add_argument("--rpc_retries", type=int, default=2,
                   help="transient worker-error retries per RPC before the shard is "
                        "requeued to a different worker")
    p.add_argument("--rpc_backoff_s", type=float, default=0.25,
                   help="base delay of the seeded exponential backoff of RPC retries, "
                        "worker reconnects and the async producer's restarts")
    p.add_argument("--poison_shard_k", type=int, default=3,
                   help="quarantine a shard that fails on this many distinct workers")
    p.add_argument("--degrade_on_poison", action="store_true",
                   help="on a quarantined shard, drop its prompts (cp/degraded_groups) "
                        "instead of failing the round")
    p.add_argument("--producer_restarts", type=int, default=2,
                   help="restart budget of the async producer's failed rounds")
    p.add_argument("--env", type=str, default="math", choices=["code", "math", "verifier"],
                   help="rollout environment: 'math' (single-turn), 'code' (sandboxed "
                        "<tool> execution) or 'verifier' (critique and retry); the "
                        "multi-turn ones need the paged refill engine with "
                        "--continuous_batching --continuous_admission")
    p.add_argument("--max_turns", type=int, default=1,
                   help="conversation-turn budget per episode for multi-turn --env "
                        "values (env='math' is single-turn; > 1 there is refused)")
    p.add_argument("--format_reward", type=str, default="soft", choices=["soft", "strict"])
    p.add_argument("--no_print_samples", dest="print_samples", action="store_false",
                   help="disable the per-update sample dump")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--metrics_backend", type=str, default="auto",
                   choices=["auto", "wandb", "jsonl", "null"])
    p.add_argument("--export_hf_snapshots", action="store_true",
                   help="write HF-format merged-model snapshots to run_dir/model_{step}")
    p.add_argument("--write_adapter_file", action="store_true",
                   help="export the reference's per-step adapter artifact")
    p.add_argument("--prompt_buckets", type=str, default="",
                   help="comma-separated prompt length buckets for the rollout engine")
    p.add_argument("--learner_len_buckets", type=str, default="",
                   help="comma-separated answer length buckets for the learner's update")
    p.add_argument("--learner_prompt_buckets", type=str, default="",
                   help="comma-separated prompt length buckets for the learner's update")
    p.add_argument("--generation_timeout_s", type=float, default=0.0,
                   help="hang detector on generation rounds (0 = off; the "
                        "reference's value: 240)")
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="local HF checkpoint dir (defaults to --model as a path)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model, engine and learner run")
    p.add_argument("--smoke", action="store_true",
                   help="end-to-end smoke: tiny random model, inline dataset, real "
                        "engine and learner, 1 episode")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    fields = {k: v for k, v in vars(args).items() if k in TrainConfig.__dataclass_fields__}
    # tri-state: omitted = None (unset), "on"/"off" a pin
    fields["prefix_cache"] = None if args.prefix_cache is None else args.prefix_cache == "on"
    fields["rollout_workers"] = tuple(
        w.strip() for w in str(args.rollout_workers or "").split(",") if w.strip())
    fields["worker_rejoin"] = args.worker_rejoin == "on"
    fields["prompt_buckets"] = parse_buckets(args.prompt_buckets)
    fields["learner_len_buckets"] = parse_buckets(args.learner_len_buckets,
                                                  field="learner_len_buckets")
    fields["learner_prompt_buckets"] = parse_buckets(args.learner_prompt_buckets,
                                                     field="learner_prompt_buckets")
    if getattr(args, "smoke", False):
        # the smoke trains TINY (run_smoke): the config's width rules
        # (full_finetune's fit on one card) are TINY's, not --model's
        fields["model"] = "tiny"
    # the role counts follow number_of_actors / number_of_learners
    fields["mesh"] = MeshConfig(tp=args.tp, sp=args.sp, fsdp=args.fsdp)
    return TrainConfig(**fields)


def run_smoke(config: TrainConfig, device: str = "cuda") -> None:
    """BASELINE config-1-shaped smoke without downloads: a random TINY model
    through the real engine, learner and trainer on ``device``. Asserts the
    loss is finite and prints the last metrics record."""
    import dataclasses

    import numpy as np
    import torch

    from distrl_llm_tpu_torch.data import process_dataset
    from distrl_llm_tpu_torch.engine import GenerationEngine, PagedGenerationEngine
    from distrl_llm_tpu_torch.metrics import MemorySink
    from distrl_llm_tpu_torch.models.configs import TINY
    from distrl_llm_tpu_torch.models.lora import lora_scale
    from distrl_llm_tpu_torch.models.transformer import init_params
    from distrl_llm_tpu_torch.ops.quant import quantize_base
    from distrl_llm_tpu_torch.rewards import reward_function
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer
    from distrl_llm_tpu_torch.trainer import Trainer
    from distrl_llm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    multi_turn = config.env != "math"
    config = dataclasses.replace(
        config, model="tiny", episodes=1, batch_size=4, num_candidates=4, topk=4,
        # a multi-turn episode's turns share the window: room for the
        # verifier's ~130-token critique and a turn after it
        train_batch_size=4, max_prompt_tokens=64, max_new_tokens=224 if multi_turn else 32,
        number_of_actors=1, number_of_learners=1, learner_chunk_size=1,
        eval_every=0, save_every=0, metrics_backend="null",
        max_lora_rank=4, lora_alpha=8, lr=1e-3,
    )
    tokenizer = CharTokenizer(TINY.vocab_size)
    problems = [f"What is {i}+{i}?" for i in range(8)]
    train = process_dataset(tokenizer, {"problem": problems,
                                        "solution": [str(2 * i) for i in range(8)]})
    test = {k: v[:4] for k, v in train.items()}
    model = init_params(torch.Generator(device=dev).manual_seed(0), TINY)
    # TINY's projections take 64 or 128 inputs: groups of 16 divide them
    quantize_base(model, config.base_quant,
                  None if config.base_quant == "none" else config.quant_group_size or 16)
    # random weights almost never sample the one EOS id, so a turn would
    # never end by choice: a multi-turn smoke ends turns on every 16th id too
    eos = [tokenizer.eos_token_id] + (list(range(5, TINY.vocab_size, 16)) if multi_turn else [])
    common = dict(
        max_prompt_tokens=config.max_prompt_tokens, max_new_tokens=config.max_new_tokens,
        eos_token_ids=eos, pad_token_id=tokenizer.pad_token_id,
        lora_scale=lora_scale(config.max_lora_rank, config.lora_alpha),
        capture_logprobs=config.clip_ratio > 0.0, attn_impl=config.attn_impl, device=dev,
    )
    if config.engine_impl == "paged":
        engine = PagedGenerationEngine(
            TINY, page_size=8, max_concurrent_rows=4,
            scheduler="refill" if config.continuous_batching else "waves",
            prefix_sharing=config.prefix_sharing,
            continuous_admission=config.continuous_admission, decode_chunk=4, **common)
    elif config.engine_impl == "paged_sharded":  # one rank: the whole round on this card
        from distrl_llm_tpu_torch.engine.sharded_paged import ShardedPagedEngine
        from distrl_llm_tpu_torch.parallel.mesh import build_role_meshes

        engine = ShardedPagedEngine(TINY, build_role_meshes(config.mesh).rollout, page_size=8,
                                    decode_chunk=4, **common)
    else:
        engine = GenerationEngine(TINY, **common)
    sink = MemorySink()
    trainer = Trainer(train, test, reward_function, config, tokenizer=tokenizer,
                      engine=engine, model=model, sink=sink)
    trainer.train()
    train_recs = [m for _, m in sink.records if "loss" in m]
    assert train_recs, "no train steps ran"
    assert all(np.isfinite(m["loss"]) for m in train_recs), "non-finite loss"
    if multi_turn:
        print(f"env {config.env}: turns per episode, mean "
              f"{np.mean([m['env/turns_mean'] for m in train_recs]):.2f}, max "
              f"{max(m['env/turns_max'] for m in train_recs)}")
    print(f"SMOKE OK — {len(train_recs)} train steps on {dev}")
    print(train_recs[-1])


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    if args.smoke:
        run_smoke(config, device=args.device)
        return

    from distrl_llm_tpu_torch.data import prepare_dataset
    from distrl_llm_tpu_torch.distributed.launch import initialize_distributed
    from distrl_llm_tpu_torch.rewards import reward_function
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer

    # first: under torchrun (or the DISTRL_* variables) each rank joins the
    # job's process group on its own card
    args.device = str(initialize_distributed(device=args.device).device)
    tokenizer = load_tokenizer(args.checkpoint_path or config.model)
    train_ds, test_ds = prepare_dataset(config.dataset, tokenizer, test_size=0.1,
                                        seed=config.seed)
    trainer = Trainer.from_pretrained(train_ds, test_ds, reward_function, config,
                                      checkpoint_path=args.checkpoint_path,
                                      tokenizer=tokenizer, device=args.device)
    trainer.train()


if __name__ == "__main__":
    main()
