#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``distrl_llm_tpu_torch``).

    python3 chip_smoke.py [--layers N] [--seed S] [--profile] [--until 6|7|...|16]

Needs one NVIDIA GPU (Hopper: the kernels build for ``sm_90a``) and ``nvcc``.
Without a GPU it exits non-zero before computing anything. Phases, each
printing its own lines:

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: every kernel in ``distrl_llm_tpu_torch/csrc`` is compiled (one
   ``nvcc`` per source, started together) into ``build/torch_kernels/``;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the main path's shapes, with its time, the plain version's time
   and the card's least time for the same work (the bound); K1's stanza
   covers rows 1 to 128 at V 152,064 and 64 rows at every preset's
   vocabulary under the four sampler settings, each case run twice for
   identical bits, prints each shape's cluster plan and how many such
   clusters the card holds at once, and times [64, 152064] as a CUDA graph
   over logits copies past twice the L2; K2's stanza also holds lengths on its split's boundaries,
   reruns every case for identical bits and times 64 and 16 rows as CUDA
   graphs over page copies past twice the L2;
4. rollout: the port's rollout engines at Qwen2.5-7B width (random bf16
   weights from a seed, a rank-32 LoRA with non-zero B), 4 math prompts x 16
   candidates x 128 new tokens: the dense engine, then the paged engine
   (wave scheduler, 128-token pages) with bf16 and with int8 KV pages. Each
   runs one sampled round scored by the reward function and two greedy
   rounds that must agree. The kernels' launch counts are set to 0 just
   before each engine's rounds and read just after; every kernel of that
   path must have been launched, K1 once per decode step and K2 once per
   layer per decode forward. Then the paged engine's logits are held to the
   dense engine's, teacher-forced over the prefill and a few decode
   forwards (K2 at every layer): in f32 with f32 pages, in bf16, and with
   int8 pages; and the greedy tokens' agreement with the dense engine is
   printed beside its yardsticks (dense bf16 vs f32, paged vs dense in f32).
   The paged engine also runs one greedy round with ``attn_impl="splash"``:
   K4 in its prefill, 28 launches, logits held to "reference" in f32;
5. learner: the dense engine's sampled round through shaping into 8
   microbatches of 8 x 1550 tokens, one Adam8bit step at Qwen2.5-7B width
   (phase 8's trainer takes two) with K4 (2 x 28 x 8 forward and 28 x 8
   backward launches, its
   plain version never called), every adapter element within Adam8bit's
   clip; the adapter pushed into the dense engine's mailbox for one greedy
   round; then, at 2 layers in f32, the learner's loss and LoRA grads with
   K4 against its plain version and its logprobs of the engine's greedy
   tokens against the logprobs the engine captured.
6. QLoRA, at 7 of the 28 layers (SHALLOW_LAYERS: the depth cut that makes
   room for phases 9 and 17; phase 8's trainer drives the
   int4 base at 14): the
   same weights with the seven projections quantized on the card
   to int4 in groups of 64 (the reference's 4-bit base), every projection
   through K3 with the adapter in its epilogue: the dense and the paged
   engine (bf16 pages) as in phase 4 but with one greedy round each (phase
   4 holds two identical), K3 launched 7 times per layer per model forward;
   one dense-engine run over an int8 base (per-column
   scales); the dense engine's f32 logits, teacher-forced, with K3 against
   K3's plain version (``k3_plain_version()``), beside their distance from
   the bf16 base's; one Adam8bit learner step on phase 5's batch (K3 2 x 7
   x 7 x 8 times; phase 8 takes two over the int4 base at 14 layers); and
   a 2-layer f32 learner parity run, K3 against
   its plain version.

7. speculative decoding: K5 (``csrc/paged_verify.cu``, the draft-block
   verify attention) against its plain version at 64 rows x S 5 x 28 / 4
   heads x hd 128, lengths around 600 with page crossings and on the
   split's boundaries, bf16, int8 and f32 (each case run twice for identical
   bits), and timed against its bound and the unrolled 5 x K2 as K2 is; then the
   engine of the README's BASELINE config 2 (refill scheduler, 64 slots,
   ``spec_draft=4``, n-gram 2, 128-token pages) over 8 math prompts x 16
   candidates x 256 new tokens, at 7 layers (SHALLOW_LAYERS, the depth
   cut that makes room for phases 12 and 17): speculative and plain refill greedy
   rounds with bf16 pages, then with int8 pages, and one sampled
   speculative round, each with the counts reset around it
   (K5 = layers x verify forwards and no K2 in a speculative round; K2 =
   layers x decode forwards in a plain one), printing
   ms/step, tokens/s, accept rate and tokens per verify step (random
   weights give the n-gram drafter nothing to accept, so the same engine
   and kernels also run the TINY preset in f32, whose greedy streams loop:
   drafts accepted, speculative greedy tokens equal to plain refill's);
   the f32 logits of one verify forward over 5 positions against 5
   single-token decode forwards; and one greedy speculative round over the
   weights quantized to int4 g64 at phase 6's depth, K3 at M = 64 x 5 (7
   launches per layer per model forward).
8. trainer: the synchronous PG trainer end to end. (a) ``Trainer.train()``
   at Qwen2.5-7B width (random bf16 weights from the seed, quantized by
   ``quantize_base`` to int4 g64, the reference's QLoRA base) with the
   engine ``trainer.make_engine`` builds (paged refill scheduler, 32 slots,
   its KV pool from ``kv_pool_pages``, ``attn_impl="splash"``), a byte-level
   BPE ``tokenizer.json`` written by the script and read by the native
   tokenizer, 8 math prompts through the R1 template: the initial eval (4
   prompts x 8, wave scheduler), then 2 optimizer steps of 4 prompts x 16
   candidates x 128 new tokens, learner 8 microbatches of 8 rows, PG, rank
   32, Adam8bit lr 2e-5, a checkpoint and an adapter file at each step.
   Random weights solve nothing, so the accuracy reward is a hash of the
   completion (``smoke_reward``) and the learner trains on every
   microbatch. The counts are reset around ``train()`` and held to what the
   path dispatched: K1 per sampler call (decode steps and admissions), K2
   14 per decode forward, K3 7 x 14 per engine forward and twice that per
   learner forward, K4 14 per splash prefill and 2 x 14 per learner forward
   (backward 28); each step's generation, reward and update times and
   their sum, ms per training step, are printed; the loss finite, the
   adapter within Adam8bit's clip at each step, weight version 2, the
   reference's metric names, the adapter file and the resume state equal
   to the adapter. (b) ``Trainer.from_pretrained`` on a full-width 2-layer
   checkpoint written by ``save_hf_checkpoint`` with that tokenizer: the
   weights read back bit for bit, the native tokenizer, one step with
   K1-K4 launched.
9. the refill engine's riders and the dense slice's leftovers, at
   Qwen2.5-7B width (bf16, phase 7's weights and prompts; (a)-(c) at 7
   layers, SHALLOW_LAYERS, the depth cut that makes room for phases 12 and
   17, (d) at 28), each round with the counts reset around it and held to what it
   dispatched:
   (a) prefix sharing, continuous admission and the radix cache (64 slots,
   64-token pages so every prompt has a full page to cache, splash): two
   greedy rounds of 8 prompts x 16 x 256 tokens over the same adapter, the
   second admitting every group warm (its pages parked in host memory at
   the first round's end and copied back; K4 only in cold prefills), with
   peak pages, shared pages, radix hit pages and the prompt tokens not
   re-prefilled; at 4 layers in f32, warm vs cold prefill logits within
   LOGIT_F32_ATOL, and three rounds through the cache engine (cold, warm,
   a new adapter object that misses the cache) with equal greedy tokens and
   lengths; (b) host
   spill under an 80-page budget (8 x 16 x 128), preempted slots' pages and
   logits rows parked and copied back, greedy tokens equal to the
   worst-case pool's at 7 layers bf16 and at 4 layers f32; (c) the
   self-drafter with spec_adapt (d = 4; 4 x 16 x 128, 64 slots): adapter v1
   drafts for v2 (v1 moved by one Adam8bit step at lr 2e-5), a greedy and a
   sampled round beside plain decoding with the same push, accept rate,
   tokens per verify step and the draft length at each boundary (K2 once a
   layer per drafter forward, K5 per verify forward), and on TINY in f32 greedy
   tokens equal to plain refill's; (d) the dense engine with the int8 cache at phase 4's shape
   (ms/step, peak GiB, its quantization on the card equal to the CPU's bit
   for bit, teacher-forced f32 logits within twice the int8 pages' own
   distance; its sampled round filters with top_p_impl="bisect_mw", K1 each
   step),
   and ``Trainer.from_pretrained`` on a 2-layer Gemma-2B-wide checkpoint
   with a Unigram tokenizer the script writes (the native SPM tokenizer,
   the script's expected ids, one step over the int8 dense cache).
10. full fine-tuning at Gemma-2B width (9 of its 18 layers, D 2048, 8 / 1
   heads of head_dim 256, F 16384, V 256,000, tied embeddings; random bf16
   weights from the seed; phase 9's Unigram tokenizer): (a)
   ``Trainer.train()`` with ``full_finetune=True`` and ``attn_impl=
   "splash"`` on the paged refill engine (16 slots), 4 prompts x 4 x 128
   new tokens, microbatch 4, the initial eval and 2 optimizer steps: the
   learner trains f32 master weights (K4's f32 forward and backward at
   head_dim 256), the engine prefills in bf16 (K4's bf16 forward at
   head_dim 256), with K1 and K2; launches held to the path's dispatches
   by route; every parameter moved (the tied embedding and the norms too)
   within 2 Adam8bit steps, the rollout copy equal to the masters cast to
   bf16, the step-2 round's probe logits moved by the push (and the step-1
   round's equal to the eval round's), the radix cache dropped by a push
   (three rounds over the rollout copy: cold, warm, after the push cold);
   ms per step by phase and peak GiB against the state estimate; (b) one
   LoRA step at the same width under splash with the bf16 learner (K4's
   bf16 backward at head_dim 256).
11. scan chunks: the dense engine and the paged wave scheduler with
   ``scan_chunk`` 16, each chunk of 16 decode steps captured once as a CUDA
   graph and replayed, at phase 4's cell (the same weights from the seed, 4
   prompts x 16 x 128 new tokens; (a)-(d) at 7 layers, GRAPH_TRAIN_LAYERS, the
   depth cut that makes room for phase 17; 14 before it, 28 before that). (a)
   dense and (b) paged
   (bf16 pages), greedy: a first graphed round (its first chunk eager, the
   second captured), then graphed and eager rounds in turns (G E G; a
   second eager round was cut in PR 17 for the script's time), the
   counts reset around each and held to what it dispatched (K1 per step, K2
   per layer per decode forward, replays included), tokens and lengths
   equal, the largest |dlogp|, ms per step of each, captures and replays;
   a graphed round of 16 steps under ``torch.profiler`` must name K1 (and
   K2) in its device trace; with ``--profile`` device ms per step and the
   idle share of both. (c) a sampled round, graphed vs eager, tokens equal.
   (d) a second adapter pushed at step 32 (a chunk boundary) on both
   engines: the same swap log, tokens equal. (e) two graphed greedy rounds
   over the int4 g64 base at 7 layers (SHALLOW_LAYERS), the second all
   replays: tokens equal to phase 6's eager round, K3 7 x layers x model
   forwards. (f) one
   ``Trainer.train()`` step with ``decode_scan_chunk=16`` on the dense
   engine (bf16 base, 7 layers, flash, 4 x 16 x 128, the initial eval
   first): generation, reward and update ms, captures and replays.
12. scan chunks on the refill scheduler: its plain, speculative and
   self-drafted steps with ``scan_chunk`` 16 (the largest divisor of the
   host cadence, 16), each chunk a CUDA graph replay, at the trainer's
   refill cell (32 slots, phase 4's weights and 4 prompts x 16 x 128 new
   tokens: 64 candidates over 32 slots, so slots refill). Every round's
   counts are reset around it and held to what it dispatched (K1 per
   sampler call, K2 per layer per plain or drafter forward, K5 per layer per
   verify forward, replays included); every graphed/eager pair has equal
   tokens, lengths and logprobs. (a) plain refill, greedy, G E G (the first
   graphed round holds the capture; a second eager round was cut for the
   script's time); (b) speculative refill (``spec_draft=4``, n-gram
   2), greedy, G G E, (a) and (b) at 7 layers (GRAPH_TRAIN_LAYERS: the depth
   cut that makes room for phase 17; 14 before it, 28 before that), with
   accept rate
   and tokens per verify step; with ``--profile`` device ms per step and
   the idle share of (a) and (b) graphed and eager. Depth cut to 7 layers
   (GRAPH_TRAIN_LAYERS, phase 11 (f)'s) for (c)-(e): (c) prefix sharing,
   continuous admission, the radix cache and host spill under 96 of the
   worst case's 121 64-token pages, two greedy rounds an engine (the second
   warm), G E round by round: preemptions on both, equal restores, warm
   groups and prompt tokens not re-prefilled; (d) the self-drafter with
   ``spec_adapt``,
   sampled at t 1.2, an adapter one Adam8bit step away pushed at step 32 (a
   chunk boundary), G E: the swap at 32 on both, equal draft-length traces;
   (e) one ``Trainer.train()`` step of phase 8's configuration (int4 g64
   base, refill 32 slots, splash, 4 x 16 x 128, the initial eval first)
   with ``decode_scan_chunk=16`` and the same step eager: every engine
   round equal, generation, reward and update ms of each, K3 on every
   projection of the replayed steps.
13. the overlapped rollout modes: ``Trainer.train()`` of phase 8's
   configuration (int4 g64, refill 32 slots, splash, rank 32, Adam8bit lr
   2e-5, 4 x 16 x 128) with GRPO and ``clip_ratio=0.2`` in every regime,
   at 7 layers (GRAPH_TRAIN_LAYERS, as phase 12 (e)), the initial eval and
   one episode of 4 batches, one model quantized once and each trainer
   dropped before the next: (a) sync and (b) pipelined with
   ``decode_scan_chunk=16``, (c) sync and (d) pipelined eager, (e) async
   with ``inflight_weight_updates``, ``max_staleness=2`` and the buffer at
   its floor (2 x batch). Each round's launches (the tally of the thread
   that ran it) and each update's (every other thread's) equal what their
   counts say, and add up to the run's; pipelined round t >= 1 opened with
   version t - 1; async swaps are real learner versions on chunk
   boundaries, the tags change exactly there, the buffer's books balance;
   each graph key is captured at most once, by a train round over weights
   it or an earlier train round read, at most the ring's buffers; every regime's first train round equals (a)'s
   bit for bit; finite losses, the adapter within Adam8bit's clip. Printed:
   ms per training step and each ``timing/*_duration``, the seconds of
   host-clock overlap between rounds and updates, peak GiB allocated and
   reserved, captures and replays, the phase's seconds.
14. the kernel domains past rank 64 and 64 query rows: (a) one
   ``Trainer.train()`` of phase 13's configuration (int4 g64, refill 32
   slots, splash, Adam8bit, GRPO clip 0.2, 4 x 16 x 128) at 7 layers
   (GRAPH_TRAIN_LAYERS) with ``max_lora_rank=128``, ``spec_draft=12``
   (n-gram) and ``decode_scan_chunk=16``, the initial eval and two steps (the
   second round decodes over a non-zero B): K3 walks the rank in two chunks
   on every projection, K5 serves 13 x 7 = 91 query rows in two row tiles;
   each round's and each update's launches held to what they dispatched,
   replays included (K5 and its row tiles per layer per verify forward, K3
   and its rank chunks 7 per layer per model forward), K5 launched at 91
   rows only, finite losses, the adapter within Adam8bit's clip; (b) the
   refill engine on TINY's width with 8 query heads over 1 kv head in f32 at
   ``spec_draft=12`` (104 query rows a block, two tiles), whose greedy
   streams loop: drafts accepted, speculative greedy tokens equal to plain
   refill's. Printed: ms per training step, each ``timing/*_duration``, the
   verify forwards and accept rates, the row tiles launched, peak GiB and
   the phase's seconds.
15. multi-turn environments and full fine-tuning under the overlapped
   modes: (a) ``Trainer.train()`` of phase 13's QLoRA configuration at 7
   layers with ``env="verifier"``, ``max_turns=3``, continuous admission and
   a 256-token window that an episode's turns share, the engine's EOS set
   widened to every 32nd id (random weights almost never sample the one EOS
   id, so turns would never end by choice) and each turn's reward raised by
   a hash of its completion (random weights format nothing:
   ``hashed_env_reward``), the initial eval and two steps graphed
   (``decode_scan_chunk=16``), then on a fresh trainer from the same seed
   the eval and first step eager: more than one turn an episode and turn
   resumes in training and in eval, each round's ``turn_prefill_saved_tokens``
   the sum over its resumes of the prompt and the turns before, every
   row's loss mask 1 exactly on the policy's spans and each injected span
   the verifier's critique, the eager rounds, masks and loss equal to the
   graphed ones, every round's and update's launches as dispatched (a turn
   resume is a chunked forward: K3, no K4); (b) at full width, 2 layers,
   f32, one prompt: a refill round whose scripted hook grants one
   observation continues exactly as a dense engine's greedy round over the
   whole conversation (tokens; logprobs within 1e-4; the logits the resume
   leaves within ``LOGIT_F32_ATOL`` of a dense forward's); (c) phase 10's
   full fine-tuning at Gemma-2B width (9 layers, graphed) pipelined, then
   async (clip 0.2, ``max_staleness=2``), 3 steps each: the rollout copy a
   ring of two bf16 ``Decoder``s, every push writing the copy no round
   held (the ring's books), the rounds reading only those two copies (two
   graph keys), pipelined round t opening with version t - 1, round 0 and
   the eval equal to a sync trainer's from the same seed. Printed: turns,
   resumes, declines, ``env/step_ms_p50``, each ``timing/*_duration``, the
   ring's books, peak GiB beside phase 10's, the phase's seconds.
16. remote rollout workers (ROADMAP item 9): phase 13's QLoRA configuration
   (int4 g64, GRPO clip 0.2, rank 32, splash, 4 x 16 x 128) at 7 layers
   (GRAPH_TRAIN_LAYERS) through ``Trainer.from_pretrained`` with
   ``rollout_workers``: a checkpoint written once by ``save_hf_checkpoint``
   with phase 8's tokenizer, then for each regime two worker processes on
   the card (``distributed/worker_main.py``, started with ``subprocess``,
   each a refill engine of 16 slots over the int4 base with splash
   prefills and behavior logprobs, a 0.12 share of the card for its page
   pool; phase 13's 32 slots split over the two), the adapter over the
   versioned weight bus. (a) sync, graphed
   workers (scan chunk 16): the initial eval (greedy) and 2 steps; the
   eval round's tokens equal an in-process refill engine's over the same
   weights shard by shard. (b) async with ``inflight_weight_updates`` and
   ``max_staleness=2``, graphed workers, 2 steps, under a fixed schedule
   (round 1 enters once update 0's train step is done; that update's push
   starts as the round is about to dispatch, and the round's shards go out
   once the bus has encoded it): the push swaps in mid-round on a chunk
   boundary of a graphed worker round, and the round's version tags change
   exactly there. Then sync and pipelined over eager workers, 2 steps
   each: the GIL measurement, printed, not claimed. Every run: finite
   losses, the adapter within Adam8bit's clip, every version broadcast
   (full at v0, deltas after) and acked by both workers with the driver's
   checksum, no shard resubmitted or retried and both workers alive, the
   driver's launches as its learner dispatched (K3 and K4, no K1 or K2),
   and each worker's launches, read at its SIGTERM drain, as its rounds
   dispatched (K1 per sampler call, K2 per layer per decode forward, K3 7
   per layer per model forward, K4 per layer per splash prefill). Printed:
   ms per step by phase, push ms and bytes of the full push and of each
   delta, each process's peak GiB, the phase's seconds.
17. learners sharded over ranks (ROADMAP item 10a), in a child process
   (``--mesh-child``) whose one-rank process group runs over NCCL, so that
   every collective of the path (the fsdp gathers, the dp merge, the push)
   runs on the real backend and the group ends with the phase: (a) phase
   13 (a)'s configuration (int4 g64, GRPO clip 0.2, rank 32, splash, 4 x
   16 x 128, decode chunks of 16 graphed, 7 layers) through
   ``Trainer.train()``, the initial eval and 2 steps, first without a
   process group, then with ``MeshConfig(fsdp=1)``'s default roles, which
   timeshare the rank: records and the adapter after each step bit for bit
   the same; (b) the same cell with ``engine_impl="paged_sharded"`` (the
   wave scheduler, greedy eval): its eval round's tokens equal one paged
   wave engine's over the same weights; (c) full fine-tuning at Llama-3-8B
   width (D 4096, F 14336, 32 / 8 heads, V 128,256) cut to 4 of 32 layers
   (1.92 B parameters), as BASELINE config 3 runs it (bf16 rollout copy,
   f32 masters sharded at fsdp 1, GRPO, splash, phase 10's engine and
   cell), 2 steps: every master moved within Adam8bit's clip, the rollout
   copy the masters cast. Every run's launches held to what it dispatched
   (``check_trainer_run``). Printed: ms per step by phase, peak GiB, the
   rank's shard bytes and ``check_full_finetune_fits``' verdicts for 32
   layers at fsdp 1 (raises) and 4 (passes).

Phase 3 holds K4 (forward and backward) against its plain version at the
learner's [8, 1550, 28 / 4, 128] and at Gemma-2B's [8, 1550, 8 / 1, 256],
f32 and bf16, with its time, bound and ``scaled_dot_product_attention`` as
the library yardstick (the head_dim 256 routes each a line of their own in
``{"kernels": ...}``); and K3 at every
projection shape of a layer, M = 64, 320 and 12,400, int4 g64 and int8,
with its edge cases, one-hot rows that must reproduce ``dequantize()``
exactly, and ``quantize`` on the card against the CPU bit for bit; K3's
time at every projection shape at M = 64 (a CUDA graph over weight copies
past the L2) and their sum per QLoRA decode step ("K3 per QLoRA decode
step"), and w_gate at M = 12,400. Then K3 past rank 64, at ranks 128 and
200 (``QMM_HIGH_RANKS``: the kernel walks the rank in chunks of 64): every
projection shape at M = 64, w_gate at M = 416 (the verify step at
spec_draft 12) and 12,400, int4 g64 and int8, f32 x at M = 64 and the edge
shapes where the chunks meet the tiling, against its plain version; each
timed beside its bound and the library yardstick, and "K3 per QLoRA decode
step" at each rank. Then K5 past 64 query rows (``VF_TILE_SHAPES``: S 13 x
28 / 4 at hd 128, 91 rows; S 17 x 64 / 8 at hd 128 and S 17 x 8 / 1 at hd
256, 136 rows), 64 rows of lengths 550-650, bf16 and int8 pages (and f32
at 91 rows), against its plain version, each timed as a CUDA graph over
page copies past the L2 beside its bound and the unrolled S x K2.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits 1 without that last line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores, the rate the sampler's arithmetic runs at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the SFU's transcendentals (ex2, lg2 behind expf and logf): 16 results a
# clock per SM (the CUDA C++ Programming Guide's arithmetic-instruction
# throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz, the clock
# at which 132 x 128 f32 lanes x 2 give the data sheet's 67 TFLOP/s
SFU_OPS_PER_S = 16 * 132 * 1.98e9

# the main path's shapes: Qwen2.5-7B's vocabulary, 4 prompts x 16 candidates
VOCAB = 152064
ROWS = 64
# fused_sample's tolerances: tokens identical except on near-tie rows (the
# plain version's two best perturbed scores within NEAR_TIE_REL of each
# other, which exp/sum rounding may flip), at most 1 such row in 1000;
# logprobs within LOGP_ATOL (one f32 log-sum-exp over V terms, summed in
# another order)
NEAR_TIE_REL = 1e-5
LOGP_ATOL = 1e-5

# (name, temperature, top_p): greedy, train (config.py's 1.2/0.95), eval
# (0.6/0.95), and no nucleus cut
SAMPLER_SETTINGS = (("greedy", 0.0, 0.95), ("train", 1.2, 0.95),
                    ("eval", 0.6, 0.95), ("no_cut", 1.0, 1.0))

PROBLEMS = (
    ("What is 7 * 8?", "56"),
    ("Compute 2^10.", "1024"),
    ("What is the sum of the first 10 positive integers?", "55"),
    ("Simplify (x^2 - 1)/(x - 1) for x != 1.", "x+1"),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _sampling():
    from distrl_llm_tpu_torch.ops import sampling

    return sampling


# every kernel of the main path: the module holding its wrapper and launch
# counter, and where the TPU kernel it replaces lives in the JAX package
KERNELS = (
    {"name": "fused_sample", "route": "cuda",
     "source": "distrl_llm_tpu_torch/csrc/fused_sample.cu",
     "replaces": "distrl_llm_tpu/ops/sampling.py:260",
     "module": "distrl_llm_tpu_torch.ops.sampling", "counter": "fused_sample_launches"},
    {"name": "paged_attention", "route": "cuda",
     "source": "distrl_llm_tpu_torch/csrc/paged_attention.cu",
     "replaces": "distrl_llm_tpu/ops/paged_native.py:695",
     "module": "distrl_llm_tpu_torch.ops.paged_native",
     "counter": "paged_attention_launches"},
    {"name": "flash_attention_fwd", "route": "cuda",
     "source": "distrl_llm_tpu_torch/csrc/flash_attention.cu",
     "replaces": "distrl_llm_tpu/ops/splash.py:58",
     "module": "distrl_llm_tpu_torch.ops.flash_attention",
     "counter": "flash_attention_fwd_launches"},
    {"name": "flash_attention_bwd", "route": "cuda",
     "source": "distrl_llm_tpu_torch/csrc/flash_attention.cu",
     "replaces": "distrl_llm_tpu/ops/splash.py:58",
     "module": "distrl_llm_tpu_torch.ops.flash_attention",
     "counter": "flash_attention_bwd_launches"},
    # K4's four routes at head_dim 256 (the Gemma family), each also counted
    # in the two entries above
    *({"name": f"flash_attention_{part}_hd256_{dt}", "route": "cuda",
       "source": "distrl_llm_tpu_torch/csrc/flash_attention.cu",
       "replaces": "distrl_llm_tpu/ops/splash.py:58",
       "module": "distrl_llm_tpu_torch.ops.flash_attention",
       "counter": f"flash_attention_hd256_{dt}_{part}_launches"}
      for dt in ("bf16", "f32") for part in ("fwd", "bwd")),
    {"name": "quant_matmul", "route": "cuda",
     "source": "distrl_llm_tpu_torch/csrc/quant_matmul.cu",
     "replaces": "distrl_llm_tpu/ops/quant_matmul.py:150",
     "module": "distrl_llm_tpu_torch.ops.quant_matmul", "counter": "quant_matmul_launches"},
    {"name": "paged_verify", "route": "cuda",
     "source": "distrl_llm_tpu_torch/csrc/paged_verify.cu",
     "replaces": "distrl_llm_tpu/ops/paged_native.py:573",
     "module": "distrl_llm_tpu_torch.ops.paged_native", "counter": "paged_verify_launches"},
    # K3 past rank 64 (its rank chunks) and K5 past 64 query rows (its row
    # tiles), each also counted in the entry of its kernel above
    {"name": "quant_matmul_rank_chunks", "route": "cuda",
     "source": "distrl_llm_tpu_torch/csrc/quant_matmul.cu",
     "replaces": "distrl_llm_tpu/ops/quant_matmul.py:150",
     "module": "distrl_llm_tpu_torch.ops.quant_matmul",
     "counter": "quant_matmul_rank_chunks_launches"},
    {"name": "paged_verify_row_tiles", "route": "cuda",
     "source": "distrl_llm_tpu_torch/csrc/paged_verify.cu",
     "replaces": "distrl_llm_tpu/ops/paged_native.py:573",
     "module": "distrl_llm_tpu_torch.ops.paged_native",
     "counter": "paged_verify_row_tiles_launches"},
)

# K2 at the main path's full configuration: Qwen2.5-7B heads (28 / 4, hd
# 128), 128-token pages, 4 prompts x 16 candidates, and the page geometry of
# max_prompt_tokens 350 / max_new_tokens 1200 (the JAX package's
# config.py:126-127): 3 prompt pages + 1 + 10 private pages per row
PA_HEADS, PA_KV_HEADS, PA_HEAD_DIM, PA_PAGE = 28, 4, 128, 128
PA_PROMPTS, PA_N = 4, 16
PA_PROMPT_PAGES, PA_PRIVATE_PAGES = 3, 1 + 10
PA_TIMED_LENGTH = 1550
BF16_PEAK_OPS_PER_S = 989e12
# f32 pages with f32 q: sums in another order, |dout| <= F32_ATOL. bf16 out:
# each version rounds its f32 result once, so the two differ by at most one
# bf16 ulp of the value plus F32_ATOL
F32_ATOL = 1e-5
# paged vs dense engine logits, teacher-forced (prefill and decode). The
# engines put RoPE at other absolute positions (packed vs left-padded) and
# attend over other widths: equal math, other rounding. In f32 (logits of std
# ~1.2) the sums differ in order only: LOGIT_F32_ATOL. In bf16 the two may be
# as far apart as bf16 rounding moves either one: twice the dense engine's
# own bf16-vs-f32 distance on the same input, measured in the same run. int8
# pages likewise: twice their own distance from dense, measured in the same
# run with K2's plain version reading the same pages
LOGIT_F32_ATOL = 1e-3
LOGIT_STEPS = 4  # teacher-forced decode forwards compared

# K4 at the learner's shape: a microbatch of 8 rows of max_prompt_tokens 350
# + max_new_tokens 1200 (the JAX package's config.py:126-127), Qwen2.5-7B
# heads; left-padded prompts and right-padded answers of these real lengths
# (row 0 has no valid key at all; rows 1 and 6 one prompt token)
FA_BATCH, FA_PROMPT, FA_ANSWER = 8, 350, 1200
# and at head_dim 256: Gemma-2B's heads (phase 10's learner) on the same rows
GEMMA_HEADS, GEMMA_KV_HEADS, GEMMA_HEAD_DIM = 8, 1, 256
FA_PROMPT_LENS = (0, 1, 200, 350, 350, 120, 1, 350)
FA_ANSWER_LENS = (0, 1200, 1, 700, 0, 1200, 37, 1200)
# f32: out, dq, dk, dv are sums of up to 1550 (dk, dv: 1550 · 7) products,
# taken in another order than the plain version's. Their rounding grows with
# the size of the sum: about 2^-24 times the square root of the terms (~100)
# times the largest value, some 1e-5 of it. So the tolerance is FA_F32_ATOL
# times the tensor's largest plain value, at least 1: 1e-4 absolute for the
# O(1) outputs, relative for the grads that sum long (|dk| reaches ~30 at
# this shape). A masking or indexing fault moves values by O(1).
FA_F32_ATOL = 1e-4
# the learner in f32, K4 vs its plain version: the loss and every LoRA grad
# (max |d| over max |g|) relative; the same sums in another order through
# 2 layers of forward and backward. Learner vs engine logprobs in f32: the
# engine's cached reference attention and K4 sum in other orders, as the
# paged and dense engines do (LOGIT_F32_ATOL)
LEARNER_REL = 1e-4
LEARNER_LOGP_ATOL = 1e-3

# K3 at the main path's shapes: Qwen2.5-7B's projections as (K, N) — wq and
# wo, wk and wv, w_gate and w_up, w_down — at decode's M = 64 and the
# learner's M = 8 x 1550; int4 in groups of 64 (the QLoRA base) and int8
# with per-column scales; a rank-32 adapter. f32: sums of up to 18,944
# products in another order, so QMM_F32_REL times the largest |y|. bf16:
# twice the plain version's own bf16-vs-f32 distance on the same inputs,
# plus 1e-3 (as K4's stanza)
QMM_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
QMM_ROWS = (64, 12400)
QMM_VERIFY_ROWS = 320  # the speculative verify step over a quantized base: 64 slots x 5
QMM_GROUP = 64
QMM_RANK = 32
# K3 past rank 64 (the TPU kernel takes any rank): 128, and 200, no multiple
# of 32 or 64; at decode's M = 64, the verify step at spec_draft 12 (32
# slots x S 13 = 416, phase 14's) and the learner's 12,400
QMM_HIGH_RANKS = (128, 200)
QMM_HIGH_RANK_ROWS = (64, 416, 12400)
QMM_F32_REL = 1e-4
# phases 6 and 7, 9 (a)-(c) and 11 (e) run at a quarter of Qwen2.5-7B's
# depth, which keeps the script with phase 17 inside its time; phases 4 and
# 5 and 9 (d) run all 28 layers, phase 8's trainer (TRAINER_LAYERS) half
SHALLOW_LAYERS = 7


def reset_counts() -> None:
    for k in KERNELS:
        setattr(importlib.import_module(k["module"]), k["counter"], 0)


def read_counts() -> dict[str, int]:
    return {k["name"]: getattr(importlib.import_module(k["module"]), k["counter"])
            for k in KERNELS}


def hd256_counts(head_dim: int, *, bf16_fwd: int = 0, bf16_bwd: int = 0, f32_fwd: int = 0,
                 f32_bwd: int = 0) -> dict[str, int]:
    """The counts of K4's head_dim 256 routes a path should show: the given
    launches at head_dim 256, none at any other."""
    at = head_dim == 256
    return {f"flash_attention_{part}_hd256_{dt}": n if at else 0
            for (dt, part), n in ((("bf16", "fwd"), bf16_fwd), (("bf16", "bwd"), bf16_bwd),
                                  (("f32", "fwd"), f32_fwd), (("f32", "bwd"), f32_bwd))}


def domain_counts(*, rank_chunks: int = 0, row_tiles: int = 0) -> dict[str, int]:
    """The counts of K3's launches past rank 64 and K5's past 64 query rows a
    path should show."""
    return {"quant_matmul_rank_chunks": rank_chunks, "paged_verify_row_tiles": row_tiles}


def ptxas_lines(log: str) -> list[tuple[str, str]]:
    """ptxas -v's report, one (entry, "registers ...; spills ...") pair per
    entry function (each template instance): its spills come before its
    registers in the log."""
    out, entry, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
            # a kernel and its template instance by its mangled arguments,
            # e.g. paged_mma_kernelIaLi128ELi1EE: int8 pages, hd 128, 1 m-tile;
            # flash_fwd_mmaILi256EE: K4's bf16 forward at hd 256
            m = re.search(r"\d+([a-z_]+_(?:kernel|mma))(I\w*?EE)?", entry)
            entry = m.group(1) + (m.group(2) or "") if m else "kernel"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line or "error" in line:
            out.append((entry, f"{line.split(':', 1)[-1].strip()}; {spill}"))
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out.splitlines()[0]


def _time_ms(fn, calls: int = 30, warmup: int = 3) -> float:
    """Median of ``calls`` single-call CUDA-event timings, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fused_sample_bound_ms(rows: int, vocab: int, sampling: bool,
                          kept: int | None = None) -> tuple[float, str]:
    """Least time on the card for one fused_sample call, the largest of three
    times: each input read and each output written once (f32 logits, int32
    seeds; int32 token and f32 logprob per row) over HBM bandwidth; the f32
    operations over the f32 peak; the transcendentals over the SFU's rate.
    Operations: 4 per element for greedy (argmax compare; sub, exp, add of
    the logprob's log-sum-exp); sampling adds 38 per element (the
    temperature division, softmax's sub/exp/add/div, 16 bisection
    compare+add pairs, the filter compare) and 19 per kept column (13 for
    the uint32 hash and its float conversion, 4 for -log(-log u), the noise
    add and the draw's compare). Transcendentals: the exps of the two sums
    (one when greedy), and the draw's two logs on each kept column.
    ``kept``: the kept columns summed over the rows, as this run's data
    gives them (``kept_columns``); None counts every column as kept."""
    cells = rows * vocab
    kept = cells if kept is None else kept
    nbytes = cells * 4 + rows * 4 + rows * 8
    ops = cells * 4 + ((cells * 38 + kept * 19) if sampling else 0)
    sfu = cells * (2 if sampling else 1) + (2 * kept if sampling else 0)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(ops / F32_OPS_PER_S, sfu / SFU_OPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def kept_columns(logits, temperature: float, top_p: float, iters: int = 16) -> int:
    """The columns the nucleus keeps (probs >= the bisected threshold),
    summed over the rows, by the plain version's arithmetic; every column
    at temperature 0 (nothing is drawn)."""
    import torch

    smp = _sampling()
    if temperature == 0.0:
        return logits.numel()
    scaled = logits.float() / max(temperature, 1e-6)
    e = torch.exp(scaled - scaled.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    lo = smp._bisect_threshold(probs, top_p, iters)
    return int((probs >= lo[:, None]).sum())


# K1's stanza: rows 1 to 128 at Qwen2.5's vocabulary, then 64 rows at every
# preset's (TINY 256, Mistral 32000, Llama-3 128256, Qwen2.5-0.5B 151936,
# Gemma 256000), 64 x 1000 and a ragged 7 x 999 (unaligned rows: the
# kernel's 4-byte copies)
K1_SHAPES = ((1, VOCAB), (16, VOCAB), (ROWS, VOCAB), (128, VOCAB), (ROWS, 256),
             (ROWS, 1000), (ROWS, 32000), (ROWS, 128256), (ROWS, 151936), (ROWS, 256000),
             (7, 999))


def _k1_logits(gen, b: int, v: int, dev):
    """Logits of std 3; bf16-rounded at a model's vocabulary (>= 32000), as
    the engine's lm_head gives them, so exact ties at the top occur."""
    import torch

    logits = torch.randn((b, v), generator=gen, device=dev) * 3.0
    return logits.bfloat16().float() if v >= 32000 else logits


def compare_fused_sample(device, seed: int, shapes=K1_SHAPES) -> float:
    """The kernel against its plain version on ``device`` at ``shapes`` under
    every sampler setting, each case run twice for identical bits, then a
    row of NaN. Prints each shape's cluster plan (and on the card how many
    such clusters it holds at once). Returns the largest |dlogp|."""
    import torch

    smp = _sampling()
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_err, rows_total, near_ties, excused = 0.0, 0, 0, 0
    for b, v in shapes:
        plan = smp.plan_sample_cluster(b, v)
        active = (f", {smp.max_active_clusters(plan)} clusters at once"
                  if dev.type == "cuda" else "")
        print(f"kernel fused_sample plan [{b},{v}]: C {plan.cluster}, {plan.blocks} blocks "
              f"of {plan.threads} threads x {plan.cols} columns, {plan.smem_bytes} bytes of "
              f"shared memory a block{active}")
        logits = _k1_logits(gen, b, v, dev)
        for name, t, p in SAMPLER_SETTINGS:
            seeds = torch.randint(-2**31, 2**31, (b,), generator=gen, device=dev,
                                  dtype=torch.int32)
            tok, logp = smp.fused_sample(logits, t, p, seeds)
            tok2, logp2 = smp.fused_sample(logits, t, p, seeds)
            check(torch.equal(tok, tok2) and torch.equal(logp, logp2),
                  f"fused_sample [{b},{v}] {name}: a second run gave other bits")
            rtok, rlogp = smp.fused_sample_reference(logits, t, p, seeds)
            scores = smp.fused_sample_scores(logits, t, p, seeds)
            top2 = scores.topk(min(2, v), dim=-1).values
            tie = ((top2[:, 0] - top2[:, -1]).abs()
                   <= NEAR_TIE_REL * top2[:, 0].abs().clamp_min(1e-30)) & (v > 1)
            same = tok == rtok
            check(bool(((tok >= 0) & (tok < v)).all()),
                  f"fused_sample [{b},{v}] {name}: token out of range")
            check(bool((same | tie).all()),
                  f"fused_sample [{b},{v}] {name}: tokens differ from the plain "
                  f"version on rows {(~(same | tie)).nonzero().flatten().tolist()}")
            own = (logp - smp.token_logprob(logits, tok)).abs().max()
            vs_plain = (logp - rlogp).abs()[same]
            err = max(float(own), float(vs_plain.max()) if vs_plain.numel() else 0.0)
            check(err <= LOGP_ATOL,
                  f"fused_sample [{b},{v}] {name}: |dlogp| {err:.3g} > {LOGP_ATOL}")
            max_err = max(max_err, err)
            rows_total += b
            near_ties += int(tie.sum())
            excused += int((~same).sum())
            print(f"kernel fused_sample [{b},{v}] {name} (t={t}, top_p={p}): "
                  f"tokens equal on {int(same.sum())}/{b} rows, near-tie rows "
                  f"{int(tie.sum())}, max |dlogp| {err:.3g}, second run bit-identical")
    check(excused * 1000 <= rows_total,
          f"fused_sample: {excused} near-tie rows differ, above 1 in 1000 of "
          f"{rows_total}")
    print(f"kernel fused_sample: {excused} of {rows_total} rows differ, all "
          f"near-ties ({near_ties} near-tie rows in all); max |dlogp| {max_err:.3g} "
          f"(tolerance {LOGP_ATOL})")

    nan_logits = torch.randn((3, 1000), generator=gen, device=dev)
    nan_logits[1] = float("nan")
    for t in (0.0, 1.2):
        tok, _ = smp.fused_sample(nan_logits, t, 0.95,
                                  torch.tensor([5, 6, 7], dtype=torch.int32, device=dev))
        check(bool(((tok >= 0) & (tok < 1000)).all()),
              f"fused_sample: a NaN row gave an out-of-range token at t={t}")
    print("kernel fused_sample: a row of NaN returns an in-range token (greedy and sampled)")
    return max_err


def _k1_graph_ms(logits, seeds) -> tuple[float, int]:
    """K1's device ms per call under the train setting as a CUDA graph over
    copies of the logits whose cycle reads more than twice the 50 MB L2, so
    each call finds its row cold, as a decode step does. Returns (ms,
    copies)."""
    smp = _sampling()
    copies = int(2 * L2_BYTES // (logits.numel() * 4)) + 1
    sets = [logits] + [logits.clone() for _ in range(copies - 1)]
    ms = _graph_ms([lambda x=x: smp.fused_sample(x, 1.2, 0.95, seeds) for x in sets] * 2)
    return ms, copies


def time_fused_sample(seed: int) -> dict:
    """The kernel's time at the main path's shape under the train setting
    (a CUDA graph over logits copies past the L2, and one call at a time,
    host enqueue included, as earlier kernels were timed), the plain
    version's and the card's bound for this run's kept columns."""
    import torch

    smp = _sampling()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = _k1_logits(gen, ROWS, VOCAB, dev)
    seeds = torch.randint(-2**31, 2**31, (ROWS,), generator=gen, device=dev,
                          dtype=torch.int32)
    plan = smp.plan_sample_cluster(ROWS, VOCAB)
    ms, copies = _k1_graph_ms(logits, seeds)
    single_ms = _time_ms(lambda: smp.fused_sample(logits, 1.2, 0.95, seeds))
    plain_ms = _time_ms(lambda: smp.fused_sample_reference(logits, 1.2, 0.95, seeds),
                        calls=20)
    kept = kept_columns(logits, 1.2, 0.95)
    bound_ms, bound_by = fused_sample_bound_ms(ROWS, VOCAB, sampling=True, kept=kept)
    del logits
    torch.cuda.empty_cache()
    # no single PyTorch call computes this function: library_ms is null
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "single_ms": single_ms,
            "copies": copies, "kept": kept, "plan": plan}


def paged_bytes(reaches, page_indices, *, q_dtype, kv_dtype, s: int = 1,
                page_size: int = PA_PAGE, heads: int = PA_HEADS, kv_heads: int = PA_KV_HEADS,
                head_dim: int = PA_HEAD_DIM) -> int:
    """The bytes one K2 (``s`` 1) or K5 call must move: every K/V position
    some row reads (its first ``reaches[row]`` positions) once, a page that
    several rows reach through the table (the n candidates of a prompt share
    its full prompt pages) once up to the furthest position any of them
    reads, with its f32 scales for int8 pages; then q and the output (``s``
    tokens a row), the lengths and the table entries the rows use."""
    import torch

    reach: dict[int, int] = {}  # page -> positions of it that some row reads
    entries = 0
    for row, n in zip(page_indices.tolist(), reaches):
        for j in range(-(-int(n) // page_size)):
            reach[row[j]] = max(reach.get(row[j], 0), min(page_size, int(n) - j * page_size))
            entries += 1
    per_position = head_dim * kv_dtype.itemsize + (4 if kv_dtype == torch.int8 else 0)
    rows = len(reaches)
    return (2 * kv_heads * sum(reach.values()) * per_position
            + 2 * rows * s * heads * head_dim * q_dtype.itemsize + rows * 4 + entries * 4)


def paged_attention_bound_ms(lengths, page_indices, *, q_dtype, kv_dtype,
                             page_size: int = PA_PAGE, heads: int = PA_HEADS,
                             kv_heads: int = PA_KV_HEADS,
                             head_dim: int = PA_HEAD_DIM) -> tuple[float, str]:
    """Least time on the card for one K2 call over rows of these lengths and
    this page table: the bytes the function must move over HBM bandwidth,
    against the QK and PV products (2 · 2 · H · length · hd operations per
    row) over the peak of their type: the bf16 tensor cores for bf16 q (int8
    pages dequantize to it), f32 outside the tensor cores for f32 q. The
    bytes are every K/V position some row attends to, read once: a page that
    several rows reach through the table (the n candidates of a prompt share
    its full prompt pages) counts once, up to the furthest position any of
    them reads, with its f32 scales for int8 pages; then q, the output, the
    lengths and the table entries the rows use."""
    import torch

    lens = [int(x) for x in lengths]
    nbytes = paged_bytes(lens, page_indices, q_dtype=q_dtype, kv_dtype=kv_dtype,
                         page_size=page_size, heads=heads, kv_heads=kv_heads,
                         head_dim=head_dim)
    ops = 4 * heads * sum(lens) * head_dim
    peak = F32_OPS_PER_S if q_dtype == torch.float32 else BF16_PEAK_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_case(device, seed: int, *, q_dtype, kv: str, prompt_lens, lengths,
               heads: int = PA_HEADS, kv_heads: int = PA_KV_HEADS, head_dim: int = PA_HEAD_DIM):
    """K2's inputs at the main path's geometry: random pages in a pool of
    ``P · 3 + P · 16 · 11`` pages for the P = ``len(prompt_lens)`` prompts
    (4 on the main path; 1 for a wave's tail of 16 rows), bf16/f32 or int8
    (quantized from bf16), q pre-scaled by hd^-0.5 in its dtype, and the
    page table the paged engine's fan-out builds for prompts of
    ``prompt_lens`` real tokens (shared full prompt pages, private tails);
    Qwen2.5-7B's heads unless ``heads``, ``kv_heads`` and ``head_dim`` say
    otherwise. Returns the wrapper's positional and keyword arguments."""
    import torch

    from distrl_llm_tpu_torch.engine.paged_engine import _page_table_rows
    from distrl_llm_tpu_torch.ops.paged import quantize_pages

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = len(prompt_lens)
    rows = prompts * PA_N
    total = prompts * PA_PROMPT_PAGES + rows * PA_PRIVATE_PAGES
    shape = (kv_heads, total, PA_PAGE, head_dim)
    full = torch.tensor(prompt_lens, device=dev) // PA_PAGE
    table = _page_table_rows(
        torch.arange(prompts, device=dev).repeat_interleave(PA_N),
        full.repeat_interleave(PA_N),
        prompts * PA_PROMPT_PAGES + torch.arange(rows, device=dev) * PA_PRIVATE_PAGES,
        prompt_pages=PA_PROMPT_PAGES, private_pages=PA_PRIVATE_PAGES)
    pages = [torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
    kw = {}
    if kv == "int8":
        qk, qv = (quantize_pages(x.bfloat16()) for x in pages)
        pages = [qk.weight, qv.weight]
        kw = {"k_scales": qk.scales, "v_scales": qv.scales}
    else:
        pages = [x.to(getattr(torch, kv)) for x in pages]
    q = (torch.randn((rows, heads, head_dim), generator=gen, device=dev)
         .to(q_dtype) * head_dim**-0.5)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, pages[0], pages[1], lens, table), kw


# (q dtype, page format) pairs K2 is held to: the engine's bf16 and int8 KV
# under bf16 activations, and f32 throughout
PA_CASES = (("bfloat16", "bfloat16"), ("bfloat16", "int8"), ("float32", "float32"))


def _paged_build_lines(name: str, instance: str) -> list[str]:
    """ptxas's registers and spills of the kernels a stanza runs from
    ``csrc/<name>.cu``'s library (this process's build log; empty if it was
    cached): the tensor-core body's ``instance`` (its mangled template
    arguments), the f32 CUDA-core body and the merge."""
    from distrl_llm_tpu_torch.ops import _build

    want = re.compile(rf"{instance}|cc_kernelIffEE|merge_kernel")
    return [f"{entry}: {line}" for entry, line in ptxas_lines(_build.load(name).log)
            if want.search(entry)]


def _split_lengths(span: int, caps, fixed, draw, rng):
    """Lengths of 64 rows for the K2/K5 stanzas: ``fixed`` on the first
    rows of every 16, then lengths on the split's boundaries (a split's last
    position, one past it, the second split's last position and one past
    it; ``span`` positions a split), a row reaching exactly its table's end,
    and random lengths from ``draw``; each clipped to its row's ``caps``."""
    import torch

    edges = (span, span + 1, 2 * span, 2 * span + 1, 10**6)
    out = []
    for r, cap in enumerate(caps):
        k = r % 16
        if k < len(fixed):
            want = fixed[k]
        elif k < len(fixed) + len(edges):
            want = edges[k - len(fixed)]
        else:
            want = int(torch.randint(*draw, (1,), generator=rng))
        out.append(min(want, cap))
    return out


def compare_paged_attention(device, seed: int) -> float:
    """K2 against its plain version on ``device`` at the main path's
    geometry, for each of ``PA_CASES`` and pages_per_block 1, 3 and 8: 64
    rows whose lengths cover 0, 1, 127, 128, 129, a page-aligned 256, 1550
    (clipped to the row's table), the boundaries of the planned split (its
    last position, one past it), a row reaching its table's end, and random
    lengths. Rows of length 0 must be exactly 0, a second run must give the
    same bits, and garbage table entries past every row's length must change
    nothing. Prints the plan and the kernels' registers. Returns the largest
    |dout| over all cases."""
    import torch

    from distrl_llm_tpu_torch.ops.paged_native import (
        paged_attention_native, paged_attention_native_reference, plan_paged_split,
    )

    dev = torch.device(device)
    prompt_lens = (350, 256, 128, 60)  # two full pages, two aligned, one, none
    rows = PA_PROMPTS * PA_N
    plan = plan_paged_split(rows, PA_KV_HEADS, PA_PROMPT_PAGES + PA_PRIVATE_PAGES, PA_PAGE)
    caps = [(prompt_lens[r // PA_N] // PA_PAGE + PA_PRIVATE_PAGES) * PA_PAGE
            for r in range(rows)]
    lengths = _split_lengths(plan.pages_per_split * PA_PAGE, caps,
                             (0, 1, 127, 128, 129, 256, 1550), (2, 1700),
                             torch.Generator().manual_seed(seed))
    print(f"kernel paged_attention: plan at {rows} rows x {PA_KV_HEADS} kv heads, "
          f"{PA_PROMPT_PAGES + PA_PRIVATE_PAGES} pages of {PA_PAGE}: {plan.splits} splits of "
          f"{plan.pages_per_split} pages, {plan.blocks} blocks; lengths {lengths[:16]}")
    if device != "cpu":
        # hd 128, one m-tile of 8-row heads (G = 7): <KVT, 128, 1, 1>
        for line in _paged_build_lines("paged_attention", "Li128ELi1ELi1EE"):
            print(f"kernel paged_attention build: {line}")
    worst = 0.0
    for qn, kv in PA_CASES:
        q_dtype = getattr(torch, qn)
        args, kw = paged_case(dev, seed, q_dtype=q_dtype, kv=kv,
                              prompt_lens=prompt_lens, lengths=lengths)
        want = paged_attention_native_reference(*args, **kw).float()
        for ppb in (1, 3, 8):
            got = paged_attention_native(*args, **kw, pages_per_block=ppb)
            again = paged_attention_native(*args, **kw, pages_per_block=ppb)
            gf = got.float()
            err = (gf - want).abs()
            if q_dtype == torch.float32:
                tol = torch.full_like(err, F32_ATOL)
            else:  # one bf16 ulp of the value, plus the f32 difference
                mag = torch.maximum(gf.abs(), want.abs()).clamp_min(2.0**-126)
                tol = torch.exp2(torch.floor(torch.log2(mag)) - 7) + F32_ATOL
            bad = err > tol
            check(bool(torch.isfinite(gf).all()), f"K2 {qn}/{kv} ppb={ppb}: non-finite output")
            check(not bool(bad.any()),
                  f"K2 {qn}/{kv} ppb={ppb}: |dout| {float(err.max()):.3g} above the "
                  f"tolerance on {int(bad.sum())} elements")
            check(torch.equal(got, again), f"K2 {qn}/{kv} ppb={ppb}: a second run gave "
                  "other bits")
            zero_rows = args[3] == 0
            check(bool((got[zero_rows] == 0).all()), f"K2 {qn}/{kv} ppb={ppb}: a "
                  "length-0 row is not exactly 0")
            worst = max(worst, float(err.max()))
            print(f"kernel paged_attention q {qn}, pages {kv}, pages_per_block {ppb}: "
                  f"max |dout| {float(err.max()):.3g} over {got.numel()} outputs; second "
                  f"run bit-identical")
        # the table past each row's length is never read: poison it
        q, kp, vp, lens, table = args
        live = -(-lens.long() // PA_PAGE)
        cols = torch.arange(table.shape[1], device=dev)[None, :]
        poisoned = torch.where(cols >= live[:, None], 10**6, table).to(torch.int32)
        base = paged_attention_native(q, kp, vp, lens, table, **kw)
        again = paged_attention_native(q, kp, vp, lens, poisoned.contiguous(), **kw)
        check(torch.equal(base, again), f"K2 {qn}/{kv}: garbage table entries past "
              "the length changed the output")
    print(f"kernel paged_attention: all cases within tolerance (f32 {F32_ATOL}; bf16 "
          f"one ulp + {F32_ATOL}); length-0 rows exactly 0; second runs bit-identical; "
          f"max |dout| {worst:.3g}")
    return worst


# the other shapes of K2 and K5's bodies, as the presets and draft lengths
# reach them: (query heads, kv heads, head_dim, page size, S or None for
# K2). Rows S·G of 1 to 8, 9-16, 17-32, 33-48 and 49-64 take each of the
# tensor-core body's block shapes (MMA_SHAPES); head_dim 256 and 16 the
# CUDA-core body with bf16 q; page sizes below a 64-position stage
PAGED_SHAPES = ((8, 1, 64, 16, None), (16, 1, 128, 32, None), (4, 4, 128, 64, None),
                (14, 2, 64, 8, 2), (16, 4, 128, 128, 5), (56, 8, 64, 16, 5),
                (28, 4, 128, 128, 9), (4, 2, 16, 8, 5), (8, 1, 256, 16, 3))


def compare_paged_shapes(device, seed: int, rows: int = 6) -> float:
    """K2 (S None) and K5 at every entry of ``PAGED_SHAPES`` against their
    plain versions on ``device``, bf16 q over bf16 and int8 pages and f32
    throughout, ``rows`` rows of random pages and lengths (a row of length
    0 or 1, one reaching the table's end, the rest random) over a table
    that the planner splits in three: the same tolerances as the stanzas,
    and a second run giving the same bits. Returns the largest |dout|."""
    import torch

    from distrl_llm_tpu_torch.ops.paged import quantize_pages
    from distrl_llm_tpu_torch.ops.paged_native import (
        MIN_SPLIT_POSITIONS, paged_attention_native, paged_attention_native_reference,
        paged_attention_native_verify, paged_attention_native_verify_reference,
    )

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for h, kh, hd, ps, s in PAGED_SHAPES:
        pps = 2 * -(-MIN_SPLIT_POSITIONS * (s or 1) // ps) + 1  # the shortest splits, 3 of them
        cap = pps * ps - (s or 0)
        lens = torch.randint(0, cap + 1, (rows,), generator=gen, device=dev)
        lens[0], lens[1] = (0 if s is None else 1), cap
        lens = lens.to(torch.int32)
        total = rows * pps
        table = torch.randperm(total, generator=gen, device=dev).reshape(rows, pps).int()
        pages = [torch.randn(kh, total, ps, hd, generator=gen, device=dev) for _ in range(2)]
        shape = (rows, h, hd) if s is None else (rows, s, h, hd)
        qf = torch.randn(shape, generator=gen, device=dev) * hd**-0.5
        for qn, kv in PA_CASES:
            q_dtype = getattr(torch, qn)
            kw = {}
            if kv == "int8":
                qk, qv = (quantize_pages(x.bfloat16()) for x in pages)
                kp, vp, kw = qk.weight, qv.weight, {"k_scales": qk.scales, "v_scales": qv.scales}
            else:
                kp, vp = (x.to(getattr(torch, kv)) for x in pages)
            args = (qf.to(q_dtype), kp, vp, lens, table)
            if s is None:
                got = paged_attention_native(*args, **kw)
                again = paged_attention_native(*args, **kw)
                want = paged_attention_native_reference(*args, **kw).float()
            else:
                got = paged_attention_native_verify(*args, **kw)
                again = paged_attention_native_verify(*args, **kw)
                want = paged_attention_native_verify_reference(*args, **kw).float()
            gf = got.float()
            err = (gf - want).abs()
            if q_dtype == torch.float32:
                tol = torch.full_like(err, F32_ATOL)
            else:  # one bf16 ulp of the value, plus the f32 difference
                mag = torch.maximum(gf.abs(), want.abs()).clamp_min(2.0**-126)
                tol = torch.exp2(torch.floor(torch.log2(mag)) - 7) + F32_ATOL
            what = f"{'K2' if s is None else f'K5 S={s}'} {h}/{kh} hd {hd} ps {ps} {qn}/{kv}"
            check(bool(torch.isfinite(gf).all()), f"{what}: non-finite output")
            check(not bool((err > tol).any()), f"{what}: |dout| {float(err.max()):.3g} above "
                  f"the tolerance on {int((err > tol).sum())} elements")
            check(torch.equal(got, again), f"{what}: a second run gave other bits")
            worst = max(worst, float(err.max()))
    print(f"kernel paged_attention/paged_verify at {len(PAGED_SHAPES)} more shapes (query "
          f"rows 1 to 63, head_dim 16 to 256, pages of 8 to 128; bf16/bf16, bf16/int8, "
          f"f32/f32): all within tolerance, second runs bit-identical; max |dout| {worst:.3g}")
    return worst


def _rotating_graph_ms(fn, args, kw, nbytes: int) -> tuple[float, int]:
    """Device ms per call of ``fn(*args, **kw)`` as a CUDA graph over enough
    copies of the pages (and int8 scales) that one cycle of calls reads
    more than twice the 50 MB L2 (``nbytes`` a call): each call finds its
    pages cold, as a decode step's layer does. Returns (ms, copies)."""
    import torch

    copies = int(2 * L2_BYTES // nbytes) + 1
    q, kp, vp, lens, table = args
    sets = [(kp, vp, kw)] + [
        (kp.clone(), vp.clone(), {k: v.clone() for k, v in kw.items()})
        for _ in range(copies - 1)]
    ms = _graph_ms([lambda c=c: fn(q, c[0], c[1], lens, table, **c[2]) for c in sets] * 2)
    del sets
    torch.cuda.empty_cache()
    return ms, copies


def time_paged_attention(seed: int) -> dict:
    """K2's and the plain version's times with every row at length 1550
    (prompts of 350 tokens), bf16 q: at B = 64 with bf16 and int8 pages, and
    at B = 16 (one prompt's candidates, a wave's tail) with bf16 pages,
    beside the card's bound. K2 runs as a CUDA graph over copies of the
    pages past twice the L2 (``_rotating_graph_ms``); the plain version one
    call at a time."""
    import torch

    from distrl_llm_tpu_torch.ops.paged_native import (
        paged_attention_native, paged_attention_native_reference, plan_paged_split,
    )

    out = {}
    for label, prompts, kv in (("bfloat16", PA_PROMPTS, "bfloat16"),
                               ("int8", PA_PROMPTS, "int8"), ("bfloat16_16rows", 1, "bfloat16")):
        lengths = [PA_TIMED_LENGTH] * (prompts * PA_N)
        args, kw = paged_case("cuda", seed, q_dtype=torch.bfloat16, kv=kv,
                              prompt_lens=(350,) * prompts, lengths=lengths)
        table = args[4].cpu()
        nbytes = paged_bytes(lengths, table, q_dtype=torch.bfloat16, kv_dtype=args[1].dtype)
        ms, copies = _rotating_graph_ms(paged_attention_native, args, kw, nbytes)
        plain_ms = _time_ms(lambda: paged_attention_native_reference(*args, **kw), calls=10)
        bound_ms, bound_by = paged_attention_bound_ms(
            lengths, table, q_dtype=torch.bfloat16, kv_dtype=args[1].dtype)
        plan = plan_paged_split(len(lengths), PA_KV_HEADS, table.shape[1], PA_PAGE)
        # no single PyTorch call takes a page table: library_ms is null
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None, "rows": len(lengths),
                      "copies": copies, "splits": plan.splits, "blocks": plan.blocks}
        del args, kw
        torch.cuda.empty_cache()
    return out


def flash_bound_ms(valid, *, heads: int, kv_heads: int, head_dim: int, itemsize: int,
                   backward: bool) -> tuple[float, str]:
    """Least time on the card for one K4 forward (or backward) over these
    key-validity rows: the operations over the causal pairs whose key is
    valid (every query row i counts the valid keys j <= i), 4·hd per pair
    and head forward (q·k and p·v), 10·hd backward (s, dp, dv, dk, dq), at
    the peak of their type (bf16: the tensor cores'; f32, ``itemsize`` 4:
    the CUDA cores', never TF32); against the bytes, each input read and
    each output written once (forward: q, k, v, key_valid, out, lse;
    backward: q, k, v, key_valid, out, lse, dout, dq, dk, dv)."""
    b, s = valid.shape
    pairs = float(valid.long().cumsum(dim=1).sum())
    q_elems, kv_elems = b * s * heads * head_dim, b * s * kv_heads * head_dim
    if backward:
        ops = 10 * head_dim * heads * pairs
        nbytes = itemsize * (4 * q_elems + 4 * kv_elems) + 4 * b * s + 4 * b * heads * s
    else:
        ops = 4 * head_dim * heads * pairs
        nbytes = itemsize * (2 * q_elems + 2 * kv_elems) + 4 * b * s + 4 * b * heads * s
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (F32_OPS_PER_S if itemsize == 4 else BF16_PEAK_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_case(device, seed: int, dtype, *, batch: int = FA_BATCH, prompt: int = FA_PROMPT,
               answer: int = FA_ANSWER, heads: int = PA_HEADS, kv_heads: int = PA_KV_HEADS,
               head_dim: int = PA_HEAD_DIM, prompt_lens=FA_PROMPT_LENS,
               answer_lens=FA_ANSWER_LENS):
    """K4's inputs at the learner's shape: q, k, v and an output gradient
    from ``seed`` in ``dtype``, and the key validity of left-padded prompts
    of ``prompt_lens`` real tokens followed by right-padded answers of
    ``answer_lens`` (the learner's [prompt | answer] concatenation)."""
    import torch

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = prompt + answer
    q, dout = (torch.randn((batch, s, heads, head_dim), generator=gen, device=dev)
               for _ in range(2))
    k, v = (torch.randn((batch, s, kv_heads, head_dim), generator=gen, device=dev)
            for _ in range(2))
    valid = torch.zeros((batch, s), dtype=torch.int32, device=dev)
    for r in range(batch):
        pl, al = prompt_lens[r % len(prompt_lens)], answer_lens[r % len(answer_lens)]
        valid[r, prompt - min(pl, prompt):prompt] = 1
        valid[r, prompt:prompt + min(al, answer)] = 1
    return [x.to(dtype) for x in (q, k, v, dout)] + [valid]


def _flash_run(fn, q, k, v, dout, valid):
    """out, dq, dk, dv of ``fn`` (K4's wrapper or its plain version)."""
    import torch

    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v, valid)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))


def compare_flash_attention(device, seed: int, **shape) -> dict:
    """K4 against its plain version on ``device`` at the learner's shape
    (``flash_case``), forward and backward: in f32 every one of out, dq,
    dk, dv within ``FA_F32_ATOL`` times its largest plain value (at least 1);
    in bf16 within twice the plain version's
    own bf16-vs-f32 distance on the same inputs plus 1e-3 (each measured per
    tensor in this run). Rows with no valid key must be exactly 0, nothing
    may be non-finite, and a second run must give the same bits (K4 sums
    without atomics). Returns the largest f32 difference and the bf16
    distances."""
    import torch

    from distrl_llm_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference,
    )

    names = ("out", "dq", "dk", "dv")
    q, k, v, dout, valid = flash_case(device, seed, torch.float32, **shape)
    keyless = ~(valid.cumsum(dim=1) > 0)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = [x.to(dtype) for x in (q, k, v, dout)] + [valid]
        got = _flash_run(flash_attention, *args)
        want = _flash_run(flash_attention_reference, *args)
        label = str(dtype).split(".")[-1]
        for name, x in zip(names, got):
            check(bool(torch.isfinite(x.float()).all()), f"K4 {label}: non-finite {name}")
        check(bool((got[0][keyless] == 0).all()), f"K4 {label}: a row with no valid key "
              "is not exactly 0")
        again = _flash_run(flash_attention, *args)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K4 {label}: two runs differ (the backward must be deterministic)")
        errs = {n: float((a.float() - b.float()).abs().max()) for n, a, b in zip(names, got, want)}
        if dtype == torch.float32:
            res["f32"] = errs
            res["f32_tol"] = {n: FA_F32_ATOL * max(1.0, float(w.abs().max()))
                              for n, w in zip(names, want)}
            for n, e in errs.items():
                check(e <= res["f32_tol"][n], f"K4 f32 {n}: |d| {e:.3g} > {res['f32_tol'][n]:.3g}")
            wide = want
        else:
            noise = {n: float((a.float() - b).abs().max()) for n, a, b in zip(names, want, wide)}
            res["bf16"], res["bf16_noise"] = errs, noise
            for n in names:
                tol = 2 * noise[n] + 1e-3
                check(errs[n] <= tol, f"K4 bf16 {n}: |d| {errs[n]:.3g} > {tol:.3g} (twice "
                      f"the plain version's own bf16-vs-f32 distance {noise[n]:.3g}, + 1e-3)")
        print(f"kernel flash_attention {label} at {list(q.shape)} / k,v {list(k.shape)}: "
              + ", ".join(f"max |{n} - plain| {e:.3g}" for n, e in errs.items())
              + ("; tolerances " + ", ".join(f"{n} {t:.3g}" for n, t in res["f32_tol"].items())
                 if dtype == torch.float32 else
                 "; plain version's own bf16-vs-f32 distance " + ", ".join(
                     f"{n} {e:.3g}" for n, e in res["bf16_noise"].items()))
              + f"; {int(keyless.sum())} keyless rows exactly 0; a second run bit-identical")
    res["max_abs_err"] = max(res["f32"].values())
    return res


def time_flash_attention(seed: int, dtype=None, **shape) -> dict:
    """K4's forward and backward at the learner's shape (``flash_case``'s,
    or ``shape``) in ``dtype`` (default bf16, the main path's) with its
    masks, beside the plain version's forward and backward, the card's
    bound, and ``F.scaled_dot_product_attention`` with a boolean [B, 1, S,
    S] mask and ``enable_gqa`` as the library yardstick (timed here only;
    the port never calls it). Backward times are the backward alone
    (autograd's over a kept graph for plain and library)."""
    import torch
    import torch.nn.functional as F

    from distrl_llm_tpu_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_forward, flash_attention_reference,
    )

    q, k, v, dout, valid = flash_case("cuda", seed, dtype or torch.bfloat16, **shape)
    scale = q.shape[-1] ** -0.5
    fwd_ms = _time_ms(lambda: flash_attention_forward(q, k, v, valid, scale), calls=10)
    out, lse = flash_attention_forward(q, k, v, valid, scale)
    bwd_ms = _time_ms(lambda: flash_attention_backward(q, k, v, valid, out, lse, dout, scale),
                      calls=10)

    def fwd_bwd_ms(fn):
        with torch.no_grad():
            f_ms = _time_ms(lambda: fn(q, k, v), calls=5, warmup=1)
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*leaves)
        b_ms = _time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
                        calls=5, warmup=1)
        del o
        torch.cuda.empty_cache()
        return f_ms, b_ms

    plain = fwd_bwd_ms(lambda q_, k_, v_: flash_attention_reference(q_, k_, v_, valid))
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = ((pos[None, :] <= pos[:, None])[None] & valid.bool()[:, None, :])[:, None]
    try:
        library = fwd_bwd_ms(lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2), attn_mask=mask,
            enable_gqa=True).transpose(1, 2))
    except RuntimeError as e:  # the yardstick only: report, never fail the run
        print(f"kernel flash_attention: the library yardstick did not run: {e}")
        library = (None, None)
    dims = dict(heads=q.shape[2], kv_heads=k.shape[2], head_dim=q.shape[3],
                itemsize=q.element_size())
    out = {}
    for i, (name, ms) in enumerate((("fwd", fwd_ms), ("bwd", bwd_ms))):
        bound_ms, bound_by = flash_bound_ms(valid, backward=name == "bwd", **dims)
        out[name] = {"ms": ms, "plain_ms": plain[i], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library[i]}
    return out


def _qmm():
    from distrl_llm_tpu_torch.ops import quant_matmul

    return quant_matmul


def qmm_case(device, seed: int, *, k: int, n: int, m: int, bits: int, group, dtype,
             bias: bool = True, rank: int = QMM_RANK):
    """K3's inputs: x [m, k] in ``dtype``, a weight N(0, 0.02) quantized to
    ``bits`` (``group``; None = per column), a bias in ``dtype`` (or None)
    and an f32 rank-``rank`` adapter (A ~ N(0, 1/k), B ~ N(0, 0.01^2)),
    from ``seed``. Returns (x, w, bias, A, B)."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import quantize

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = quantize(torch.randn((k, n), generator=gen, device=dev).mul_(0.02).bfloat16(),
                 bits, group)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype) if bias else None
    la = torch.randn((k, rank), generator=gen, device=dev) * k**-0.5 if rank else None
    lb = torch.randn((rank, n), generator=gen, device=dev) * 0.01 if rank else None
    return x, w, b, la, lb


def compare_quant_matmul(device, seed: int, *, shapes=QMM_SHAPES,
                         rows=(QMM_ROWS[0], QMM_VERIFY_ROWS, QMM_ROWS[1]),
                         group: int = QMM_GROUP, scale: float = 0.5) -> dict:
    """K3 against its plain version on ``device`` at the main path's shapes:
    every (K, N) of ``shapes`` at every M of ``rows``, int4 in groups of
    ``group`` and int8 per column, bf16 x with a rank-32 adapter (a bias on
    the first two shapes, the q/k/v projections); f32 x at the first M; the
    edges M = 1 and 7, N = 200 and one group of the whole K. Then one-hot
    rows of x, which must reproduce ``dequantize()``'s rows exactly (a wrong
    nibble order or group index shows there), and ``quantize`` of one
    full-width layer's seven weights on ``device`` against the CPU, bit for
    bit. Returns the largest f32 difference (relative and absolute), the
    bf16 differences and their tolerances, and the two exact checks."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import dequantize, quantize

    qm = _qmm()
    res = {"f32_rel": 0.0, "f32_abs": 0.0, "bf16": []}
    k0 = shapes[0][0]
    cases = [(k, n, m, bits, torch.bfloat16, i < 2)
             for i, (k, n) in enumerate(shapes) for m in rows for bits in (4, 8)]
    cases += [(k, n, rows[0], bits, torch.float32, i < 2)
              for i, (k, n) in enumerate(shapes) for bits in (4, 8)]
    cases += [(k0, n, m, bits, dt, True) for m in (1, 7) for n in (200,) for bits in (4, 8)
              for dt in (torch.bfloat16, torch.float32)]
    for case_i, case in enumerate(cases):
        check_quant_matmul_case(device, seed + case_i, *case, group=group, rank=QMM_RANK,
                                scale=scale, res=res)
    # one group of the whole K (int4 g = K) and no adapter
    x, w, _, _, _ = qmm_case(device, seed, k=k0, n=200, m=7, bits=4, group=k0,
                             dtype=torch.float32, bias=False, rank=0)
    err = float((qm.quant_matmul(x, w) - qm.quant_matmul_reference(x, w)).abs().max())
    check(err <= QMM_F32_REL * float(qm.quant_matmul_reference(x, w).abs().max()),
          f"K3 int4 g=K: |d| {err:.3g}")
    # one-hot rows: y = dequantize(w)[ks], exactly
    exact = True
    for bits in (4, 8):
        g = group if bits == 4 else None
        for dt in (torch.float32, torch.bfloat16):
            _, w, _, _, _ = qmm_case(device, seed + bits, k=k0, n=shapes[0][1], m=1, bits=bits,
                                     group=g, dtype=dt, bias=False, rank=0)
            ks = sorted({0, 1, 2, 3, group - 1, group, group + 1, k0 - 2, k0 - 1}
                        | set(range(5, k0, max(1, k0 // 40))))[:64]
            x = torch.zeros((len(ks), k0), dtype=dt, device=w["scale"].device)
            x[torch.arange(len(ks)), torch.tensor(ks)] = 1
            same = torch.equal(qm.quant_matmul(x, w), dequantize(w, dt)[ks])
            exact &= same
            check(same, f"K3 int{bits} {dt}: one-hot rows differ from dequantize()'s rows")
    # quantize on the device against the CPU, at the (K, N) of every weight
    # of one layer
    bits_equal = True
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    for kk, nn in shapes:
        w = (torch.randn((kk, nn), generator=gen, device=device) * 0.02).bfloat16()
        for bits, g in ((4, group), (8, None)):
            on_dev, on_cpu = quantize(w, bits, g), quantize(w.cpu(), bits, g)
            same = all(torch.equal(on_dev[key].cpu(), on_cpu[key]) for key in on_cpu)
            bits_equal &= same
            check(same, f"quantize int{bits} [{kk},{nn}]: {device} and the CPU differ")
    res.update(onehot_exact=exact, quantize_bits_equal=bits_equal)
    print(f"kernel quant_matmul: {len(cases) + 1} cases within tolerance (f32 {QMM_F32_REL} x "
          f"max |y|, bf16 twice the plain version's own distance + 1e-3); max f32 |d| "
          f"{res['f32_abs']:.3g} ({res['f32_rel']:.3g} relative); one-hot rows equal "
          f"dequantize() exactly (int4 g{group} and int8, f32 and bf16); quantize at every "
          f"weight shape of a layer bit-equal on {device} and the CPU (int4 and int8)")
    return res


def check_quant_matmul_case(device, seed: int, k: int, n: int, m: int, bits: int, dt,
                            bias: bool, *, group: int, rank: int, scale: float,
                            res: dict) -> None:
    """One case of K3 against its plain version (``qmm_case``'s inputs:
    int4 in groups of ``group`` or int8 per column, a rank-``rank`` f32
    adapter with non-zero B): f32 within ``QMM_F32_REL`` of max |y|, bf16
    within twice the plain version's own bf16-vs-f32 distance + 1e-3.
    Records the differences in ``res``."""
    import torch

    qm = _qmm()
    g = group if bits == 4 else None
    x, w, b, la, lb = qmm_case(device, seed, k=k, n=n, m=m, bits=bits, group=g, dtype=dt,
                               bias=bias, rank=rank)
    got = qm.quant_matmul(x, w, b, la, lb, scale)
    want = qm.quant_matmul_reference(x, w, b, la, lb, scale)
    check(bool(torch.isfinite(got.float()).all()), f"K3 [{m},{k}]x[{k},{n}]: non-finite")
    err = float((got.float() - want.float()).abs().max())
    label = f"K3 int{bits} {str(dt).split('.')[-1]} [{m},{k}] x [{k},{n}]"
    if dt == torch.float32:
        ymax = float(want.abs().max())
        check(err <= QMM_F32_REL * ymax, f"{label}, rank {rank}: |d| {err:.3g} > "
              f"{QMM_F32_REL} x {ymax:.3g}")
        res["f32_rel"] = max(res["f32_rel"], err / ymax)
        res["f32_abs"] = max(res["f32_abs"], err)
        print(f"kernel quant_matmul {label}{', bias' if bias else ''}, rank {rank}: "
              f"max |d| {err:.3g} ({err / ymax:.3g} of max |y| {ymax:.3g})")
    else:
        wide = qm.quant_matmul_reference(x.float(), w, None if b is None else b.float(),
                                         la, lb, scale)
        noise = float((want.float() - wide).abs().max())
        tol = 2 * noise + 1e-3
        check(err <= tol, f"{label}, rank {rank}: |d| {err:.3g} > {tol:.3g} (twice the plain "
              f"version's own bf16-vs-f32 distance {noise:.3g}, + 1e-3)")
        res["bf16"].append((label, err, tol))
        print(f"kernel quant_matmul {label}{', bias' if bias else ''}, rank {rank}: "
              f"max |d| {err:.3g}; plain version's own bf16-vs-f32 distance {noise:.3g}")


def compare_quant_matmul_ranks(device, seed: int, *, ranks=QMM_HIGH_RANKS, shapes=QMM_SHAPES,
                               rows=QMM_HIGH_RANK_ROWS, group: int = QMM_GROUP,
                               scale: float = 0.5, edge_k: int = 256) -> dict:
    """K3 past rank 64 against its plain version (``check_quant_matmul_case``),
    at each rank of ``ranks``: bf16 x at every (K, N) of ``shapes`` at the
    first M of ``rows``, and at w_gate's (the third shape) at the others (the
    verify step at d = 12, the learner), int4 and int8; f32 x at w_gate's
    first M; and the edges where the rank chunks meet the tiling: N = 200 at
    M = 7 (a split call with fewer column blocks than chunks) and K =
    ``edge_k`` at M = 40 (one split: xa from its own kernel). Returns the
    largest f32 difference and the bf16 differences with their tolerances."""
    import torch

    res = {"f32_rel": 0.0, "f32_abs": 0.0, "bf16": []}
    k0, gate = shapes[0][0], shapes[2 % len(shapes)]
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(k, n, rows[0], bits, bf, i < 2) for i, (k, n) in enumerate(shapes)
             for bits in (4, 8)]
    cases += [(*gate, m, bits, bf, False) for m in rows[1:] for bits in (4, 8)]
    cases += [(*gate, rows[0], bits, f32, False) for bits in (4, 8)]
    cases += [(k0, 200, 7, 4, dt, True) for dt in (bf, f32)]
    cases += [(edge_k, 512, 40, bits, bf, False) for bits in (4, 8)]
    n_cases = 0
    for rank in ranks:
        for case_i, case in enumerate(cases):
            check_quant_matmul_case(device, seed + 1000 * rank + case_i, *case, group=group,
                                    rank=rank, scale=scale, res=res)
            n_cases += 1
    print(f"kernel quant_matmul at ranks {list(ranks)}: {n_cases} cases within tolerance (f32 "
          f"{QMM_F32_REL} x max |y|, bf16 twice the plain version's own distance + 1e-3); "
          f"max f32 |d| {res['f32_abs']:.3g} ({res['f32_rel']:.3g} relative)")
    return res


def quant_matmul_bound_ms(m: int, k: int, n: int, *, bits: int, group, rank: int,
                          bias: bool, itemsize: int = 2) -> tuple[float, str]:
    """Least time on the card for one K3 call: each input read and the output
    written once (x, the payload at its width, the f32 scales, the bias if
    the call has one, A and B in f32, y) over HBM bandwidth, against 2 M K N
    (+ 2 M r (K + N) for the adapter) operations at the bf16 tensor cores'
    peak."""
    groups = k // (group or k)
    nbytes = (m * k * itemsize + k * n * bits // 8 + groups * n * 4
              + (n * itemsize if bias else 0) + 4 * rank * (k + n) + m * n * itemsize)
    ops = 2 * m * k * n + 2 * m * rank * (k + n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _graph_ms(calls, replays: int = 5) -> float:
    """Device time per call of ``calls`` (thunks launching work on the
    card), captured once into a CUDA graph and replayed ``replays`` times
    after a warm-up replay: the calls run back to back, without the host's
    per-call enqueue time, which at decode sizes exceeds the kernels' own."""
    import torch

    for fn in calls[:2]:  # lazy initialisation outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * len(calls))
    del graph
    torch.cuda.empty_cache()
    return ms


L2_BYTES = 50e6  # the H100's L2 cache


def time_quant_matmul(seed: int, *, shape=(3584, 18944), scale: float = 0.5,
                      rank: int = QMM_RANK, gate_rows=(QMM_ROWS[1],)) -> dict:
    """K3's, the plain version's and the library yardstick's times beside
    the bound, bf16 x and a rank-``rank`` adapter, int4 g64 and int8 per
    column: at decode's M = 64 for every projection shape of ``QMM_SHAPES``
    (a bias on the first two, the q/k/v projections), and at each M of
    ``gate_rows`` for w_gate (``shape``; the learner's 12,400). Up to M =
    512 the calls cycle through enough
    weight copies that one cycle moves more than twice the 50 MB L2, as a
    decode step meets each layer's weight cold, and are timed as a CUDA
    graph (``_graph_ms``); above, one call at a time. The library
    yardstick is ``torch.matmul`` on the weight dequantized beforehand
    (dequantization not timed) plus the adapter's delta as torch ops; the
    port never calls it. Keys (m, k, n, bits)."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import dequantize

    qm = _qmm()
    out = {}
    runs = [(QMM_ROWS[0], k, n, i < 2) for i, (k, n) in enumerate(QMM_SHAPES)]
    runs += [(m, *shape, False) for m in gate_rows]
    for m, k, n, bias in runs:
        graphed = m <= qm.DECODE_MAX_M
        for bits in (4, 8):
            g = QMM_GROUP if bits == 4 else None
            one = (k * n * bits // 8 + (k // (g or k)) * n * 4 + 2 * m * k
                   + 4 * rank * (k + n))
            copies = max(2, math.ceil(2 * L2_BYTES / one)) if graphed else 1
            cs = [qmm_case("cuda", seed + i, k=k, n=n, m=m, bits=bits, group=g,
                           dtype=torch.bfloat16, bias=bias, rank=rank) for i in range(copies)]
            s_t = torch.tensor(scale, dtype=torch.bfloat16, device="cuda")
            dense = [(c[0], dequantize(c[1], torch.bfloat16), c[2], c[3].bfloat16(),
                      c[4].bfloat16()) for c in cs]

            def lib(x, wd, b, la, lb):
                y = torch.matmul(x, wd) + (x @ la) @ lb * s_t
                return y if b is None else y + b

            if graphed:
                ms = _graph_ms([lambda c=c: qm.quant_matmul(*c, scale) for c in cs])
                library_ms = _graph_ms([lambda d=d: lib(*d) for d in dense])
            else:
                ms = _time_ms(lambda: qm.quant_matmul(*cs[0], scale), calls=10)
                library_ms = _time_ms(lambda: lib(*dense[0]), calls=10)
            plain_ms = _time_ms(lambda: qm.quant_matmul_reference(*cs[0], scale), calls=5,
                                warmup=1)
            bound_ms, bound_by = quant_matmul_bound_ms(m, k, n, bits=bits, group=g,
                                                       rank=rank, bias=bias)
            out[(m, k, n, bits)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                    "bound_by": bound_by, "library_ms": library_ms,
                                    "copies": copies}
            del cs, dense
            torch.cuda.empty_cache()
    return out


def qlora_decode_step_ms(times: dict, bits: int = 4) -> dict:
    """K3's time per decode step of the QLoRA model from the M = 64 rows of
    ``time_quant_matmul``: 28 layers x (wq, wo, wk, wv, w_gate, w_up,
    w_down), as 28 x (2 t(wq/wo) + 2 t(wk/wv) + 2 t(w_gate/w_up) +
    t(w_down)), and the same sum of the bounds."""
    m = QMM_ROWS[0]
    per_layer = (2, 2, 2, 1)  # QMM_SHAPES: wq/wo, wk/wv, w_gate/w_up, w_down
    rows = [times[(m, k, n, bits)] for k, n in QMM_SHAPES]
    return {key: 28 * sum(c * r[key] for c, r in zip(per_layer, rows))
            for key in ("ms", "bound_ms", "library_ms")}


def _check_round(res, *, rows: int, n: int, steps: int, vocab: int,
                 eos: int, pad: int, what: str) -> None:
    import numpy as np

    check(res.tokens.shape == (rows, n, steps), f"{what}: tokens {res.tokens.shape}")
    check(((res.tokens >= 0) & (res.tokens < vocab)).all(), f"{what}: token out of range")
    tok = res.tokens.reshape(-1, steps)
    lengths = res.lengths.reshape(-1)
    logp = res.logprobs.reshape(-1, steps)
    check(((lengths >= 0) & (lengths <= steps)).all(), f"{what}: lengths out of range")
    check(np.isfinite(logp).all(), f"{what}: non-finite logprob")
    check((logp <= 1e-6).all(), f"{what}: positive logprob {logp.max()}")
    col = np.arange(steps)[None, :]
    after = col >= lengths[:, None]
    check((tok[after] == pad).all(), f"{what}: a non-pad token after a row's end")
    check((logp[after] == 0.0).all(), f"{what}: a logprob after a row's end")
    eos_at = np.where((tok == eos) & ~after, col, steps).min(axis=1)
    # a row ends at its first EOS, or runs to the step limit without one
    check(((eos_at == lengths - 1) | ((eos_at == steps) & (lengths == steps))).all(),
          f"{what}: a row does not end at its first EOS")
    check(res.steps_dispatched is not None and 1 <= res.steps_dispatched <= steps,
          f"{what}: steps_dispatched {res.steps_dispatched}")


def device_us_by_kernel(fn):
    """``fn()`` under ``torch.profiler``: (its result, device microseconds
    summed by kernel name)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    return result, by_name


def profile_decode(run_round, steps=(8, 40), top: int = 12) -> dict:
    """Device time per decode step, by kernel: ``run_round(n)`` runs a
    greedy round of ``n`` steps (returning the steps dispatched) under
    ``torch.profiler``; the difference of two rounds cancels the prefill."""
    totals = [device_us_by_kernel(lambda: run_round(n)) for n in steps]
    (s0, k0), (s1, k1) = totals
    check(s1 > s0, f"profiled rounds dispatched {s0} and {s1} steps")
    per_step = {name: (k1[name] - k0.get(name, 0.0)) / (s1 - s0) / 1e3 for name in k1}
    ranked = sorted(per_step.items(), key=lambda kv: -kv[1])
    return {"device_ms_per_step": sum(per_step.values()), "top": ranked[:top],
            "kernels_per_step": len(per_step),
            "k1_ms": sum(ms for name, ms in per_step.items() if "fused_sample" in name)}


def make_weights(cfg, device, *, seed: int, rank: int = 32, dtype=None):
    """Random weights (``dtype``, by default bf16 on the GPU and f32 on the
    CPU) and an f32 rank-``rank`` LoRA with non-zero B, from ``seed``."""
    import torch

    from distrl_llm_tpu_torch.models.lora import init_lora_params
    from distrl_llm_tpu_torch.models.transformer import init_params

    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    model = init_params(gen, cfg, dtype=dtype)
    lora = init_lora_params(gen, cfg, rank)
    for ab in lora["layers"].values():  # non-zero B: the delta is exercised
        ab["b"].normal_(0.0, 0.01, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"rollout: {cfg.num_layers} layers at D={cfg.hidden_size} "
          f"F={cfg.intermediate_size} H={cfg.num_heads}/K={cfg.num_kv_heads} "
          f"hd={cfg.head_dim} V={cfg.vocab_size}, {dtype} weights and a rank-{rank} "
          f"LoRA made in {time.perf_counter() - t0:.1f} s")
    return model, lora


def prompt_texts() -> list[str]:
    """The math prompts through the chat template, as the engines see them."""
    from distrl_llm_tpu_torch.data import process_dataset
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer

    return process_dataset(CharTokenizer(), {"problem": [p for p, _ in PROBLEMS]})["problem"]


def prompt_batch(max_prompt_tokens: int):
    """The math prompts through the tokenizer, left-padded: (tokenizer, ids,
    mask, solutions)."""
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer, encode_fixed

    tok = CharTokenizer()
    ids, mask = encode_fixed(tok, prompt_texts(), max_prompt_tokens, side="left")
    return tok, ids, mask, [s for _, s in PROBLEMS]


def make_engine(cfg, device, *, engine: str, kv_quant: str, cache_dtype,
                max_prompt_tokens: int, max_new_tokens: int, page_size: int,
                scale: float, attn_impl: str = "reference", scan_chunk: int = 0):
    """The engine a rollout drives: ("dense" or "paged" with ``kv_quant``,
    decoding ``scan_chunk`` steps a CUDA graph replay when > 1) and its
    label, with the tokenizer's EOS and pad ids."""
    from distrl_llm_tpu_torch.engine import GenerationEngine, PagedGenerationEngine
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer

    tok = CharTokenizer()
    common = dict(max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
                  eos_token_ids=[tok.eos_token_id], pad_token_id=tok.pad_token_id,
                  lora_scale=scale, cache_dtype=cache_dtype, capture_logprobs=True,
                  attn_impl=attn_impl, scan_chunk=scan_chunk, device=device)
    if engine == "dense":
        label = "dense" + (" int8 KV" if kv_quant == "int8" else "")
        return GenerationEngine(cfg, kv_quant=kv_quant, **common), label
    eng = PagedGenerationEngine(cfg, page_size=page_size, kv_quant=kv_quant, **common)
    return eng, f"paged {'int8' if kv_quant == 'int8' else str(cache_dtype).split('.')[-1]} KV"


def rollout(cfg, device, *, seed: int, max_prompt_tokens: int = 350,
            max_new_tokens: int = 128, n: int = 16, rank: int = 32,
            alpha: float = 16.0, card: str = "", profile: bool = False,
            engine: str = "dense", kv_quant: str = "none", page_size: int = 128,
            weights=None, tag: str = "", greedy_rounds: int = 2,
            top_p_impl: str | None = None) -> dict:
    """The port's main path through one engine ("dense", or "paged" with
    ``kv_quant`` "none"/"int8" pages): ``weights`` (or new ones from
    ``seed``), the math prompts through the tokenizer, a short warm-up round,
    then (with the kernels' launch counts reset) one sampled round (its
    nucleus filter ``top_p_impl``, None: the default) scored by the reward
    function and ``greedy_rounds`` greedy rounds that must agree. Returns the
    counts, the decode steps dispatched, the decode forwards, the timings and
    the first greedy round's tokens; with ``profile``, also the device time
    per decode step by kernel (after the counts are read). ``tag`` prefixes
    the printed label. ``model_forwards`` counts the model's forward calls
    (prefill and decode) in the counted rounds, ``plain_calls`` the calls of
    K3's plain version there (0 on the card)."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.models.lora import lora_scale
    from distrl_llm_tpu_torch.rewards import RewardComputer
    from distrl_llm_tpu_torch.tokenizer import decode_batch

    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, lora = weights or make_weights(cfg, device, seed=seed, rank=rank)
    tok, ids, mask, solutions = prompt_batch(max_prompt_tokens)
    eng, label = make_engine(cfg, device, engine=engine, kv_quant=kv_quant,
                             cache_dtype=dtype, max_prompt_tokens=max_prompt_tokens,
                             max_new_tokens=max_new_tokens, page_size=page_size,
                             scale=lora_scale(rank, alpha))
    label = tag + label
    train = SamplingConfig(max_tokens=max_new_tokens, temperature=1.2, top_p=0.95, n=n,
                           top_p_impl=top_p_impl)
    greedy = train.replace(temperature=0.0, top_p_impl=None)
    eng.generate(model, lora, ids, mask, train.replace(max_tokens=4), seed)  # warm-up
    live = 0.0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        live = torch.cuda.memory_allocated(device) / 2**30
    forwards = [0]

    def run(sampling, round_seed, what):
        t = time.perf_counter()
        res = eng.generate(model, lora, ids, mask, sampling, round_seed)
        wall = time.perf_counter() - t
        st = eng.last_round_stats
        forwards[0] += st.get("decode_forwards", 0)
        _check_round(res, rows=len(PROBLEMS), n=n, steps=max_new_tokens,
                     vocab=cfg.vocab_size, eos=tok.eos_token_id,
                     pad=tok.pad_token_id, what=f"{label} {what}")
        timing = {
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tok_s": st["gen_tokens"] / st["decode_s"],
            "ms_per_step": st["decode_s"] * 1e3 / res.steps_dispatched,
            "steps": res.steps_dispatched, "gen_tokens": st["gen_tokens"],
            "wall_s": wall,
        }
        print(f"rollout {label} {what}: {res.steps_dispatched} decode steps, "
              f"{st['gen_tokens']} tokens; prefill {timing['prefill_tok_s']:.1f} tok/s "
              f"({st['prefill_tokens']} prompt tokens, {st['prefill_s'] * 1e3:.1f} ms); "
              f"decode {timing['decode_tok_s']:.1f} tok/s, "
              f"{timing['ms_per_step']:.2f} ms/step; {card}")
        return res, timing

    model_forwards, plain = [0], [0]

    def count_forward(*_):
        model_forwards[0] += 1

    hook = model.register_forward_hook(count_forward)
    with counting_plain_calls(_qmm(), "quant_matmul_reference", plain):
        reset_counts()
        sampled, t_sampled = run(train, seed + 1, "sampled t=1.2 top_p=0.95"
                                 + (f" top_p_impl={top_p_impl}" if top_p_impl else ""))
        greedy_runs = [run(greedy, seed + 2 + i, f"greedy #{i + 1}")
                       for i in range(greedy_rounds)]
        counts = read_counts()
    hook.remove()

    g1 = greedy_runs[0][0]
    for g, _ in greedy_runs[1:]:
        check(np.array_equal(g1.tokens, g.tokens) and np.array_equal(g1.lengths, g.lengths),
              f"{label}: two greedy rounds differ")
    dlogp = max((float(np.abs(g1.logprobs - g.logprobs).max()) for g, _ in greedy_runs[1:]),
                default=0.0)
    check(not np.array_equal(sampled.tokens, g1.tokens), f"{label}: the sampled round equals greedy")
    steps = sampled.steps_dispatched + sum(g.steps_dispatched for g, _ in greedy_runs)
    agree = (f"{greedy_rounds} greedy rounds identical (max |dlogp| {dlogp:.3g})"
             if greedy_rounds > 1 else "one greedy round")
    print(f"rollout {label}: {agree}; {steps} decode steps and {forwards[0]} decode forwards "
          f"dispatched in all; launches {counts}")

    flat = decode_batch(tok, sampled.tokens.reshape(-1, max_new_tokens),
                        sampled.lengths.reshape(-1))
    groups = [(flat[b * n:(b + 1) * n], [solutions[b]] * n) for b in range(len(PROBLEMS))]
    rewards = RewardComputer()(groups)
    check(all(r.shape == (n, 2) and np.isfinite(r).all() for r in rewards),
          "reward arrays of the wrong shape or non-finite")
    mean = np.concatenate(rewards).mean(axis=0)
    print(f"rollout {label}: sampled round scored, mean format reward {mean[0]:.4f}, "
          f"mean accuracy {mean[1]:.4f}")
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    out = {"label": label, "counts": counts, "steps": steps, "forwards": forwards[0],
           "model_forwards": model_forwards[0], "plain_calls": plain[0],
           "sampled": t_sampled, "greedy": [t for _, t in greedy_runs], "peak_gib": peak,
           "live_gib": live,
           "greedy_tokens": g1.tokens, "greedy_lengths": g1.lengths,
           "round": sampled, "rewards": rewards, "answers": flat}
    if profile:
        prof = profile_decode(lambda k: eng.generate(
            model, lora, ids, mask, greedy.replace(max_tokens=k), seed).steps_dispatched)
        wall = out["greedy"][-1]["ms_per_step"]
        print(f"profile {label}: {prof['device_ms_per_step']:.3f} ms of device time per "
              f"decode step in {prof['kernels_per_step']} kernel names, against "
              f"{wall:.3f} ms/step unprofiled: device idle "
              f"{100 * (1 - prof['device_ms_per_step'] / wall):.1f}%; {card}")
        for name, ms in prof["top"]:
            print(f"profile {label}: {ms:8.4f} ms/step  {name[:110]}")
        print(f"profile {label}: K1 (fused_sample) {prof['k1_ms']:.4f} ms/step")
        out["profile"] = prof
    return out


def widen(weights):
    """The same weight values in f32 (on the weights' device); a quantized
    model keeps its int8 payloads and f32 scales as they are, and only its
    dense tensors are cast."""
    import torch

    from distrl_llm_tpu_torch.models.transformer import Decoder

    model, lora = weights
    wide = Decoder(model.cfg, dtype=torch.float32, device=model.embed.device, quant=model.quant)
    wide.load_state_dict(model.state_dict())
    return wide, lora


@contextlib.contextmanager
def k2_plain_version():
    """Within the block the paged engine's decode attention runs K2's plain
    version on the card instead of launching K2 (``paged_attention_op``
    looks the wrapper up at every call): a yardstick, never the main path."""
    from distrl_llm_tpu_torch.ops import paged_native

    kernel = paged_native.paged_attention_native
    paged_native.paged_attention_native = paged_native.paged_attention_native_reference
    try:
        yield
    finally:
        paged_native.paged_attention_native = kernel


def engine_logits(weights, ids, mask, tokens, *, engine: str, kv_quant: str = "none",
                  max_prompt_tokens: int, max_new_tokens: int, page_size: int,
                  scale: float) -> list:
    """Teacher-forced logits of one engine, in the weights' dtype (its KV
    too): the prefill's last position [B, V], then one [B·n, V] per column
    of ``tokens`` [B·n, steps], each fed at every row's next position. The
    paged engine runs its own prefill, fan-out and decode forward (packed
    positions, the fan-out page table, K2 per layer on the card); the dense
    one its prefill and candidate expansion."""
    import torch

    from distrl_llm_tpu_torch.engine.engine import _decode_init, _prefill
    from distrl_llm_tpu_torch.engine.paged_engine import _paged_fanout, _paged_forward, _paged_prefill

    model, lora = weights
    cfg, dtype = model.cfg, model.embed.dtype
    b, p = ids.shape
    n = tokens.shape[0] // b
    alive = mask.sum(dim=-1) > 0
    eng, _ = make_engine(cfg, ids.device, engine=engine, kv_quant=kv_quant,
                         cache_dtype=dtype, max_prompt_tokens=max_prompt_tokens,
                         max_new_tokens=max_new_tokens, page_size=page_size, scale=scale)
    out = []
    with torch.inference_mode():
        if engine == "dense":
            cache, key_mask, last = _prefill(
                model, lora, ids, mask, max_total=max_prompt_tokens + max_new_tokens,
                lora_scale=scale, cache_dtype=dtype, attn_impl="reference",
                kv_quant=kv_quant)
            st = _decode_init(cache, key_mask, last, alive, n=n, max_steps=max_new_tokens,
                              pad_id=eng.pad_id)
            out.append(last)
            for i in range(tokens.shape[1]):
                st.key_mask[:, p + i] = 1
                logits, _ = model(tokens[:, i:i + 1], attention_mask=st.key_mask,
                                  lora=lora, lora_scale=scale, kv_cache=st.cache,
                                  cache_offset=p + i)
                out.append(logits[:, 0])
            return out
        k, v, last, real_len = _paged_prefill(
            model, lora, ids, mask, prompt_pages=eng.prompt_pages, page_size=page_size,
            lora_scale=scale, cache_dtype=dtype, attn_impl="reference", kv_quant=kv_quant,
            total_pages=b * eng.prompt_pages + b * n * eng.private_pages)
        st, table = _paged_fanout(
            k, v, last, real_len, alive, n=n, b=b, prompt_pages=eng.prompt_pages,
            private_pages=eng.private_pages, page_size=page_size,
            max_steps=max_new_tokens, pad_id=eng.pad_id)
        out.append(last)
        for i in range(tokens.shape[1]):
            _paged_forward(model, lora, st, tokens[:, i], table, page_size=page_size,
                           lora_scale=scale)
            st.seq_lengths += 1
            out.append(st.logits.clone())
    return out


def compare_engine_logits(weights, wide, *, seed: int, steps: int = LOGIT_STEPS,
                          n: int = PA_N,
                          max_prompt_tokens: int = 350, max_new_tokens: int = 128,
                          page_size: int = 128, rank: int = 32,
                          alpha: float = 16.0) -> dict:
    """The paged engine's logits against the dense engine's on the math
    prompts, teacher-forced with the same random tokens for ``n`` candidates
    per prompt (so decode reads shared full prompt pages through the fan-out
    table): the prefill's last position, then ``steps`` decode forwards,
    each of which runs K2 at every layer on the card. ``weights`` are the
    rollout's (bf16 on the card), ``wide`` the same values in f32. Returns
    the largest |dlogit| over all positions for:

    * ``low``: paged vs dense, both in the weights' dtype (bf16 pages);
    * ``noise``: dense in the weights' dtype vs dense in f32, how far
      rounding alone moves these logits;
    * ``f32``: paged with f32 pages vs dense, f32;
    * ``int8``: paged with int8 pages vs dense, f32 activations;
    * ``int8_plain``: the same with K2's plain version in K2's place, the
      int8 pages' own distance from dense;
    * ``int8_k2``: int8 pages, K2 against its plain version;

    with the dense f32 logits' std and K2's launches in the plain-version
    run (which must be 0)."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.models.lora import lora_scale
    from distrl_llm_tpu_torch.ops import paged_native

    model = weights[0]
    dev = model.embed.device
    _, ids, mask, _ = prompt_batch(max_prompt_tokens)
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=dev)
    mask = torch.as_tensor(np.asarray(mask), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (ids.shape[0] * n, steps),
                           generator=gen, device=dev, dtype=torch.int32)
    kw = dict(max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
              page_size=page_size, scale=lora_scale(rank, alpha))

    def dist(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    dense = engine_logits(weights, ids, mask, tokens, engine="dense", **kw)
    dense32 = engine_logits(wide, ids, mask, tokens, engine="dense", **kw)
    out = {"low": dist(engine_logits(weights, ids, mask, tokens, engine="paged", **kw), dense),
           "noise": dist(dense, dense32),
           "f32": dist(engine_logits(wide, ids, mask, tokens, engine="paged", **kw), dense32),
           "std": float(torch.cat(dense32).std())}
    del dense
    int8 = engine_logits(wide, ids, mask, tokens, engine="paged", kv_quant="int8", **kw)
    before = paged_native.paged_attention_launches
    with k2_plain_version():
        plain = engine_logits(wide, ids, mask, tokens, engine="paged", kv_quant="int8", **kw)
    out.update(int8=dist(int8, dense32), int8_plain=dist(plain, dense32),
               int8_k2=dist(int8, plain),
               plain_launches=paged_native.paged_attention_launches - before)
    return out


def greedy_agreement(cfg, device, wide, reference_tokens, *, seed: int,
                     max_prompt_tokens: int = 350, max_new_tokens: int = 128,
                     n: int = PA_N, page_size: int = 128, rank: int = 32,
                     alpha: float = 16.0) -> dict:
    """Yardsticks for the share of greedy tokens two engines have in common:
    one greedy round of the dense engine and one of the paged engine (f32
    pages) with the f32 weights. Returns the share of positions equal
    between dense f32 and ``reference_tokens`` (the dense engine's round in
    the weights' dtype) and between paged f32 and dense f32."""
    import numpy as np

    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.models.lora import lora_scale

    _, ids, mask, _ = prompt_batch(max_prompt_tokens)
    greedy = SamplingConfig(max_tokens=max_new_tokens, temperature=0.0, top_p=0.95, n=n)
    wide_model = wide[0]
    got = {}
    for engine in ("dense", "paged"):
        eng, _ = make_engine(cfg, device, engine=engine, kv_quant="none",
                             cache_dtype=wide_model.embed.dtype,
                             max_prompt_tokens=max_prompt_tokens,
                             max_new_tokens=max_new_tokens, page_size=page_size,
                             scale=lora_scale(rank, alpha))
        got[engine] = eng.generate(wide_model, wide[1], ids, mask, greedy, seed).tokens
    return {"dense_low_vs_f32": float(np.mean(reference_tokens == got["dense"])),
            "paged_vs_dense_f32": float(np.mean(got["paged"] == got["dense"]))}


@contextlib.contextmanager
def k4_plain_version():
    """Within the block ``attention(impl="flash"|"splash")`` runs K4's plain
    version on the card instead of launching K4 (``attention`` looks the
    wrapper up at every call): a yardstick, never the main path."""
    from distrl_llm_tpu_torch.ops import flash_attention as fa

    kernel = fa.flash_attention
    fa.flash_attention = fa.flash_attention_reference
    try:
        yield
    finally:
        fa.flash_attention = kernel


@contextlib.contextmanager
def counting_plain_calls(module, name: str, calls: list):
    """Counts, in ``calls[0]``, the calls of ``module.name`` (a kernel's
    plain version, looked up at every call) within the block: the main path
    on the card must make none."""
    plain = getattr(module, name)

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, plain)


@contextlib.contextmanager
def k3_plain_version():
    """Within the block every quantized projection runs K3's plain version
    on the card instead of launching K3 (``linear`` and ``_proj`` look the
    wrapper up at every call): a yardstick, never the main path."""
    qm = _qmm()
    kernel = qm.quant_matmul
    qm.quant_matmul = qm.quant_matmul_reference
    try:
        yield
    finally:
        qm.quant_matmul = kernel


def splash_prefill(cfg, device, weights, wide, *, seed: int, max_prompt_tokens: int = 350,
                   max_new_tokens: int = 128, n: int = PA_N, page_size: int = 128,
                   rank: int = 32, alpha: float = 16.0) -> dict:
    """K4 on the engines' prefill: one greedy round of the paged engine
    built with ``attn_impl="splash"`` (its packed prefill attends through
    K4, decode through K2), the launch counts reset just before and read
    just after; then the f32 prefill's last-position logits of that engine
    against the same engine with ``attn_impl="reference"``, on ``wide``
    (the same weights in f32)."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.engine.paged_engine import _paged_prefill
    from distrl_llm_tpu_torch.models.lora import lora_scale

    model, lora = weights
    scale = lora_scale(rank, alpha)
    tok, ids, mask, _ = prompt_batch(max_prompt_tokens)
    eng, label = make_engine(cfg, device, engine="paged", kv_quant="none",
                             cache_dtype=model.embed.dtype, max_prompt_tokens=max_prompt_tokens,
                             max_new_tokens=max_new_tokens, page_size=page_size, scale=scale,
                             attn_impl="splash")
    greedy = SamplingConfig(max_tokens=max_new_tokens, temperature=0.0, top_p=0.95, n=n)
    reset_counts()
    res = eng.generate(model, lora, ids, mask, greedy, seed)
    counts = read_counts()
    _check_round(res, rows=len(PROBLEMS), n=n, steps=max_new_tokens, vocab=cfg.vocab_size,
                 eos=tok.eos_token_id, pad=tok.pad_token_id, what=f"{label} splash prefill")
    dev = wide[0].embed.device
    ids_t = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=dev)
    mask_t = torch.as_tensor(np.asarray(mask), dtype=torch.int32, device=dev)
    last = {}
    with torch.inference_mode():
        for impl in ("splash", "reference"):
            last[impl] = _paged_prefill(wide[0], wide[1], ids_t, mask_t,
                                        prompt_pages=eng.prompt_pages, page_size=page_size,
                                        lora_scale=scale, cache_dtype=torch.float32,
                                        attn_impl=impl)[2]
    return {"counts": counts, "steps": res.steps_dispatched,
            "forwards": eng.last_round_stats["decode_forwards"],
            "logit_err": float((last["splash"] - last["reference"]).abs().max()),
            "logit_std": float(last["reference"].std()), "label": label}


def learner_batch(out: dict, *, n: int, seed: int, device, max_prompt_tokens: int = 350,
                  max_new_tokens: int = 1200, micro: int = 8):
    """The learner's input from the dense engine's sampled round ``out``
    (``rollout``'s result): its rewards through ``shape_rewards`` (PG:
    reward − group mean) and ``flatten_for_update``, then
    ``prepare_update_batch``. The engine's own tokens and behavior
    logprobs ride along (``raw_rollout``): the download-free
    CharTokenizer decodes only ids below 256, so the retokenized text of
    a random-weight model's answers would be nearly empty. Random weights
    score 0 on every row, which makes every coefficient 0 and would skip
    every microbatch: then the coefficients are drawn from ``seed``.
    Returns (batch, where the coefficients came from)."""
    import numpy as np

    from distrl_llm_tpu_torch.learner.train_step import prepare_update_batch
    from distrl_llm_tpu_torch.shaping import flatten_for_update, shape_rewards
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer

    res = out["round"]
    prompts = prompt_texts()
    b = len(prompts)
    cand = {"rewards": list(out["rewards"]),
            "token_lengths": [res.lengths[i] for i in range(b)],
            "answers": [out["answers"][i * n:(i + 1) * n] for i in range(b)],
            "problem": [[p] * n for p in prompts],
            "answer_tokens": [res.tokens[i] for i in range(b)],
            "behavior_logps": [res.logprobs[i] for i in range(b)],
            "gen_lengths": [res.lengths[i] for i in range(b)]}
    shape_rewards([cand], "pg")
    problems, answers, coeffs, raw = flatten_for_update([cand], "pg")
    source = "the rewards (reward - group mean)"
    if not np.any(coeffs != 0):
        coeffs = np.random.default_rng(seed).standard_normal(coeffs.shape).astype(np.float32)
        source = ("drawn from the seed: every reward - group mean is 0 under random "
                  "weights, which would skip every microbatch")
    batch = prepare_update_batch(CharTokenizer(), problems, answers, coeffs,
                                 max_prompt_tokens=max_prompt_tokens,
                                 max_new_tokens=max_new_tokens, micro_size=micro,
                                 raw_rollout=raw, device=device)
    return batch, source


def _trainable_copy(lora):
    return {"layers": {t: {k: x.detach().clone().requires_grad_(True) for k, x in ab.items()}
                       for t, ab in lora["layers"].items()}}


def _lora_leaves(lora):
    if not isinstance(lora, dict):  # a ShardedLora (phase 17): gathered whole
        lora = lora.full()
    return [x for t in sorted(lora["layers"]) for x in (lora["layers"][t]["a"],
                                                        lora["layers"][t]["b"])]


def learner_run(weights, batch, *, steps: int = 2, lr: float = 2e-5, scale: float,
                micro: int = 8, logit_chunk: int = 128, card: str = "",
                profile: bool = False, top: int = 12) -> dict:
    """The learner's main path: ``make_train_step`` with the trainer's
    defaults (PG, Adam8bit at ``lr``, micro ``micro``, chunked logprobs,
    remat, ``attn_impl="splash"``) over a trainable copy of the adapter in
    ``weights``, ``steps`` optimizer steps. The kernels' launch counts are
    reset just before each step and read just after; the plain version of
    K4 (``plain_calls``) and of K3 (``k3_plain_calls``) are counted.
    Returns per-step loss, seconds, counts and adapter
    movement, the trained adapter, token counts and peak memory; with
    ``profile``, one more step under ``torch.profiler``: device time by
    kernel against the last unprofiled step's wall time."""
    import torch

    from distrl_llm_tpu_torch.learner.optim import make_optimizer
    from distrl_llm_tpu_torch.learner.train_step import make_train_step

    model, lora0 = weights
    dev = model.embed.device
    lora = _trainable_copy(lora0)
    leaves = _lora_leaves(lora)
    opt = make_optimizer(leaves, lr)
    step = make_train_step(model.cfg, learner_type="pg", optimizer=opt, lora_scale=scale,
                           micro_size=micro, remat=True, attn_impl="splash",
                           logit_chunk=logit_chunk)
    real = batch.sample_mask > 0
    real_tokens = int(batch.prompt_mask[real].sum() + batch.answer_mask[real].sum())
    n, s = batch.prompt_ids.shape[0], batch.prompt_ids.shape[1] + batch.answer_ids.shape[1]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    from distrl_llm_tpu_torch.ops import flash_attention as fa

    plain, k3_plain = [0], [0]
    per_step = []
    with (counting_plain_calls(fa, "flash_attention_reference", plain),
          counting_plain_calls(_qmm(), "quant_matmul_reference", k3_plain)):
        for i in range(steps):
            before = [x.detach().clone() for x in leaves]
            reset_counts()
            t = time.perf_counter()
            loss = float(step(lora, model, batch))
            if cuda:
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t
            counts = read_counts()
            delta = [(x.detach() - b).abs() for x, b in zip(leaves, before)]
            # Adam8bit's clip: |step| <= 5 lr, plus the rounding of p + step
            within = all(bool((d <= 5 * lr * (1 + 1e-6) + b.abs() * 2.0**-23).all())
                         for d, b in zip(delta, before))
            moved = sum(int((d > 0).sum()) for d in delta) / sum(d.numel() for d in delta)
            per_step.append({"loss": loss, "s": secs, "counts": counts, "within_clip": within,
                             "moved_share": moved,
                             "max_delta": max(float(d.max()) for d in delta)})
            print(f"learner step {i + 1}: loss_sum {loss:.6g}, {secs * 1e3:.1f} ms; "
                  f"{real_tokens / secs:.1f} real / {n * s / secs:.1f} padded learner tokens/s "
                  f"({real_tokens} real of {n} x {s}); adapter max |step| "
                  f"{per_step[-1]['max_delta']:.3g} (clip 5 lr = {5 * lr:.3g}), "
                  f"{100 * moved:.2f}% of elements moved; launches {counts}; {card}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
    out = {"steps": per_step, "lora": lora, "plain_calls": plain[0],
           "k3_plain_calls": k3_plain[0], "real_tokens": real_tokens,
           "padded_tokens": n * s, "peak_gib": peak, "num_micro": n // micro}
    if profile:
        _, by_name = device_us_by_kernel(lambda: float(step(lora, model, batch)))
        device_ms = sum(by_name.values()) / 1e3
        wall_ms = per_step[-1]["s"] * 1e3
        k4_ms = sum(us for name, us in by_name.items() if "flash_" in name) / 1e3
        print(f"profile learner: {device_ms:.1f} ms of device time per step in "
              f"{len(by_name)} kernel names, against {wall_ms:.1f} ms/step unprofiled: "
              f"device idle {100 * (1 - device_ms / wall_ms):.1f}%; K4 {k4_ms:.1f} ms "
              f"({100 * k4_ms / device_ms:.1f}% of device time); {card}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            print(f"profile learner: {us / 1e3:10.2f} ms/step  {name[:110]}")
        out["profile"] = {"device_ms": device_ms, "k4_ms": k4_ms}
    return out


def push_and_round(cfg, device, weights, lora, *, seed: int, version: int, n: int = PA_N,
                   max_prompt_tokens: int = 350, max_new_tokens: int = 128, rank: int = 32,
                   alpha: float = 16.0) -> dict:
    """The trained adapter pushed into a dense engine's ``LoraMailbox``
    (a detached copy: the optimizer's in-place updates never touch what a
    round reads), then one greedy round that swaps it in at its first
    decode step. Returns the engine's swap log and the round."""
    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.models.lora import lora_scale

    model, old = weights
    tok, ids, mask, _ = prompt_batch(max_prompt_tokens)
    eng, label = make_engine(cfg, device, engine="dense", kv_quant="none",
                             cache_dtype=model.embed.dtype, max_prompt_tokens=max_prompt_tokens,
                             max_new_tokens=max_new_tokens, page_size=128,
                             scale=lora_scale(rank, alpha))
    eng.push_lora({"layers": {t: {k: x.detach().clone() for k, x in ab.items()}
                              for t, ab in lora["layers"].items()}}, version=version)
    greedy = SamplingConfig(max_tokens=max_new_tokens, temperature=0.0, top_p=0.95, n=n)
    res = eng.generate(model, old, ids, mask, greedy, seed)
    _check_round(res, rows=len(PROBLEMS), n=n, steps=max_new_tokens, vocab=cfg.vocab_size,
                 eos=tok.eos_token_id, pad=tok.pad_token_id, what=f"{label} after the push")
    return {"versions": list(eng.last_swap_versions), "swap_steps": list(eng.last_swap_steps),
            "tokens": res.tokens}


def learner_parity(cfg, device, *, seed: int, n: int = 2, max_prompt_tokens: int = 350,
                   max_new_tokens: int = 1200, gen_tokens: int = 128, rank: int = 32,
                   alpha: float = 16.0, logit_chunk: int = 128, weights=None,
                   plain_version=None) -> dict:
    """The learner in f32 (``cfg``'s widths, f32 ``weights`` or new ones
    from ``seed``), two ways: (1) the dense engine's greedy round (4 prompts
    x ``n``, K1 and the cached forward) against the learner's
    ``answer_logprobs`` of the same tokens (K4, no cache) on the generated
    positions; (2) the PG loss and LoRA grads of one microbatch of those
    rows (``max_prompt_tokens`` + ``max_new_tokens`` tokens each) with the
    kernels against the same with one kernel's plain version in its place
    (``plain_version``, by default ``k4_plain_version``). Returns the
    differences and the launch counts of both runs."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.learner.losses import answer_logprobs, pg_loss
    from distrl_llm_tpu_torch.learner.train_step import prepare_update_batch
    from distrl_llm_tpu_torch.models.lora import lora_scale

    model, lora = weights or make_weights(cfg, device, seed=seed, rank=rank, dtype=torch.float32)
    scale = lora_scale(rank, alpha)
    tok, ids, mask, _ = prompt_batch(max_prompt_tokens)
    eng, _ = make_engine(cfg, device, engine="dense", kv_quant="none", cache_dtype=torch.float32,
                         max_prompt_tokens=max_prompt_tokens, max_new_tokens=gen_tokens,
                         page_size=128, scale=scale)
    res = eng.generate(model, lora, ids, mask,
                       SamplingConfig(max_tokens=gen_tokens, temperature=0.0, top_p=0.95, n=n),
                       seed)
    raw = {"answer_tokens": res.tokens.reshape(-1, gen_tokens),
           "behavior_logps": res.logprobs.reshape(-1, gen_tokens),
           "lengths": res.lengths.reshape(-1)}
    problems = [p for p in prompt_texts() for _ in range(n)]
    coeffs = np.random.default_rng(seed).standard_normal(len(problems)).astype(np.float32)
    batch = prepare_update_batch(tok, problems, [""] * len(problems), coeffs,
                                 max_prompt_tokens=max_prompt_tokens,
                                 max_new_tokens=max_new_tokens, micro_size=len(problems),
                                 raw_rollout=raw, device=device)
    args = (batch.prompt_ids, batch.prompt_mask, batch.answer_ids, batch.answer_mask)
    gen = batch.answer_mask.bool()
    with torch.no_grad():
        lp = answer_logprobs(model, *args, lora=lora, lora_scale=scale, attn_impl="splash",
                             logit_chunk=logit_chunk)
    logp_err = float((lp - batch.behavior_logps)[gen].abs().max())

    def loss_and_grads():
        tl = _trainable_copy(lora)
        logps = answer_logprobs(model, *args, lora=tl, lora_scale=scale, remat=True,
                                attn_impl="splash", logit_chunk=logit_chunk)
        loss = pg_loss(logps, batch.answer_mask.float(), batch.coeffs, batch.sample_mask)
        loss.backward()
        return float(loss.detach()), torch.cat([x.grad.reshape(-1) for x in _lora_leaves(tl)])

    reset_counts()
    loss_kernel, grads_kernel = loss_and_grads()
    counts_kernel = read_counts()
    with (plain_version or k4_plain_version)():
        reset_counts()
        loss_plain, grads_plain = loss_and_grads()
        counts_plain = read_counts()
    return {"logp_err": logp_err, "gen_positions": int(gen.sum()),
            "loss_kernel": loss_kernel, "loss_plain": loss_plain,
            "loss_rel": abs(loss_kernel - loss_plain) / max(abs(loss_plain), 1e-30),
            "grad_rel": float((grads_kernel - grads_plain).abs().max()
                              / grads_plain.abs().max()),
            "grad_max": float(grads_plain.abs().max()),
            "counts_kernel": counts_kernel, "counts_plain": counts_plain,
            "shape": [int(batch.prompt_ids.shape[0]), int(args[0].shape[1] + args[2].shape[1])]}


def make_qlora_weights(cfg, device, *, seed: int, bits: int, group, rank: int = 32,
                       dtype=None):
    """``make_weights`` (the same values from the same seed) with the seven
    projections then quantized in place to ``bits`` (``group``; None = per
    column), one layer at a time, each dense weight freed as it goes."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import quantize_params

    model, lora = make_weights(cfg, device, seed=seed, rank=rank, dtype=dtype)
    t0 = time.perf_counter()
    quantize_params(model, bits, group)
    if model.embed.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
    print(f"qlora: the base quantized to int{bits}, "
          f"{'groups of ' + str(group) if group else 'per-column scales'}, in "
          f"{time.perf_counter() - t0:.1f} s: {nbytes / 1e9:.3f} GB of payload and scales")
    return model, lora


def qlora_rollouts(cfg, device, weights, *, seed: int, card: str = "", profile: bool = False,
                   engines=(("dense", "none"), ("paged", "none")), tag: str = "QLoRA int4, ",
                   **kw) -> list:
    """``rollout`` of each engine of ``engines`` over the quantized
    ``weights``; on the card, each run's launches are checked: K3 7 times per
    layer per model forward (prefill and decode), K1 once per decode step,
    K2 once per layer per paged decode forward, K4 never, K3's plain version
    never."""
    runs = []
    for engine, kv_quant in engines:
        out = rollout(cfg, device, seed=seed, card=card, profile=profile, engine=engine,
                      kv_quant=kv_quant, weights=weights, tag=tag, **kw)
        label, c = out["label"], out["counts"]
        check(out["steps"] > 0 and out["model_forwards"] > 0, f"{label}: nothing ran")
        if str(device).startswith("cuda"):
            want = 7 * cfg.num_layers * out["model_forwards"]
            check(c["quant_matmul"] == want, f"{label}: quant_matmul launches "
                  f"{c['quant_matmul']} != {want} (7 x layers x {out['model_forwards']} forwards)")
            check(c["fused_sample"] == out["steps"], f"{label}: fused_sample launches "
                  f"{c['fused_sample']} != decode steps {out['steps']}")
            want_pa = cfg.num_layers * out["forwards"] if engine == "paged" else 0
            check(c["paged_attention"] == want_pa, f"{label}: paged_attention launches "
                  f"{c['paged_attention']} != {want_pa}")
            check(c["flash_attention_fwd"] == c["flash_attention_bwd"] == 0,
                  f"{label}: K4 launched with attn_impl='reference'")
            check(out["plain_calls"] == 0, f"{label}: K3's plain version ran "
                  f"{out['plain_calls']} times")
        print(f"rollout {label}: {out['model_forwards']} model forwards; peak device memory "
              f"{out['peak_gib']:.2f} GiB ({out['live_gib']:.2f} GiB allocated before its "
              f"rounds, the quantized model included); launches {c}; {card}")
        runs.append(out)
    return runs


def qlora_logits(qweights, dense_weights, *, seed: int, steps: int = LOGIT_STEPS,
                 n: int = PA_N, max_prompt_tokens: int = 350, max_new_tokens: int = 128,
                 page_size: int = 128, rank: int = 32, alpha: float = 16.0) -> dict:
    """Teacher-forced f32 logits of the dense engine over the prefill's last
    position and ``steps`` decode forwards: the quantized model widened to
    f32 with K3, against the same with K3's plain version in its place
    (``k3_vs_plain``, the check), and against the dense base in f32
    (``vs_dense``, a yardstick of what quantizing moves). Returns both
    distances, the dense logits' std and K3's launches in both runs."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.models.lora import lora_scale

    dev = qweights[0].embed.device
    _, ids, mask, _ = prompt_batch(max_prompt_tokens)
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=dev)
    mask = torch.as_tensor(np.asarray(mask), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, qweights[0].cfg.vocab_size, (ids.shape[0] * n, steps),
                           generator=gen, device=dev, dtype=torch.int32)
    kw = dict(engine="dense", max_prompt_tokens=max_prompt_tokens,
              max_new_tokens=max_new_tokens, page_size=page_size, scale=lora_scale(rank, alpha))

    def dist(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    wide = widen(dense_weights)
    dense32 = engine_logits(wide, ids, mask, tokens, **kw)
    del wide
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wide = widen(qweights)
    qm = _qmm()
    before = qm.quant_matmul_launches
    k3 = engine_logits(wide, ids, mask, tokens, **kw)
    k3_launches = qm.quant_matmul_launches - before
    before = qm.quant_matmul_launches
    with k3_plain_version():
        plain = engine_logits(wide, ids, mask, tokens, **kw)
    return {"k3_vs_plain": dist(k3, plain), "vs_dense": dist(k3, dense32),
            "std": float(torch.cat(dense32).std()), "k3_launches": k3_launches,
            "plain_launches": qm.quant_matmul_launches - before}


def qlora_learner_parity(cfg, device, *, seed: int, group: int = QMM_GROUP, **kw) -> dict:
    """``learner_parity`` over an f32 base quantized to int4 (``group``):
    the loss and LoRA grads with K3 against K3's plain version."""
    import torch

    weights = make_qlora_weights(cfg, device, seed=seed, bits=4, group=group,
                                 rank=kw.get("rank", 32), dtype=torch.float32)
    return learner_parity(cfg, device, seed=seed, weights=weights,
                          plain_version=k3_plain_version, **kw)


def qlora_phase(cfg, args, batch, card: str, t_start: float) -> tuple[list, object]:
    """Phase 6 on the card (see the module's docstring), with phase 5's
    learner ``batch``; the bf16 weights of the earlier phases are freed, so
    the peaks measured here are the QLoRA runs'. Returns the launch counts
    of every main-path run in it and the dense engine's greedy tokens over
    the int4 base (phase 11 holds its graphed round to them)."""
    import torch

    counted = []
    # one greedy round a cell: phase 4 holds two greedy rounds identical
    qw = make_qlora_weights(cfg, "cuda", seed=args.seed, bits=4, group=QMM_GROUP)
    runs = qlora_rollouts(cfg, "cuda", qw, seed=args.seed, card=card, profile=args.profile,
                          greedy_rounds=1)
    counted += [out["counts"] for out in runs]
    dense_tokens = runs[0]["greedy_tokens"]
    q8 = make_qlora_weights(cfg, "cuda", seed=args.seed, bits=8, group=None)
    runs8 = qlora_rollouts(cfg, "cuda", q8, seed=args.seed, card=card, engines=(("dense", "none"),),
                           tag="QLoRA int8, ", greedy_rounds=1)
    counted += [out["counts"] for out in runs8]
    del q8, runs8
    torch.cuda.empty_cache()
    dense = make_weights(cfg, "cuda", seed=args.seed)  # the values qw was quantized from
    lg = qlora_logits(qw, dense, seed=args.seed)
    del dense
    print(f"qlora: f32 logits of the dense engine over the int4 base, teacher-forced over the "
          f"prefill's last position and {LOGIT_STEPS} decode forwards of {PA_PROMPTS * PA_N} rows: "
          f"K3 vs its plain version max |dlogit| {lg['k3_vs_plain']:.4g} (tolerance "
          f"{LOGIT_F32_ATOL}); yardstick, the int4 base vs the bf16 base's values in f32: "
          f"{lg['vs_dense']:.4g} (not asserted; dense f32 logit std {lg['std']:.4g}); K3 "
          f"launched {lg['k3_launches']} times, {lg['plain_launches']} with its plain version")
    check(lg["plain_launches"] == 0 and lg["k3_launches"] > 0,
          "qlora logits: K3 ran where it should not, or not where it should")
    check(lg["k3_vs_plain"] <= LOGIT_F32_ATOL, f"qlora f32 logits: K3 and its plain version "
          f"differ by {lg['k3_vs_plain']:.4g} > {LOGIT_F32_ATOL}")
    torch.cuda.empty_cache()
    lr, scale = 2e-5, 16.0 / 32
    lrn = learner_run(qw, batch, steps=1, lr=lr, scale=scale, card=card,
                      profile=args.profile)
    want_k3 = 2 * 7 * cfg.num_layers * lrn["num_micro"]
    want_fwd = 2 * cfg.num_layers * lrn["num_micro"]
    want_bwd = cfg.num_layers * lrn["num_micro"]
    for i, st in enumerate(lrn["steps"]):
        c = st["counts"]
        check(math.isfinite(st["loss"]), f"qlora learner step {i + 1}: loss {st['loss']}")
        check(c["quant_matmul"] == want_k3, f"qlora learner step {i + 1}: K3 launched "
              f"{c['quant_matmul']} times, want {want_k3} (2 x 7 x layers x microbatches)")
        check(c["flash_attention_fwd"] == want_fwd and c["flash_attention_bwd"] == want_bwd,
              f"qlora learner step {i + 1}: K4 launched {c['flash_attention_fwd']} / "
              f"{c['flash_attention_bwd']}, want {want_fwd} / {want_bwd}")
        check(c["fused_sample"] == c["paged_attention"] == 0,
              f"qlora learner step {i + 1}: K1/K2 launched")
        check(st["within_clip"], f"qlora learner step {i + 1}: an adapter element moved by "
              f"{st['max_delta']:.3g}, beyond Adam8bit's clip 5 lr = {5 * lr:.3g}")
        check(st["moved_share"] > 0, f"qlora learner step {i + 1}: the adapter did not move")
        counted.append(c)
    check(lrn["plain_calls"] == lrn["k3_plain_calls"] == 0, "qlora learner: a plain version "
          "ran on the main path")
    ms = [1e3 * st["s"] for st in lrn["steps"]]
    print(f"qlora learner: {len(ms)} steps over the int4 base, {cfg.num_layers} layers: "
          f"{', '.join(f'{m:.1f}' for m in ms)} ms/step; "
          f"{lrn['real_tokens'] / (ms[-1] / 1e3):.1f} real and "
          f"{lrn['padded_tokens'] / (ms[-1] / 1e3):.1f} padded learner tokens/s (last step); "
          f"peak device memory {lrn['peak_gib']:.2f} GiB; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    del lrn, qw
    torch.cuda.empty_cache()
    lp = qlora_learner_parity(dataclasses.replace(cfg, num_layers=2), "cuda", seed=args.seed)
    print(f"qlora learner parity (f32, int4 g{QMM_GROUP}, 2 layers, {lp['shape'][0]} rows x "
          f"{lp['shape'][1]}): loss K3 {lp['loss_kernel']:.8g} vs plain {lp['loss_plain']:.8g} "
          f"(relative {lp['loss_rel']:.3g}), LoRA grads max |d| / max |g| {lp['grad_rel']:.3g} "
          f"(tolerance {LEARNER_REL} each); learner vs engine logprobs max |d| "
          f"{lp['logp_err']:.3g}; launches with K3 {lp['counts_kernel']}, with its plain "
          f"version {lp['counts_plain']}")
    check(lp["counts_kernel"]["quant_matmul"] > 0 and lp["counts_plain"]["quant_matmul"] == 0,
          "qlora learner parity: K3 ran where it should not, or not where it should")
    check(lp["loss_rel"] <= LEARNER_REL and lp["grad_rel"] <= LEARNER_REL,
          "qlora learner parity: K3 and its plain version disagree beyond the tolerance")
    return counted, dense_tokens


# ---------------------------------------------------------------- phase 7

# K5 at the speculative main path's geometry: Qwen2.5-7B heads, d = 4 drafts
# (S = 5 queries per row), 64 slots, the paged page geometry above, resident
# lengths around 600 (a 350-token prompt and ~250 generated tokens)
VF_S = 5
VF_CASES = PA_CASES
# the speculative round: BASELINE config 2's engine (refill, 64 slots,
# spec_draft 4, n-gram 2, 128-token pages) over 8 math prompts x 16
# candidates x 256 new tokens, so that 128 candidates refill 64 slots
SPEC_PROBLEMS = PROBLEMS + (
    ("What is 12 squared?", "144"),
    ("Compute 3 + 4 * 5.", "23"),
    ("How many sides does a hexagon have?", "6"),
    ("What is 100 divided by 4?", "25"),
)
SPEC_DRAFT, SPEC_NGRAM, SPEC_SLOTS, SPEC_NEW_TOKENS = 4, 2, 64, 256


def verify_lengths(seed: int, prompt_lens=(350, 256, 128, 60)) -> list:
    """Resident lengths of 64 rows for K5's stanza: page crossings of the
    5-token block (a block starting at 124..128 spans two pages), length 1,
    a block ending exactly at the table's capacity, the planned split's
    boundaries (a block whose last position is a split's last, or one past
    it; ``_split_lengths``), and random lengths in [550, 650], each clipped
    so the block fits its row's table."""
    import torch

    from distrl_llm_tpu_torch.ops.paged_native import plan_paged_split

    rows = PA_PROMPTS * PA_N
    plan = plan_paged_split(rows, PA_KV_HEADS, PA_PROMPT_PAGES + PA_PRIVATE_PAGES, PA_PAGE,
                            VF_S)
    caps = [(prompt_lens[r // PA_N] // PA_PAGE + PA_PRIVATE_PAGES) * PA_PAGE - VF_S
            for r in range(rows)]
    # resident lengths: the block's reach is length + S
    reach = _split_lengths(plan.pages_per_split * PA_PAGE, [c + VF_S for c in caps],
                           (VF_S, 1 + VF_S, 124 + VF_S, 126 + VF_S, 127 + VF_S, 128 + VF_S,
                            251 + VF_S, 10**6), (550 + VF_S, 651 + VF_S),
                           torch.Generator().manual_seed(seed))
    return [n - VF_S for n in reach]


def verify_case(device, seed: int, *, q_dtype, kv: str, lengths, prompt_lens=(350, 256, 128, 60),
                s: int = VF_S, heads: int = PA_HEADS, kv_heads: int = PA_KV_HEADS,
                head_dim: int = PA_HEAD_DIM):
    """K5's inputs: K2's pages and fan-out table (``paged_case``) with an
    S-token query block per row, q pre-scaled in its dtype."""
    import torch

    args, kw = paged_case(device, seed, q_dtype=q_dtype, kv=kv, prompt_lens=prompt_lens,
                          lengths=lengths, heads=heads, kv_heads=kv_heads, head_dim=head_dim)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    q = (torch.randn((len(lengths), s, heads, head_dim), generator=gen,
                     device=device).to(q_dtype) * head_dim**-0.5)
    return (q,) + args[1:], kw


def paged_verify_bound_ms(lengths, page_indices, *, q_dtype, kv_dtype, s: int = VF_S,
                          page_size: int = PA_PAGE, heads: int = PA_HEADS,
                          kv_heads: int = PA_KV_HEADS,
                          head_dim: int = PA_HEAD_DIM) -> tuple[float, str]:
    """Least time on the card for one K5 call: ``paged_attention_bound_ms``
    over the positions the blocks reach (each row reads its first
    ``length + S`` positions; a page several rows share counts once), with
    an S-token q and output per row, against 4 · H · hd operations per
    (query, attended position), query i of a row attending ``length + i +
    1`` positions."""
    import torch

    nbytes = paged_bytes([int(n) + s for n in lengths], page_indices, q_dtype=q_dtype,
                         kv_dtype=kv_dtype, s=s, page_size=page_size, heads=heads,
                         kv_heads=kv_heads, head_dim=head_dim)
    attended = sum(s * int(n) + s * (s + 1) // 2 for n in lengths)
    ops = 4 * heads * head_dim * attended
    peak = F32_OPS_PER_S if q_dtype == torch.float32 else BF16_PEAK_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _verify_tolerance(got, want, q_dtype):
    """K5's tolerance against its plain version: F32_ATOL for f32 q; for
    bf16 one bf16 ulp of the value plus F32_ATOL (each version rounds its f32
    result once)."""
    import torch

    err = (got - want).abs()
    if q_dtype == torch.float32:
        return err, torch.full_like(err, F32_ATOL)
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0**-126)
    return err, torch.exp2(torch.floor(torch.log2(mag)) - 7) + F32_ATOL


def compare_paged_verify(device, seed: int, ppbs=(1, 2, 4), cases=VF_CASES) -> float:
    """K5 against its plain version on ``device`` at the verify geometry
    (all 35 query rows of a (row, kv head) in one block), for each of
    ``VF_CASES`` and several pages_per_block; a second run must give the same
    bits, and garbage table entries past every row's block must change
    nothing. Prints the plan and the kernels' registers. Returns the largest
    |dout|."""
    import torch

    from distrl_llm_tpu_torch.ops.paged_native import (
        paged_attention_native_verify, paged_attention_native_verify_reference,
        plan_paged_split,
    )

    dev = torch.device(device)
    lengths = verify_lengths(seed)
    plan = plan_paged_split(len(lengths), PA_KV_HEADS, PA_PROMPT_PAGES + PA_PRIVATE_PAGES,
                            PA_PAGE, VF_S)
    print(f"kernel paged_verify: plan at {len(lengths)} rows x S {VF_S} x {PA_KV_HEADS} kv "
          f"heads, {PA_PROMPT_PAGES + PA_PRIVATE_PAGES} pages of {PA_PAGE}: {plan.splits} "
          f"splits of {plan.pages_per_split} pages, {plan.blocks} blocks; resident lengths "
          f"{lengths[:16]}")
    if device != "cpu":
        # hd 128, three m-tiles (35 rows): <KVT, 128, 3, 2>
        for line in _paged_build_lines("paged_verify", "Li128ELi3ELi2EE"):
            print(f"kernel paged_verify build: {line}")
    worst = 0.0
    for qn, kv in cases:
        q_dtype = getattr(torch, qn)
        args, kw = verify_case(dev, seed, q_dtype=q_dtype, kv=kv, lengths=lengths)
        want = paged_attention_native_verify_reference(*args, **kw).float()
        for ppb in ppbs:
            got = paged_attention_native_verify(*args, **kw, pages_per_block=ppb)
            again = paged_attention_native_verify(*args, **kw, pages_per_block=ppb)
            gf = got.float()
            err, tol = _verify_tolerance(gf, want, q_dtype)
            bad = err > tol
            what = f"K5 {qn}/{kv} ppb={ppb}"
            check(bool(torch.isfinite(gf).all()), f"{what}: non-finite output")
            check(not bool(bad.any()), f"{what}: |dout| {float(err.max()):.3g} above the "
                  f"tolerance on {int(bad.sum())} elements")
            check(torch.equal(got, again), f"{what}: a second run gave other bits")
            worst = max(worst, float(err.max()))
            print(f"kernel paged_verify q {qn}, pages {kv}, pages_per_block {ppb}: "
                  f"max |dout| {float(err.max()):.3g} over {got.numel()} outputs; second "
                  f"run bit-identical")
        q, kp, vp, lens, table = args
        live = -(-(lens.long() + VF_S) // PA_PAGE)
        cols = torch.arange(table.shape[1], device=dev)[None, :]
        poisoned = torch.where(cols >= live[:, None], 10**6, table).to(torch.int32)
        base = paged_attention_native_verify(q, kp, vp, lens, table, **kw)
        again = paged_attention_native_verify(q, kp, vp, lens, poisoned.contiguous(), **kw)
        check(torch.equal(base, again), f"K5 {qn}/{kv}: garbage table entries past "
              "the block changed the output")
    print(f"kernel paged_verify: all cases within tolerance (f32 {F32_ATOL}; bf16 one ulp "
          f"+ {F32_ATOL}); second runs bit-identical; max |dout| {worst:.3g}")
    return worst


# K5 past 64 query rows (phase 3): (S, query heads, kv heads, head_dim) of
# Qwen2.5-7B at d = 12 (91 rows, phase 14's), Qwen2-72B's heads at d = 16
# and Gemma-2B's at d = 16 (136 rows each; head_dim 256 takes the CUDA-core
# body)
VF_TILE_SHAPES = ((13, 28, 4, 128), (17, 64, 8, 128), (17, 8, 1, 256))


def compare_paged_verify_tiles(device, seed: int, shapes=VF_TILE_SHAPES,
                               rows: int = PA_PROMPTS * PA_N) -> float:
    """K5 past 64 query rows against its plain version on ``device``: each
    (S, H, K, hd) of ``shapes`` over ``rows`` rows of resident lengths
    550-650 (and 1, 120 and 127: page crossings of the block), bf16 q over
    bf16 and int8 pages, and f32 throughout at the first shape (the
    CUDA-core body's row tiles at head_dim 128); a second run must give the
    same bits. Prints each shape's row tiles. Returns the largest |dout|."""
    import torch

    from distrl_llm_tpu_torch.ops.paged_native import (
        paged_attention_native_verify, paged_attention_native_verify_reference, plan_row_tiles,
    )

    dev = torch.device(device)
    worst = 0.0
    for i, (s, heads, kv_heads, hd) in enumerate(shapes):
        lengths = [550 + (37 * r) % 101 for r in range(rows)]
        lengths[:3] = [1, 120, 127]
        cases = [("bfloat16", "bfloat16"), ("bfloat16", "int8")]
        cases += [("float32", "float32")] if i == 0 else []
        for qn, kv in cases:
            q_dtype = getattr(torch, qn)
            args, kw = verify_case(dev, seed + i, q_dtype=q_dtype, kv=kv, lengths=lengths, s=s,
                                   heads=heads, kv_heads=kv_heads, head_dim=hd)
            tiles = plan_row_tiles(s * heads // kv_heads, hd, q_dtype, args[1].dtype)
            want = paged_attention_native_verify_reference(*args, **kw).float()
            got = paged_attention_native_verify(*args, **kw)
            again = paged_attention_native_verify(*args, **kw)
            gf = got.float()
            err, tol = _verify_tolerance(gf, want, q_dtype)
            bad = err > tol
            what = (f"K5 S {s} x {heads}/{kv_heads} hd {hd} ({s * heads // kv_heads} rows in "
                    f"{tiles.tiles} tiles of {tiles.rows}) {qn}/{kv}")
            check(bool(torch.isfinite(gf).all()), f"{what}: non-finite output")
            check(not bool(bad.any()), f"{what}: |dout| {float(err.max()):.3g} above the "
                  f"tolerance on {int(bad.sum())} elements")
            check(torch.equal(got, again), f"{what}: a second run gave other bits")
            worst = max(worst, float(err.max()))
            print(f"kernel paged_verify {what}: max |dout| {float(err.max()):.3g} over "
                  f"{got.numel()} outputs; second run bit-identical")
            del args, kw, want, got, again
    print(f"kernel paged_verify past 64 rows: all cases within tolerance (f32 {F32_ATOL}; bf16 "
          f"one ulp + {F32_ATOL}); second runs bit-identical; max |dout| {worst:.3g}")
    return worst


def time_paged_verify(seed: int, *, s: int = VF_S, heads: int = PA_HEADS,
                      kv_heads: int = PA_KV_HEADS, head_dim: int = PA_HEAD_DIM) -> dict:
    """K5's, the plain version's and the unrolled S x K2's times at 64 rows of the verify
    geometry (lengths around 600, prompts of 350 tokens: 4 prompts x 16
    candidates; Qwen2.5-7B's heads and S 5 unless the arguments say
    otherwise), bf16 and int8 pages under bf16 q, beside the card's
    bound. K5 and the unrolled K2 run as CUDA graphs over copies of the
    pages past twice the L2 (``_rotating_graph_ms``: the ~45 MB these rows
    read would otherwise come from the L2); the plain version one call at a
    time."""
    import torch

    from distrl_llm_tpu_torch.ops.paged_native import (
        paged_attention_native, paged_attention_native_verify,
        paged_attention_native_verify_reference,
    )

    lengths = [550 + (37 * r) % 101 for r in range(PA_PROMPTS * PA_N)]
    heads_kw = dict(heads=heads, kv_heads=kv_heads, head_dim=head_dim)
    out = {}
    for kv in ("bfloat16", "int8"):
        args, kw = verify_case("cuda", seed, q_dtype=torch.bfloat16, kv=kv, lengths=lengths,
                               prompt_lens=(350,) * PA_PROMPTS, s=s, **heads_kw)
        q, kp, vp, lens, table = args
        qs = [q[:, i].contiguous() for i in range(s)]
        ls = [(lens + i + 1).to(torch.int32) for i in range(s)]

        def unrolled(q_, kp_, vp_, lens_, table_, **kw_):
            for i in range(s):
                paged_attention_native(qs[i], kp_, vp_, ls[i], table_, **kw_)

        nbytes = paged_bytes([n + s for n in lengths], table.cpu(), q_dtype=torch.bfloat16,
                             kv_dtype=kp.dtype, s=s, **heads_kw)
        ms, copies = _rotating_graph_ms(paged_attention_native_verify, args, kw, nbytes)
        unrolled_ms, _ = _rotating_graph_ms(unrolled, args, kw, nbytes)
        plain_ms = _time_ms(lambda: paged_attention_native_verify_reference(*args, **kw),
                            calls=10)
        bound_ms, bound_by = paged_verify_bound_ms(lengths, table.cpu(), q_dtype=torch.bfloat16,
                                                   kv_dtype=kp.dtype, s=s, **heads_kw)
        # no single PyTorch call takes a page table: library_ms is null; the
        # unrolled S launches of K2 are the yardstick
        out[kv] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "unrolled_ms": unrolled_ms, "copies": copies}
        del args, kw, qs
        torch.cuda.empty_cache()
    return out


def spec_prompt_batch(max_prompt_tokens: int):
    """Phase 7's 8 math prompts through the tokenizer, left-padded."""
    from distrl_llm_tpu_torch.data import process_dataset
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer, encode_fixed

    tok = CharTokenizer()
    texts = process_dataset(tok, {"problem": [p for p, _ in SPEC_PROBLEMS]})["problem"]
    ids, mask = encode_fixed(tok, texts, max_prompt_tokens, side="left")
    return tok, ids, mask


def spec_engine(cfg, device, *, spec_draft: int, kv_quant: str, cache_dtype,
                max_prompt_tokens: int = 350, max_new_tokens: int = SPEC_NEW_TOKENS,
                slots: int = SPEC_SLOTS, page_size: int = 128, scale: float = 0.5):
    """BASELINE config 2's rollout engine: the refill scheduler over
    ``slots`` slots with ``spec_draft`` n-gram drafts (0: plain refill)."""
    from distrl_llm_tpu_torch.engine import PagedGenerationEngine
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer

    tok = CharTokenizer()
    return PagedGenerationEngine(
        cfg, max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
        eos_token_ids=[tok.eos_token_id], pad_token_id=tok.pad_token_id, lora_scale=scale,
        cache_dtype=cache_dtype, capture_logprobs=True, page_size=page_size,
        kv_quant=kv_quant, scheduler="refill", max_concurrent_rows=slots,
        spec_draft=spec_draft, spec_ngram=SPEC_NGRAM, device=device)


def _check_refill_round(res, *, rows: int, n: int, steps: int, vocab: int, eos: int,
                        pad: int, what: str) -> None:
    """``_check_round`` for a refill round, whose dispatched steps serve
    several occupants per slot: every candidate generated 1..steps tokens,
    ending at its first EOS or at the limit, pad after its end."""
    import numpy as np

    check(res.tokens.shape == (rows, n, steps), f"{what}: tokens {res.tokens.shape}")
    check(((res.tokens >= 0) & (res.tokens < vocab)).all(), f"{what}: token out of range")
    tok = res.tokens.reshape(-1, steps)
    lengths = res.lengths.reshape(-1)
    logp = res.logprobs.reshape(-1, steps)
    check(((lengths >= 1) & (lengths <= steps)).all(), f"{what}: lengths out of range")
    check(np.isfinite(logp).all() and (logp <= 1e-6).all(), f"{what}: bad logprobs")
    col = np.arange(steps)[None, :]
    after = col >= lengths[:, None]
    check((tok[after] == pad).all(), f"{what}: a non-pad token after a row's end")
    check((logp[after] == 0.0).all(), f"{what}: a logprob after a row's end")
    eos_at = np.where((tok == eos) & ~after, col, steps).min(axis=1)
    check(((eos_at == lengths - 1) | ((eos_at == steps) & (lengths == steps))).all(),
          f"{what}: a row does not end at its first EOS")
    check(res.steps_dispatched >= 1, f"{what}: no step dispatched")


def spec_round(cfg, device, weights, *, seed: int, spec_draft: int, kv_quant: str,
               temperature: float = 0.0, n: int = PA_N, max_new_tokens: int = SPEC_NEW_TOKENS,
               slots: int = SPEC_SLOTS, page_size: int = 128, card: str = "",
               max_prompt_tokens: int = 350, profile: bool = False) -> dict:
    """One round of the refill engine (speculative with ``spec_draft`` > 0)
    on phase 7's prompts, after a short warm-up, with the launch counts
    reset just before and read just after. Checks the round's tokens;
    ``check_spec_counts`` checks its launches. With ``profile``, also the
    device time per step by kernel (after the counts are read)."""
    import torch

    from distrl_llm_tpu_torch.config import SamplingConfig

    model, lora = weights
    dtype = model.embed.dtype
    tok, ids, mask = spec_prompt_batch(max_prompt_tokens)
    eng = spec_engine(cfg, device, spec_draft=spec_draft, kv_quant=kv_quant, cache_dtype=dtype,
                      max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
                      slots=slots, page_size=page_size)
    sc = SamplingConfig(max_tokens=max_new_tokens, temperature=temperature, top_p=0.95, n=n)
    eng.generate(model, lora, ids, mask, sc.replace(max_tokens=4), seed)  # warm-up
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    model_forwards, plain = [0], [0]
    hook = model.register_forward_hook(lambda *_: model_forwards.__setitem__(
        0, model_forwards[0] + 1))
    with counting_plain_calls(_qmm(), "quant_matmul_reference", plain):
        reset_counts()
        t = time.perf_counter()
        res = eng.generate(model, lora, ids, mask, sc, seed + 1)
        wall = time.perf_counter() - t
        counts = read_counts()
    hook.remove()
    st, spec = eng.last_round_stats, eng.last_spec_stats
    quantized = any(b.dtype == torch.int8 for b in model.buffers())
    label = (f"{'spec d=' + str(spec_draft) if spec_draft else 'plain refill'} "
             f"{'int8' if kv_quant == 'int8' else str(dtype).split('.')[-1]} KV "
             f"t={temperature}{', int4 base' if quantized else ''}")
    _check_refill_round(res, rows=ids.shape[0], n=n, steps=max_new_tokens,
                        vocab=cfg.vocab_size, eos=tok.eos_token_id, pad=tok.pad_token_id,
                        what=label)
    fwd = st["decode_forwards"]
    steps = res.steps_dispatched
    out = {"label": label, "counts": counts, "res": res, "wall_s": wall,
           "spec_draft": spec_draft, "quantized": quantized,
           "model_forwards": model_forwards[0], "plain_calls": plain[0],
           "sampler_calls": st["sampler_calls"],
           "ms_per_step": st["decode_s"] * 1e3 / steps, "decode_tok_s": st["gen_tokens"]
           / st["decode_s"], "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "steps": steps, "forwards": fwd, "gen_tokens": st["gen_tokens"], "spec": spec,
           "pool": eng.last_pool_stats, "alive_slot_steps": res.alive_slot_steps}
    extra = ""
    if spec:
        extra = (f"; accept rate {spec['accept_rate']:.4f}, {spec['tokens_per_verify_step']:.4f} "
                 f"tokens per verify step, emit histogram {spec['emit_hist']}")
    print(f"spec {label}: {ids.shape[0]} prompts x {n} over {slots} slots, {steps} steps "
          f"({res.alive_slot_steps} slot-steps), {st['gen_tokens']} tokens; decode "
          f"{out['decode_tok_s']:.1f} tok/s, {out['ms_per_step']:.2f} ms/step; prefill "
          f"{out['prefill_tok_s']:.1f} tok/s; wall {wall:.1f} s{extra}; launches {counts}; {card}")
    if profile:
        prof = profile_decode(lambda k: eng.generate(
            model, lora, ids, mask, sc.replace(max_tokens=k), seed).steps_dispatched)
        print(f"profile spec {label}: {prof['device_ms_per_step']:.3f} ms of device time per "
              f"step in {prof['kernels_per_step']} kernel names, against "
              f"{out['ms_per_step']:.3f} ms/step unprofiled: device idle "
              f"{100 * (1 - prof['device_ms_per_step'] / out['ms_per_step']):.1f}%; {card}")
        for name, ms in prof["top"]:
            print(f"profile spec {label}: {ms:8.4f} ms/step  {name[:110]}")
        out["profile"] = prof
    return out


def check_spec_counts(out: dict, layers: int) -> None:
    """Every kernel of a refill round's path ran as often as the path
    dispatches it: speculative, K5 once per layer per verify forward and K2
    never, K1 once per admission;
    plain, K2 once per layer per decode forward, K1 once per step, K5
    never; K4 never; K3 7 times per layer per model forward over a
    quantized base (its plain version never), else never."""
    c, fwd, d, label = out["counts"], out["forwards"], out["spec_draft"], out["label"]
    if d:
        check(c["paged_verify"] == layers * fwd and c["paged_attention"] == 0,
              f"{label}: K5 launched {c['paged_verify']} times, K2 {c['paged_attention']}; "
              f"want {layers} x {fwd} verify forwards and 0")
    else:
        check(c["paged_attention"] == layers * fwd and c["paged_verify"] == 0,
              f"{label}: K2 launched {c['paged_attention']} times, K5 {c['paged_verify']}; "
              f"want {layers} x {fwd} decode forwards and 0")
    check(c["fused_sample"] == out["sampler_calls"] > 0,
          f"{label}: K1 launched {c['fused_sample']} times, want {out['sampler_calls']}")
    check(c["flash_attention_fwd"] == c["flash_attention_bwd"] == 0, f"{label}: K4 launched")
    want_qmm = 7 * layers * out["model_forwards"] if out["quantized"] else 0
    check(c["quant_matmul"] == want_qmm and out["plain_calls"] == 0,
          f"{label}: K3 launched {c['quant_matmul']} times, want {want_qmm} (7 x layers x "
          f"{out['model_forwards']} model forwards over a quantized base, else 0); its plain "
          f"version {out['plain_calls']} times")


def spec_exactness(device, seed: int, *, max_new_tokens: int = 32) -> dict:
    """Greedy speculative decoding emits exactly the plain refill round's
    tokens, checked where drafts do get accepted: random Qwen2.5-7B-wide
    weights never repeat themselves, so this runs the TINY preset in f32
    (8 prompts x 2 candidates through 4 slots, 8-token pages), whose
    greedy streams loop, through the same engine and kernels on the
    card. Returns the spec and plain rounds."""
    import torch

    from distrl_llm_tpu_torch.models.configs import TINY

    weights = make_weights(TINY, device, seed=seed, rank=4, dtype=torch.float32)
    kw = dict(seed=seed, n=2, max_new_tokens=max_new_tokens, slots=4, page_size=8,
              max_prompt_tokens=96)
    spec = spec_round(TINY, device, weights, spec_draft=SPEC_DRAFT, kv_quant="none", **kw)
    plain = spec_round(TINY, device, weights, spec_draft=0, kv_quant="none", **kw)
    return {"spec": spec, "plain": plain, "layers": TINY.num_layers}


def verify_logits(wide, *, seed: int, n: int = PA_N, s: int = SPEC_DRAFT + 1,
                  page_size: int = 128, scale: float = 0.5, max_prompt_tokens: int = 350,
                  max_new_tokens: int = SPEC_NEW_TOKENS) -> dict:
    """f32 teacher-forced logits of one verify forward over S positions
    against S single-token decode forwards fed the same tokens, on the math
    prompts' fanned-out pages (4 prompts x ``n``; ``wide`` is the f32
    model): K5 at every layer of the verify, K2 at every layer of each
    decode. Returns the largest |dlogit|, the logit std and the launches."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.engine.paged_engine import _paged_fanout, _paged_prefill
    from distrl_llm_tpu_torch.ops import paged_native

    model, lora = wide
    dev = model.embed.device
    _, ids, mask, _ = prompt_batch(max_prompt_tokens)
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=dev)
    mask = torch.as_tensor(np.asarray(mask), dtype=torch.int32, device=dev)
    b = ids.shape[0]
    pp = -(-max_prompt_tokens // page_size)
    priv = 1 + -(-(max_new_tokens + s) // page_size)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (b * n, s), generator=gen, device=dev,
                           dtype=torch.int32)

    def fanned():
        k, v, last, real_len = _paged_prefill(
            model, lora, ids, mask, prompt_pages=pp, page_size=page_size, lora_scale=scale,
            cache_dtype=torch.float32, attn_impl="reference",
            total_pages=b * pp + b * n * priv)
        return _paged_fanout(k, v, last, real_len, mask.sum(dim=-1) > 0, n=n, b=b,
                             prompt_pages=pp, private_pages=priv, page_size=page_size,
                             max_steps=max_new_tokens, pad_id=0)

    with torch.inference_mode():
        st, table = fanned()
        lens = st.seq_lengths.clone()
        cache = {"k": st.k_pages, "v": st.v_pages, "lengths": lens, "page_indices": table}
        before = (paged_native.paged_verify_launches, paged_native.paged_attention_launches)
        positions = lens[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        verify, _ = model(tokens, positions=positions, lora=lora, lora_scale=scale,
                          kv_cache=cache, page_size=page_size, paged_verify=True)
        k5 = paged_native.paged_verify_launches - before[0]
        del st, cache
        st, table = fanned()
        steps = []
        for i in range(s):
            cache = {"k": st.k_pages, "v": st.v_pages, "lengths": lens + i,
                     "page_indices": table}
            lg, _ = model(tokens[:, i:i + 1], positions=(lens + i)[:, None], lora=lora,
                          lora_scale=scale, kv_cache=cache, page_size=page_size)
            steps.append(lg[:, 0])
        k2 = paged_native.paged_attention_launches - before[1]
        decode = torch.stack(steps, dim=1)
    return {"err": float((verify - decode).abs().max()), "std": float(decode.std()),
            "k5": k5, "k2": k2, "shape": tuple(verify.shape)}


def spec_phase(cfg, args, card: str, t_start: float) -> tuple[list, dict, dict]:
    """Phase 7 on the card: speculative decoding at Qwen2.5-7B width (see
    the module's docstring). Returns the launch counts of its main-path
    runs, K5's stanza results, and the plain refill round's peak pages and
    ms/step (bf16 pages) for phase 9 to print beside its own."""
    import numpy as np
    import torch

    err = compare_paged_verify("cuda", args.seed)
    times = time_paged_verify(args.seed)
    for kv, r in times.items():
        print(f"kernel paged_verify at B={PA_PROMPTS * PA_N} x S={VF_S} x lengths 550-650, "
              f"{kv} pages, bf16 q (a CUDA graph over {r['copies']} page copies past twice "
              f"the L2): {r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), unrolled {VF_S} x K2 (the "
              f"yardstick; no library call takes a page table) {r['unrolled_ms']:.4f} ms; "
              f"{card}")
    result = {"max_abs_err": err, **{k: v for k, v in times["bfloat16"].items()
                                     if k not in ("unrolled_ms", "copies")}}
    counted = []
    # the rounds at SHALLOW_LAYERS (the bf16 pages' too: the depth cut that
    # makes room for phase 12), the f32 verify logits at the full depth
    shallow = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, SHALLOW_LAYERS))
    shallow_weights = make_weights(shallow, "cuda", seed=args.seed)
    runs = {}
    for kv_quant in ("none", "int8"):
        for d in (SPEC_DRAFT, 0):
            out = spec_round(shallow, "cuda", shallow_weights, seed=args.seed, spec_draft=d,
                             kv_quant=kv_quant, card=card, profile=args.profile)
            check_spec_counts(out, shallow.num_layers)
            runs[(kv_quant, d)] = out
            counted.append(out["counts"])
        spec, plain = runs[(kv_quant, SPEC_DRAFT)], runs[(kv_quant, 0)]
        same = spec["res"].tokens == plain["res"].tokens
        rows = same.reshape(-1, same.shape[-1]).all(axis=1)
        print(f"spec {kv_quant} KV, {shallow.num_layers} layers: speculative vs plain refill "
              f"greedy tokens equal on {100 * same.mean():.2f}% of positions, "
              f"{int(rows.sum())}/{rows.size} rows "
              f"whole (not asserted: bf16 batches the verify's products over 5 positions, "
              f"which rounds otherwise and flips near-ties); decode {spec['ms_per_step']:.2f} "
              f"vs {plain['ms_per_step']:.2f} ms/step, {spec['decode_tok_s']:.1f} vs "
              f"{plain['decode_tok_s']:.1f} tok/s, {spec['steps']} vs {plain['steps']} steps; "
              f"total {time.perf_counter() - t_start:.1f} s; {card}")
    ex = spec_exactness("cuda", args.seed)
    for out in (ex["spec"], ex["plain"]):
        check_spec_counts(out, ex["layers"])
    same = ex["spec"]["res"].tokens == ex["plain"]["res"].tokens
    acc = ex["spec"]["spec"]["accept_rate"]
    print(f"spec exactness (TINY preset, f32, the same engine and kernels): speculative vs "
          f"plain refill greedy tokens equal on {100 * same.mean():.2f}% of positions; accept "
          f"rate {acc:.4f}, {ex['spec']['spec']['tokens_per_verify_step']:.4f} tokens per "
          f"verify step, {ex['spec']['alive_slot_steps']} vs {ex['plain']['alive_slot_steps']} "
          f"slot-steps")
    check(acc > 0, "spec exactness: no draft was accepted, the multi-token path did not run")
    check(bool(same.all()) and np.array_equal(ex["spec"]["res"].lengths,
                                              ex["plain"]["res"].lengths),
          "spec exactness: speculative greedy tokens differ from plain refill's")
    sampled = spec_round(shallow, "cuda", shallow_weights, seed=args.seed,
                         spec_draft=SPEC_DRAFT, kv_quant="none", temperature=1.2, card=card)
    check_spec_counts(sampled, shallow.num_layers)
    counted.append(sampled["counts"])
    del shallow_weights
    torch.cuda.empty_cache()
    wide = widen(make_weights(cfg, "cuda", seed=args.seed))
    torch.cuda.empty_cache()
    lg = verify_logits(wide, seed=args.seed)
    del wide
    torch.cuda.empty_cache()
    print(f"spec: f32 logits of one verify forward over {VF_S} positions vs {VF_S} "
          f"single-token decode forwards, {lg['shape'][0]} rows, teacher-forced: max |dlogit| "
          f"{lg['err']:.4g} (tolerance {LOGIT_F32_ATOL}; logit std {lg['std']:.4g}); K5 "
          f"launched {lg['k5']} times in the verify, K2 {lg['k2']} in the decodes")
    check(lg["k5"] == cfg.num_layers and lg["k2"] == VF_S * cfg.num_layers,
          f"spec logits: K5 {lg['k5']} / K2 {lg['k2']} launches, want {cfg.num_layers} / "
          f"{VF_S * cfg.num_layers}")
    check(lg["err"] <= LOGIT_F32_ATOL, f"verify vs decode f32 logits differ by "
          f"{lg['err']:.4g} > {LOGIT_F32_ATOL}")
    check(np.isfinite(lg["std"]), "spec logits: non-finite")
    # one greedy speculative round over the int4 base: K3 at M = 64 x 5
    # verify positions (and at the prefills), K5 as over the bf16 base
    qw = make_qlora_weights(shallow, "cuda", seed=args.seed, bits=4, group=QMM_GROUP)
    q4 = spec_round(shallow, "cuda", qw, seed=args.seed, spec_draft=SPEC_DRAFT, kv_quant="none",
                    card=card, profile=args.profile)
    check_spec_counts(q4, shallow.num_layers)
    counted.append(q4["counts"])
    print(f"spec over the int4 g{QMM_GROUP} base: {q4['ms_per_step']:.2f} ms/step, "
          f"{q4['decode_tok_s']:.1f} tok/s, accept rate {q4['spec']['accept_rate']:.4f}, "
          f"{q4['steps']} steps; K3 {q4['counts']['quant_matmul']} launches (7 x "
          f"{shallow.num_layers} x {q4['model_forwards']} model forwards); total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    del qw
    torch.cuda.empty_cache()
    plain = runs[("none", 0)]
    plain_refill = {"peak_pages_used": plain["pool"]["peak_pages_used"],
                    "ms_per_step": plain["ms_per_step"]}
    return counted, result, plain_refill


# ---------------------------------------------------------------- phase 8

# the trainer's cell (ROADMAP queue 1 item 6's main path, the reference's
# loop): 8 math problems, batch 4 x 16 candidates (64 rows, topk 16), 128 new
# tokens (cut from 1200), 8 learner microbatches of 8 rows, a refill engine of
# 32 slots, so the refill scheduler runs (64 candidates > 32 slots) and the
# eval round (4 prompts x eval_n 8 = 32 rows) takes the wave scheduler
TRAIN_PROBLEMS = PROBLEMS + (
    ("What is 15% of 80?", "12"),
    ("Solve for x: 3x + 5 = 20.", "5"),
    ("How many primes are less than 20?", "8"),
    ("What is the greatest common divisor of 48 and 18?", "6"),
)
TRAIN_SLOTS = 32
# phase 8 (a)'s depth: half of Qwen2.5-7B's 28, the cut that makes room for
# phase 17
TRAINER_LAYERS = 14
TRAIN_NEW_TOKENS = 128
# a phase's time ends on finished device work: a synchronize right after
# the phase returns waits for nothing but its own launch (tens of us); a
# learner microbatch or a decode step left queued would take milliseconds
PHASE_DRAIN_MS = 1.0
# the reference's metric names (distributed_trainer.py:348-366, :412-415)
TRAIN_METRICS = {
    "loss", "mean_accuracy_reward", "min_accuracy_reward", "max_accuracy_reward",
    "mean_format_reward", "mean_token_length", "episode", "total_batch_steps",
    "total_samples_processed", "timing/update_duration", "timing/reward_duration",
    "timing/generation_duration",
}
# Qwen2's pretokenizer pattern (the cl100k-style regex of its tokenizer.json)
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def smoke_reward(completions, solutions):
    """The reference's (N, 2) reward with its format column, and an accuracy
    column that a random-weight model can move: such a model solves nothing,
    so every accuracy would be 0, every PG coefficient 0 and every learner
    microbatch skipped. Here accuracy is a hash of the completion's text in
    [0, 1): distinct completions score apart, groups have reward variance,
    and the learner trains on every microbatch."""
    import zlib

    from distrl_llm_tpu_torch.rewards import reward_function

    r = reward_function(completions, solutions)
    r[:, 1] = [zlib.crc32(c.encode("utf-8")) % 1000 / 1000 for c in completions]
    return r


def write_bpe_tokenizer(path: Path, vocab_size: int) -> Path:
    """A byte-level BPE ``tokenizer.json`` (and a ``tokenizer_config.json``
    without a chat template) in ``path``, written by hand, since no
    tokenizer package is assumed: Qwen2's pretokenizer and NFC normalizer,
    the 256 byte tokens, merges of printable byte pairs, then merges of
    those pairs and a further byte until the vocabulary is full, and the
    three ChatML special tokens at the top: ``vocab_size`` ids in all (up to
    the 256 + 95**3 that printable ASCII spells), so every id a model of that
    vocabulary samples decodes to text."""
    # GPT-2's bytes_to_unicode: printable bytes stand for themselves, the
    # rest map past U+0100
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    char = {b: chr(b) for b in printable}
    extra = 0
    for b in range(256):
        if b not in char:
            char[b] = chr(256 + extra)
            extra += 1
    vocab = {char[b]: b for b in range(256)}
    merges = []
    # lowercase first: the merges that fit a small vocabulary shorten words
    ascii_bytes = sorted(range(0x20, 0x7f), key=lambda c: (not chr(c).islower(), c))
    pairs = [char[a] + char[b] for a in ascii_bytes for b in ascii_bytes]
    triples = ((p, char[c]) for p in pairs for c in ascii_bytes)
    for left, right in itertools.chain(((p[0], p[1]) for p in pairs), triples):
        if len(vocab) >= vocab_size - 3:
            break
        merges.append(f"{left} {right}")
        vocab[left + right] = len(vocab)
    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    added = [{"id": len(vocab) + i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(specials)]
    tj = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                    "use_regex": False},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "vocab": vocab, "merges": merges},
    }
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps({"chat_template": None}))
    return path


def trainer_datasets(tokenizer):
    """The 8 problems (train) and the first 4 (eval) through the R1 chat
    template, as ``data.py``'s preparers template MATH-500."""
    from distrl_llm_tpu_torch.data import R1_PREPROMPT, process_dataset

    data = {"problem": [p for p, _ in TRAIN_PROBLEMS], "solution": [s for _, s in TRAIN_PROBLEMS]}
    train = process_dataset(tokenizer, data, R1_PREPROMPT, "")
    return train, {k: v[:4] for k, v in train.items()}


def trainer_config(workdir: Path, **kw):
    """The trainer's configuration for phase 8: the reference's QLoRA
    setting (int4 g64 base, PG, rank 32, alpha 16, Adam8bit, lr 2e-5), the
    paged refill engine with splash attention, and the cuts of the cell."""
    from distrl_llm_tpu_torch.config import TrainConfig

    base = dict(
        model="qwen2.5-7b-random", learner="pg", max_lora_rank=32, lora_alpha=16.0,
        lr=2e-5, optimizer_8bit=True, base_quant="int4", engine_impl="paged",
        continuous_batching=True, max_concurrent_sequences=TRAIN_SLOTS,
        attn_impl="splash", batch_size=4, num_candidates=16, topk=16,
        max_prompt_tokens=350, max_new_tokens=TRAIN_NEW_TOKENS, train_batch_size=8,
        episodes=1, eval_every=0, eval_n=8, save_every=1,
        number_of_actors=1, number_of_learners=1, learner_chunk_size=1,
        checkpoint_dir=str(workdir / "ckpt"), write_adapter_file=True,
        lora_save_path=str(workdir / "adapter"), metrics_backend="null",
        print_samples=False)
    base.update(kw)
    return TrainConfig(**base)


class _StepSink:
    """The trainer's metrics sink: keeps every record and, at each train
    record (after that step's update), a host copy of the adapter, for the
    per-step clip check."""

    def __init__(self, trainer_cell: list):
        self.records, self.adapters, self.trainer_cell = [], [], trainer_cell

    def log(self, metrics, step):
        self.records.append((step, dict(metrics)))
        if "loss" in metrics and not self.trainer_cell[0]._full:
            # full fine-tuning's tree is the model: check_full_run holds it
            self.adapters.append(_lora_host(self.trainer_cell[0].lora))

    def finish(self):
        pass


def _lora_host(lora) -> list:
    return [x.detach().cpu().clone() for x in _lora_leaves(lora)]


def forward_counter(model, cell: list):
    """A forward hook counting, in ``cell[0]``, the model's forward calls
    that run: a call made while a CUDA graph is being captured launches
    nothing (the engines report the steps their replays ran as
    ``graph_steps``)."""
    import torch

    def hook(*_):
        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            cell[0] += 1

    return model.register_forward_hook(hook)


def trainer_run(build, *, label: str = "", probe=None) -> dict:
    """``build(sink)`` makes a ``Trainer``; this runs its ``train()`` with the
    kernels' counts reset just before and read just after, recording each
    engine round (decode steps, decode forwards, sampler calls, resumes) and
    the model's forward calls inside and outside the engine, so the counts
    can be held to what the path dispatched. ``probe(model)``, when given,
    runs at each round's start on the model the round samples with (its
    launches are not counted) and its result is kept with the round."""
    import torch

    from distrl_llm_tpu_torch.ops import flash_attention as fa

    cell = []
    sink = _StepSink(cell)
    trainer = build(sink)
    cell.append(trainer)
    # the model the engine samples with (the shared base; in full mode the
    # rollout copy) and the one the learner trains (the base, or the f32
    # master weights)
    model, eng = trainer._engine_params()[0], trainer.engine
    learner_model = trainer.lora if trainer._full else model
    forwards, learner_calls = [0], [0]
    hooks = [forward_counter(model, forwards)]
    if learner_model is not model:
        hooks.append(learner_model.register_forward_hook(
            lambda *_: learner_calls.__setitem__(0, learner_calls[0] + 1)))
    rounds = []
    generate, push = eng.generate, trainer._push_weights
    dev = model.embed.device
    cuda = dev.type == "cuda"
    # device work still queued when a phase ends: the time a synchronize
    # takes right after a round returns (the generation phase's end) and
    # right after the update phase (the weight push follows it at once)
    pending = {"generation": [], "update": []}

    def drained(phase: str) -> None:
        if cuda:
            t = time.perf_counter()
            torch.cuda.synchronize(dev)
            pending[phase].append(1e3 * (time.perf_counter() - t))

    def pushed():
        drained("update")
        push()

    def recorded(*a, **kw):
        seen = None
        if probe is not None:
            held, f_held = read_counts(), forwards[0]
            seen = probe(a[0])
            forwards[0] = f_held  # the probe's forward and launches are not the path's
            for k in KERNELS:
                setattr(importlib.import_module(k["module"]), k["counter"], held[k["name"]])
        f0 = forwards[0]
        res = generate(*a, **kw)
        drained("generation")
        st, pool = eng.last_round_stats, getattr(eng, "last_pool_stats", None) or {}
        # the steps graph replays ran: each a decode forward no hook saw
        forwards[0] += st.get("graph_steps", 0)
        rounds.append({"steps": res.steps_dispatched, "forwards": st.get("decode_forwards", 0),
                       "sampler_calls": st.get("sampler_calls", res.steps_dispatched),
                       "resumes": pool.get("resumes", 0), "refill": bool(pool),
                       "model_forwards": forwards[0] - f0, "probe": seen,
                       "prefill_tok_saved": pool.get("prefill_tok_saved"), "res": res})
        return res

    eng.generate, trainer._push_weights = recorded, pushed
    initial = [] if trainer._full else _lora_host(trainer.lora)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    k4_plain, k3_plain = [0], [0]
    try:
        with (counting_plain_calls(fa, "flash_attention_reference", k4_plain),
              counting_plain_calls(_qmm(), "quant_matmul_reference", k3_plain)):
            reset_counts()
            t = time.perf_counter()
            trainer.train()
            wall = time.perf_counter() - t
            counts = read_counts()
    finally:
        for hook in hooks:
            hook.remove()
        eng.generate, trainer._push_weights = generate, push
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
    engine_forwards = sum(r["model_forwards"] for r in rounds)
    learner = learner_calls[0] if learner_model is not model else forwards[0] - engine_forwards
    return {"trainer": trainer, "records": sink.records,
            "adapters": [] if trainer._full else [initial] + sink.adapters,
            "rounds": rounds, "counts": counts, "wall_s": wall, "peak_gib": peak,
            "learner_forwards": learner, "engine_forwards": engine_forwards,
            "k4_plain": k4_plain[0], "k3_plain": k3_plain[0], "label": label,
            "pending_ms": pending}


def check_adapter_clip(adapters, lr: float, label: str) -> None:
    """Each step moved the adapter, and no element beyond Adam8bit's clip
    (5 lr, plus the rounding of p + step)."""
    for i in range(1, len(adapters)):
        before, after = adapters[i - 1], adapters[i]
        d = [(a - b).abs() for a, b in zip(after, before)]
        within = all(bool((x <= 5 * lr * (1 + 1e-6) + b.abs() * 2.0**-23).all())
                     for x, b in zip(d, before))
        check(within, f"{label} step {i}: an adapter element moved beyond Adam8bit's "
              f"clip 5 lr = {5 * lr:.3g}")
        check(any(bool((x > 0).any()) for x in d), f"{label} step {i}: the adapter did not move")


def check_trainer_run(out: dict, layers: int, *, steps: int, lr: float, cuda: bool) -> None:
    """The trainer's run did what phase 8's cell asks: ``steps`` finite
    losses, weight version and rollout-resident version ``steps``, every
    adapter element within Adam8bit's clip at every step (and moved), the
    reference's metric names, and on the card every kernel launched as often
    as the path dispatched it (graph replays included): K1 once per sampler
    call (decode steps and refill admissions), K2 once per layer per paged
    decode forward (none on the dense engine), K3 (a
    quantized base) 7 times per layer per engine forward and twice that per
    learner forward (forward and remat recompute), K4 (flash or splash)
    forward once per layer per prefill and twice per layer per learner
    forward, backward once (at head_dim 256 also each by its route and
    dtype); no plain version. A full fine-tuning run has no adapter: its
    tree is held by ``check_full_run``."""
    tr, label = out["trainer"], out["label"]
    train = [m for _, m in out["records"] if "loss" in m]
    evals = [m for _, m in out["records"] if any(k.startswith("eval/") for k in m)]
    check(len(train) == steps, f"{label}: {len(train)} train records, want {steps}")
    for m in train:
        check(math.isfinite(m["loss"]), f"{label}: loss {m['loss']}")
        check(TRAIN_METRICS <= set(m), f"{label}: train record lacks {TRAIN_METRICS - set(m)}")
    n = tr.config.eval_n
    want_eval = {f"eval/pass@1(mean{n})", f"eval/BoN({n})", "eval/mean_token_length",
                 "timing/eval_duration"}
    check(evals and all(set(m) == want_eval for m in evals),
          f"{label}: eval records {[sorted(m) for m in evals]}, want {sorted(want_eval)}")
    check(tr.weight_version == steps and tr._rollout_weight_version == steps,
          f"{label}: weight version {tr.weight_version}, rollout-resident "
          f"{tr._rollout_weight_version}, want {steps}")
    check_adapter_clip(out["adapters"], lr, label)
    if not cuda:
        return
    c, rounds = out["counts"], out["rounds"]
    decode_fwd = sum(r["forwards"] for r in rounds)
    prefills = sum(r["model_forwards"] - r["forwards"] - r["resumes"] for r in rounds)
    learner = out["learner_forwards"]
    quantized = tr.config.base_quant != "none"
    k4 = tr.config.attn_impl in ("flash", "splash")
    # K4's head_dim 256 routes by dtype: the engine's prefill at the rollout
    # weights' dtype, the learner at its trainable model's (f32 masters in
    # full mode, else the base's)
    rollout_f32 = str(tr._engine_params()[0].embed.dtype) == "torch.float32"
    learner_f32 = tr._full or rollout_f32
    k4_eng, k4_lrn = (layers * prefills, layers * learner) if k4 else (0, 0)
    routes = hd256_counts(
        tr.model_cfg.head_dim,
        bf16_fwd=(0 if rollout_f32 else k4_eng) + (0 if learner_f32 else 2 * k4_lrn),
        bf16_bwd=0 if learner_f32 else k4_lrn,
        f32_fwd=(k4_eng if rollout_f32 else 0) + (2 * k4_lrn if learner_f32 else 0),
        f32_bwd=k4_lrn if learner_f32 else 0)
    want = {
        "fused_sample": sum(r["sampler_calls"] for r in rounds),
        "paged_attention": (layers * decode_fwd
                            if tr.config.engine_impl in ("paged", "paged_sharded") else 0),
        "quant_matmul": 7 * layers * (out["engine_forwards"] + 2 * learner) if quantized else 0,
        "flash_attention_fwd": layers * (prefills + 2 * learner) if k4 else 0,
        "flash_attention_bwd": layers * learner if k4 else 0,
        "paged_verify": 0,
        **routes,
        **domain_counts(rank_chunks=7 * layers * (out["engine_forwards"] + 2 * learner)
                        if quantized and tr.config.max_lora_rank > 64 else 0),
    }
    check(c == want, f"{label}: launches {c}, want {want} ({decode_fwd} decode forwards, "
          f"{prefills} prefills, {out['engine_forwards']} engine and {learner} learner forwards)")
    check(learner == steps * tr.config.batch_size * tr.config.num_candidates
          // tr.config.train_batch_size,
          f"{label}: {learner} learner forwards, want every microbatch of every step")
    check(out["k4_plain"] == out["k3_plain"] == 0, f"{label}: a plain version ran on the "
          f"trainer's path (K4 {out['k4_plain']}, K3 {out['k3_plain']} times)")
    for phase, ms in out["pending_ms"].items():
        check(ms and max(ms) <= PHASE_DRAIN_MS, f"{label}: {phase} left device work queued "
              f"(a synchronize after it took {max(ms or [0]):.3f} ms > {PHASE_DRAIN_MS} ms)")


def trainer_step_lines(out: dict, card: str) -> list:
    """Per step: the phases' times and their sum, ms per training step."""
    lines = []
    for m in (m for _, m in out["records"] if "loss" in m):
        g, r, u = (1e3 * m[f"timing/{k}_duration"] for k in ("generation", "reward", "update"))
        lines.append(
            f"trainer {out['label']} step {m['total_batch_steps']}: generation {g:.1f} ms, "
            f"reward {r:.1f} ms, update {u:.1f} ms; {g + r + u:.1f} ms per training step; loss "
            f"{m['loss']:.6g}, mean accuracy (hash) {m['mean_accuracy_reward']:.4f}, mean "
            f"token length {m['mean_token_length']:.1f}, engine/decode_tok_s "
            f"{m.get('engine/decode_tok_s', float('nan')):.1f}, pool/pages "
            f"{m.get('pool/pages')}, pool/peak_pages_used {m.get('pool/peak_pages_used')}, "
            f"pool/preemptions {m.get('pool/preemptions')}; {card}")
    return lines


def trainer_smoke(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                  group=QMM_GROUP, hbm_bytes=None, config_kw=None) -> dict:
    """Phase 8a: whole training steps through ``Trainer.train()``: random
    weights from ``seed`` (bf16 on the card, f32 on the CPU) quantized to
    int4 by ``quantize_base``, the native BPE tokenizer from
    ``tokenizer_dir``, the engine ``trainer.make_engine`` builds (its KV
    pool from ``kv_pool_pages``), 2 optimizer steps in 1 episode after the
    initial eval, a checkpoint and an adapter file at every step."""
    import torch

    from distrl_llm_tpu_torch.checkpoint import CheckpointManager, load_adapter_file
    from distrl_llm_tpu_torch.ops.quant import quantize_base
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine

    tok = load_tokenizer(str(tokenizer_dir))
    config = trainer_config(workdir, seed=seed, quant_group_size=group, **(config_kw or {}))
    model, _ = make_weights(cfg, device, seed=seed)
    quantize_base(model, config.base_quant, config.quant_group_size)
    if model.embed.device.type == "cuda":
        torch.cuda.empty_cache()
    engine = make_engine(config, model, tok, hbm_bytes=hbm_bytes)
    train, test = trainer_datasets(tok)
    out = trainer_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                           engine=engine, model=model, sink=sink),
                      label="qlora")
    tr = out["trainer"]
    saved = load_adapter_file(config.lora_save_path, tr.lora)
    out["adapter_equal"] = all(torch.equal(saved["layers"][t][k], tr.lora["layers"][t][k])
                               for t in tr.lora["layers"] for k in ("a", "b"))
    restored = CheckpointManager(config.checkpoint_dir).restore()
    out["resume_state"] = (restored["step"], all(
        torch.equal(restored["lora"]["layers"][t][k], tr.lora["layers"][t][k].cpu())
        for t in tr.lora["layers"] for k in ("a", "b")))
    out["kv_pages"] = engine.max_kv_pages
    out["pool_pages"] = engine.last_pool_stats["pool_pages"]
    out["config"] = config
    return out


def from_pretrained_smoke(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                          group=QMM_GROUP, hbm_bytes=None, config_kw=None) -> dict:
    """Phase 8b: ``Trainer.from_pretrained`` on a checkpoint written by the
    port's ``save_hf_checkpoint`` (random weights from ``seed``, a Qwen2
    ``config.json``) with the tokenizer files of ``tokenizer_dir``: the
    weights ``load_pretrained`` reads back must equal the written ones bit
    for bit, the tokenizer must be the native one, and one training step
    runs over the int4 base."""
    import shutil

    import torch

    from distrl_llm_tpu_torch.models.loading import load_pretrained, save_hf_checkpoint
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer

    ckpt = workdir / "hf"
    model, _ = make_weights(cfg, device, seed=seed)
    t = time.perf_counter()
    save_hf_checkpoint(model, str(ckpt))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(tokenizer_dir / name, ckpt / name)
    written = time.perf_counter() - t
    nbytes = sum(f.stat().st_size for f in ckpt.iterdir())
    t = time.perf_counter()
    loaded, loaded_cfg = load_pretrained(str(ckpt), dtype=model.embed.dtype, device=device)
    read = time.perf_counter() - t
    want = dict(model.named_parameters())
    got = dict(loaded.named_parameters())
    equal = loaded_cfg == cfg and set(want) == set(got) and all(
        torch.equal(want[k], got[k]) for k in want)
    dtype = str(model.embed.dtype).removeprefix("torch.")
    del model, loaded, want, got
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    config = trainer_config(workdir / "fp", seed=seed, quant_group_size=group, dtype=dtype,
                            **(config_kw or {}))

    def build(sink):
        # as the CLI does: the tokenizer first (the dataset's chat template)
        tok = load_tokenizer(str(ckpt))
        train, test = trainer_datasets(tok)
        train = {k: v[:config.batch_size] for k, v in train.items()}  # one batch: one step
        return Trainer.from_pretrained(train, test, smoke_reward, config,
                                       checkpoint_path=str(ckpt), tokenizer=tok, sink=sink,
                                       device=device, hbm_bytes=hbm_bytes)

    out = trainer_run(build, label="from_pretrained")
    out.update({"equal": equal, "bytes": nbytes, "write_s": written, "read_s": read,
                "tokenizer": type(out["trainer"].tokenizer).__name__})
    return out


def trainer_phase(cfg, args, card: str, t_start: float) -> list:
    """Phase 8 on the card (see the module's docstring). Returns the launch
    counts of its two trainer runs."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
        work = Path(tmp)
        tok_dir = write_bpe_tokenizer(work / "tokenizer", cfg.vocab_size)
        cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, TRAINER_LAYERS))
        a = trainer_smoke(cfg, "cuda", seed=args.seed, workdir=work / "a", tokenizer_dir=tok_dir)
        check_trainer_run(a, cfg.num_layers, steps=2, lr=a["config"].lr, cuda=True)
        check(a["adapter_equal"], "trainer: the saved adapter file does not read back equal "
              "to trainer.lora")
        check(a["resume_state"] == (2, True), f"trainer: the latest resume state is step "
              f"{a['resume_state'][0]} / adapter equal {a['resume_state'][1]}, want (2, True)")
        rounds = a["rounds"]
        print(f"trainer qlora: Trainer.train() at {cfg.num_layers} layers over the int4 "
              f"g{QMM_GROUP} base, paged refill engine ({TRAIN_SLOTS} slots, KV pool "
              f"budget of {a['kv_pages']} pages of 128 tokens from kv_pool_pages under "
              f"learner_gpu_usage {a['config'].learner_gpu_usage}, of which the refill "
              f"round built {a['pool_pages']}), 4 prompts x 16 x "
              f"{TRAIN_NEW_TOKENS} new tokens, learner 8 microbatches of 8 x "
              f"{a['config'].max_seq_length}: {len(rounds)} engine rounds "
              f"({', '.join(('refill' if r['refill'] else 'waves') + ' ' + str(r['steps']) + ' steps' for r in rounds)}); "
              f"{a['learner_forwards']} learner forwards; a synchronize after each phase "
              f"waited at most {max(a['pending_ms']['generation']):.3f} ms (generation) and "
              f"{max(a['pending_ms']['update']):.3f} ms (update); train() {a['wall_s']:.1f} s; peak "
              f"device memory {a['peak_gib']:.2f} GiB; launches {a['counts']}; {card}")
        for line in trainer_step_lines(a, card):
            print(line)
        ev = next(m for _, m in a["records"] if "timing/eval_duration" in m)
        print(f"trainer qlora: initial eval (4 prompts x eval_n 8) "
              f"{1e3 * ev['timing/eval_duration']:.1f} ms; {card}")
        counted = [a["counts"]]
        del a
        torch.cuda.empty_cache()
        b = from_pretrained_smoke(dataclasses.replace(cfg, num_layers=2), "cuda", seed=args.seed,
                                  workdir=work / "b", tokenizer_dir=tok_dir)
        check(b["equal"], "from_pretrained: the weights read back differ from the written ones")
        check(b["tokenizer"] == "NativeBPETokenizer", f"from_pretrained: tokenizer "
              f"{b['tokenizer']}, want the native BPE")
        check_trainer_run(b, 2, steps=1, lr=b["trainer"].config.lr, cuda=True)
        check(all(b["counts"][k] > 0 for k in ("fused_sample", "paged_attention", "quant_matmul",
                                               "flash_attention_fwd", "flash_attention_bwd")),
              f"from_pretrained: a kernel of K1-K4 was not launched: {b['counts']}")
        print(f"trainer from_pretrained: a {b['bytes'] / 1e9:.3f} GB checkpoint at full width, "
              f"2 layers, written by save_hf_checkpoint in {b['write_s']:.1f} s and read back "
              f"bit for bit in {b['read_s']:.1f} s; {b['tokenizer']}; one step: train() "
              f"{b['wall_s']:.1f} s, peak device memory {b['peak_gib']:.2f} GiB; launches "
              f"{b['counts']}; total {time.perf_counter() - t_start:.1f} s; {card}")
        for line in trainer_step_lines(b, card):
            print(line)
        counted.append(b["counts"])
        del b
        torch.cuda.empty_cache()
    return counted


# ---------------------------------------------------------------- phase 9

# the refill engine's riders (ROADMAP queue 1 item 7) and the dense slice's
# leftovers (item 5): (a) prefix sharing, continuous admission and the radix
# cache at phase 7's shape; (b) host spill under a small page budget; (c)
# the self-drafter with the adaptive draft length; (d) the int8 dense cache,
# bisect_mw and a Gemma checkpoint with its Unigram tokenizer
RIDER_NEW_TOKENS = 128  # (b) and (c): phase 4's length, to keep the script's time
# (a): 64-token pages, so that every one of phase 7's prompts (94-131 tokens)
# has a full page below its last token for the radix cache to hold
CACHE_PAGE = 64
SPILL_PAGES = 80  # (b): the worst case of 64 slots is 153 pages; 80 preempts
ADAM_STEP = 2e-5  # (c): one Adam8bit step at lr 2e-5 moves an element ~lr
GEMMA_STRINGS = ("solve the equation", "what is the answer", "é", "<start_of_turn>user")


def rider_engine(cfg, device, *, cache_dtype, slots: int = SPEC_SLOTS,
                 max_new_tokens: int = SPEC_NEW_TOKENS, max_prompt_tokens: int = 350,
                 page_size: int = 128, scale: float = 0.5, **kw):
    """The refill engine (``slots`` slots) with the riders of ``kw``, the
    CharTokenizer's EOS and pad ids, behavior logprobs captured."""
    from distrl_llm_tpu_torch.engine import PagedGenerationEngine
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer

    tok = CharTokenizer()
    return PagedGenerationEngine(
        cfg, max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
        eos_token_ids=[tok.eos_token_id], pad_token_id=tok.pad_token_id, lora_scale=scale,
        cache_dtype=cache_dtype, capture_logprobs=True, page_size=page_size,
        scheduler="refill", max_concurrent_rows=slots, device=device, **kw)


def rider_round(eng, model, lora, ids, mask, *, seed: int, label: str, n: int = PA_N,
                temperature: float = 0.0, max_new_tokens: int = SPEC_NEW_TOKENS,
                card: str = "") -> dict:
    """One round with the kernels' counts reset just before and read just
    after; the round checked as a refill round; its stats returned."""
    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer

    tok = CharTokenizer()
    sc = SamplingConfig(max_tokens=max_new_tokens, temperature=temperature, top_p=0.95, n=n)
    reset_counts()
    t = time.perf_counter()
    res = eng.generate(model, lora, ids, mask, sc, seed)
    wall = time.perf_counter() - t
    counts = read_counts()
    st = dict(eng.last_round_stats)
    st.setdefault("sampler_calls", res.steps_dispatched)  # the wave scheduler's
    for key in ("draft_forwards", "warm_prefills", "prefill_tokens_skipped"):
        st.setdefault(key, 0)
    _check_refill_round(res, rows=ids.shape[0], n=n, steps=max_new_tokens,
                        vocab=model.cfg.vocab_size, eos=tok.eos_token_id,
                        pad=tok.pad_token_id, what=label)
    out = {"label": label, "res": res, "counts": counts, "stats": st, "wall_s": wall,
           "pool": dict(eng.last_pool_stats or {}), "spec": eng.last_spec_stats,
           "steps": res.steps_dispatched,
           "ms_per_step": st["decode_s"] * 1e3 / res.steps_dispatched,
           "decode_tok_s": st["gen_tokens"] / st["decode_s"]}
    print(f"riders {label}: {ids.shape[0]} prompts x {n} over {eng.max_concurrent_rows} "
          f"slots, {out['steps']} steps, {st['gen_tokens']} tokens; decode "
          f"{out['decode_tok_s']:.1f} tok/s, {out['ms_per_step']:.2f} ms/step; prefill "
          f"{st['prefill_s'] * 1e3:.1f} ms ({st['warm_prefills']} of "
          f"{out['pool']['groups_prefilled']} group prefills warm, "
          f"{st['prefill_tokens_skipped']} prompt tokens not re-prefilled)"
          if out["pool"].get("groups_prefilled") is not None else
          f"riders {label}: {ids.shape[0]} prompts x {n} over {eng.max_concurrent_rows} "
          f"slots, {out['steps']} steps, {st['gen_tokens']} tokens; decode "
          f"{out['decode_tok_s']:.1f} tok/s, {out['ms_per_step']:.2f} ms/step", end="")
    print(f"; wall {wall:.1f} s; launches {counts}; {card}")
    return out


def check_rider_counts(out: dict, layers: int, *, splash: bool) -> None:
    """The round's kernels ran as often as its path dispatched them: K1 once
    per sampler call (a decode step, or a speculative admission), K2 once per
    layer per decode forward (and per self-drafter forward), K5 once per
    layer per verify forward, K4 once per layer per COLD group prefill with
    splash (a warm prefill runs the plain attention the JAX package runs
    there), K3 never (a bf16 base)."""
    c, st, label = out["counts"], out["stats"], out["label"]
    spec = out["spec"]
    cold = (out["pool"].get("groups_prefilled") or 0) - st["warm_prefills"]
    want = {
        "fused_sample": st["sampler_calls"],
        "paged_attention": layers * (st["draft_forwards"] if spec else st["decode_forwards"]),
        "paged_verify": layers * st["decode_forwards"] if spec else 0,
        "flash_attention_fwd": layers * cold if splash else 0,
        "flash_attention_bwd": 0, "quant_matmul": 0,
        **hd256_counts(0),  # the riders run head dims below 256
        **domain_counts(),  # rank 32, d <= 4
    }
    check(c == want and c["fused_sample"] > 0,
          f"{label}: launches {c}, want {want} ({cold} cold group prefills)")


def warm_cold_logits(weights, *, max_prompt_tokens: int = 350, page_size: int = CACHE_PAGE,
                     scale: float = 0.5) -> dict:
    """Each math prompt's sampling logits from its cold prefill and from a
    warm prefill that aliases the cold one's full pages (all but the last
    token's page when the prompt ends on a page boundary, as a radix hit
    does): the largest |dlogit|, the logit std and the tokens the warm path
    did not re-prefill."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.engine.paged_engine import (
        _empty_pools, _paged_prefill, _warm_prefill,
    )

    model, lora = weights
    dev = model.embed.device
    _, ids, mask, _ = prompt_batch(max_prompt_tokens)
    pp = -(-max_prompt_tokens // page_size)
    err, std, skipped = 0.0, 0.0, 0
    with torch.inference_mode():
        for g in range(ids.shape[0]):
            real = np.asarray(ids[g])[np.asarray(mask[g]) > 0]
            rl = real.size
            hit = (rl - 1) // page_size * page_size
            n_chain = -(-rl // page_size)
            k, v = _empty_pools(model.cfg, 2 * pp + 1, page_size=page_size,
                                cache_dtype=model.embed.dtype, kv_quant="none", device=dev)
            scratch = 2 * pp
            row = np.full((1, pp), scratch, np.int32)
            row[0, :n_chain] = np.arange(n_chain)
            _, _, cold, _ = _paged_prefill(
                model, lora, torch.as_tensor(ids[g:g + 1], device=dev),
                torch.as_tensor(mask[g:g + 1], device=dev), prompt_pages=pp,
                page_size=page_size, lora_scale=scale, cache_dtype=model.embed.dtype,
                attn_impl="reference", pools=(k, v), table=torch.as_tensor(row, device=dev))
            # the warm chain: the cold chain's full pages, fresh pages after
            ext = np.full(pp + 1, scratch, np.int32)
            ext[:hit // page_size] = np.arange(hit // page_size)
            ext[hit // page_size:n_chain] = pp + np.arange(n_chain - hit // page_size)
            warm = _warm_prefill(model, lora, k, v, ext, real[hit:], hit,
                                 page_size=page_size, lora_scale=scale, pad_id=0)
            err = max(err, float((warm - cold[0]).abs().max()))
            std = max(std, float(cold.std()))
            skipped += hit
    return {"err": err, "std": std, "skipped": skipped}


def cache_miss_after_a_push(cfg, device, weights, *, max_new_tokens: int = 8,
                            slots: int = 8, page_size: int = CACHE_PAGE, n: int = 2) -> dict:
    """Two rounds of the cache engine with the same adapter (the second
    warm), then a round with a new adapter object of the same values: the
    cached KV belongs to the adapter that wrote it, so that round misses.
    ``same``: the three rounds' greedy tokens and lengths are equal (each
    prefill, cold or warm, attends with the plain attention here)."""
    import numpy as np

    model, lora = weights
    _, ids, mask, _ = prompt_batch(350)
    eng = rider_engine(cfg, device, cache_dtype=model.embed.dtype, slots=slots,
                       max_new_tokens=max_new_tokens, page_size=page_size,
                       continuous_admission=True, prefix_cache=True)
    saved, tokens, lengths = [], [], []
    pushed = {"layers": {t: dict(ab) for t, ab in lora["layers"].items()}}
    for adapter in (lora, lora, pushed):
        out = rider_round(eng, model, adapter, ids, mask, seed=0, n=n,
                          label="cache miss check", max_new_tokens=max_new_tokens)
        saved.append(eng.last_pool_stats["prefill_tok_saved"])
        tokens.append(out["res"].tokens)
        lengths.append(out["res"].lengths)
    same = all(np.array_equal(t, tokens[0]) for t in tokens) and all(
        np.array_equal(n_, lengths[0]) for n_ in lengths)
    return {"saved": saved, "same": same}


def prefix_cache_phase(cfg, device, weights, *, seed: int, card: str = "",
                       splash: bool = True, n: int = PA_N, slots: int = SPEC_SLOTS,
                       max_new_tokens: int = SPEC_NEW_TOKENS, page_size: int = CACHE_PAGE,
                       max_prompt_tokens: int = 350) -> dict:
    """(a) Two greedy rounds of the engine with prefix sharing, continuous
    admission and the radix cache over phase 7's prompts and adapter: the
    first prefills every group cold, the second admits every group with a
    full page warm through the cache (its pages parked in host memory at
    the first round's end and copied back)."""
    model, lora = weights
    _, ids, mask = spec_prompt_batch(max_prompt_tokens)
    kw = dict(cache_dtype=model.embed.dtype, slots=slots, max_new_tokens=max_new_tokens,
              page_size=page_size, max_prompt_tokens=max_prompt_tokens,
              prefix_sharing=True, continuous_admission=True, prefix_cache=True,
              attn_impl="splash" if splash else "reference")
    # a short warm-up on an engine of its own (the cache belongs to the engine)
    warm_up = rider_engine(model.cfg, device, **{**kw, "max_new_tokens": 4})
    rider_round(warm_up, model, lora, ids, mask, seed=seed, n=2, max_new_tokens=4,
                label="cache warm-up")
    del warm_up
    eng = rider_engine(model.cfg, device, **kw)
    rounds = [rider_round(eng, model, lora, ids, mask, seed=seed + 1, n=n,
                          max_new_tokens=max_new_tokens, card=card,
                          label=f"prefix cache round {i + 1}") for i in range(2)]
    return {"rounds": rounds}


def spill_phase(cfg, device, weights, *, seed: int, card: str = "", n: int = PA_N,
                slots: int = SPEC_SLOTS, max_new_tokens: int = RIDER_NEW_TOKENS,
                max_kv_pages: int = SPILL_PAGES, page_size: int = 128,
                max_prompt_tokens: int = 350) -> dict:
    """(b) The cache engine with host spill under ``max_kv_pages`` pages, so
    that slots are preempted, against the same engine with the worst-case
    pool: greedy, phase 7's prompts."""
    model, lora = weights
    _, ids, mask = spec_prompt_batch(max_prompt_tokens)
    kw = dict(cache_dtype=model.embed.dtype, slots=slots, max_new_tokens=max_new_tokens,
              page_size=page_size, max_prompt_tokens=max_prompt_tokens,
              continuous_admission=True, prefix_cache=True, kv_spill=True)
    spill = rider_round(rider_engine(model.cfg, device, max_kv_pages=max_kv_pages, **kw),
                        model, lora, ids, mask, seed=seed, n=n,
                        max_new_tokens=max_new_tokens, card=card,
                        label=f"host spill, {max_kv_pages} pages")
    full = rider_round(rider_engine(model.cfg, device, **kw), model, lora, ids, mask,
                       seed=seed, n=n, max_new_tokens=max_new_tokens, card=card,
                       label="host spill engine, worst-case pool")
    return {"spill": spill, "full": full}


def adam_step_neighbour(lora, *, seed: int, step: float = ADAM_STEP):
    """``lora`` with every element moved by ``step`` in a random direction:
    the size of one Adam8bit step at lr ``step``."""
    import torch

    gen = torch.Generator(device=lora["layers"]["wq"]["a"].device).manual_seed(seed)
    out = {"layers": {}}
    for t, ab in lora["layers"].items():
        out["layers"][t] = {k: x + step * torch.sign(torch.randn(
            x.shape, generator=gen, device=x.device)) for k, x in ab.items()}
    return out


def self_draft_phase(cfg, device, weights, *, seed: int, card: str = "", n: int = PA_N,
                     slots: int = SPEC_SLOTS, max_new_tokens: int = RIDER_NEW_TOKENS,
                     page_size: int = 128, max_prompt_tokens: int = 350) -> dict:
    """(c) Speculative decoding with the self-drafter and the adaptive draft
    length: adapter v1 is the round's entry, v2 (v1 moved by one Adam8bit
    step) is pushed, so v1 drafts for v2. One greedy round, then one sampled
    round (entry v2, v1 still the previous version), and plain decoding with
    the same push, over phase 4's 4 prompts: 64 candidates in 64 slots, so
    plain decoding takes the wave scheduler (the same 64-row decode step;
    a speculative engine always takes the refill one)."""
    model, v1 = weights
    v2 = adam_step_neighbour(v1, seed=seed)
    _, ids, mask, _ = prompt_batch(max_prompt_tokens)
    kw = dict(cache_dtype=model.embed.dtype, slots=slots, max_new_tokens=max_new_tokens,
              page_size=page_size, max_prompt_tokens=max_prompt_tokens)
    spec = rider_engine(model.cfg, device, spec_draft=SPEC_DRAFT, spec_drafter="self",
                        spec_adapt=True, **kw)
    plain = rider_engine(model.cfg, device, **kw)
    rider_round(spec, model, v1, ids, mask, seed=seed, n=2, max_new_tokens=4,
                label="self-drafter warm-up")
    out = {}
    for eng, key in ((spec, "greedy"), (plain, "plain")):
        eng.push_lora(v2, 2)
        out[key] = rider_round(eng, model, v1, ids, mask, seed=seed + 1, n=n,
                               max_new_tokens=max_new_tokens, card=card,
                               label=f"{'self-drafter' if key == 'greedy' else 'plain'} "
                                     f"v1 -> v2, greedy")
    out["sampled"] = rider_round(spec, model, v2, ids, mask, seed=seed + 2, n=n,
                                 temperature=1.2, max_new_tokens=max_new_tokens, card=card,
                                 label="self-drafter (v1 drafts) v2, t=1.2")
    return out


def self_draft_exactness(device, seed: int, *, max_new_tokens: int = 32) -> dict:
    """On TINY in f32 (phase 7's exactness preset), the greedy self-drafted
    tokens against plain refill's, both engines given the same push."""
    import torch

    from distrl_llm_tpu_torch.models.configs import TINY

    model, v1 = make_weights(TINY, device, seed=seed, rank=4, dtype=torch.float32)
    v2 = adam_step_neighbour(v1, seed=seed, step=0.01)
    _, ids, mask = spec_prompt_batch(96)
    kw = dict(cache_dtype=torch.float32, slots=4, max_new_tokens=max_new_tokens,
              page_size=8, max_prompt_tokens=96)
    out = {}
    for key, extra in (("spec", dict(spec_draft=SPEC_DRAFT, spec_drafter="self",
                                      spec_adapt=True)), ("plain", {})):
        eng = rider_engine(TINY, device, **kw, **extra)
        eng.push_lora(v2, 2)
        out[key] = rider_round(eng, model, v1, ids, mask, seed=seed, n=2,
                               max_new_tokens=max_new_tokens, label=f"TINY f32 {key}")
    out["layers"] = TINY.num_layers
    return out


def dense_int8_quantize_check(device, seed: int, *, shape=(4, 4, 350, 128)) -> dict:
    """``quantize_kv_position`` on the card against the CPU, bit for bit, on
    one layer's k at Qwen2.5-7B width (bf16, as the engine quantizes it)."""
    import torch

    from distrl_llm_tpu_torch.ops.attention import quantize_kv_position

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * torch.rand(shape[:-1] + (1,), generator=gen)
         * 4).to(torch.bfloat16)
    q_dev, s_dev = quantize_kv_position(x.to(device))
    q_cpu, s_cpu = quantize_kv_position(x)
    return {"q_equal": bool(torch.equal(q_dev.cpu(), q_cpu)),
            "s_equal": bool(torch.equal(s_dev.cpu(), s_cpu)), "elements": x.numel()}


def dense_int8_logits(wide, *, seed: int, steps: int = LOGIT_STEPS, n: int = PA_N,
                      max_prompt_tokens: int = 350, max_new_tokens: int = 128,
                      scale: float = 0.5) -> dict:
    """The dense engine's teacher-forced f32 logits with the int8 cache
    against the f32 cache (the prefill's last position and ``steps`` decode
    forwards of phase 4's prompts): the largest |dlogit| and the std."""
    import numpy as np
    import torch

    model = wide[0]
    dev = model.embed.device
    _, ids, mask, _ = prompt_batch(max_prompt_tokens)
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=dev)
    mask = torch.as_tensor(np.asarray(mask), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, model.cfg.vocab_size, (ids.shape[0] * n, steps),
                           generator=gen, device=dev, dtype=torch.int32)
    kw = dict(max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
              page_size=128, scale=scale)
    want = engine_logits(wide, ids, mask, tokens, engine="dense", **kw)
    got = engine_logits(wide, ids, mask, tokens, engine="dense", kv_quant="int8", **kw)
    return {"err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
            "std": float(torch.cat(want).std())}


def write_unigram_tokenizer(path: Path, vocab_size: int) -> tuple[Path, dict]:
    """A Gemma-shaped sentencepiece Unigram ``tokenizer.json`` (and a
    ``tokenizer_config.json`` with a Gemma chat template) written by hand, no
    tokenizer package assumed: <pad> <eos> <bos> <unk> at ids 0-3, the 256
    byte pieces, words with and without the ▁ prefix at score -1, single
    characters at -10, then ▁-prefixed filler pieces at -20 up to
    ``vocab_size`` (every id decodes to text), <start_of_turn> and
    <end_of_turn> at the top, the Replace(" " -> ▁) normalizer. Returns the
    directory and the ids the script expects for ``GEMMA_STRINGS``."""
    words = ["solve", "the", "equation", "what", "is", "answer", "user", "model",
             "reasoning", "process", "here", "think", "a", "and", "question", "assistant"]
    vocab = [["<pad>", 0.0], ["<eos>", 0.0], ["<bos>", 0.0], ["<unk>", 0.0]]
    vocab += [[f"<0x{b:02X}>", 0.0] for b in range(256)]
    ids = {}
    for w in words:
        for piece in (w, "▁" + w):
            ids[piece] = len(vocab)
            vocab.append([piece, -1.0])
    for c in ("▁" + "".join(chr(x) for x in range(0x21, 0x7f))):
        if c not in ids:
            ids[c] = len(vocab)
            vocab.append([c, -10.0])
    specials = ["<start_of_turn>", "<end_of_turn>"]
    i = 0
    while len(vocab) < vocab_size - len(specials):
        vocab.append([f"▁qz{i:x}", -20.0])
        i += 1
    added = [{"id": k, "content": vocab[k][0], "special": True} for k in range(4)]
    for s in specials:
        ids[s] = len(vocab)
        added.append({"id": len(vocab), "content": s, "special": True})
        vocab.append([s, 0.0])
    tj = {"version": "1.0", "added_tokens": added,
          "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
          "pre_tokenizer": None, "decoder": None,
          "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": True}}
    template = ("{% for m in messages %}<start_of_turn>{{ m['role'] }}\n{{ m['content'] }}"
                "<end_of_turn>\n{% endfor %}{% if add_generation_prompt %}<start_of_turn>model\n"
                "{% endif %}")
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False))
    (path / "tokenizer_config.json").write_text(json.dumps({"chat_template": template}))
    expected = {
        GEMMA_STRINGS[0]: [ids["solve"], ids["▁the"], ids["▁equation"]],
        GEMMA_STRINGS[1]: [ids["what"], ids["▁is"], ids["▁the"], ids["▁answer"]],
        GEMMA_STRINGS[2]: [4 + 0xC3, 4 + 0xA9],  # byte fallback: é is C3 A9
        GEMMA_STRINGS[3]: [ids["<start_of_turn>"], ids["user"]],
    }
    return path, expected


def gemma_phase(cfg, device, *, seed: int, workdir: Path, hbm_bytes=None,
                config_kw=None) -> dict:
    """(d) ``Trainer.from_pretrained`` on a checkpoint of ``cfg`` (Gemma)
    written by ``save_hf_checkpoint`` with the script's Unigram tokenizer:
    the native SPM tokenizer, the script's expected ids, and one training
    step with the dense engine over the int8 cache (``attn_impl``
    "reference")."""
    import shutil

    from distrl_llm_tpu_torch.models.loading import save_hf_checkpoint
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer

    tok_dir, expected = write_unigram_tokenizer(workdir / "tokenizer", cfg.vocab_size)
    ckpt = workdir / "hf"
    model, _ = make_weights(cfg, device, seed=seed)
    dtype = str(model.embed.dtype).removeprefix("torch.")
    save_hf_checkpoint(model, str(ckpt))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(tok_dir / name, ckpt / name)
    del model
    tok = load_tokenizer(str(ckpt))
    got = {s: tok.encode(s) for s in GEMMA_STRINGS}
    config = trainer_config(workdir / "run", seed=seed, model="gemma-2b-random", dtype=dtype,
                            base_quant="none", engine_impl="dense", continuous_batching=False,
                            max_concurrent_sequences=0, attn_impl="reference",
                            kv_cache_quant="int8", **(config_kw or {}))

    def build(sink):
        train, test = trainer_datasets(tok)
        train = {k: v[:config.batch_size] for k, v in train.items()}  # one batch: one step
        return Trainer.from_pretrained(train, test, smoke_reward, config,
                                       checkpoint_path=str(ckpt), tokenizer=tok, sink=sink,
                                       device=device, hbm_bytes=hbm_bytes)

    out = trainer_run(build, label="gemma from_pretrained")
    out.update(tokenizer=type(tok).__name__, ids=got, expected=expected,
               kv_quant=out["trainer"].engine.kv_quant)
    return out


def riders_phase(cfg, args, card: str, t_start: float, *, dense_peak_gib: float,
                 int8_page_err: float, plain_refill_pool: dict) -> list:
    """Phase 9 on the card (see the module's docstring). Returns the launch
    counts of its main-path runs."""
    import tempfile

    import numpy as np
    import torch

    from distrl_llm_tpu_torch.models.configs import GEMMA_2B

    counted = []
    # the trainers of phase 8 sit in reference cycles (trainer <-> sink):
    # collect them, so their models do not count in this phase's peaks
    gc.collect()
    torch.cuda.empty_cache()
    # (a)-(c) at SHALLOW_LAYERS, the depth cut that makes room for phase 12;
    # (d) at the full depth, where phase 4's dense peak was taken
    shallow = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, SHALLOW_LAYERS))
    weights = make_weights(shallow, "cuda", seed=args.seed)
    # (a) prefix sharing, continuous admission and the radix cache
    a = prefix_cache_phase(shallow, "cuda", weights, seed=args.seed, card=card)
    r1, r2 = a["rounds"]
    for r in (r1, r2):
        check_rider_counts(r, shallow.num_layers, splash=True)
        counted.append(r["counts"])
    groups = len(SPEC_PROBLEMS)
    # round 1 prefills a group warm only where an earlier group of the round
    # finished with the same leading page; round 2 finds every group cached
    check(r2["stats"]["warm_prefills"] == groups,
          f"prefix cache: {r2['stats']['warm_prefills']} of round 2's {groups} group "
          f"prefills ran warm, want all")
    check(r2["pool"]["prefill_tok_saved"] > 0 and r2["pool"]["restored_pages"] > 0,
          f"prefix cache round 2 hit nothing: {r2['pool']}")
    same = r1["res"].tokens == r2["res"].tokens
    print(f"riders (a): {CACHE_PAGE}-token pages; peak KV tokens resident in the pool "
          f"{r1['pool']['peak_pages_used'] * CACHE_PAGE} / "
          f"{r2['pool']['peak_pages_used'] * CACHE_PAGE} (rounds 1 / 2, prompt chains "
          f"included) against phase 7's plain refill "
          f"{plain_refill_pool['peak_pages_used'] * 128} in its pool plus "
          f"{groups * 3 * 128} in its static prompt region; peak shared pages "
          f"{r1['pool']['peak_shared_pages']} / {r2['pool']['peak_shared_pages']}, copy-on-write "
          f"splits {r1['pool']['cow_splits']} ({shallow.num_layers} layers); round 2: radix "
          f"hit pages "
          f"{r2['pool']['prefill_tok_saved'] // CACHE_PAGE} ({r2['pool']['prefill_tok_saved']} prompt "
          f"tokens not re-prefilled, {r2['pool']['restored_pages']} pages copied back from "
          f"host memory in {r2['pool']['spill_restore_ms_p50']} ms p50), hit rate "
          f"{r2['pool']['radix_hit_rate']}; greedy tokens of the warm round equal the cold "
          f"round's on {100 * same.mean():.2f}% of positions (printed, not asserted: a cold "
          f"prefill attends with K4, a warm one with the plain attention, and bf16 at "
          f"{shallow.num_layers} layers of random weights flips near-ties; in f32 below, with "
          f"the plain attention in both, the two give the same logits and tokens); decode "
          f"{r1['ms_per_step']:.2f} / {r2['ms_per_step']:.2f} ms/step against phase 7's "
          f"plain refill at {cfg.num_layers} layers "
          f"{plain_refill_pool['ms_per_step']:.2f}; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    del a, r1, r2
    # (b) host spill under a small budget, against the worst-case pool
    b = spill_phase(shallow, "cuda", weights, seed=args.seed, card=card)
    check_rider_counts(b["spill"], shallow.num_layers, splash=False)
    check_rider_counts(b["full"], shallow.num_layers, splash=False)
    counted += [b["spill"]["counts"], b["full"]["counts"]]
    sp = b["spill"]["pool"]
    check(sp["preemptions"] > 0 and sp["spilled_pages"] > 0 and sp["restored_pages"] > 0,
          f"host spill: preemptions {sp['preemptions']}, spilled pages "
          f"{sp['spilled_pages']}, restored {sp['restored_pages']}: want each > 0")
    check(np.array_equal(b["spill"]["res"].tokens, b["full"]["res"].tokens),
          "host spill: the preempted round's greedy tokens differ from the worst-case pool's")
    print(f"riders (b): host spill at {shallow.num_layers} layers bf16, {SPILL_PAGES} pages: "
          f"{sp['preemptions']} preemptions, {sp['spilled_pages']} pages parked, "
          f"{sp['restored_pages']} copied back, restore {sp['spill_restore_ms_p50']} ms p50; "
          f"greedy tokens equal to the worst-case pool's ({b['full']['pool']['pool_pages']} "
          f"pages, {b['full']['pool']['preemptions']} preemptions); {card}")
    del b
    # (c) the self-drafter and the adaptive draft length
    c = self_draft_phase(shallow, "cuda", weights, seed=args.seed, card=card)
    for key in ("greedy", "sampled", "plain"):
        check_rider_counts(c[key], shallow.num_layers, splash=False)
        counted.append(c[key]["counts"])
    g, pl = c["greedy"], c["plain"]
    same = g["res"].tokens == pl["res"].tokens
    for key in ("greedy", "sampled"):
        s = c[key]["spec"]
        print(f"riders (c) self-drafter {key}: accept rate {s['accept_rate']:.4f}, "
              f"{s['tokens_per_verify_step']:.4f} tokens per verify step, drafter version "
              f"{s['drafter_version']} for target {s['target_version']}, the draft length at "
              f"each boundary {s['draft_len_trace']}, {s['draft_forwards']} drafter and "
              f"{s['verify_forwards']} verify forwards; {c[key]['ms_per_step']:.2f} ms/step, "
              f"{c[key]['decode_tok_s']:.1f} tok/s against plain decoding under v2 "
              f"{pl['ms_per_step']:.2f} ms/step, {pl['decode_tok_s']:.1f} tok/s; {card}")
    print(f"riders (c): self-drafted vs plain greedy tokens equal on "
          f"{100 * same.mean():.2f}% of positions (printed: the verify forward and the "
          f"single-token decodes round otherwise in bf16)")
    check(g["spec"]["accepted"] > 0, "self-drafter: no draft was accepted")
    del c
    ex = self_draft_exactness("cuda", args.seed)
    for key in ("spec", "plain"):
        check_rider_counts(ex[key], ex["layers"], splash=False)
    s = ex["spec"]["spec"]
    print(f"riders (c) TINY f32 self-drafter: accept rate {s['accept_rate']:.4f}, "
          f"{s['tokens_per_verify_step']:.4f} tokens per verify step, draft lengths "
          f"{s['draft_len_trace']}")
    check(np.array_equal(ex["spec"]["res"].tokens, ex["plain"]["res"].tokens)
          and np.array_equal(ex["spec"]["res"].lengths, ex["plain"]["res"].lengths),
          "self-drafter exactness: greedy tokens differ from plain refill's")
    check(s["accepted"] > 0, "self-drafter exactness: no draft was accepted")
    # (a) at 4 layers in f32: warm vs cold logits, and a push misses the cache
    small = make_weights(dataclasses.replace(cfg, num_layers=4), "cuda", seed=args.seed,
                         dtype=torch.float32)
    wc = warm_cold_logits(small)
    miss = cache_miss_after_a_push(dataclasses.replace(cfg, num_layers=4), "cuda", small)
    print(f"riders (a) 4 layers f32: warm vs cold prefill logits max |dlogit| "
          f"{wc['err']:.4g} (tolerance {LOGIT_F32_ATOL}; logit std {wc['std']:.4g}; "
          f"{wc['skipped']} prompt tokens aliased); prompt tokens not re-prefilled by three "
          f"rounds (adapter, same adapter, a new adapter object) {miss['saved']}, their greedy "
          f"tokens and lengths {'equal' if miss['same'] else 'NOT equal'}")
    check(wc["err"] <= LOGIT_F32_ATOL, f"warm prefill logits differ from cold by "
          f"{wc['err']:.4g} > {LOGIT_F32_ATOL}")
    check(miss["saved"][0] == 0 and miss["saved"][1] > 0 and miss["saved"][2] == 0,
          f"prefix cache: rounds saved {miss['saved']}, want 0, > 0, 0")
    check(miss["same"], "prefix cache at 4 layers f32: the warm or the missed round's greedy "
          "tokens or lengths differ from the cold round's")
    # (b) at 4 layers in f32
    bs = spill_phase(dataclasses.replace(cfg, num_layers=4), "cuda", small, seed=args.seed)
    check(bs["spill"]["pool"]["preemptions"] > 0 and bs["spill"]["pool"]["restored_pages"] > 0,
          f"host spill at 4 layers f32: {bs['spill']['pool']['preemptions']} preemptions, "
          f"{bs['spill']['pool']['restored_pages']} pages restored: want each > 0")
    check(np.array_equal(bs["spill"]["res"].tokens, bs["full"]["res"].tokens),
          "host spill at 4 layers f32: tokens differ from the worst-case pool's")
    print(f"riders (b) 4 layers f32: {bs['spill']['pool']['preemptions']} preemptions, "
          f"{bs['spill']['pool']['restored_pages']} pages copied back, greedy tokens equal to "
          f"the worst-case pool's")
    del small, bs
    torch.cuda.empty_cache()
    # (d) the int8 dense cache, bisect_mw, and a Gemma checkpoint
    del weights
    torch.cuda.empty_cache()
    weights = make_weights(cfg, "cuda", seed=args.seed)
    qc = dense_int8_quantize_check("cuda", args.seed)
    check(qc["q_equal"] and qc["s_equal"], "quantize_kv_position: the card's int8 values or "
          "scales differ from the CPU's")
    # its sampled round filters with bisect_mw: K1 once a step there too
    d = rollout(cfg, "cuda", seed=args.seed, card=card, engine="dense", kv_quant="int8",
                weights=weights, top_p_impl="bisect_mw")
    check(d["counts"]["fused_sample"] == d["steps"] and sum(d["counts"].values())
          == d["steps"], f"{d['label']}: launches {d['counts']}, want K1 {d['steps']} only")
    counted.append(d["counts"])
    wide = widen(weights)
    del weights
    torch.cuda.empty_cache()
    lg = dense_int8_logits(wide, seed=args.seed)
    del wide
    torch.cuda.empty_cache()
    int8_tol = 2 * int8_page_err + LOGIT_F32_ATOL
    print(f"riders (d): dense engine, int8 cache: {d['greedy'][1]['ms_per_step']:.2f} ms/step "
          f"greedy, peak {d['peak_gib']:.2f} GiB against phase 4's bf16 dense cell "
          f"{dense_peak_gib:.2f} GiB; quantize_kv_position on the card equals the CPU's on "
          f"{qc['elements']} elements, values and scales; teacher-forced f32 logits, int8 vs "
          f"f32 cache: max |dlogit| {lg['err']:.4g} (tolerance {int8_tol:.4g}: twice the "
          f"int8 pages' own distance {int8_page_err:.4g} measured in phase 4, the same "
          f"per-token absmax over head_dim, plus {LOGIT_F32_ATOL}; logit std "
          f"{lg['std']:.4g}); {card}")
    check(lg["err"] <= int8_tol, f"dense int8 cache logits differ from f32 by "
          f"{lg['err']:.4g} > {int8_tol:.4g}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gemma_") as tmp:
        gm = gemma_phase(dataclasses.replace(GEMMA_2B, num_layers=2), "cuda", seed=args.seed,
                         workdir=Path(tmp))
    check(gm["tokenizer"] == "NativeSPMTokenizer" and gm["ids"] == gm["expected"],
          f"gemma: tokenizer {gm['tokenizer']}, ids {gm['ids']}, want {gm['expected']}")
    check_trainer_run(gm, 2, steps=1, lr=gm["trainer"].config.lr, cuda=True)
    check(gm["kv_quant"] == "int8", "gemma: the engine does not hold an int8 cache")
    counted.append(gm["counts"])
    print(f"riders (d) Gemma 2B width, 2 layers: {gm['tokenizer']}, ids {gm['ids']} as "
          f"expected; one training step with the dense engine over the int8 cache: train() "
          f"{gm['wall_s']:.1f} s, peak {gm['peak_gib']:.2f} GiB; launches {gm['counts']}; "
          f"total {time.perf_counter() - t_start:.1f} s; {card}")
    for line in trainer_step_lines(gm, card):
        print(line)
    return counted


# ---------------------------------------------------------------- phase 10

# full fine-tuning (ROADMAP item 13) at Gemma-2B width under splash, which
# puts K4's head_dim 256 routes on the main path: the f32 learner (f32
# master weights) forward and backward, the bf16 prefill; (b) one LoRA
# step with the bf16 learner, K4's bf16 backward at head_dim 256
FULL_PROMPT_TOKENS = 256  # the R1 prompts are 202-232 Unigram tokens
FULL_NEW_TOKENS = 128
FULL_SLOTS = 16  # every row of a 4 x 4 round decodes at once
FULL_GPU_USAGE = 0.9  # the KV budget beside ~30 GB of learner state
# phases 10 and 15 (c): half of Gemma-2B's 18 layers, the cut that makes room
# for phase 17
FULL_LAYERS = 9


def full_config(workdir: Path, **kw):
    """Phase 10's trainer: Gemma-2B (random bf16 weights), PG, Adam8bit lr
    2e-5, the paged refill engine under splash, 4 prompts x 4 candidates x
    128 new tokens, microbatch 4, ``logprob_chunk`` 128 (the default); no
    checkpoint (a resume state of 12.5 GB is the CPU tests' to check)."""
    base = dict(model="gemma-2b-random", full_finetune=True, base_quant="none",
                write_adapter_file=False, checkpoint_dir=None, save_every=0,
                batch_size=4, num_candidates=4, topk=4, train_batch_size=4,
                max_prompt_tokens=FULL_PROMPT_TOKENS, max_new_tokens=FULL_NEW_TOKENS,
                max_concurrent_sequences=FULL_SLOTS, learner_gpu_usage=FULL_GPU_USAGE,
                eval_n=4)
    base.update(kw)
    return trainer_config(workdir, **base)


def probe_logits(ids):
    """``probe(model)`` for ``trainer_run``: the last position's f32 logits
    of ``ids`` under the model a round samples with."""
    import torch

    def probe(model):
        with torch.no_grad():
            return model(ids, logits_slice=(ids.shape[1] - 1, 1))[0].float().cpu()
    return probe


def full_finetune_run(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                      hbm_bytes=None, config_kw=None) -> dict:
    """(a) ``Trainer.train()`` with ``full_finetune``: random bf16 weights
    from ``seed`` become the rollout copy and the f32 masters are built from
    them; the initial eval, then 2 optimizer steps. Returns
    ``trainer_run``'s record with the initial weights (on the host) and the
    probe's logits at each round's start."""
    import torch

    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine

    tok = load_tokenizer(str(tokenizer_dir))
    model, _ = make_weights(cfg, device, seed=seed)
    config = full_config(workdir, seed=seed, dtype=str(model.embed.dtype).removeprefix(
        "torch."), **(config_kw or {}))
    initial = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    engine = make_engine(config, model, tok, hbm_bytes=hbm_bytes)
    train, test = trainer_datasets(tok)
    ids = torch.as_tensor(tok.encode(train["problem"][0]), device=model.embed.device)[None]
    out = trainer_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                           engine=engine, model=model, sink=sink),
                      label="full", probe=probe_logits(ids))
    out.update(initial=initial, config=config, kv_pages=engine.max_kv_pages)
    return out


def check_full_run(out: dict, *, steps: int) -> dict:
    """Full fine-tuning's tree after ``steps`` steps: every parameter moved
    from the initial weights (the tied embedding and the norms included),
    each element by at most ``steps`` Adam8bit steps (5 lr each, plus the
    rounding of each add); the rollout copy equal to the masters cast to
    its dtype; each round's probe logits equal to the previous round's
    when no push came between, different after one. Returns the largest
    move and the parameter count."""
    import torch

    tr, label = out["trainer"], out["label"]
    lr = tr.config.lr
    rollout = tr._engine_params()[0]
    names = [n for n, _ in tr.lora.named_parameters()]
    check("embed" in names and tr.lora.lm_head is None, f"{label}: the tied embedding is "
          f"not one parameter ({names[:3]})")
    moved, worst = [], 0.0
    for name, m, init, r in zip(names, tr.lora.parameters(), out["initial"],
                                rollout.parameters(), strict=True):
        d = (m.detach() - init.to(m.device, torch.float32)).abs()
        bound = steps * 5 * lr * (1 + 1e-6) + steps * m.detach().abs() * 2.0**-23
        check(bool((d <= bound).all()), f"{label}: {name} moved beyond {steps} Adam8bit "
              f"steps (max {float(d.max()):.3g})")
        worst = max(worst, float(d.max()))
        if not bool((d > 0).any()):
            moved.append(name)
        check(torch.equal(r, m.detach().to(r.dtype)), f"{label}: the rollout copy's {name} "
              "is not the masters cast to its dtype")
    check(not moved, f"{label}: parameters that did not move: {moved}")
    probes = [r["probe"] for r in out["rounds"]]
    check(len(probes) == steps + 1, f"{label}: {len(probes)} rounds, want the eval and "
          f"{steps} steps")
    check(torch.equal(probes[0], probes[1]), f"{label}: the first step's round does not "
          "sample the weights the eval round sampled (no push came between)")
    for i in range(2, len(probes)):
        check(not torch.equal(probes[i], probes[i - 1]), f"{label}: round {i} samples the "
              "weights of the round before it: the push did not reach the engine")
    return {"max_move": worst, "params": sum(p.numel() for p in tr.lora.parameters()),
            "probe_delta": [float((probes[i] - probes[i - 1]).abs().max())
                            for i in range(1, len(probes))]}


def cache_miss_after_a_full_push(cfg, device, trainer, *, max_new_tokens: int = 8,
                                 slots: int = 8, page_size: int = CACHE_PAGE,
                                 n: int = 2) -> dict:
    """With the radix cache on, two rounds over the full trainer's rollout
    copy (the second warm), then the trainer's push (which rewrites the
    copy in place, here with the same values) and a third round: the
    cache keys its KV on the weights' version, so that round misses.
    ``same``: the three rounds' greedy tokens and lengths are equal."""
    import numpy as np

    model = trainer._engine_params()[0]
    _, ids, mask, _ = prompt_batch(350)
    eng = rider_engine(cfg, device, cache_dtype=model.embed.dtype, slots=slots,
                       max_new_tokens=max_new_tokens, page_size=page_size,
                       continuous_admission=True, prefix_cache=True)
    saved, tokens, lengths, versions = [], [], [], []
    for i in range(3):
        if i == 2:
            trainer._push_weights()
        versions.append(model.weights_version)
        out = rider_round(eng, model, None, ids, mask, seed=0, n=n,
                          label="full-FT cache check", max_new_tokens=max_new_tokens)
        saved.append(eng.last_pool_stats["prefill_tok_saved"])
        tokens.append(out["res"].tokens)
        lengths.append(out["res"].lengths)
    same = all(np.array_equal(t, tokens[0]) for t in tokens) and all(
        np.array_equal(n_, lengths[0]) for n_ in lengths)
    return {"saved": saved, "same": same, "versions": versions}


def lora_gemma_run(cfg, device, model, *, seed: int, workdir: Path, tokenizer_dir: Path,
                   hbm_bytes=None, config_kw=None) -> dict:
    """(b) One LoRA training step over ``model`` (bf16: K4's bf16 backward)
    with phase 10's engine and batch, under splash."""
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine

    tok = load_tokenizer(str(tokenizer_dir))
    config = full_config(workdir, seed=seed, full_finetune=False,
                         dtype=str(model.embed.dtype).removeprefix("torch."),
                         **(config_kw or {}))
    engine = make_engine(config, model, tok, hbm_bytes=hbm_bytes)
    train, test = trainer_datasets(tok)
    train = {k: v[:config.batch_size] for k, v in train.items()}  # one batch: one step
    return trainer_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                            engine=engine, model=model, sink=sink),
                       label="gemma lora")


def full_finetune_phase(args, card: str, t_start: float) -> list:
    """Phase 10 on the card (see the module's docstring). Returns the launch
    counts of its main-path runs."""
    import gc
    import tempfile

    import torch

    from distrl_llm_tpu_torch.config import full_finetune_bytes
    from distrl_llm_tpu_torch.models.configs import GEMMA_2B

    cfg = dataclasses.replace(GEMMA_2B, num_layers=FULL_LAYERS)
    est = full_finetune_bytes(cfg)["total"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_full_") as tmp:
        work = Path(tmp)
        tok_dir, _ = write_unigram_tokenizer(work / "tokenizer", cfg.vocab_size)
        a = full_finetune_run(cfg, "cuda", seed=args.seed, workdir=work / "a",
                              tokenizer_dir=tok_dir)
        check_trainer_run(a, cfg.num_layers, steps=2, lr=a["config"].lr, cuda=True)
        c = a["counts"]
        check(all(c[k] > 0 for k in ("fused_sample", "paged_attention",
                                     "flash_attention_fwd_hd256_f32",
                                     "flash_attention_bwd_hd256_f32",
                                     "flash_attention_fwd_hd256_bf16")),
              f"full: a kernel of the path was not launched: {c}")
        held = check_full_run(a, steps=2)
        tr = a["trainer"]
        cm = cache_miss_after_a_full_push(cfg, "cuda", tr)
        check(cm["saved"][1] > 0 and cm["saved"][2] == 0 and cm["same"],
              f"full: prefix cache across a push: prompt tokens not re-prefilled "
              f"{cm['saved']} (want the second round warm, the third after the push "
              f"cold), tokens equal {cm['same']}")
        rounds = a["rounds"]
        print(f"full: Trainer.train() with full_finetune at Gemma-2B width ({cfg.num_layers} "
              f"layers, D {cfg.hidden_size}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.head_dim}, F {cfg.intermediate_size}, V {cfg.vocab_size}, tied; "
              f"{held['params']:,} parameters as f32 masters), attn_impl='splash', paged "
              f"refill engine ({FULL_SLOTS} slots, {a['kv_pages']} KV pages of 128 under "
              f"learner_gpu_usage {FULL_GPU_USAGE}), 4 prompts x 4 x {FULL_NEW_TOKENS} new "
              f"tokens, learner microbatches of 4 x {a['config'].max_seq_length} in f32: "
              f"{len(rounds)} engine rounds, {a['learner_forwards']} learner forwards; every "
              f"parameter moved (max {held['max_move']:.3g}, within 2 x 5 lr); rollout copy "
              f"= masters cast to bf16; probe logits moved {held['probe_delta']} across the "
              f"rounds (eval -> step 1: no push; step 1 -> step 2: a push); train() "
              f"{a['wall_s']:.1f} s; peak device memory {a['peak_gib']:.2f} GiB against the "
              f"state estimate {est / 2**30:.2f} GiB (12 P bytes: masters, grads, 8-bit "
              f"moments, bf16 rollout copy); launches {c}; {card}")
        print(f"full: radix cache over the rollout copy (8 slots, 64-token pages): prompt "
              f"tokens not re-prefilled {cm['saved']} at weights_version {cm['versions']} "
              f"(the push drops the cache); greedy tokens equal across the three rounds "
              f"{cm['same']}; {card}")
        for line in trainer_step_lines(a, card):
            print(line)
        counted = [a["counts"]]
        model = tr._engine_params()[0]
        del a, tr, held, cm
        gc.collect()
        torch.cuda.empty_cache()
        b = lora_gemma_run(cfg, "cuda", model, seed=args.seed, workdir=work / "b",
                           tokenizer_dir=tok_dir)
        check_trainer_run(b, cfg.num_layers, steps=1, lr=b["trainer"].config.lr, cuda=True)
        check(b["counts"]["flash_attention_bwd_hd256_bf16"] > 0,
              f"gemma lora: K4's bf16 backward at head_dim 256 did not launch: {b['counts']}")
        print(f"gemma lora: one LoRA step (rank 32, bf16 base and learner) at Gemma-2B "
              f"width under splash: train() {b['wall_s']:.1f} s, peak device memory "
              f"{b['peak_gib']:.2f} GiB; launches {b['counts']}; {card}")
        for line in trainer_step_lines(b, card):
            print(line)
        counted.append(b["counts"])
        del b, model
        gc.collect()
        torch.cuda.empty_cache()
    print(f"full: phase 10 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    return counted


# ---------------------------------------------------------------- phase 11

# scan chunks: the dense engine and the paged wave scheduler decode 16 steps
# a chunk, each chunk one CUDA graph replay, at phase 4's cell (the same
# weights from the seed, prompts and shapes); (e) at phase 6's depth over the
# int4 base, (f) one Trainer.train() step at GRAPH_TRAIN_LAYERS
GRAPH_CHUNK = 16
GRAPH_SWAP_STEP = 32  # (d): an in-flight push lands at this chunk boundary
GRAPH_TRACE_STEPS = 16  # the profiled graphed round of every cell: one chunk
GRAPH_SHAPE = dict(max_prompt_tokens=350, max_new_tokens=128, n=PA_N, page_size=128,
                   rank=32, chunk=GRAPH_CHUNK)
# (f)'s depth, the cut that keeps the script near 700 s (SHALLOW_LAYERS is
# the same); (e) stays at SHALLOW_LAYERS, where phase 6's eager
# tokens were taken
GRAPH_TRAIN_LAYERS = 7


def graph_round(eng, model, lora, ids, mask, sampling, seed: int) -> dict:
    """One round of ``eng`` with the launch counts reset just before and
    read just after: its result, ms per decode step (``last_round_stats``),
    the decode forwards, the steps its graph replays ran, the captures and
    replays in it, and its peak allocated and reserved device memory."""
    import torch

    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    g = eng.decode_graphs
    before = (g.captures, g.replays)
    reset_counts()
    t = time.perf_counter()
    res = eng.generate(model, lora, ids, mask, sampling, seed)
    wall = time.perf_counter() - t
    counts = read_counts()
    st = eng.last_round_stats
    return {"res": res, "counts": counts, "steps": res.steps_dispatched,
            "forwards": st["decode_forwards"], "graph_steps": st["graph_steps"],
            "prefills": st["prompt_rows"] // ids.shape[0], "cuda": cuda,
            "ms_per_step": st["decode_s"] * 1e3 / res.steps_dispatched, "wall_s": wall,
            "captures": g.captures - before[0], "replays": g.replays - before[1],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan"),
            "reserved_gib": torch.cuda.max_memory_reserved() / 2**30 if cuda else float("nan")}


def check_graph_counts(r: dict, layers: int, *, paged: bool, quant: bool, what: str) -> None:
    """On the card, a round's launches as its path dispatched them, graph
    replays included: K1 once per decode step, K2 once per layer per paged
    decode forward, K3 7 times per layer per model forward (each prefill and
    each decode forward), no K4 (``attn_impl="reference"``), no K5. On the
    CPU the plain versions run and nothing counts."""
    c = r["counts"]
    want = {k["name"]: 0 for k in KERNELS}
    if r["cuda"]:
        want["fused_sample"] = r["steps"]
        want["paged_attention"] = layers * r["forwards"] if paged else 0
        want["quant_matmul"] = 7 * layers * (r["prefills"] + r["forwards"]) if quant else 0
    check(c == want, f"{what}: launches {c}, want {want} ({r['steps']} steps, "
          f"{r['forwards']} decode forwards, {r['graph_steps']} of them replayed)")


def graph_engines(cfg, device, *, engine: str, **shape):
    """(graphed engine at ``scan_chunk`` = the shape's chunk, eager engine)
    of ``engine``, bf16 on the card and f32 on the CPU, at ``shape``
    (GRAPH_SHAPE: phase 4's)."""
    import torch

    from distrl_llm_tpu_torch.models.lora import lora_scale

    sh = {**GRAPH_SHAPE, **shape}
    kw = dict(engine=engine, kv_quant="none",
              cache_dtype=torch.bfloat16 if device == "cuda" else torch.float32,
              max_prompt_tokens=sh["max_prompt_tokens"], max_new_tokens=sh["max_new_tokens"],
              page_size=sh["page_size"], scale=lora_scale(sh["rank"], 16.0))
    return (make_engine(cfg, device, scan_chunk=sh["chunk"], **kw)[0],
            make_engine(cfg, device, **kw)[0])


def _greedy_sampling(**shape):
    from distrl_llm_tpu_torch.config import SamplingConfig

    sh = {**GRAPH_SHAPE, **shape}
    return SamplingConfig(max_tokens=sh["max_new_tokens"], temperature=0.0, top_p=0.95,
                          n=sh["n"])


def kernel_names_in_trace(eng, model, lora, ids, mask, sampling, seed: int,
                          steps: int = GRAPH_TRACE_STEPS) -> list:
    """The kernels the device trace of one graphed round of ``steps`` steps
    names (``torch.profiler``)."""
    _, by_name = device_us_by_kernel(lambda: eng.generate(
        model, lora, ids, mask, sampling.replace(max_tokens=steps), seed))
    return sorted(by_name)


def graph_ab(cfg, device, weights, *, engine: str, seed: int, card: str = "",
             profile: bool = False, **shape) -> dict:
    """(a) / (b): the graphed and the eager engine of ``engine`` in turns,
    G E G, greedy, after a first graphed round (each key's first chunk
    eager, the next captured) and an eager warm-up; each round's launches
    checked; tokens and lengths of the three equal, logprobs' largest
    distance printed; on the card a warm graphed round replays every chunk
    and a profiled graphed round must name K1 (and K2, paged) in its device
    trace; with ``profile``, device ms per decode step of both (rounds
    differenced: GRAPH_TRACE_STEPS and 128 steps graphed, 8 and 40 eager).
    Returns the engines, the rounds and the greedy tokens."""
    import numpy as np

    model, lora = weights
    sh = {**GRAPH_SHAPE, **shape}
    _, ids, mask, _ = prompt_batch(sh["max_prompt_tokens"])
    g, e = graph_engines(cfg, device, engine=engine, **shape)
    label, cuda, k = f"graphed {engine}", device == "cuda", sh["chunk"]
    paged = engine == "paged"
    greedy = _greedy_sampling(**shape)
    first = graph_round(g, model, lora, ids, mask, greedy, seed)
    check_graph_counts(first, cfg.num_layers, paged=paged, quant=False,
                       what=f"{label} first round")
    if cuda:
        check(first["captures"] == 1 and first["replays"] == first["steps"] // k - 1,
              f"{label}: the first round captured {first['captures']} and replayed "
              f"{first['replays']} chunks, want 1 and {first['steps'] // k - 1}")
    print(f"{label}: first round (chunk 1 eager, chunk 2 captured, the rest replayed) "
          f"{1e3 * first['wall_s']:.1f} ms, {first['ms_per_step']:.2f} ms/step; {card}")
    e.generate(model, lora, ids, mask, greedy.replace(max_tokens=4), seed)  # warm-up
    rounds = []
    for eng, kind in ((g, "graphed"), (e, "eager"), (g, "graphed")):
        r = graph_round(eng, model, lora, ids, mask, greedy, seed)
        check_graph_counts(r, cfg.num_layers, paged=paged, quant=False,
                           what=f"{engine} {kind}")
        if cuda and kind == "graphed":
            check(r["captures"] == 0 and r["graph_steps"] == r["steps"],
                  f"{label}: a warm round captured {r['captures']} chunks and replayed "
                  f"{r['graph_steps']} of {r['steps']} steps")
        rounds.append((kind, r))
        print(f"{engine} {kind}: {r['steps']} steps in {r['ms_per_step']:.3f} ms/step "
              f"({r['replays']} replays); peak {r['peak_gib']:.2f} GiB allocated, "
              f"{r['reserved_gib']:.2f} GiB reserved; {card}")
    ref = rounds[0][1]["res"]
    for kind, r in rounds[1:]:
        check(np.array_equal(r["res"].tokens, ref.tokens)
              and np.array_equal(r["res"].lengths, ref.lengths),
              f"{engine}: the {kind} round's tokens or lengths differ from the graphed round's")
    dlogp = max(float(np.abs(r["res"].logprobs - ref.logprobs).max()) for _, r in rounds)
    dg = g.decode_graphs
    traced = ""
    if cuda:
        names = kernel_names_in_trace(g, model, lora, ids, mask, greedy, seed)
        want = ["fused_sample"] + (["paged_"] if paged else [])
        check(all(any(w in n for n in names) for w in want),
              f"{label}: the device trace of a graphed round names {names[:20]}, not {want}")
        traced = (f"; a graphed round's device trace names "
                  f"{', '.join(n[:40] for n in names if any(w in n for w in want))}")
    print(f"{label}: G E G rounds' tokens and lengths equal; max |dlogp| {dlogp:.3g}; "
          f"captures {dg.captures}, replays {dg.replays}, eager chunks "
          f"{dg.eager_chunks}{traced}")
    out = {"g": g, "e": e, "rounds": rounds, "dlogp": dlogp, "tokens": ref.tokens,
           "greedy": greedy, "ids": ids, "mask": mask, "first": first}
    if profile:
        for eng, kind, steps in ((g, "graphed", (GRAPH_TRACE_STEPS, 128)),
                                 (e, "eager", (8, 40))):
            prof = profile_decode(lambda n, _eng=eng: _eng.generate(
                model, lora, ids, mask, greedy.replace(max_tokens=n), seed).steps_dispatched,
                steps=steps)
            wall = statistics.median(r["ms_per_step"] for kd, r in rounds if kd == kind)
            print(f"profile {engine} {kind}: {prof['device_ms_per_step']:.3f} ms of device "
                  f"time per decode step against {wall:.3f} ms/step unprofiled: device idle "
                  f"{100 * (1 - prof['device_ms_per_step'] / wall):.1f}%; {card}")
            for name, ms in prof["top"][:6]:
                print(f"profile {engine} {kind}: {ms:8.4f} ms/step  {name[:100]}")
            out[f"profile_{kind}"] = prof
    return out


def graph_sampled(ab: dict, weights, *, seed: int, layers: int, card: str = "") -> list:
    """(c): one sampled round (t 1.2, top-p 0.95) on the graphed and the
    eager dense engine of (a): equal tokens. The graphed engine's first
    sampled chunk runs eagerly (a new key), the next is captured."""
    import numpy as np

    model, lora = weights
    sampled = ab["greedy"].replace(temperature=1.2)
    rs = [graph_round(eng, model, lora, ab["ids"], ab["mask"], sampled, seed + 1)
          for eng in (ab["g"], ab["e"])]
    for r, kind in zip(rs, ("graphed", "eager")):
        check_graph_counts(r, layers, paged=False, quant=False, what=f"sampled {kind}")
    check(np.array_equal(rs[0]["res"].tokens, rs[1]["res"].tokens),
          "sampled: the graphed round's tokens differ from the eager round's")
    check(not np.array_equal(rs[0]["res"].tokens, ab["tokens"]), "sampled: equals greedy")
    print(f"graphed dense sampled t=1.2 top_p=0.95: tokens equal to the eager round's; "
          f"{rs[0]['ms_per_step']:.3f} vs {rs[1]['ms_per_step']:.3f} ms/step "
          f"({rs[0]['captures']} capture, {rs[0]['replays']} replays); {card}")
    return [r["counts"] for r in rs]


def swap_at(engine, step: int, lora, version: int) -> None:
    """Push ``lora`` as ``engine`` reaches decode step ``step``."""
    take = engine._take_pending_lora

    def patched(cell, dispatched):
        if dispatched == step:
            engine.push_lora(lora, version=version)
        take(cell, dispatched)

    engine._take_pending_lora = patched


def graph_swap(ab: dict, weights, cfg, *, seed: int, card: str = "",
               step: int = GRAPH_SWAP_STEP, rank: int = 32) -> list:
    """(d): a second adapter (other tensors, so another graph key) pushed
    as both dense engines of (a) reach ``step``, a chunk boundary: the same
    swap log, tokens before it equal to (a)'s, and equal greedy tokens."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.models.lora import init_lora_params

    model, lora = weights
    gen = torch.Generator(device=model.embed.device).manual_seed(seed + 7)
    second = init_lora_params(gen, cfg, rank)
    for ab_ in second["layers"].values():
        ab_["b"].normal_(0.0, 0.01, generator=gen)
    rs = []
    for eng, kind in ((ab["g"], "graphed"), (ab["e"], "eager")):
        take = eng._take_pending_lora
        swap_at(eng, step, second, 1)
        try:
            r = graph_round(eng, model, lora, ab["ids"], ab["mask"], ab["greedy"], seed)
        finally:
            eng._take_pending_lora = take
        check_graph_counts(r, cfg.num_layers, paged=False, quant=False, what=f"swap {kind}")
        check(eng.last_swap_steps == [step] and eng.last_swap_versions == [1],
              f"swap {kind}: swap log {eng.last_swap_steps} {eng.last_swap_versions}")
        rs.append(r)
    check(np.array_equal(rs[0]["res"].tokens, rs[1]["res"].tokens),
          "swap: the graphed round's tokens differ from the eager round's")
    check((rs[0]["res"].tokens[..., :step] == ab["tokens"][..., :step]).all(),
          "swap: tokens before the swap differ from the unswapped round's")
    print(f"graphed dense, a second adapter pushed at step {step}: swapped in at step "
          f"{step} on both engines, tokens equal ({rs[0]['captures']} capture, "
          f"{rs[0]['replays']} replays for the new adapter); the round's tokens equal the "
          f"unswapped round's on {100 * (rs[0]['res'].tokens == ab['tokens']).mean():.2f}% "
          f"of positions; {card}")
    return [r["counts"] for r in rs]


def graph_qlora(cfg, device, weights, *, seed: int, eager_tokens, card: str = "",
                **shape) -> dict:
    """(e): two graphed greedy rounds of the dense engine over quantized
    ``weights`` (on the card the int4 g64 base at phase 6's depth; the
    first captures, the second replays every chunk): K3 launched 7 times
    per layer per model forward, replays included, its plain version
    never; tokens equal ``eager_tokens`` (phase 6's eager round)."""
    import numpy as np

    model, lora = weights
    sh = {**GRAPH_SHAPE, **shape}
    _, ids, mask, _ = prompt_batch(sh["max_prompt_tokens"])
    g, _ = graph_engines(cfg, device, engine="dense", **shape)
    plain = [0]
    with counting_plain_calls(_qmm(), "quant_matmul_reference", plain):
        # the first round captures; the second replays every chunk
        rs = [graph_round(g, model, lora, ids, mask, _greedy_sampling(**shape), seed)
              for _ in range(2)]
    for r in rs:
        check_graph_counts(r, cfg.num_layers, paged=False, quant=True, what="graphed qlora")
        check(np.array_equal(r["res"].tokens, eager_tokens),
              "graphed qlora: tokens differ from phase 6's eager round")
    if device == "cuda":
        check(plain[0] == 0 and rs[1]["graph_steps"] == rs[1]["steps"],
              f"graphed qlora: K3's plain version ran {plain[0]} times; the second round "
              f"replayed {rs[1]['graph_steps']} of {rs[1]['steps']} steps")
    r = rs[0]
    print(f"graphed dense over the quantized base, {cfg.num_layers} layers: two greedy rounds, "
          f"tokens equal to phase 6's eager round; {r['steps']} steps, {r['ms_per_step']:.3f} "
          f"ms/step with its first chunk eager and {r['captures']} capture, "
          f"{rs[1]['ms_per_step']:.3f} ms/step replayed; K3 {r['counts']['quant_matmul']} "
          f"launches a round = 7 x {cfg.num_layers} x {r['prefills'] + r['forwards']} model "
          f"forwards; {card}")
    g.release_decode_graphs()
    return rs


def graph_trainer(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                  **config_kw) -> dict:
    """(f): ``Trainer.train()`` with ``decode_scan_chunk`` GRAPH_CHUNK on
    the dense engine ``make_engine`` builds, over a base in the weights'
    dtype at ``cfg``'s depth (random weights from the seed), flash attention
    (K4 in the prefill and the learner), phase 8's tokenizer and reward: the
    initial eval and one step of 4 prompts x 16 x 128 new tokens."""
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine as trainer_engine

    tok = load_tokenizer(str(tokenizer_dir))
    config = trainer_config(workdir, seed=seed, base_quant="none", engine_impl="dense",
                            continuous_batching=False, max_concurrent_sequences=0,
                            attn_impl="flash", decode_scan_chunk=GRAPH_CHUNK, save_every=0,
                            write_adapter_file=False, **config_kw)
    model, _ = make_weights(cfg, device, seed=seed)
    engine = trainer_engine(config, model, tok)
    train, test = trainer_datasets(tok)
    train = {k: v[:config.batch_size] for k, v in train.items()}  # one batch: one step
    out = trainer_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                           engine=engine, model=model, sink=sink),
                      label="graphed dense")
    out["config"] = config
    return out


def graph_phase(cfg, args, card: str, t_start: float, *, qlora_tokens) -> list:
    """Phase 11 on the card (see the module's docstring). Returns the launch
    counts of its rounds."""
    import gc
    import tempfile

    import torch

    t0 = time.perf_counter()
    # (a)-(d) at GRAPH_TRAIN_LAYERS: the depth cut that makes room for phase 17
    mid = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, GRAPH_TRAIN_LAYERS))
    weights = make_weights(mid, "cuda", seed=args.seed)
    counted = []
    ab = {}
    for engine in ("dense", "paged"):
        ab[engine] = graph_ab(mid, "cuda", weights, engine=engine, seed=args.seed, card=card,
                              profile=args.profile)
        counted += [ab[engine]["first"]["counts"]] + [
            r["counts"] for _, r in ab[engine]["rounds"]]
        g, e = (ab[engine]["rounds"][i][1]["ms_per_step"] for i in (0, 1))
        print(f"graphed {engine}: {g:.3f} ms/step graphed vs {e:.3f} eager; total "
              f"{time.perf_counter() - t_start:.1f} s; {card}")
    ab.pop("paged")["g"].release_decode_graphs()
    counted += graph_sampled(ab["dense"], weights, seed=args.seed, layers=mid.num_layers,
                             card=card)
    counted += graph_swap(ab["dense"], weights, mid, seed=args.seed, card=card)
    ab["dense"]["g"].release_decode_graphs()
    del ab, weights
    gc.collect()
    torch.cuda.empty_cache()
    shallow = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, SHALLOW_LAYERS))
    qw = make_qlora_weights(shallow, "cuda", seed=args.seed, bits=4, group=QMM_GROUP)
    counted += [r["counts"] for r in graph_qlora(shallow, "cuda", qw, seed=args.seed,
                                                 eager_tokens=qlora_tokens, card=card)]
    del qw
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        work = Path(tmp)
        tok_dir = write_bpe_tokenizer(work / "tokenizer", cfg.vocab_size)
        train_cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, GRAPH_TRAIN_LAYERS))
        f = graph_trainer(train_cfg, "cuda", seed=args.seed, workdir=work / "f",
                          tokenizer_dir=tok_dir)
        check_trainer_run(f, train_cfg.num_layers, steps=1, lr=f["config"].lr, cuda=True)
        dg = f["trainer"].engine.decode_graphs
        check(dg.replays > 0, f"graphed trainer: no chunk was replayed ({dg.captures} "
              f"captures)")
        print(f"trainer graphed dense: Trainer.train() at {train_cfg.num_layers} layers, bf16 "
              f"base, decode_scan_chunk {GRAPH_CHUNK}, flash: {len(f['rounds'])} engine "
              f"rounds ({', '.join(str(r['steps']) + ' steps' for r in f['rounds'])}); "
              f"captures {dg.captures}, replays {dg.replays}; train() {f['wall_s']:.1f} s; "
              f"peak device memory {f['peak_gib']:.2f} GiB; launches {f['counts']}; {card}")
        for line in trainer_step_lines(f, card):
            print(line)
        counted.append(f["counts"])
        f["trainer"].engine.release_decode_graphs()
        del f
        gc.collect()
        torch.cuda.empty_cache()
    print(f"graphs: phase 11 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    return counted


# ---------------------------------------------------------------- phase 12

# scan chunks on the refill scheduler: its plain, speculative and
# self-drafted steps 16 a chunk, each chunk one CUDA graph replay, at the
# trainer's refill cell (32 slots, phase 4's 4 prompts x 16 x 128 new tokens:
# 64 candidates over 32 slots, so slots refill); (c)-(e) at
# GRAPH_TRAIN_LAYERS, phase 11 (f)'s depth, the cut that keeps the script near
# 820 s (at 14 layers their rounds alone took ~100 s)
REFILL_GRAPH_SHAPE = dict(max_prompt_tokens=350, max_new_tokens=TRAIN_NEW_TOKENS, n=PA_N,
                          page_size=128, rank=32, chunk=GRAPH_CHUNK, slots=TRAIN_SLOTS)
REFILL_GRAPH_SWAP_STEP = 32  # (d): a push lands at this chunk boundary
# (c): 64-token pages (every prompt keeps a full page below its last token for
# the radix cache) and a pool under the worst case of 32 slots (121 pages),
# so that occupants are preempted
REFILL_RIDER_PAGE = CACHE_PAGE
REFILL_RIDER_PAGES = 96


def refill_graph_engines(cfg, device, *, shape: dict, **kw):
    """(graphed engine at ``scan_chunk`` = the shape's chunk, eager engine):
    the refill scheduler at ``shape``'s slots with the riders or speculative
    settings of ``kw``, bf16 pages on the card and f32 on the CPU."""
    import torch

    from distrl_llm_tpu_torch.models.lora import lora_scale

    common = dict(cache_dtype=torch.bfloat16 if device == "cuda" else torch.float32,
                  slots=shape["slots"], max_new_tokens=shape["max_new_tokens"],
                  max_prompt_tokens=shape["max_prompt_tokens"], page_size=shape["page_size"],
                  scale=lora_scale(shape["rank"], 16.0), **kw)
    return (rider_engine(cfg, device, scan_chunk=shape["chunk"], **common),
            rider_engine(cfg, device, **common))


def refill_graph_round(eng, model, lora, ids, mask, sampling, seed: int, *, what: str,
                       layers: int) -> dict:
    """``graph_round`` of a refill engine, its stats kept, its launches held
    to what it dispatched (replays included): K1 once per sampler call (a
    plain step, or a speculative admission), K2 once per layer per plain or
    self-drafter decode forward, K5 once per layer per verify forward, no
    K3 or K4. On the CPU the plain versions run and nothing counts."""
    r = graph_round(eng, model, lora, ids, mask, sampling, seed)
    st, spec = dict(eng.last_round_stats), eng.last_spec_stats
    r.update(stats=st, spec=spec, pool=dict(eng.last_pool_stats), what=what)
    want = {k["name"]: 0 for k in KERNELS}
    if r["cuda"]:
        want["fused_sample"] = st["sampler_calls"]
        want["paged_attention"] = layers * (st["draft_forwards"] if spec else r["forwards"])
        want["paged_verify"] = layers * r["forwards"] if spec else 0
    check(r["counts"] == want, f"{what}: launches {r['counts']}, want {want} ({r['steps']} "
          f"steps, {r['forwards']} forwards, {r['graph_steps']} of them replayed)")
    return r


def check_graph_equal(rounds, what: str) -> float:
    """Every round's tokens and lengths equal the first's, and its
    logprobs too (where the engine captures them); returns the largest
    |dlogp| (0 without logprobs)."""
    import numpy as np

    ref = rounds[0]["res"]
    for r in rounds[1:]:
        check(np.array_equal(r["res"].tokens, ref.tokens)
              and np.array_equal(r["res"].lengths, ref.lengths)
              and (ref.logprobs is None) == (r["res"].logprobs is None)
              and (ref.logprobs is None or np.array_equal(r["res"].logprobs, ref.logprobs)),
              f"{what}: the {r['what']} round's tokens, lengths or logprobs differ from the "
              f"{rounds[0]['what']} round's")
    if ref.logprobs is None:
        return 0.0
    return max(float(np.abs(r["res"].logprobs - ref.logprobs).max()) for r in rounds)


def check_replayed(g, what: str) -> None:
    """On the card, a graphed engine replayed chunks and reports
    ``scan_chunk_active``; on the CPU, where nothing is graphed, it ran
    chunks."""
    dg = g.decode_graphs
    want = dg.replays > 0 if g.device.type == "cuda" else dg.eager_chunks > 0
    check(want and g.scan_chunk_active, f"{what}: {dg.replays} replays, {dg.eager_chunks} eager "
          f"chunks, scan_chunk_active {g.scan_chunk_active}")


def refill_graph_ab(cfg, device, weights, *, seed: int, spec_draft: int, card: str = "",
                    profile: bool = False, **shape) -> dict:
    """(a) plain refill, rounds G E G, and (b) speculative refill
    (``spec_draft`` n-gram drafts), rounds G G E: greedy, the graphed engine's
    first round its capture (each key's first chunk eager, the next
    captured, the rest replayed), the later graphed rounds all replays; every
    round's launches checked, tokens, lengths and logprobs all equal. With
    ``profile``, device ms per step (rounds of 16 and 32 new tokens
    differenced) and the idle share of the graphed and the eager engine
    against their unprofiled 128-token rounds."""
    model, lora = weights
    sh = {**REFILL_GRAPH_SHAPE, **shape}
    _, ids, mask, _ = prompt_batch(sh["max_prompt_tokens"])
    kw = dict(spec_draft=spec_draft, spec_ngram=SPEC_NGRAM) if spec_draft else {}
    g, e = refill_graph_engines(cfg, device, shape=sh, **kw)
    label = f"{'spec d=' + str(spec_draft) if spec_draft else 'plain'} refill"
    greedy = _greedy_sampling(**sh)
    cuda, k = device == "cuda", sh["chunk"]
    kinds = ("graphed", "graphed", "eager") if spec_draft else ("graphed", "eager", "graphed")
    rounds = []
    for i, kind in enumerate(kinds):
        eng = g if kind == "graphed" else e
        r = refill_graph_round(eng, model, lora, ids, mask, greedy, seed,
                               what=f"{label} {kind} round {i + 1}", layers=cfg.num_layers)
        r["kind"] = kind
        first = kind == "graphed" and i == 0
        if cuda and kind == "graphed":
            chunks = r["steps"] // k
            want = (1, chunks - 1) if first else (0, chunks)
            check((r["captures"], r["replays"]) == want and r["steps"] % k == 0,
                  f"{r['what']}: {r['captures']} captures and {r['replays']} replays over "
                  f"{r['steps']} steps, want {want}")
        rounds.append(r)
        extra = ""
        if spec_draft:
            s = r["spec"]
            extra = (f", accept rate {s['accept_rate']:.4f}, {s['tokens_per_verify_step']:.4f} "
                     f"tokens per verify step")
        print(f"{label} {kind}{' (first: eager chunk, capture)' if first else ''}: "
              f"{r['steps']} steps, {r['ms_per_step']:.3f} ms/step ({r['replays']} replays, "
              f"{r['graph_steps']} steps replayed){extra}; peak {r['peak_gib']:.2f} GiB "
              f"allocated, {r['reserved_gib']:.2f} GiB reserved; {card}")
    dlogp = check_graph_equal(rounds, label)
    check_replayed(g, label)
    if spec_draft:
        check(all(r["spec"]["emit_hist"] == rounds[0]["spec"]["emit_hist"] for r in rounds),
              f"{label}: the emit histograms differ between graphed and eager rounds")
    dg = g.decode_graphs
    order = " ".join(r["kind"][0].upper() for r in rounds)
    print(f"graphed {label}: {order} rounds' tokens, lengths and logprobs equal (max |dlogp| "
          f"{dlogp:.3g}); captures {dg.captures}, replays {dg.replays}, eager chunks "
          f"{dg.eager_chunks}; scan_chunk_active {g.scan_chunk_active}")
    out = {"g": g, "e": e, "rounds": rounds, "tokens": rounds[0]["res"].tokens, "dlogp": dlogp}
    if profile and cuda:
        # rounds of 16 and 32 new tokens differenced (a graphed engine's new
        # length is a new key: its first chunk runs eagerly and the next is
        # captured, the same kernels as a replay, so the device time holds)
        for eng, kind in ((g, "graphed"), (e, "eager")):
            prof = profile_decode(lambda n, _eng=eng: _eng.generate(
                model, lora, ids, mask, greedy.replace(max_tokens=n), seed).steps_dispatched,
                steps=(16, 32))
            wall = statistics.median(r["ms_per_step"] for r in rounds[1:] if r["kind"] == kind)
            print(f"profile {label} {kind}: {prof['device_ms_per_step']:.3f} ms of device time "
                  f"per step against {wall:.3f} ms/step unprofiled: device idle "
                  f"{100 * (1 - prof['device_ms_per_step'] / wall):.1f}%; {card}")
            for name, ms in prof["top"][:6]:
                print(f"profile {label} {kind}: {ms:8.4f} ms/step  {name[:100]}")
            out[f"profile_{kind}"] = prof
    return out


def refill_graph_riders(cfg, device, weights, *, seed: int, card: str = "",
                        pages: int = REFILL_RIDER_PAGES, min_preemptions: int = 1,
                        **shape) -> dict:
    """(c) prefix sharing, continuous admission, the radix cache and host
    spill under ``pages`` pages (under the worst case, so occupants are
    preempted), 64-token pages, two greedy rounds an engine (the second
    admits its groups warm through the cache), graphed and eager in turns:
    tokens, lengths and logprobs equal round by round, at least
    ``min_preemptions`` preemptions a round on both, restores, warm groups
    and prompt tokens not re-prefilled equal."""
    model, lora = weights
    sh = {**REFILL_GRAPH_SHAPE, "page_size": REFILL_RIDER_PAGE, **shape}
    _, ids, mask, _ = prompt_batch(sh["max_prompt_tokens"])
    g, e = refill_graph_engines(cfg, device, shape=sh, continuous_admission=True,
                                prefix_cache=True, kv_spill=True, max_kv_pages=pages)
    greedy = _greedy_sampling(**sh)
    rounds = {}
    for rnd in (1, 2):
        for eng, kind in ((g, "graphed"), (e, "eager")):
            r = refill_graph_round(eng, model, lora, ids, mask, greedy, seed,
                                   what=f"riders {kind} round {rnd}", layers=cfg.num_layers)
            rounds[(kind, rnd)] = r
            p = r["pool"]
            print(f"riders {kind} round {rnd}: {r['steps']} steps, {r['ms_per_step']:.3f} "
                  f"ms/step ({r['replays']} replays); preemptions {p['preemptions']}, "
                  f"spilled / restored pages {p['spilled_pages']} / {p['restored_pages']}, "
                  f"{r['stats']['warm_prefills']} of {p['groups_prefilled']} group prefills "
                  f"warm, {p['prefill_tok_saved']} prompt tokens not re-prefilled; peak "
                  f"{r['peak_gib']:.2f} GiB; {card}")
        pair = [rounds[("graphed", rnd)], rounds[("eager", rnd)]]
        check_graph_equal(pair, f"riders round {rnd}")
        for key in ("preemptions", "restored_pages", "spilled_pages", "prefill_tok_saved",
                    "groups_prefilled", "resumes"):
            check(pair[0]["pool"][key] == pair[1]["pool"][key],
                  f"riders round {rnd}: {key} {pair[0]['pool'][key]} graphed, "
                  f"{pair[1]['pool'][key]} eager")
        check(pair[0]["stats"]["warm_prefills"] == pair[1]["stats"]["warm_prefills"],
              f"riders round {rnd}: warm group prefills differ")
    r2 = rounds[("graphed", 2)]
    check_replayed(g, "riders")
    preempt = min(rounds[(k, r)]["pool"]["preemptions"] for k in ("graphed", "eager")
                  for r in (1, 2))
    check(preempt >= min_preemptions, f"riders: a round with {pages} pages preempted "
          f"{preempt} times, want at least {min_preemptions}")
    check(r2["stats"]["warm_prefills"] > 0 and r2["pool"]["prefill_tok_saved"] > 0,
          f"riders: round 2 admitted no group warm ({r2['pool']})")
    print(f"graphed riders: G E round by round equal; preemptions >= {preempt} on both, "
          f"round 2 warm groups {r2['stats']['warm_prefills']}, "
          f"{r2['pool']['prefill_tok_saved']} prompt tokens not re-prefilled, restores "
          f"{r2['pool']['restored_pages']}; graphed captures {g.decode_graphs.captures}, "
          f"replays {g.decode_graphs.replays}; {card}")
    return {"g": g, "e": e, "rounds": rounds, "preemptions": preempt,
            "warm_groups": r2["stats"]["warm_prefills"]}


def refill_graph_self_draft(cfg, device, weights, *, seed: int, card: str = "",
                            step: int = REFILL_GRAPH_SWAP_STEP, **shape) -> dict:
    """(d) the self-drafter with ``spec_adapt``, sampled (t 1.2, top-p
    0.95): the round opens with adapter v1 (which drafts for itself), v2
    (v1 moved by one Adam8bit step) is pushed at ``step``, a chunk
    boundary, and v1 drafts for it from there. Graphed then eager: tokens,
    lengths and logprobs equal, the swap at ``step`` on both, the draft
    length at every boundary equal. Each draft length and each drafter
    adapter is a chunk key of its own."""
    model, v1 = weights
    v2 = adam_step_neighbour(v1, seed=seed)
    sh = {**REFILL_GRAPH_SHAPE, **shape}
    _, ids, mask, _ = prompt_batch(sh["max_prompt_tokens"])
    g, e = refill_graph_engines(cfg, device, shape=sh, spec_draft=SPEC_DRAFT,
                                spec_drafter="self", spec_adapt=True)
    sampled = _greedy_sampling(**sh).replace(temperature=1.2)
    rs = []
    for eng, kind in ((g, "graphed"), (e, "eager")):
        take = eng._take_pending_lora
        swap_at(eng, step, v2, 2)
        try:
            r = refill_graph_round(eng, model, v1, ids, mask, sampled, seed + 2,
                                   what=f"self-drafter {kind}", layers=cfg.num_layers)
        finally:
            eng._take_pending_lora = take
        check(eng.last_swap_steps == [step] and eng.last_swap_versions == [2],
              f"self-drafter {kind}: swap log {eng.last_swap_steps} {eng.last_swap_versions}")
        s = r["spec"]
        print(f"self-drafter {kind} t=1.2: {r['steps']} steps, {r['ms_per_step']:.3f} ms/step "
              f"({r['captures']} captures, {r['replays']} replays); accept rate "
              f"{s['accept_rate']:.4f}, {s['tokens_per_verify_step']:.4f} tokens per verify "
              f"step; draft length at each boundary {s['draft_len_trace']}; "
              f"{s['draft_forwards']} drafter forwards; {card}")
        rs.append(r)
    check_graph_equal(rs, "self-drafter")
    sg, se = rs[0]["spec"], rs[1]["spec"]
    check(sg["draft_len_trace"] == se["draft_len_trace"] and sg["emit_hist"] == se["emit_hist"],
          "self-drafter: the draft-length traces or emit histograms differ")
    check_replayed(g, "self-drafter")
    switches = sg["draft_len_switches"]
    why = ("" if switches else
           f" (the accept rate, {sg['accept_rate']:.4f} over the round, kept the "
           f"controller's EMA above its 0.35 floor: one Adam8bit step moves the drafter "
           f"little)")
    print(f"graphed self-drafter: G E tokens, lengths and logprobs equal; the swap at step "
          f"{step} on both; draft length switched {switches} times{why}; captures "
          f"{g.decode_graphs.captures}, replays {g.decode_graphs.replays}; {card}")
    return {"g": g, "e": e, "rounds": rs, "swap_steps": g.last_swap_steps,
            "switches": switches}


def refill_graph_trainer(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                         group=QMM_GROUP, hbm_bytes=None, **config_kw) -> dict:
    """(e) one ``Trainer.train()`` step of phase 8's configuration (int4 base,
    the refill engine ``make_engine`` builds, splash) with
    ``decode_scan_chunk`` GRAPH_CHUNK and eager, the initial eval first, each
    from the same seed and checked by ``check_trainer_run``, each trainer
    dropped before the next starts (its peak memory its own): every engine
    round's tokens, lengths and logprobs equal. Each run keeps its engine's
    captures, replays and ``scan_chunk_active``."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import quantize_base
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine as trainer_engine

    tok = load_tokenizer(str(tokenizer_dir))
    train, test = trainer_datasets(tok)
    out = {}
    for kind, chunk in (("graphed", GRAPH_CHUNK), ("eager", 0)):
        config = trainer_config(workdir / kind, seed=seed, quant_group_size=group,
                                decode_scan_chunk=chunk, save_every=0,
                                write_adapter_file=False, **config_kw)
        model, _ = make_weights(cfg, device, seed=seed)
        quantize_base(model, config.base_quant, config.quant_group_size)
        engine = trainer_engine(config, model, tok, hbm_bytes=hbm_bytes)
        one = {k: v[:config.batch_size] for k, v in train.items()}  # one batch: one step
        run = trainer_run(lambda sink: Trainer(one, test, smoke_reward, config, tokenizer=tok,
                                               engine=engine, model=model, sink=sink),
                          label=f"qlora {kind}")
        run["config"] = config
        check_trainer_run(run, cfg.num_layers, steps=1, lr=config.lr, cuda=device == "cuda")
        dg = run.pop("trainer").engine.decode_graphs
        run.update(captures=dg.captures, replays=dg.replays,
                   active=engine.scan_chunk_active)
        engine.release_decode_graphs()
        out[kind] = run
        del model, engine, dg
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    for rg, re_ in zip(out["graphed"]["rounds"], out["eager"]["rounds"], strict=True):
        check_graph_equal([dict(res=rg["res"], what="graphed"), dict(res=re_["res"],
                                                                     what="eager")],
                          "trainer qlora")
    return out


def refill_graph_phase(cfg, args, card: str, t_start: float) -> list:
    """Phase 12 on the card (see the module's docstring). Returns the launch
    counts of its rounds."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    counted = []
    gc.collect()
    torch.cuda.empty_cache()
    # (a) and (b) at GRAPH_TRAIN_LAYERS: the depth cut that makes room for phase 17
    mid = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, GRAPH_TRAIN_LAYERS))
    weights = make_weights(mid, "cuda", seed=args.seed)
    for d in (0, SPEC_DRAFT):
        ab = refill_graph_ab(mid, "cuda", weights, seed=args.seed, spec_draft=d, card=card,
                             profile=args.profile)
        counted += [r["counts"] for r in ab["rounds"]]
        g = [r["ms_per_step"] for r in ab["rounds"][1:] if r["kind"] == "graphed"]
        e = [r["ms_per_step"] for r in ab["rounds"] if r["kind"] == "eager"]
        print(f"graphed {'spec' if d else 'plain'} refill: {', '.join(f'{x:.3f}' for x in g)} "
              f"ms/step graphed (warm) vs {', '.join(f'{x:.3f}' for x in e)} eager; total "
              f"{time.perf_counter() - t_start:.1f} s; {card}")
        ab["g"].release_decode_graphs()
        del ab
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    shallow = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, GRAPH_TRAIN_LAYERS))
    weights = make_weights(shallow, "cuda", seed=args.seed)
    c = refill_graph_riders(shallow, "cuda", weights, seed=args.seed, card=card)
    counted += [r["counts"] for r in c["rounds"].values()]
    c["g"].release_decode_graphs()
    del c
    d = refill_graph_self_draft(shallow, "cuda", weights, seed=args.seed, card=card)
    counted += [r["counts"] for r in d["rounds"]]
    d["g"].release_decode_graphs()
    del d, weights
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_refill_graph_") as tmp:
        work = Path(tmp)
        tok_dir = write_bpe_tokenizer(work / "tokenizer", cfg.vocab_size)
        e = refill_graph_trainer(shallow, "cuda", seed=args.seed, workdir=work,
                                 tokenizer_dir=tok_dir)
        for kind, run in e.items():
            if kind == "graphed":
                check(run["replays"] > 0 and run["active"],
                      f"trainer qlora graphed: no chunk was replayed ({run['captures']} "
                      f"captures)")
            print(f"trainer qlora {kind}: Trainer.train() at {shallow.num_layers} layers over the "
                  f"int4 g{QMM_GROUP} base, refill engine ({TRAIN_SLOTS} slots), decode_scan_"
                  f"chunk {run['config'].decode_scan_chunk}: {len(run['rounds'])} engine rounds "
                  f"({', '.join(str(r['steps']) + ' steps' for r in run['rounds'])}); captures "
                  f"{run['captures']}, replays {run['replays']}; train() {run['wall_s']:.1f} s; "
                  f"peak device memory {run['peak_gib']:.2f} GiB; launches {run['counts']}; "
                  f"{card}")
            for line in trainer_step_lines(run, card):
                print(line)
            counted.append(run["counts"])
        del e
        gc.collect()
        torch.cuda.empty_cache()
    print(f"refill graphs: phase 12 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    return counted


# ------------------------------------------------------------------ phase 13
# the overlapped rollout modes: phase 8's trainer configuration at 7 layers
# (as phase 12(e)), GRPO with clip_ratio 0.2 for every regime (async needs
# it), one episode of 4 batches

OVERLAP_PROBLEMS = TRAIN_PROBLEMS + (
    ("What is 9 times 7?", "63"),
    ("What is the square root of 144?", "12"),
    ("How many sides does a hexagon have?", "6"),
    ("What is 2 to the power of 10?", "1024"),
    ("What is 100 divided by 4?", "25"),
    ("What is the least common multiple of 4 and 6?", "12"),
    ("What is 17 + 26?", "43"),
    ("How many degrees are in a right angle?", "90"),
)
# (label, the regime's config): (a) sync and (b) pipelined graphed, (c) sync
# and (d) pipelined eager (the trainer's default), (e) async with in-flight
# updates at the buffer's floor (2 x batch), which makes rounds interleave
# with updates
OVERLAP_REGIMES = (
    ("sync_graphed", dict(rollout_mode="sync", decode_scan_chunk=GRAPH_CHUNK)),
    ("pipelined_graphed", dict(rollout_mode="pipelined", decode_scan_chunk=GRAPH_CHUNK)),
    ("sync_eager", dict(rollout_mode="sync")),
    ("pipelined_eager", dict(rollout_mode="pipelined")),
    ("async", dict(rollout_mode="async", inflight_weight_updates=True, max_staleness=2,
                   rollout_buffer_groups=1, decode_scan_chunk=GRAPH_CHUNK)),
)


def overlap_datasets(tokenizer):
    """The 16 problems (train, 4 batches of 4) and the first 4 (eval)
    through the R1 chat template."""
    from distrl_llm_tpu_torch.data import R1_PREPROMPT, process_dataset

    data = {"problem": [p for p, _ in OVERLAP_PROBLEMS],
            "solution": [s for _, s in OVERLAP_PROBLEMS]}
    train = process_dataset(tokenizer, data, R1_PREPROMPT, "")
    return train, {k: v[:4] for k, v in train.items()}


def _kernel_counts(tally) -> dict[str, int]:
    """A launch tally by (module, counter) as counts by KERNELS name."""
    return {k["name"]: int(tally.get((k["module"], k["counter"]), 0)) for k in KERNELS}


def _overlap_s(a: tuple, b: tuple) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def overlap_run(build, *, label: str, drive=None) -> dict:
    """``build(sink)`` makes a ``Trainer``; this runs its ``train()`` (or
    ``drive(trainer)``) with the counts reset just before and read just
    after, recording on the thread that ran it each engine round (host
    interval, its own launches from the thread's tally, model forwards, the
    preemption and turn resumes, captures, the weights it read, the version
    it opened with, its swaps and tags, an environment's columns) and each
    update (host interval to the loss on the host, the launches of every
    thread but the rollout's, learner forwards), each train record's host
    time and the peak device memory. In full mode the model forwards are
    counted on every rollout copy and on the f32 masters."""
    import collections

    import numpy as np
    import torch

    from distrl_llm_tpu_torch.engine.decode_graph import tensors_key
    from distrl_llm_tpu_torch.ops import launch_count

    cell = []
    sink = _StepSink(cell)
    trainer = build(sink)
    cell.append(trainer)
    eng = trainer.engine
    if trainer._full:  # every rollout copy, and the masters the learner trains
        ring = trainer._ring
        models = [*(ring._bufs if ring is not None else [trainer._rollout_model]),
                  trainer.lora]
    else:
        models = [trainer.model]
    dev = models[0].embed.device
    cuda = dev.type == "cuda"
    main = threading.get_ident()
    fwd, mu = collections.Counter(), threading.Lock()

    def hook(*_):  # a forward made while capturing launches nothing
        if not (cuda and torch.cuda.is_current_stream_capturing()):
            with mu:
                fwd[threading.get_ident()] += 1

    handles = [m.register_forward_hook(hook) for m in models]
    rounds, updates, tagged, rollout_threads, env_rounds = [], [], [], set(), []
    swapped: dict[int, list] = collections.defaultdict(list)  # adapters a round swapped in
    swap_hook = eng.lora_swap_hook

    def hooked_swap(dropped, taken):
        swapped[threading.get_ident()].append(tensors_key(taken))
        swap_hook(dropped, taken)

    if swap_hook is not None:
        eng.lora_swap_hook = hooked_swap
    generate, train_step, gen_round = eng.generate, trainer.train_step, trainer._generate_round
    times = {"records": []}
    log = sink.log

    def logged(metrics, step):
        times["records"].append((time.perf_counter(), "loss" in metrics))
        log(metrics, step)

    def recorded(*a, **kw):
        ident = threading.get_ident()
        if ident != main:
            rollout_threads.add(ident)
        c0, f0 = launch_count.thread_counts(), fwd[ident]
        g0 = (eng.decode_graphs.captures, eng.decode_graphs.replays,
              len(eng.decode_graphs.captured_keys))
        swapped[ident] = []
        t0 = time.perf_counter()
        res = generate(*a, **kw)
        t1 = time.perf_counter()
        st = dict(eng.last_round_stats or {})
        pool = dict(getattr(eng, "last_pool_stats", None) or {})
        rounds.append({
            "t": (t0, t1), "thread": ident,
            "train": a[4].n == trainer.config.num_candidates and not evaluating[0],
            "res": res, "steps": res.steps_dispatched, "forwards": st.get("decode_forwards", 0),
            "sampler_calls": st.get("sampler_calls", res.steps_dispatched),
            "draft_forwards": st.get("draft_forwards", 0), "spec": eng.last_spec_stats,
            "resumes": pool.get("resumes", 0), "refill": bool(pool),
            "turn_resumes": pool.get("turn_resumes") or 0,
            "turn_saved": pool.get("turn_prefill_saved_tokens") or 0,
            "model_forwards": fwd[ident] - f0 + st.get("graph_steps", 0),
            "counts": _kernel_counts(launch_count.thread_counts() - c0),
            "captures": eng.decode_graphs.captures - g0[0],
            "replays": eng.decode_graphs.replays - g0[1],
            "captured_keys": eng.decode_graphs.captured_keys[g0[2]:],
            "model_key": tensors_key(a[0]),
            "adapters": [tensors_key(a[1]), *swapped[ident]]})
        return res

    def round_tags(batch, sampling):
        out = gen_round(batch, sampling)
        c = out[0]
        train_round = sampling.n == trainer.config.num_candidates and not evaluating[0]
        if train_round and "base_version" in c:
            tagged.append({"base": c["base_version"], "events": list(c["swap_events"]),
                           "tags": np.asarray(c["version_tags"][0])})
        if "turns" in c:
            env_rounds.append({"train": train_round, "problems": list(batch["problem"]),
                               "solutions": list(batch["solution"]), "n": sampling.n,
                               "cand": c})
        return out

    def stepped(*a):
        before, f0 = launch_count.all_thread_counts(), fwd[main]
        t0 = time.perf_counter()
        loss = train_step(*a)
        float(loss)  # the update ends on the host, as the trainer's next line does
        t1 = time.perf_counter()
        after = launch_count.all_thread_counts()
        tally = collections.Counter()
        for ident, c in after.items():
            if ident not in rollout_threads:
                tally += c - before.get(ident, collections.Counter())
        updates.append({"t": (t0, t1), "counts": _kernel_counts(tally),
                        "learner_forwards": fwd[main] - f0})
        return loss

    # an eval round may share the train rounds' shape (phase 10's eval_n is
    # num_candidates): the rounds run inside evaluate() are told apart
    evaluating, evaluate = [False], trainer.evaluate

    def evaluated():
        evaluating[0] = True
        try:
            return evaluate()
        finally:
            evaluating[0] = False

    eng.generate, trainer.train_step, trainer._generate_round = recorded, stepped, round_tags
    trainer.evaluate = evaluated
    sink.log = logged
    initial = [] if trainer._full else _lora_host(trainer.lora)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    k4_plain, k3_plain = [0], [0]
    from distrl_llm_tpu_torch.ops import flash_attention as fa

    try:
        with (counting_plain_calls(fa, "flash_attention_reference", k4_plain),
              counting_plain_calls(_qmm(), "quant_matmul_reference", k3_plain)):
            reset_counts()
            t = time.perf_counter()
            (drive or (lambda tr: tr.train()))(trainer)
            wall = time.perf_counter() - t
            counts = read_counts()
    finally:
        for handle in handles:
            handle.remove()
        eng.generate, trainer.train_step = generate, train_step
        trainer._generate_round, eng.lora_swap_hook = gen_round, swap_hook
        trainer.evaluate = evaluate
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
    reserved = torch.cuda.max_memory_reserved(dev) / 2**30 if cuda else float("nan")
    train_rounds = [r for r in rounds if r["train"]]
    overlap = sum(_overlap_s(r["t"], u["t"]) for r in train_rounds if r["thread"] != main
                  for u in updates)
    stamps = times["records"]
    step_ms = [1e3 * (t1 - t0) for (t0, _), (t1, is_train) in zip(stamps, stamps[1:])
               if is_train]
    return {"trainer": trainer, "label": label, "records": sink.records,
            "adapters": [initial] + sink.adapters, "rounds": rounds,
            "train_rounds": train_rounds, "tagged": tagged, "updates": updates,
            "env_rounds": env_rounds,
            "counts": counts, "wall_s": wall, "peak_gib": peak, "reserved_gib": reserved,
            "overlap_s": overlap, "step_ms": step_ms, "k4_plain": k4_plain[0],
            "k3_plain": k3_plain[0], "captures": eng.decode_graphs.captures,
            "replays": eng.decode_graphs.replays}


def check_overlap_run(out: dict, layers: int, *, steps: int, cuda: bool) -> None:
    """Phase 13's checks of one regime: finite losses and the reference's
    metric names; the adapter within Adam8bit's clip; the versions each
    round sampled (pipelined: round t >= 1 the version t - 1; async: every
    swap a real learner version on a chunk boundary, the tags changing
    exactly there); the buffer's books; each graph key captured at most
    once, by a train round over weights that it or an earlier one read, and
    no more adapters than the ring's buffers; on the card
    each round's and each update's own launches as its counts say, and
    together all the run's."""
    import numpy as np

    from distrl_llm_tpu_torch.rollout import version_tags_for_round

    tr, label = out["trainer"], out["label"]
    cfg = tr.config
    train = [m for _, m in out["records"] if "loss" in m]
    check(len(train) == steps and len(out["updates"]) == steps,
          f"{label}: {len(train)} train records, {len(out['updates'])} updates, want {steps}")
    for m in train:
        check(math.isfinite(m["loss"]), f"{label}: loss {m['loss']}")
        check(TRAIN_METRICS <= set(m), f"{label}: train record lacks {TRAIN_METRICS - set(m)}")
        check(m["rollout_mode"] == cfg.rollout_mode
              and m["max_staleness"] == cfg.allowed_weight_lag, f"{label}: regime fields")
    check_adapter_clip(out["adapters"], cfg.lr, label)
    check(tr.weight_version == steps, f"{label}: weight version {tr.weight_version}")
    tagged = out["tagged"]
    check(len(tagged) == steps, f"{label}: {len(tagged)} tagged train rounds")
    if cfg.rollout_mode == "pipelined":
        bases = [t["base"] for t in tagged]
        check(bases == [max(t - 1, 0) for t in range(steps)] and
              not any(t["events"] for t in tagged),
              f"{label}: the train rounds opened with versions {bases}, want "
              f"{[max(t - 1, 0) for t in range(steps)]} (one step stale, never more)")
    if cfg.rollout_mode == "async":
        # the refill scheduler's chunk: the largest divisor of its host
        # cadence that is <= scan_chunk
        cadence = max(1, min(tr.engine.decode_chunk, 16, cfg.max_new_tokens))
        k = min(tr.engine.scan_chunk, cadence)
        while k > 1 and cadence % k:
            k -= 1
        for t in tagged:
            for step, v in t["events"]:
                check(0 < v <= tr.weight_version, f"{label}: a swap to version {v}")
                check(k <= 1 or step % k == 0, f"{label}: a swap at step {step}, not on a "
                      f"chunk boundary of {k}")
            want = version_tags_for_round(*t["tags"].shape, t["base"], t["events"])
            check(np.array_equal(t["tags"], want), f"{label}: tags do not change exactly at "
                  f"the swap steps {t['events']}")
        swaps = sum(len(t["events"]) for t in tagged)
        check(swaps > 0 if cfg.inflight_weight_updates else swaps == 0,
              f"{label}: {swaps} in-flight swaps landed, inflight_weight_updates "
              f"{cfg.inflight_weight_updates}")
        s = tr._rollout_buffer.stats()
        check(s["total_put"] == s["total_got"] + s["dropped_stale"] + s["dropped_capacity"]
              + s["occupancy"], f"{label}: the buffer's books do not balance: {s}")
    graphed = (cfg.decode_scan_chunk or 0) > 1
    if graphed and cuda:
        # each key is captured at most once over the run (its graph cache
        # keys, from the engine), and a train round captures only keys over
        # weights (the model and an adapter) that it or an earlier train
        # round read: a key's first chunk runs eagerly, so a swap in a
        # round's last chunk leaves its capture to the next round. In all
        # the train rounds read at most the ring's buffers (adapters; in
        # full mode the rollout copies)
        every = [key for r in out["rounds"] for key in r["captured_keys"]]
        check(len(set(every)) == len(every), f"{label}: {len(every) - len(set(every))} "
              f"graph keys were captured twice")
        seen: set = set()
        for i, r in enumerate(out["train_rounds"]):
            seen |= {(r["model_key"], a) for a in r["adapters"]}
            for key in r["captured_keys"]:
                check(any(m in key and a in key for m, a in seen),
                      f"{label}: train round {i} captured a key over weights no train round "
                      f"had read by then")
        captured = sum(len(r["captured_keys"]) for r in out["train_rounds"])
        ring = tr._ring.size if tr._ring is not None else 1
        check(captured <= ring and len(seen) <= ring, f"{label}: {captured} captures over "
              f"{len(seen)} adapters, more than the ring's {ring} buffers")
    if not cuda:
        return
    quant = cfg.base_quant != "none"
    hd = tr.model_cfg.head_dim
    # K4 at head_dim 256 by its route: the prefill at the rollout weights'
    # dtype (bf16), the learner at the trained tree's (full mode: f32)
    for r in out["rounds"]:
        # a preemption's or a turn's resume is a chunked forward: K3, no K4
        prefills = r["model_forwards"] - r["forwards"] - r["resumes"] - r["turn_resumes"]
        want = {**{k["name"]: 0 for k in KERNELS},
                "fused_sample": r["sampler_calls"], "paged_attention": layers * r["forwards"],
                "quant_matmul": 7 * layers * r["model_forwards"] if quant else 0,
                "flash_attention_fwd": layers * prefills,
                **hd256_counts(hd, bf16_fwd=layers * prefills)}
        check(r["counts"] == want, f"{label}: a round's launches {r['counts']}, want {want}")
    for u in out["updates"]:
        mb = u["learner_forwards"]
        routes = (hd256_counts(hd, f32_fwd=2 * layers * mb, f32_bwd=layers * mb) if tr._full
                  else hd256_counts(hd, bf16_fwd=2 * layers * mb, bf16_bwd=layers * mb))
        want = {**{k["name"]: 0 for k in KERNELS},
                "quant_matmul": 2 * 7 * layers * mb if quant else 0,
                "flash_attention_fwd": 2 * layers * mb, "flash_attention_bwd": layers * mb,
                **routes}
        check(mb == cfg.batch_size * cfg.num_candidates // cfg.train_batch_size,
              f"{label}: {mb} learner forwards, want every microbatch")
        check(u["counts"] == want, f"{label}: an update's launches {u['counts']}, want {want}")
    total = {k["name"]: sum(x["counts"][k["name"]] for x in out["rounds"] + out["updates"])
             for k in KERNELS}
    check(out["counts"] == total, f"{label}: launches {out['counts']}, the rounds' and "
          f"updates' own add up to {total}")
    check(out["k4_plain"] == out["k3_plain"] == 0, f"{label}: a plain version ran")


def overlap_trainer(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                    group=QMM_GROUP, hbm_bytes=None, regimes=OVERLAP_REGIMES,
                    **config_kw) -> dict:
    """Phase 13: ``Trainer.train()`` in each regime of ``regimes`` in turn, one
    model quantized once (int4 g64 over random weights from the seed), each
    trainer and its engine dropped before the next; each run checked by
    ``check_overlap_run``, and every regime's first train round equal, bit
    for bit, to the first regime's (the same seed and version 0)."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import quantize_base
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine as trainer_engine

    tok = load_tokenizer(str(tokenizer_dir))
    train, test = overlap_datasets(tok)
    model, _ = make_weights(cfg, device, seed=seed)
    base_kw = dict(seed=seed, quant_group_size=group, learner="grpo", clip_ratio=0.2,
                   lora_dropout=0.0, save_every=0, write_adapter_file=False,
                   checkpoint_dir=None)
    quantize_base(model, "int4", group)
    out = {}
    for label, regime in regimes:
        config = trainer_config(workdir / label, **{**base_kw, **regime, **config_kw})
        engine = trainer_engine(config, model, tok, hbm_bytes=hbm_bytes)
        run = overlap_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                               engine=engine, model=model, sink=sink),
                          label=label)
        steps = len(train["problem"]) // config.batch_size
        check_overlap_run(run, cfg.num_layers, steps=steps, cuda=device == "cuda")
        run.pop("trainer")
        run["config"] = config
        engine.release_decode_graphs()
        out[label] = run
        del engine
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    first = {label: run["train_rounds"][0]["res"] for label, run in out.items()}
    ref_label = next(iter(first))
    check_graph_equal([dict(res=res, what=label) for label, res in first.items()],
                      f"overlap round 0 (the reference: {ref_label})")
    return out


def overlap_lines(out: dict, card: str) -> list[str]:
    import numpy as np

    lines = []
    for label, run in out.items():
        recs = [m for _, m in run["records"] if "loss" in m]
        phases = {k: [1e3 * m[f"timing/{k}_duration"] for m in recs]
                  for k in ("generation", "reward", "update")}
        steps = run["step_ms"]
        lines.append(
            f"overlap {label}: {len(recs)} steps, ms per training step (record to record) "
            f"{', '.join(f'{x:.1f}' for x in steps)}; mean of steps 2-{len(steps)} "
            f"{float(np.mean(steps[1:])):.1f}; timing/generation_duration "
            f"{', '.join(f'{x:.1f}' for x in phases['generation'])}, reward "
            f"{', '.join(f'{x:.1f}' for x in phases['reward'])}, update "
            f"{', '.join(f'{x:.1f}' for x in phases['update'])} ms; generation and update "
            f"overlapped {run['overlap_s']:.3f} s on the host clock; train() "
            f"{run['wall_s']:.1f} s; peak {run['peak_gib']:.2f} GiB allocated, "
            f"{run['reserved_gib']:.2f} reserved; captures {run['captures']}, replays "
            f"{run['replays']}; launches {run['counts']}; {card}")
    return lines


def overlap_phase(cfg, args, card: str, t_start: float) -> list:
    """Phase 13 on the card (see the module's docstring). Returns the launch
    counts of its runs."""
    import tempfile

    import numpy as np
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shallow = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, GRAPH_TRAIN_LAYERS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_overlap_") as tmp:
        work = Path(tmp)
        tok_dir = write_bpe_tokenizer(work / "tokenizer", cfg.vocab_size)
        out = overlap_trainer(shallow, "cuda", seed=args.seed, workdir=work,
                              tokenizer_dir=tok_dir)
    for line in overlap_lines(out, card):
        print(line)
    sync, pipe = out["sync_graphed"], out["pipelined_graphed"]
    print(f"overlap: Trainer.train() at {shallow.num_layers} layers over the int4 g{QMM_GROUP} "
          f"base, refill engine ({TRAIN_SLOTS} slots), GRPO clip 0.2, 4 x 16 x "
          f"{TRAIN_NEW_TOKENS}; graphed pipelined / sync mean step (2-4) "
          f"{np.mean(pipe['step_ms'][1:]) / np.mean(sync['step_ms'][1:]):.3f}, eager "
          f"{np.mean(out['pipelined_eager']['step_ms'][1:]) / np.mean(out['sync_eager']['step_ms'][1:]):.3f}"
          f"; phase 13 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    return [run["counts"] for run in out.values()]


def overlap_rehearsal(workdir) -> dict:
    """Phase 13 at TINY on the CPU (a 1024-token vocabulary for the
    hand-written BPE; 8 new tokens, 8 slots): every regime run and checked
    as on the card, launch counts apart."""
    from distrl_llm_tpu_torch.models.configs import TINY

    cfg = dataclasses.replace(TINY, vocab_size=1024)
    work = Path(workdir)
    tok = write_bpe_tokenizer(work / "tok", cfg.vocab_size)
    return overlap_trainer(cfg, "cpu", seed=0, workdir=work, tokenizer_dir=tok, group=16,
                           hbm_bytes=2**30, max_prompt_tokens=96, max_new_tokens=8,
                           num_candidates=4, topk=4, train_batch_size=4, eval_n=2,
                           max_concurrent_sequences=8, max_lora_rank=4)


# ------------------------------------------------------------------ phase 14
# the two kernel domains the port took last, K3 past rank 64 and K5 past 64
# query rows, through Trainer.train: phase 13's QLoRA configuration (int4
# g64, refill 32 slots, splash, Adam8bit, GRPO clip 0.2, 4 x 16 x 128) at 7
# layers (GRAPH_TRAIN_LAYERS) with max_lora_rank 128, spec_draft 12 (n-gram)
# and decode_scan_chunk 16, the initial eval and two steps (the second
# step's round decodes over a non-zero B); then the refill engine on TINY's
# width with 8 query heads over 1 kv head in f32 at spec_draft 12
DOMAIN_RANK = 128
DOMAIN_DRAFT = 12
DOMAIN_REGIME = dict(rollout_mode="sync", decode_scan_chunk=GRAPH_CHUNK,
                     max_lora_rank=DOMAIN_RANK, spec_draft=DOMAIN_DRAFT, spec_ngram=SPEC_NGRAM)


def _paged_native():
    from distrl_llm_tpu_torch.ops import paged_native

    return paged_native


def verify_geometries() -> set:
    """The (query rows, row tiles, rows a tile, head_dim) K5 launched at
    since ``_paged_native().launch_geometries`` was last cleared."""
    return {g[1:] for g in _paged_native().launch_geometries if g[0] == "paged_verify"}


def check_domain_run(out: dict, layers: int, *, steps: int, cuda: bool) -> None:
    """Phase 14 (a)'s checks: ``steps`` finite losses with the reference's
    metric names, the adapter (rank ``DOMAIN_RANK``) within Adam8bit's clip
    and its B non-zero after the first step, every round speculative; on
    the card each round's and each update's own launches as its counts say
    (K1 per sampler call, K5 and its row tiles per layer per verify forward,
    K2 per layer per drafter forward (none with n-grams), K3 and its rank
    chunks 7 per layer per model forward, K4 per layer per prefill; the
    learner's K3 twice that per forward, K4 twice forward and once
    backward), together all the run's, no plain version, chunks replayed,
    and K5 launched at S·G rows only."""
    tr, label = out["trainer"], out["label"]
    cfg = tr.config
    train = [m for _, m in out["records"] if "loss" in m]
    check(len(train) == steps and len(out["updates"]) == steps,
          f"{label}: {len(train)} train records, {len(out['updates'])} updates, want {steps}")
    for m in train:
        check(math.isfinite(m["loss"]), f"{label}: loss {m['loss']}")
        check(TRAIN_METRICS <= set(m), f"{label}: train record lacks {TRAIN_METRICS - set(m)}")
    check_adapter_clip(out["adapters"], cfg.lr, label)
    check(tr.weight_version == steps, f"{label}: weight version {tr.weight_version}")
    rank = {ab["a"].shape[-1] for ab in tr.lora["layers"].values()}
    check(rank == {DOMAIN_RANK}, f"{label}: adapter ranks {rank}, want {DOMAIN_RANK}")
    b_after = out["adapters"][1][1::2]  # _lora_leaves: each target's a, then its b
    check(all(bool(b.abs().max() > 0) for b in b_after),
          f"{label}: the adapter's B is still zero after step 1")
    check(len(out["train_rounds"]) == steps and all(r["spec"] for r in out["rounds"]),
          f"{label}: {len(out['train_rounds'])} train rounds, want {steps}, all speculative")
    if not cuda:
        return
    rows = (DOMAIN_DRAFT + 1) * (tr.model_cfg.num_heads // tr.model_cfg.num_kv_heads)
    geo = verify_geometries()
    check(len(geo) == 1 and next(iter(geo))[0] == rows, f"{label}: K5 launched at "
          f"(rows, row tiles, rows a tile, head_dim) {geo}, want {rows} rows only")
    for r in out["rounds"]:
        prefills = r["model_forwards"] - r["forwards"] - r["resumes"]
        want = {**{k["name"]: 0 for k in KERNELS},
                "fused_sample": r["sampler_calls"],
                "paged_attention": layers * r["draft_forwards"],
                "paged_verify": layers * r["forwards"],
                "quant_matmul": 7 * layers * r["model_forwards"],
                "flash_attention_fwd": layers * prefills,
                **domain_counts(rank_chunks=7 * layers * r["model_forwards"],
                                row_tiles=layers * r["forwards"])}
        check(r["counts"] == want and r["forwards"] > 0,
              f"{label}: a round's launches {r['counts']}, want {want}")
    for u in out["updates"]:
        mb = u["learner_forwards"]
        want = {**{k["name"]: 0 for k in KERNELS},
                "quant_matmul": 2 * 7 * layers * mb,
                "flash_attention_fwd": 2 * layers * mb, "flash_attention_bwd": layers * mb,
                **domain_counts(rank_chunks=2 * 7 * layers * mb)}
        check(mb == cfg.batch_size * cfg.num_candidates // cfg.train_batch_size,
              f"{label}: {mb} learner forwards, want every microbatch")
        check(u["counts"] == want, f"{label}: an update's launches {u['counts']}, want {want}")
    total = {k["name"]: sum(x["counts"][k["name"]] for x in out["rounds"] + out["updates"])
             for k in KERNELS}
    check(out["counts"] == total, f"{label}: launches {out['counts']}, the rounds' and "
          f"updates' own add up to {total}")
    check(out["k4_plain"] == out["k3_plain"] == 0, f"{label}: a plain version ran")
    check(sum(r["replays"] for r in out["train_rounds"]) > 0, f"{label}: no chunk replayed")


def domain_trainer(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                   group=QMM_GROUP, hbm_bytes=None, **config_kw) -> dict:
    """Phase 14 (a): ``Trainer.train()`` of ``DOMAIN_REGIME`` over phase 13's
    configuration (random weights from the seed quantized to int4 g64,
    phase 8's 8 problems: the initial eval and two steps), run by
    ``overlap_run`` (counts reset around ``train()``, each round's and
    update's own launches) and checked by ``check_domain_run``."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import quantize_base
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine as trainer_engine

    tok = load_tokenizer(str(tokenizer_dir))
    train, test = trainer_datasets(tok)
    model, _ = make_weights(cfg, device, seed=seed)
    quantize_base(model, "int4", group)
    config = trainer_config(workdir, **{
        **dict(seed=seed, quant_group_size=group, learner="grpo", clip_ratio=0.2,
               lora_dropout=0.0, save_every=0, write_adapter_file=False, checkpoint_dir=None),
        **DOMAIN_REGIME, **config_kw})
    engine = trainer_engine(config, model, tok, hbm_bytes=hbm_bytes)
    _paged_native().launch_geometries.clear()
    run = overlap_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                           engine=engine, model=model, sink=sink),
                      label="domains")
    run["geometries"] = verify_geometries()
    check_domain_run(run, cfg.num_layers, steps=len(train["problem"]) // config.batch_size,
                     cuda=device == "cuda")
    run["config"] = config
    engine.release_decode_graphs()
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return run


def domain_exactness(device, seed: int, *, max_new_tokens: int = 32) -> dict:
    """Phase 14 (b): greedy speculative decoding at ``DOMAIN_DRAFT`` emits
    plain refill's tokens where drafts are accepted, K5 at 13 x 8 = 104
    query rows: TINY's width with 8 query heads over 1 kv head, in f32,
    whose greedy streams loop, through phase 7's engine (8 prompts x 2
    candidates, 4 slots, 8-token pages)."""
    import torch

    from distrl_llm_tpu_torch.models.configs import TINY

    cfg = dataclasses.replace(TINY, num_heads=8, num_kv_heads=1)
    weights = make_weights(cfg, device, seed=seed, rank=4, dtype=torch.float32)
    kw = dict(seed=seed, n=2, max_new_tokens=max_new_tokens, slots=4, page_size=8,
              max_prompt_tokens=96)
    _paged_native().launch_geometries.clear()
    spec = spec_round(cfg, device, weights, spec_draft=DOMAIN_DRAFT, kv_quant="none", **kw)
    geo = verify_geometries()
    plain = spec_round(cfg, device, weights, spec_draft=0, kv_quant="none", **kw)
    layers, rows = cfg.num_layers, (DOMAIN_DRAFT + 1) * cfg.num_heads // cfg.num_kv_heads
    check(spec["spec"]["accept_rate"] > 0, "domains (b): no draft accepted")
    check((spec["res"].tokens == plain["res"].tokens).all()
          and (spec["res"].lengths == plain["res"].lengths).all(),
          "domains (b): speculative greedy tokens differ from plain refill's")
    if device == "cuda":
        check_spec_counts(spec, layers)
        check_spec_counts(plain, layers)
        c = spec["counts"]
        check(c["paged_verify_row_tiles"] == c["paged_verify"] > 0
              and plain["counts"]["paged_verify_row_tiles"] == 0,
              f"domains (b): K5's row tiles launched {c['paged_verify_row_tiles']} times of "
              f"K5's {c['paged_verify']}")
        check(len(geo) == 1 and next(iter(geo))[0] == rows,
              f"domains (b): K5 launched at {geo}, want {rows} rows only")
    return {"spec": spec, "plain": plain, "geometries": geo, "rows": rows}


def domain_phase(cfg, args, card: str, t_start: float) -> list:
    """Phase 14 on the card (see the module's docstring). Returns the launch
    counts of its runs."""
    import tempfile

    import numpy as np
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shallow = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, GRAPH_TRAIN_LAYERS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_domains_") as tmp:
        work = Path(tmp)
        tok_dir = write_bpe_tokenizer(work / "tokenizer", cfg.vocab_size)
        a = domain_trainer(shallow, "cuda", seed=args.seed, workdir=work,
                           tokenizer_dir=tok_dir)
    recs = [m for _, m in a["records"] if "loss" in m]
    phases = {k: [1e3 * m[f"timing/{k}_duration"] for m in recs]
              for k in ("generation", "reward", "update")}
    spec = [r["spec"] for r in a["train_rounds"]]
    print(f"domains (a): Trainer.train() at {shallow.num_layers} layers over the int4 "
          f"g{QMM_GROUP} base, rank {DOMAIN_RANK}, spec_draft {DOMAIN_DRAFT} (n-gram), "
          f"decode_scan_chunk {GRAPH_CHUNK}, refill {TRAIN_SLOTS} slots, splash, GRPO, 4 x 16 x "
          f"{TRAIN_NEW_TOKENS}: {len(recs)} steps, losses {[round(m['loss'], 6) for m in recs]}; "
          f"ms per training step (record to record) {', '.join(f'{x:.1f}' for x in a['step_ms'])}"
          f"; timing/generation_duration {', '.join(f'{x:.1f}' for x in phases['generation'])}, "
          f"reward {', '.join(f'{x:.1f}' for x in phases['reward'])}, update "
          f"{', '.join(f'{x:.1f}' for x in phases['update'])} ms; verify forwards "
          f"{[r['forwards'] for r in a['train_rounds']]}, accept rate "
          f"{[round(x['accept_rate'], 4) for x in spec]}; K5 at (rows, row tiles, rows a tile, "
          f"head_dim) {sorted(a['geometries'])}; captures {a['captures']}, replays "
          f"{a['replays']}; peak {a['peak_gib']:.2f} GiB allocated, {a['reserved_gib']:.2f} "
          f"reserved; launches {a['counts']}; {card}")
    b = domain_exactness("cuda", args.seed)
    s = b["spec"]["spec"]
    print(f"domains (b): TINY width, 8/1 heads, f32, spec_draft {DOMAIN_DRAFT}: K5 at "
          f"{sorted(b['geometries'])}; accept rate {s['accept_rate']:.4f}, "
          f"{s['tokens_per_verify_step']:.4f} tokens per verify step; speculative greedy tokens "
          f"equal to plain refill's ({int(np.asarray(b['spec']['res'].lengths).sum())} tokens); "
          f"launches {b['spec']['counts']}")
    print(f"domains: phase 14 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    return [a["counts"], b["spec"]["counts"], b["plain"]["counts"]]


def domain_rehearsal(workdir) -> dict:
    """Phase 14 at TINY on the CPU (a 1024-token vocabulary for the
    hand-written BPE; 8 new tokens, 8 slots): (a) run and checked as on the
    card, launch counts apart, and (b)."""
    from distrl_llm_tpu_torch.models.configs import TINY

    cfg = dataclasses.replace(TINY, vocab_size=1024)
    work = Path(workdir)
    tok = write_bpe_tokenizer(work / "tok", cfg.vocab_size)
    a = domain_trainer(cfg, "cpu", seed=0, workdir=work, tokenizer_dir=tok, group=16,
                       hbm_bytes=2**30, max_prompt_tokens=96, max_new_tokens=8,
                       num_candidates=4, topk=4, train_batch_size=4, eval_n=2,
                       max_concurrent_sequences=8)
    return {"a": a, "b": domain_exactness("cpu", 0, max_new_tokens=16)}


# ---------------------------------------------------------------- phase 15

# multi-turn environments and full fine-tuning under the overlapped modes.
# (a) the verifier environment through Trainer.train(): phase 13's QLoRA
# configuration at GRAPH_TRAIN_LAYERS with env="verifier", continuous
# admission and a window of ENV_NEW_TOKENS that an episode's turns share
ENV_NEW_TOKENS = 256
ENV_TURNS = 3
# random weights almost never sample the tokenizer's one EOS id among
# 152,064, so every candidate would run to its window and each round fall
# back to one turn: the engine's EOS set is also every ENV_EOS_STRIDE-th id
# (a test construction for random weights), which ends a sampled turn after
# about that many tokens
ENV_EOS_STRIDE = 32
ENV_REGIME = dict(env="verifier", max_turns=ENV_TURNS, continuous_admission=True,
                  max_new_tokens=ENV_NEW_TOKENS)
# (b) the KV-exactness pin: full width, EXACT_LAYERS layers, f32, greedy, an
# EOS set of every 4th id, one scripted observation of EXACT_OBS tokens
EXACT_LAYERS = 2
EXACT_EOS_STRIDE = 4
EXACT_PROMPT = 48
EXACT_NEW_TOKENS = 96
EXACT_OBS = 16
EXACT_LOGP_ATOL = 1e-4  # f32 behavior logprobs, paged chunked vs dense attention
# (c) phase 10's full fine-tuning at Gemma-2B width, pipelined and async
FULL_OVERLAP_STEPS = 3
FULL_OVERLAP_LAYERS = FULL_LAYERS
PHASE10_PEAK_GIB = 34.2  # smoke-full-gemma's peak allocated, one rollout copy (PR 12)


@contextlib.contextmanager
def hashed_env_reward():
    """The port's environments with each turn's shaped reward raised by a
    hash of its completion in [0, 1) (``smoke_reward``'s accuracy column):
    random weights format nothing and solve nothing, so every group's
    rewards would be equal, every advantage 0 and every learner microbatch
    skipped. Observations and episode ends are the environments' own (an
    episode whose observation the engine declines keeps its turns' rewards
    and scores accuracy 0)."""
    import zlib

    from distrl_llm_tpu_torch.env import registry

    saved = dict(registry.ENV_REGISTRY)

    def hashed(cls):
        class Hashed(cls):
            def step(self, completion):
                step = super().step(completion)
                step.reward += zlib.crc32(completion.encode("utf-8")) % 1000 / 1000
                return step
        Hashed.name = cls.name
        return Hashed

    for name in ("code", "verifier"):
        registry.ENV_REGISTRY[name] = hashed(saved[name])
    try:
        yield
    finally:
        registry.ENV_REGISTRY.clear()
        registry.ENV_REGISTRY.update(saved)


def env_eos_ids(vocab: int, tokenizer, stride: int) -> list[int]:
    return sorted({tokenizer.eos_token_id, *range(stride - 1, vocab, stride)})


def check_env_run(out: dict, tok) -> dict:
    """Phase 15 (a)'s environment checks over every round (eval and train):
    on every row the loss mask is 1 exactly on the policy's spans, and each
    injected span holds the tokens of the observation the verifier gives
    when the episode is replayed turn by turn; each round's
    ``turn_resumes`` is its granted observations' count and its
    ``turn_prefill_saved_tokens`` the sum over them of the prompt and the
    turns before. Returns turns and resumes by kind of round."""
    import numpy as np

    from distrl_llm_tpu_torch.env import VerifierFeedbackEnv
    from distrl_llm_tpu_torch.tokenizer import encode_fixed

    tr, label = out["trainer"], out["label"]
    cfg, drv = tr.config, tr._env_driver
    check(len(out["env_rounds"]) == len(out["rounds"]),
          f"{label}: {len(out['env_rounds'])} environment rounds of {len(out['rounds'])}")
    stats = {kind: {"turns": [], "resumes": 0, "declined": 0, "saved": 0}
             for kind in ("train", "eval")}
    for er, r in zip(out["env_rounds"], out["rounds"], strict=True):
        c, n = er["cand"], er["n"]
        problems = er["problems"]
        _, mask = encode_fixed(tok, problems + [""] * (cfg.batch_size - len(problems)),
                               cfg.max_prompt_tokens, side="left")
        real_len = mask.sum(axis=-1)
        resumes = saved = 0
        for g, (masks, turns_g, toks_g) in enumerate(zip(c["loss_mask"], c["turns"],
                                                          c["answer_tokens"])):
            for i in range(n):
                row_mask, turns, toks = np.asarray(masks[i]), turns_g[i], np.asarray(toks_g[i])
                want = np.zeros_like(row_mask)
                env = VerifierFeedbackEnv(cfg.format_reward, cfg.max_turns)
                env.reset({"problem": problems[g], "solution": er["solutions"][g]})
                for t in turns:
                    s, e = t["policy_span"]
                    want[s:e] = 1
                    step = env.step(drv._decode(toks[s:e]))
                    if t["env_span"] is None:
                        continue
                    e0, e1 = t["env_span"]
                    obs = drv._encode(step.observation)
                    check(e0 == e and np.array_equal(toks[e0:e1], obs),
                          f"{label}: row {g * n + i}'s injected span {t['env_span']} is not "
                          "the verifier's critique")
                    resumes += 1
                    saved += int(real_len[g]) + e
                check(np.array_equal(row_mask, want), f"{label}: row {g * n + i}'s loss mask "
                      "is not 1 exactly on its policy spans")
                stats["train" if er["train"] else "eval"]["turns"].append(len(turns))
        check(r["turn_resumes"] == resumes and r["turn_saved"] == saved,
              f"{label}: a round's turn_resumes {r['turn_resumes']} and "
              f"turn_prefill_saved_tokens {r['turn_saved']}, want {resumes} and {saved} (the "
              "granted observations, the prompt and the turns before each)")
        kind = stats["train" if er["train"] else "eval"]
        kind["resumes"] += resumes
        kind["saved"] += saved
        kind["declined"] += c["env_stats"].resume_declined
    for kind, st in stats.items():
        mean = float(np.mean(st["turns"]))
        check(mean > 1 and st["resumes"] > 0, f"{label}: {kind} rounds took {mean:.3f} turns "
              f"an episode and {st['resumes']} resumes; want more than one turn")
        st["turns_mean"] = mean
    return stats


def env_trainer(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                group=QMM_GROUP, hbm_bytes=None, chunk: int = GRAPH_CHUNK,
                one_step: bool = False, eos_stride: int = ENV_EOS_STRIDE, label: str = "env",
                **config_kw) -> dict:
    """(a) ``Trainer.train()`` of phase 13's QLoRA configuration (random
    weights from the seed quantized to int4 g64, GRPO clip 0.2, splash,
    refill) with ``ENV_REGIME`` and ``decode_scan_chunk`` ``chunk``, the
    engine's EOS set widened to every ``eos_stride``-th id, run by
    ``overlap_run`` and checked by ``check_overlap_run`` and
    ``check_env_run``. With ``one_step`` a fresh trainer drives the initial
    eval and the first step through its own methods, as ``train()`` does."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import quantize_base
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine as trainer_engine

    tok = load_tokenizer(str(tokenizer_dir))
    train, test = trainer_datasets(tok)
    model, _ = make_weights(cfg, device, seed=seed)
    quantize_base(model, "int4", group)
    config = trainer_config(workdir, **{
        **dict(seed=seed, quant_group_size=group, learner="grpo", clip_ratio=0.2,
               lora_dropout=0.0, save_every=0, write_adapter_file=False, checkpoint_dir=None,
               decode_scan_chunk=chunk), **ENV_REGIME, **config_kw})
    engine = trainer_engine(config, model, tok, hbm_bytes=hbm_bytes)
    engine.eos_ids = torch.tensor(env_eos_ids(cfg.vocab_size, tok, eos_stride),
                                  dtype=torch.int32, device=engine.device)

    def first_step(tr):
        tr.evaluate()
        _, batch = next(tr._episode_batch_stream(0, 0))
        tr._train_batch(batch, 0)
        tr.rewards.close()

    with hashed_env_reward():
        run = overlap_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                               engine=engine, model=model, sink=sink),
                          label=label, drive=first_step if one_step else None)
    steps = 1 if one_step else len(train["problem"]) // config.batch_size
    check_overlap_run(run, cfg.num_layers, steps=steps, cuda=device == "cuda")
    run["env"] = check_env_run(run, tok)
    run["config"] = config
    run.pop("trainer")
    engine.release_decode_graphs()
    del engine, model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return run


def env_graph_eager(cfg, device, **kw) -> dict:
    """(a): the graphed run (the initial eval and two steps), then on a fresh
    trainer from the same seed the eval and first step eager; the eager
    rounds' tokens, lengths, logprobs and loss masks and its loss equal the
    graphed run's."""
    import numpy as np

    g = env_trainer(cfg, device, label="env graphed", **kw)
    e = env_trainer(cfg, device, chunk=0, one_step=True, label="env eager", **kw)
    k = len(e["rounds"])
    for rg, re_, eg, ee in zip(g["rounds"][:k], e["rounds"], g["env_rounds"][:k],
                                e["env_rounds"], strict=True):
        check_graph_equal([dict(res=rg["res"], what="graphed"), dict(res=re_["res"],
                                                                     what="eager")],
                          "env graphed vs eager")
        check(all(np.array_equal(a, b) for a, b in zip(eg["cand"]["loss_mask"],
                                                       ee["cand"]["loss_mask"], strict=True)),
              "env graphed vs eager: loss masks differ")
    lg = [m["loss"] for _, m in g["records"] if "loss" in m]
    le = [m["loss"] for _, m in e["records"] if "loss" in m]
    check(le == lg[:1], f"env graphed vs eager: the first step's loss {le} vs {lg[:1]}")
    return {"graphed": g, "eager": e}


def env_resume_exact(device, seed: int, *, layers: int = EXACT_LAYERS, cfg=None) -> dict:
    """(b) the KV-exactness pin: at full width, ``layers`` layers, f32, one
    prompt, a refill round whose scripted hook grants one observation
    continues exactly as a dense engine's greedy round over the whole
    conversation (prompt, turn 1, observation) as its prompt: the same
    tokens, logprobs within ``EXACT_LOGP_ATOL``, and the logits the resume
    leaves in the slot within ``LOGIT_F32_ATOL`` of the dense forward's.
    ``cfg`` replaces Qwen2.5-7B's width (the CPU rehearsal's)."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.engine import GenerationEngine, PagedGenerationEngine
    from distrl_llm_tpu_torch.engine import paged_engine as tpe
    from distrl_llm_tpu_torch.models.configs import QWEN2_7B

    cfg = dataclasses.replace(cfg or QWEN2_7B, num_layers=layers)
    model, lora = make_weights(cfg, device, seed=seed, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.vocab_size, (1, EXACT_PROMPT)).astype(np.int32)
    mask = np.ones_like(ids)
    scale = 16.0 / 32
    common = dict(eos_token_ids=list(range(0, cfg.vocab_size, EXACT_EOS_STRIDE)),
                  pad_token_id=1, lora_scale=scale, cache_dtype=torch.float32,
                  capture_logprobs=True, device=device)
    refill = PagedGenerationEngine(cfg, max_prompt_tokens=EXACT_PROMPT,
                                   max_new_tokens=EXACT_NEW_TOKENS, page_size=16,
                                   max_concurrent_rows=1, scheduler="refill", **common)
    greedy = SamplingConfig(max_tokens=EXACT_NEW_TOKENS, temperature=0.0, n=1)
    base = refill.generate(model, lora, ids, mask, greedy, seed)
    g1 = int(base.lengths[0, 0])
    gen1 = base.tokens[0, 0, :g1]
    check(g1 + EXACT_OBS + 2 <= EXACT_NEW_TOKENS, f"env exact: turn 1 took {g1} tokens, no "
          "room for the observation")
    # ids one past a multiple of the stride: no EOS among them
    obs = (1 + EXACT_EOS_STRIDE * (8 + np.arange(EXACT_OBS))).astype(np.int32)

    class Grant:
        def __init__(self):
            self.calls = []

        def __call__(self, cand, tokens):
            self.calls.append(len(tokens))
            return obs if len(self.calls) == 1 else None

        def declined(self, cand):
            raise SmokeFailure("env exact: the observation was declined")

    kept = {}
    fixup = tpe._turn_resume_fixup

    def watched(model_, lora_, s, slot, *a, **k):
        fixup(model_, lora_, s, slot, *a, **k)
        kept["logits"] = s.logits[slot].detach().clone()

    refill.turn_hook = Grant()
    tpe._turn_resume_fixup = watched
    reset_counts()
    try:
        res = refill.generate(model, lora, ids, mask, greedy, seed)
    finally:
        tpe._turn_resume_fixup = fixup
        refill.turn_hook = None
    counts = read_counts()
    total, row = int(res.lengths[0, 0]), res.tokens[0, 0]
    stats = refill.last_pool_stats
    check(stats["turn_resumes"] == 1 and stats["turn_prefill_saved_tokens"] == EXACT_PROMPT + g1,
          f"env exact: turn_resumes {stats['turn_resumes']}, saved "
          f"{stats['turn_prefill_saved_tokens']}, want 1 and {EXACT_PROMPT + g1}")
    check(np.array_equal(row[:g1], gen1) and np.array_equal(row[g1:g1 + EXACT_OBS], obs),
          "env exact: turn 1 and the observation are not in the row verbatim")
    start = g1 + EXACT_OBS
    check(total > start, "env exact: nothing was decoded after the observation")
    conv = np.concatenate([ids[0], gen1, obs]).astype(np.int32)[None]
    dense = GenerationEngine(cfg, max_prompt_tokens=conv.shape[1],
                             max_new_tokens=EXACT_NEW_TOKENS - start, **common)
    dres = dense.generate(model, lora, conv, np.ones_like(conv), SamplingConfig(
        max_tokens=EXACT_NEW_TOKENS - start, temperature=0.0, n=1), seed)
    g2 = int(dres.lengths[0, 0])
    check(total - start == g2 and np.array_equal(row[start:total], dres.tokens[0, 0, :g2]),
          f"env exact: the continuation {row[start:total].tolist()} differs from the dense "
          f"round's {dres.tokens[0, 0, :g2].tolist()}")
    logp_err = float(np.abs(res.logprobs[0, 0, start:total] - dres.logprobs[0, 0, :g2]).max())
    check(logp_err <= EXACT_LOGP_ATOL, f"env exact: logprobs differ by {logp_err:.3g} > "
          f"{EXACT_LOGP_ATOL}")
    with torch.no_grad():
        full = model(torch.as_tensor(conv, device=device), lora=lora, lora_scale=scale,
                     logits_slice=(conv.shape[1] - 1, 1))[0][0, 0].float()
    logit_err = float((kept["logits"] - full).abs().max())
    check(logit_err <= LOGIT_F32_ATOL, f"env exact: the resume's logits differ from the dense "
          f"forward's by {logit_err:.3g} > {LOGIT_F32_ATOL}")
    check(device == "cpu" or (counts["paged_attention"] > 0 and counts["fused_sample"] > 0),
          f"env exact: K1/K2 not launched: {counts}")
    return {"turn1": g1, "continuation": g2, "logp_err": logp_err, "logit_err": logit_err,
            "logit_std": float(full.std()), "counts": counts}


def full_overlap_datasets(tokenizer, steps: int):
    """``steps`` batches of 4 of ``OVERLAP_PROBLEMS`` (train) and the first 4
    (eval) through the R1 chat template."""
    from distrl_llm_tpu_torch.data import R1_PREPROMPT, process_dataset

    probs = OVERLAP_PROBLEMS[:4 * steps]
    data = {"problem": [p for p, _ in probs], "solution": [s for _, s in probs]}
    train = process_dataset(tokenizer, data, R1_PREPROMPT, "")
    return train, {k: v[:4] for k, v in train.items()}


def full_overlap_run(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                     mode: str, hbm_bytes=None, steps: int = FULL_OVERLAP_STEPS,
                     **config_kw) -> dict:
    """(c) ``Trainer.train()`` with phase 10's full fine-tuning (random bf16
    weights from the seed), clip 0.2, ``max_staleness`` 2 and
    ``decode_scan_chunk`` 16 under ``rollout_mode`` ``mode`` (``"sync"``:
    only the initial eval and the first round, through the trainer's own
    methods), run by ``overlap_run``; an overlapped run is checked by
    ``check_overlap_run`` and the ring's books: every push wrote a copy no
    round held and that was not the published one, each round read one of
    the ring's two copies (each one graph key), and the published copy
    holds the masters cast to bf16."""
    import torch

    from distrl_llm_tpu_torch.engine.decode_graph import tensors_key
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine

    tok = load_tokenizer(str(tokenizer_dir))
    train, test = full_overlap_datasets(tok, steps)
    model, _ = make_weights(cfg, device, seed=seed)
    config = full_config(workdir, seed=seed, dtype=str(model.embed.dtype).removeprefix("torch."),
                         rollout_mode=mode, clip_ratio=0.2, max_staleness=2,
                         decode_scan_chunk=GRAPH_CHUNK, **config_kw)
    engine = make_engine(config, model, tok, hbm_bytes=hbm_bytes)

    def first_round(tr):
        tr.evaluate()
        _, batch = next(tr._episode_batch_stream(0, 0))
        tr._generate_round(batch, config.train_sampling())
        tr.rewards.close()

    run = overlap_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                           engine=engine, model=model, sink=sink),
                      label=f"full {mode}", drive=first_round if mode == "sync" else None)
    tr = run.pop("trainer")
    run.update(config=config, kv_pages=engine.max_kv_pages)
    if mode != "sync":
        label, ring = run["label"], tr._ring
        check_overlap_run(dict(run, trainer=tr), cfg.num_layers, steps=steps,
                          cuda=device == "cuda")
        check(ring is not None and ring.size == 2 and ring.holds() == [0, 0],
              f"{label}: the ring of rollout copies {ring and ring.holds()}")
        published = None
        for j, version, holds, _events in ring.books:
            check(holds[j] == 0 and j != published, f"{label}: the push of version {version} "
                  f"wrote copy {j} (holds {holds}, published {published})")
            published = j
        check([b[1] for b in ring.books] == list(range(steps + 1)),
              f"{label}: the pushes' versions {[b[1] for b in ring.books]}")
        keys = {tensors_key(b) for b in ring._bufs}
        check(len(keys) == 2 and {r["model_key"] for r in run["rounds"]} <= keys,
              f"{label}: rounds read weights outside the ring's two copies")
        rollout = tr._engine_params()[0]
        check(all(torch.equal(p, m.detach().to(p.dtype)) for p, m in
                  zip(rollout.parameters(), tr.lora.parameters(), strict=True)),
              f"{label}: the published copy is not the masters cast to bf16")
        run["books"] = list(ring.books)
        run["push_waits"] = ring.push_waits
        run["weights_versions"] = [b.weights_version for b in ring._bufs]
    run["rounds_res"] = [r["res"] for r in run["rounds"]]
    for r in run["rounds"]:
        r.pop("res")
    engine.release_decode_graphs()
    del engine, model, tr
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return run


def full_overlap(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                 hbm_bytes=None, steps: int = FULL_OVERLAP_STEPS, **config_kw) -> dict:
    """(c): pipelined, then async, then the sync trainer's eval and first
    round; round 0 (and the eval before it) equal across the three, the
    pipelined rounds opening with versions 0, 0, 1, ..."""
    out = {}
    for mode in ("pipelined", "async", "sync"):
        out[mode] = full_overlap_run(cfg, device, seed=seed, workdir=workdir / mode,
                                     tokenizer_dir=tokenizer_dir, mode=mode,
                                     hbm_bytes=hbm_bytes, steps=steps, **config_kw)
    first = len(out["sync"]["rounds_res"])  # the eval rounds and round 0
    for mode in ("pipelined", "async"):
        for k, (a, b) in enumerate(zip(out[mode]["rounds_res"][:first],
                                       out["sync"]["rounds_res"], strict=True)):
            check_graph_equal([dict(res=b, what="sync"), dict(res=a, what=mode)],
                              f"full {mode} round {k - first + 1 if k >= first - 1 else 'eval'}")
    bases = [t["base"] for t in out["pipelined"]["tagged"]]
    check(bases == [max(t - 1, 0) for t in range(steps)], f"full pipelined: the rounds opened "
          f"with versions {bases}")
    return out


def env_phase(args, card: str, t_start: float) -> list:
    """Phase 15 on the card (see the module's docstring). Returns the launch
    counts of its runs."""
    import tempfile

    import torch

    from distrl_llm_tpu_torch.models.configs import GEMMA_2B, QWEN2_7B

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    qwen = dataclasses.replace(QWEN2_7B, num_layers=GRAPH_TRAIN_LAYERS)
    gemma = dataclasses.replace(GEMMA_2B, num_layers=FULL_OVERLAP_LAYERS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_env_") as tmp:
        work = Path(tmp)
        tok_dir = write_bpe_tokenizer(work / "tokenizer", qwen.vocab_size)
        a = env_graph_eager(qwen, "cuda", seed=args.seed, workdir=work / "a",
                            tokenizer_dir=tok_dir)
        t_a = time.perf_counter() - t0
        b = env_resume_exact("cuda", args.seed)
        t_b = time.perf_counter() - t0 - t_a
        gtok, _ = write_unigram_tokenizer(work / "gemma_tokenizer", gemma.vocab_size)
        c = full_overlap(gemma, "cuda", seed=args.seed, workdir=work / "c", tokenizer_dir=gtok)
        t_c = time.perf_counter() - t0 - t_a - t_b
    for kind in ("graphed", "eager"):
        run = a[kind]
        recs = [m for _, m in run["records"] if "loss" in m]
        phases = {k: [1e3 * m[f"timing/{k}_duration"] for m in recs]
                  for k in ("generation", "reward", "update")}
        env = run["env"]
        print(f"env (a) smoke-env-verifier-qlora {kind}: Trainer.train() at "
              f"{qwen.num_layers} layers over the int4 g{QMM_GROUP} base, env='verifier', "
              f"max_turns {ENV_TURNS}, refill {TRAIN_SLOTS} slots with continuous admission, "
              f"decode_scan_chunk {run['config'].decode_scan_chunk}, GRPO clip 0.2, 4 x 16 x "
              f"{ENV_NEW_TOKENS} (the window an episode's turns share), EOS every "
              f"{ENV_EOS_STRIDE}th id: {len(recs)} steps, losses "
              f"{[round(m['loss'], 6) for m in recs]}; turns an episode train "
              f"{env['train']['turns_mean']:.3f} / eval {env['eval']['turns_mean']:.3f}; "
              f"turn resumes train {env['train']['resumes']} / eval {env['eval']['resumes']}, "
              f"declined {env['train']['declined']} / {env['eval']['declined']}, prompt and "
              f"turn tokens not re-prefilled {env['train']['saved']} / {env['eval']['saved']}; "
              f"env/step_ms_p50 {[round(m.get('env/step_ms_p50', float('nan')), 4) for m in recs]}"
              f"; timing/generation_duration {', '.join(f'{x:.1f}' for x in phases['generation'])}"
              f", reward {', '.join(f'{x:.1f}' for x in phases['reward'])}, update "
              f"{', '.join(f'{x:.1f}' for x in phases['update'])} ms; captures "
              f"{run['captures']}, replays {run['replays']}; peak {run['peak_gib']:.2f} GiB "
              f"allocated; launches {run['counts']}; {card}")
    print(f"env (a): the eager eval and first step equal the graphed ones (tokens, lengths, "
          f"logprobs, loss masks, loss)")
    print(f"env (b) smoke-env-resume-exact: Qwen2.5-7B width, {EXACT_LAYERS} layers, f32, one "
          f"prompt of {EXACT_PROMPT}: turn 1 {b['turn1']} tokens, a {EXACT_OBS}-token "
          f"observation resumed in place, then {b['continuation']} tokens equal to the dense "
          f"engine's greedy round over the whole conversation; logprobs max |d| "
          f"{b['logp_err']:.3g} (tolerance {EXACT_LOGP_ATOL}); the resume's logits vs the dense "
          f"forward's max |d| {b['logit_err']:.3g} (tolerance {LOGIT_F32_ATOL}; logit std "
          f"{b['logit_std']:.4g}); launches {b['counts']}")
    for mode in ("pipelined", "async"):
        run = c[mode]
        recs = [m for _, m in run["records"] if "loss" in m]
        phases = {k: [1e3 * m[f"timing/{k}_duration"] for m in recs]
                  for k in ("generation", "reward", "update")}
        print(f"env (c) smoke-full-gemma-{mode}: Trainer.train() with full_finetune at "
              f"Gemma-2B width ({gemma.num_layers} layers), splash, refill {FULL_SLOTS} slots, "
              f"4 x 4 x {FULL_NEW_TOKENS}, clip 0.2, decode_scan_chunk {GRAPH_CHUNK}: "
              f"{len(recs)} steps, losses {[round(m['loss'], 6) for m in recs]}; rounds opened "
              f"with versions {[t['base'] for t in run['tagged']]}; ring books (copy, version, "
              f"holds at the choice, events waited) {run['books']}, push waits "
              f"{run['push_waits']}, copies' weights_version {run['weights_versions']}; ms per "
              f"training step {', '.join(f'{x:.1f}' for x in run['step_ms'])}; "
              f"timing/generation_duration {', '.join(f'{x:.1f}' for x in phases['generation'])}"
              f", update {', '.join(f'{x:.1f}' for x in phases['update'])} ms; overlap "
              f"{run['overlap_s']:.3f} s; captures {run['captures']}, replays {run['replays']}; "
              f"{run['kv_pages']} KV pages; peak {run['peak_gib']:.2f} GiB allocated, "
              f"{run['reserved_gib']:.2f} reserved (phase 10 at all 18 layers, one rollout "
              f"copy: {PHASE10_PEAK_GIB}); launches {run['counts']}; {card}")
    print(f"env (c): round 0 and the eval before it equal the sync trainer's "
          f"({len(c['sync']['rounds_res'])} rounds)")
    print(f"env: phase 15 {time.perf_counter() - t0:.1f} s ((a) {t_a:.1f}, (b) {t_b:.1f}, (c) "
          f"{t_c:.1f}); total {time.perf_counter() - t_start:.1f} s; {card}")
    return [a["graphed"]["counts"], a["eager"]["counts"], b["counts"],
            c["pipelined"]["counts"], c["async"]["counts"], c["sync"]["counts"]]


def env_rehearsal(workdir) -> dict:
    """Phase 15 at small shapes on the CPU: (a) at TINY's width with a
    1024-token vocabulary (the hand-written BPE), 8 slots, a 192-token
    window, graphed and eager; (b) at TINY's width; (c) on a 2-layer
    Gemma-shaped config; each checked as on the card, launch counts
    apart."""
    from distrl_llm_tpu_torch.models.configs import TINY

    work = Path(workdir)
    cfg = dataclasses.replace(TINY, vocab_size=1024)
    tok = write_bpe_tokenizer(work / "tok", cfg.vocab_size)
    a = env_graph_eager(cfg, "cpu", seed=0, workdir=work / "a", tokenizer_dir=tok, group=16,
                        hbm_bytes=2**30, max_prompt_tokens=96, max_new_tokens=192,
                        num_candidates=4, topk=4, train_batch_size=4, eval_n=2,
                        max_concurrent_sequences=8, max_lora_rank=4, eos_stride=8)
    gemma = dataclasses.replace(cfg, hidden_size=64, intermediate_size=128, num_heads=2,
                                num_kv_heads=1, head_dim=256, tie_word_embeddings=True,
                                hidden_act="gelu_tanh", rmsnorm_offset=True,
                                scale_embeddings=True, attention_bias=False)
    b = env_resume_exact("cpu", 0, cfg=TINY)
    gtok, _ = write_unigram_tokenizer(work / "gtok", gemma.vocab_size)
    c = full_overlap(gemma, "cpu", seed=0, workdir=work / "c", tokenizer_dir=gtok,
                     hbm_bytes=2**30, max_prompt_tokens=256, max_new_tokens=8,
                     max_concurrent_sequences=8, steps=3)
    return {"a": a, "b": b, "c": c}


# ------------------------------------------------------------------ phase 16
# remote rollout workers: phase 13's QLoRA configuration (int4 g64, GRPO clip
# 0.2, rank 32, splash) at 7 layers through Trainer.from_pretrained with
# rollout_workers: two worker processes on the card, each a refill engine
# over the same checkpoint, the adapter over the versioned weight bus
REMOTE_WORKERS = 2
# phase 13's 32 slots split over the workers: each worker's 32 candidates
# (2 prompts x 16) refill 16 slots, as phase 13's 64 refill 32
REMOTE_SLOTS = TRAIN_SLOTS // REMOTE_WORKERS
# each worker's share of the card for its weights and KV pool: ~150 pages of
# 128 tokens beside the int4 base (the round needs 64 private pages), so the
# driver and all eight workers the phase starts fit the card at once
REMOTE_GPU_USAGE = 0.12
REMOTE_GATE_TIMEOUT_S = 600.0
# (label, graphed workers, the regime's config): (a) sync, (b) async with
# in-flight updates, then the GIL measurement: sync and pipelined over eager
# workers. Each run gets a pair of its own (a worker's adapter cache names
# versions, and a second trainer's versions would meet the first's); all
# pairs start together before the first run (the checkpoint's pages are
# shared in the page cache: safetensors_io maps the file) and drain together
# after the last
REMOTE_REGIMES = (
    ("sync", True, dict(rollout_mode="sync")),
    ("async", True, dict(rollout_mode="async", inflight_weight_updates=True, max_staleness=2,
                         rollout_buffer_groups=1)),
    ("sync_eager", False, dict(rollout_mode="sync")),
    ("pipelined_eager", False, dict(rollout_mode="pipelined")),
)


def write_checkpoint(cfg, device, *, seed: int, path: Path, tokenizer_dir: Path) -> int:
    """Random weights from ``seed`` (bf16 on the card, f32 on the CPU)
    written by ``save_hf_checkpoint`` with the tokenizer files; its bytes."""
    import shutil

    import torch

    from distrl_llm_tpu_torch.models.loading import save_hf_checkpoint

    model, _ = make_weights(cfg, device, seed=seed)
    save_hf_checkpoint(model, str(path))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(tokenizer_dir / name, path / name)
    del model
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    return sum(f.stat().st_size for f in path.iterdir())


def worker_command(ckpt: Path, config, *, device: str, graphed: bool, group) -> list[str]:
    """The worker_main command line serving ``config``'s rollout shape over
    ``ckpt``: the refill engine, the int4 base, splash prefills, behavior
    logprobs, scan chunks of 16 when ``graphed``, and on the card a
    ``REMOTE_GPU_USAGE`` share for the page pool."""
    cmd = [sys.executable, "-m", "distrl_llm_tpu_torch.distributed.worker_main", "--port", "0",
           "--serve-model", str(ckpt), "--device", device,
           "--dtype", "bfloat16" if device == "cuda" else "float32",
           "--max-prompt-tokens", str(config.max_prompt_tokens),
           "--max-new-tokens", str(config.max_new_tokens),
           "--lora-rank", str(config.max_lora_rank), "--lora-alpha", str(config.lora_alpha),
           "--base-quant", "int4", "--quant-group-size", str(group),
           "--engine-impl", "paged", "--scheduler", "refill",
           "--max-concurrent-sequences", str(REMOTE_SLOTS), "--attn-impl", config.attn_impl,
           "--capture-logprobs"]
    if graphed:
        cmd += ["--scan-chunk", str(GRAPH_CHUNK)]
    if device == "cuda":
        cmd += ["--gpu-usage", str(REMOTE_GPU_USAGE), "--budget-batch", str(config.batch_size)]
    return cmd


class WorkerPool:
    """Worker processes (``subprocess``, never a fork of this CUDA process),
    started at construction; ``ready()`` waits for each one's ``PORT n``;
    ``drain()`` sends SIGTERM and reads each one's launch counts and peak
    memory; ``kill()`` stops whatever is left. A worker's stderr goes to a
    file of its own."""

    def __init__(self, cmd: list[str], n: int, logdir: Path):
        import os

        logdir.mkdir(parents=True, exist_ok=True)
        self.procs, self.logs, self.addresses, self.stopped = [], [], [], False
        env = {**os.environ, "PYTHONPATH": str(HERE)}
        self.t0 = time.perf_counter()
        try:
            for i in range(n):
                self.logs.append(logdir / f"worker{i}.err")
                with open(self.logs[-1], "w") as err:
                    self.procs.append(subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                        cwd=str(HERE)))
        except BaseException:
            self.kill()
            raise

    def ready(self) -> list[str]:
        """The workers' addresses, once each printed its port."""
        for i, p in enumerate(self.procs[len(self.addresses):], len(self.addresses)):
            line = p.stdout.readline().strip()
            check(line.startswith("PORT "), f"worker {i} did not start: {line!r}; "
                  f"{self.tail(i)}")
            self.addresses.append(f"127.0.0.1:{int(line.split()[1])}")
        self.start_s = time.perf_counter() - self.t0
        return self.addresses

    def tail(self, i: int) -> str:
        try:
            return self.logs[i].read_text()[-2000:]
        except OSError:
            return ""

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def stop(self) -> None:
        """SIGTERM each worker once: a graceful drain (a second SIGTERM may
        land after the drain, at the interpreter's exit)."""
        import signal

        if not self.stopped:
            for p in self.procs:
                p.send_signal(signal.SIGTERM)
            self.stopped = True

    def drain(self) -> list[dict]:
        """``stop()``, then each worker's launch counts by KERNELS name and
        peak GiB (NaN on the CPU) from its last lines; fails unless each
        drained and exited 0."""
        self.stop()
        out = []
        for i, p in enumerate(self.procs):
            stdout, _ = p.communicate(timeout=60)
            lines = stdout.splitlines()
            check(p.returncode == 0 and "DRAINED" in lines, f"worker {i} did not drain "
                  f"(exit {p.returncode}): {stdout[-500:]!r}; {self.tail(i)}")
            launches = json.loads(next(x for x in lines if x.startswith("LAUNCHES "))[9:])
            peak = next((float(x.split()[1]) for x in lines if x.startswith("PEAK_GIB ")),
                        float("nan"))
            out.append({"counts": {k["name"]: launches[f"{k['module']}.{k['counter']}"]
                                   for k in KERNELS}, "peak_gib": peak})
        return out

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            if p.stdout is not None:
                p.stdout.close()


def fix_push_schedule(trainer, *, steps: int) -> None:
    """(b)'s schedule, fixed so that an in-flight push lands inside a worker
    round, early enough to change its tags (the async producer would
    otherwise finish a round before the update that follows it ends, and a
    push takes hundreds of ms to encode, send and decode): train round t >=
    1 enters the engine once update t - 1's train step has finished, so it
    opens with version t - 1; that update's push of version t starts as the
    round is about to dispatch, and the round's shards go out once the bus
    has encoded the push. The push then lands while the workers decode."""
    import threading as _threading

    eng = trainer.engine
    generate, dispatch, push = eng.generate, eng.driver.dispatch_objects, trainer._push_weights
    encode = eng.bus._encoded
    calls, sent = [0], [0]  # the initial eval's round is call 0
    learner_done, round_out, encoded = ([_threading.Event() for _ in range(steps)]
                                        for _ in range(3))

    def gen(*a, **kw):
        t = calls[0] - 1
        calls[0] += 1
        if 1 <= t < steps:
            check(learner_done[t - 1].wait(REMOTE_GATE_TIMEOUT_S),
                  f"round {t}: update {t - 1} never finished")
        return generate(*a, **kw)

    def dispatched(*a, **kw):
        t = sent[0] - 1
        sent[0] += 1
        if 1 <= t < steps:
            round_out[t].set()
            check(encoded[t].wait(REMOTE_GATE_TIMEOUT_S), f"the push of v{t} never encoded")
        return dispatch(*a, **kw)

    def encoded_once(tree, version, base):
        out = encode(tree, version, base)
        if 1 <= version < steps:
            encoded[version].set()
        return out

    def pushed():
        v = trainer.weight_version  # the version this push publishes
        if 1 <= v < steps:
            learner_done[v - 1].set()
            check(round_out[v].wait(REMOTE_GATE_TIMEOUT_S), f"round {v} never went out")
        push()

    eng.generate, eng.driver.dispatch_objects, trainer._push_weights = gen, dispatched, pushed
    eng.bus._encoded = encoded_once


def remote_run(build, *, label: str, schedule=None) -> dict:
    """``build(sink)`` makes a ``Trainer`` over a ``RemoteEngine``; this runs
    its ``train()`` with the counts reset just before and read just after,
    recording each remote round (its inputs, result and per-shard worker
    stats, the version it dispatched), each train round's version tags and
    swaps, the learner's forwards (the driver's only kernel launches), each
    train record's host time, the weight bus's broadcasts and the driver's
    peak memory. ``schedule(trainer)``, when given, installs a fixed
    schedule first."""
    import numpy as np
    import torch

    cell = []
    sink = _StepSink(cell)
    trainer = build(sink)
    cell.append(trainer)
    if schedule is not None:
        schedule(trainer)
    eng, model = trainer.engine, trainer.model
    dev = model.embed.device
    cuda = dev.type == "cuda"
    learner = [0]

    def hook(*_):
        learner[0] += 1

    handle = model.register_forward_hook(hook)
    rounds, tagged, stamps = [], [], []
    generate, gen_round, log = eng.generate, trainer._generate_round, sink.log

    def recorded(*a, **kw):
        state = eng._bus_state
        t0 = time.perf_counter()
        res = generate(*a, **kw)
        rounds.append({"t": (t0, time.perf_counter()), "ids": a[2], "mask": a[3],
                       "sampling": a[4], "res": res,
                       "shards": [dict(m) for m in eng.last_shard_meta],
                       "lora_np": state[1] if state else None,
                       "version": state[2] if state else None})
        return res

    def round_tags(batch, sampling):
        out = gen_round(batch, sampling)
        c = out[0]
        if sampling.n == trainer.config.num_candidates and "base_version" in c:
            tagged.append({"base": c["base_version"], "events": list(c["swap_events"]),
                           "tags": np.asarray(c["version_tags"][0])})
        return out

    def logged(metrics, step):
        stamps.append((time.perf_counter(), "loss" in metrics))
        log(metrics, step)

    eng.generate, trainer._generate_round, sink.log = recorded, round_tags, logged
    initial = _lora_host(trainer.lora)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        reset_counts()
        t = time.perf_counter()
        trainer.train()
        wall = time.perf_counter() - t
        counts = read_counts()
    finally:
        handle.remove()
        eng.generate, trainer._generate_round = generate, gen_round
    acked = eng.bus.flush(60.0) if eng.bus is not None else True
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
    step_ms = [1e3 * (t1 - t0) for (t0, _), (t1, is_train) in zip(stamps, stamps[1:])
               if is_train]
    return {"trainer": trainer, "label": label, "records": sink.records,
            "adapters": [initial] + sink.adapters, "rounds": rounds, "tagged": tagged,
            "counts": counts, "wall_s": wall, "peak_gib": peak, "step_ms": step_ms,
            "learner_forwards": learner[0], "flushed": acked,
            "broadcasts": list(eng.bus.history) if eng.bus is not None else []}


def worker_rounds(out: dict) -> dict[str, list[dict]]:
    """Each worker's round stats over a run's rounds, by its address."""
    by: dict[str, list[dict]] = {}
    for r in out["rounds"]:
        for shard in r["shards"]:
            check(shard["worker"] is not None and shard["round_stats"] is not None,
                  f"{out['label']}: a shard came back from no worker")
            by.setdefault(shard["worker"], []).append(shard["round_stats"])
    return by


def worker_want(stats: list[dict], layers: int) -> dict[str, int]:
    """What a worker's rounds dispatched: K1 per sampler call, K2 per layer
    per decode forward, K3 7 per layer per model forward (the int4 base),
    K4 forward per layer per splash prefill."""
    decode = sum(s["decode_forwards"] for s in stats)
    model = sum(s["model_forwards"] for s in stats)
    prefills = sum(s["model_forwards"] - s["decode_forwards"] - s["resumes"] for s in stats)
    want = {k["name"]: 0 for k in KERNELS}
    want.update(fused_sample=sum(s["sampler_calls"] for s in stats),
                paged_attention=layers * decode, quant_matmul=7 * layers * model,
                flash_attention_fwd=layers * prefills)
    return want


def check_remote_run(out: dict, layers: int, *, steps: int, workers: int, cuda: bool) -> None:
    """A run over the workers: ``steps`` finite losses and the reference's
    metric names, the adapter within Adam8bit's clip; every broadcast acked
    by every worker, each worker holding the last version with the
    driver's checksum; the deltas smaller than the first (full) push; no
    shard resubmitted, retried or lost, both workers healthy; on the card
    the driver's launches as its learner dispatched (K3 7 x layers and K4
    per layer twice per learner forward, K4 backward once), no K1 or K2."""
    from distrl_llm_tpu_torch.distributed.weight_bus import checksum_tree

    tr, label = out["trainer"], out["label"]
    eng = tr.engine
    train = [m for _, m in out["records"] if "loss" in m]
    check(len(train) == steps, f"{label}: {len(train)} train records, want {steps}")
    for m in train:
        check(math.isfinite(m["loss"]), f"{label}: loss {m['loss']}")
        check(TRAIN_METRICS <= set(m), f"{label}: train record lacks {TRAIN_METRICS - set(m)}")
        for key in ("cp/resubmits", "cp/retries", "cp/degraded_groups", "cp/poison_shards"):
            check(not m.get(key), f"{label}: {key} {m.get(key)}")
    check(tr.weight_version == steps, f"{label}: weight version {tr.weight_version}")
    check_adapter_clip(out["adapters"], tr.config.lr, label)
    check(eng.driver.num_healthy == workers, f"{label}: {eng.driver.num_healthy} healthy "
          f"workers, want {workers}")
    check(out["flushed"], f"{label}: the weight bus did not drain")
    b = out["broadcasts"]
    check([x["version"] for x in b] == list(range(steps + 1)),
          f"{label}: broadcasts of versions {[x['version'] for x in b]}")
    for x in b:
        check(len(x["acked"]) == workers, f"{label}: v{x['version']} acked by {x['acked']}")
        check(set(x["modes"].values()) == {"full" if x["version"] == 0 else "delta"},
              f"{label}: v{x['version']} went as {x['modes']}")
    full = min(b[0]["bytes"].values())
    check(all(n < full for x in b[1:] for n in x["bytes"].values()),
          f"{label}: a delta was no smaller than the full push ({full} bytes)")
    for addr in eng.driver.addresses:
        check(eng.bus.acked_version(addr) == steps, f"{label}: {addr} acked "
              f"v{eng.bus.acked_version(addr)}")
    debug = eng.driver.dispatch_objects([("weights_debug", None)] * workers)
    want = checksum_tree(eng._bus_state[1])
    for d in debug:
        check(d["current"] == steps and d["checksums"][steps] == want,
              f"{label}: a worker holds {d}, the driver's v{steps} checksum is {want}")
    out["checksum"] = want
    if not cuda:
        return
    lf = out["learner_forwards"]
    check(lf == steps * tr.config.batch_size * tr.config.num_candidates
          // tr.config.train_batch_size, f"{label}: {lf} learner forwards")
    c = out["counts"]
    wantd = {k["name"]: 0 for k in KERNELS}
    wantd.update(quant_matmul=7 * layers * 2 * lf, flash_attention_fwd=layers * 2 * lf,
                 flash_attention_bwd=layers * lf)
    check(c == wantd, f"{label}: the driver's launches {c}, want {wantd} ({lf} learner forwards)")


def check_inflight_swap(out: dict, cuda: bool) -> dict:
    """(b): a push landed inside a worker's round (on the card a graphed
    one) on a chunk boundary after step 0, and the round's version tags
    changed to that version exactly there."""
    import numpy as np

    label = out["label"]
    found = None
    for r, t in zip([r for r in out["rounds"] if r["sampling"].n ==
                     out["trainer"].config.num_candidates], out["tagged"]):
        steps = r["res"].tokens.shape[-1]
        for step, v in t["events"]:
            if 0 < step and step + 1 < steps:
                graphed = [s["round_stats"].get("graph_steps", 0) for s in r["shards"]]
                if cuda:
                    check(all(g > 0 for g in graphed), f"{label}: the round that swapped "
                          f"at {step} was not graphed ({graphed})")
                check(step % GRAPH_CHUNK == 0 or not cuda,
                      f"{label}: swap at {step}, not on a chunk boundary")
                want = np.where(np.arange(steps) <= step, t["base"], v)
                check(np.array_equal(t["tags"][0], want),
                      f"{label}: tags {t['tags'][0]} do not change to v{v} at {step}")
                found = {"step": step, "version": v, "base": t["base"], "graph_steps": graphed}
    check(found is not None or not cuda,
          f"{label}: no in-flight swap landed inside a round (events "
          f"{[t['events'] for t in out['tagged']]})")
    return found or {}


def eval_against_in_process(out: dict, cfg, device, *, pad: int, scan_chunk) -> dict:
    """The eval round's greedy tokens against an in-process refill engine
    built as the workers build theirs (the trainer's int4 base, the
    round's adapter, the same page pool, shard by shard: the same kernels
    over the same rows in the same order)."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.engine import PagedGenerationEngine
    from distrl_llm_tpu_torch.engine.budget import kv_pool_pages, tree_bytes
    from distrl_llm_tpu_torch.models.convert import lora_from_numpy
    from distrl_llm_tpu_torch.models.lora import lora_scale
    from distrl_llm_tpu_torch.ops.paged import DEFAULT_PAGE_SIZE

    tr = out["trainer"]
    c, r = tr.config, out["rounds"][0]
    check(r["sampling"].temperature == 0.0, "the eval round is not greedy")
    cuda = str(device).startswith("cuda")
    pages = kv_pool_pages(cfg, gpu_usage=REMOTE_GPU_USAGE, param_bytes=tree_bytes(tr.model),
                          batch_prompts=c.batch_size, max_prompt_tokens=c.max_prompt_tokens,
                          max_new_tokens=c.max_new_tokens, page_size=DEFAULT_PAGE_SIZE,
                          device=device) if cuda else 0
    eng = PagedGenerationEngine(
        cfg, max_prompt_tokens=c.max_prompt_tokens, max_new_tokens=c.max_new_tokens,
        eos_token_ids=tr.engine.eos_token_ids, pad_token_id=pad,
        lora_scale=lora_scale(c.max_lora_rank, c.lora_alpha),
        cache_dtype=tr.model.embed.dtype, attn_impl=c.attn_impl, scheduler="refill",
        max_concurrent_rows=REMOTE_SLOTS, max_kv_pages=pages, capture_logprobs=True,
        scan_chunk=scan_chunk, device=device)
    lora = lora_from_numpy(r["lora_np"], cfg, device=device)
    toks = []
    for shard in r["shards"]:
        lo, hi = shard["rows"]
        res = eng.generate(tr.model, lora, r["ids"][lo:hi], r["mask"][lo:hi], r["sampling"], 0)
        toks.append(res.tokens)
    got = np.concatenate(toks)
    same = got == r["res"].tokens
    check(same.all(), f"the eval round's tokens differ from the in-process engine's on "
          f"{int((~same).sum())} of {same.size} positions")
    eng.release_decode_graphs()
    del eng, lora
    if cuda:
        torch.cuda.empty_cache()
    return {"rows": got.shape[0] * got.shape[1], "positions": same.size}


def remote_trainer(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path,
                   group=QMM_GROUP, regimes=REMOTE_REGIMES, **config_kw) -> dict:
    """Phase 16: a checkpoint written once, a pair of worker processes for
    each regime of ``regimes`` (all started together), then each regime
    over its pair: the first through ``Trainer.from_pretrained``
    with ``rollout_workers``, the rest over the base it loaded; each run
    checked by ``check_remote_run``, (a)'s eval round against an in-process
    engine, (b)'s in-flight swap; each pair drained and its launches held
    to its rounds."""
    import torch

    from distrl_llm_tpu_torch.tokenizer import load_tokenizer

    ckpt = workdir / "hf"
    t = time.perf_counter()
    nbytes = write_checkpoint(cfg, device, seed=seed, path=ckpt, tokenizer_dir=tokenizer_dir)
    write_s = time.perf_counter() - t
    tok = load_tokenizer(str(ckpt))
    train, test = trainer_datasets(tok)
    cuda = str(device).startswith("cuda")
    out: dict = {"ckpt_bytes": nbytes, "write_s": write_s, "runs": {}}
    shapes, pools = {}, {}
    try:
        for label, graphed, regime in regimes:
            kw = dict(seed=seed, quant_group_size=group, learner="grpo", clip_ratio=0.2,
                      lora_dropout=0.0, save_every=0, write_adapter_file=False,
                      checkpoint_dir=None, engine_impl="dense", continuous_batching=False,
                      max_concurrent_sequences=0, eval_temperature=0.0,
                      workers_capture_logprobs=True, weight_bus="broadcast", dtype=(
                          "bfloat16" if cuda else "float32"))
            shapes[label] = trainer_config(workdir / label, **{**kw, **regime, **config_kw})
            pools[label] = WorkerPool(
                worker_command(ckpt, shapes[label], device=device, graphed=graphed,
                               group=group), REMOTE_WORKERS, workdir / label / "logs")
        t = time.perf_counter()
        for pool in pools.values():
            pool.ready()
        out["start_s"] = time.perf_counter() - t
        model = None  # the first regime's from_pretrained loads it; the rest reuse it
        for label, graphed, _ in regimes:
            out["runs"][label] = run = _remote_regime(
                label, graphed, shapes[label], pools[label], train=train, test=test, tok=tok,
                ckpt=ckpt, cfg=cfg, device=device, model=model)
            model = run.pop("model")
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        t = time.perf_counter()
        for pool in pools.values():
            pool.stop()
        for label, run in out["runs"].items():
            _check_workers(run, pools[label], cfg.num_layers, cuda)
        out["drain_s"] = time.perf_counter() - t
    finally:
        for pool in pools.values():
            pool.kill()
    return out


def _check_workers(run: dict, pool: WorkerPool, layers: int, cuda: bool) -> None:
    """A regime's workers drained: every worker served rounds, and on the
    card each one's launches equal what its rounds dispatched."""
    label = run["label"]
    run["workers"] = pool.drain()
    run.pop("driver").shutdown()
    by = worker_rounds(run)
    check(sorted(by) == sorted(pool.addresses), f"{label}: rounds came from {sorted(by)}, "
          f"not from every worker {pool.addresses}")
    if not cuda:
        return
    for addr, w in zip(pool.addresses, run["workers"]):
        want = worker_want(by[addr], layers)
        check(w["counts"] == want, f"{label}: worker {addr} launched {w['counts']}, its "
              f"rounds dispatched {want}")
        check(want["fused_sample"] > 0 and want["quant_matmul"] > 0,
              f"{label}: worker {addr} decoded nothing")


def _remote_regime(label: str, graphed: bool, shape, pool: WorkerPool, *, train, test, tok,
                   ckpt: Path, cfg, device, model=None) -> dict:
    """One regime of phase 16 over its ready pair (see ``remote_trainer``):
    ``Trainer.from_pretrained``, or with ``model`` (the int4 base an
    earlier regime's from_pretrained loaded; the learner trains only the
    adapter) the ``Trainer`` over ``trainer.remote_engine``."""
    from distrl_llm_tpu_torch.trainer import Trainer, remote_engine

    cuda = str(device).startswith("cuda")
    config = dataclasses.replace(shape, rollout_workers=tuple(pool.addresses))
    steps = len(train["problem"]) // config.batch_size

    def build(sink):
        if model is None:
            return Trainer.from_pretrained(train, test, smoke_reward, config,
                                           checkpoint_path=str(ckpt), tokenizer=tok, sink=sink,
                                           device=device)
        return Trainer(train, test, smoke_reward, config, tokenizer=tok,
                       engine=remote_engine(config, tok), model=model, sink=sink)

    run = remote_run(
        build,
        label=label, schedule=(lambda tr: fix_push_schedule(tr, steps=steps))
        if config.rollout_mode == "async" else None)
    check(pool.alive(), f"{label}: a worker died: {pool.tail(0)} {pool.tail(1)}")
    check_remote_run(run, cfg.num_layers, steps=steps, workers=REMOTE_WORKERS,
                     cuda=cuda)
    if config.rollout_mode == "async":
        run["swap"] = check_inflight_swap(run, cuda)
    if label == "sync":
        run["eval"] = eval_against_in_process(
            run, cfg, device, scan_chunk=GRAPH_CHUNK if graphed else None,
            pad=tok.pad_token_id if tok.pad_token_id is not None else tok.eos_token_id)
    run["start_s"], run["graphed"], run["config"] = pool.start_s, graphed, config
    trainer = run.pop("trainer")
    run["model"], run["driver"] = trainer.model, trainer.engine.driver
    return run


def remote_lines(out: dict, card: str) -> list[str]:
    lines = []
    for label, run in out["runs"].items():
        recs = [m for _, m in run["records"] if "loss" in m]
        ph = {k: [1e3 * m[f"timing/{k}_duration"] for m in recs]
              for k in ("generation", "reward", "update")}
        b = run["broadcasts"]
        full = [n for x in b if x["version"] == 0 for n in x["bytes"].values()]
        delta = [n for x in b[1:] for n in x["bytes"].values()]
        kind = "graphed, scan chunk 16" if run["graphed"] else "eager"
        if run["config"].rollout_mode == "async":
            kind += "; steps under the phase's fixed push schedule"
        lines.append(
            f"remote {label}: {REMOTE_WORKERS} worker processes ({kind}; ready "
            f"{run['start_s']:.1f} s after they started), rollout_mode "
            f"{run['config'].rollout_mode}: "
            f"{len(recs)} steps, ms per training step (record to record) "
            f"{', '.join(f'{x:.1f}' for x in run['step_ms'])}; timing/generation_duration "
            f"{', '.join(f'{x:.1f}' for x in ph['generation'])}, reward "
            f"{', '.join(f'{x:.1f}' for x in ph['reward'])}, update "
            f"{', '.join(f'{x:.1f}' for x in ph['update'])} ms; train() {run['wall_s']:.1f} s; "
            f"losses {[round(m['loss'], 6) for m in recs]}; {card}")
        lines.append(
            f"remote {label}: weight bus: full push {full} bytes a worker in "
            f"{b[0]['ms']:.1f} ms; deltas {delta} bytes a worker in "
            f"{', '.join(f'{x['ms']:.1f}' for x in b[1:])} ms (push to last ack); leaf "
            f"encodings by version {[next(iter(x['leaf_modes'].values())) for x in b]}; every "
            f"version acked by both workers, checksum {run['checksum']:#x} on both; {card}")
        pools = [s["round_stats"] for r in run["rounds"] for s in r["shards"]
                 if s["round_stats"].get("pool_pages") is not None]  # refill rounds
        lines.append(
            f"remote {label}: {len(pools)} refill shard rounds, page pools "
            f"{sorted({p['pool_pages'] for p in pools})} pages, peak used "
            f"{max((p['peak_pages_used'] for p in pools), default=0)}, preemptions "
            f"{sum(p['preemptions'] for p in pools)}; peak GiB allocated: driver "
            f"{run['peak_gib']:.2f}, workers "
            f"{', '.join(f'{w['peak_gib']:.2f}' for w in run['workers'])}; launches: driver "
            f"{run['counts']}, workers {[w['counts'] for w in run['workers']]}; {card}")
        if "eval" in run:
            lines.append(f"remote {label}: the eval round's greedy tokens equal an in-process "
                         f"refill engine's over the same weights, shard by shard "
                         f"({run['eval']['positions']} positions)")
        if run.get("swap"):
            s = run["swap"]
            lines.append(f"remote {label}: in-flight swap to v{s['version']} at decode step "
                         f"{s['step']} of a graphed worker round (graph steps {s['graph_steps']})"
                         f", tags v{s['base']} before it and v{s['version']} from it; {card}")
    runs = out["runs"]
    if "sync_eager" in runs and "pipelined_eager" in runs:
        # whole runs: in a run this short the pipelined mode's last step
        # only updates (its round went out during the step before)
        se, pe = runs["sync_eager"], runs["pipelined_eager"]
        lines.append(f"remote GIL: eager workers, pipelined / sync train() wall "
                     f"{pe['wall_s'] / se['wall_s']:.3f} ({pe['wall_s']:.1f} s / "
                     f"{se['wall_s']:.1f} s, each the eval and {len(se['step_ms'])} steps; ms "
                     f"per step pipelined {', '.join(f'{x:.1f}' for x in pe['step_ms'])}, "
                     f"sync {', '.join(f'{x:.1f}' for x in se['step_ms'])}; measured, not "
                     f"claimed); {card}")
    return lines


def remote_phase(cfg, args, card: str, t_start: float) -> list:
    """Phase 16 on the card (see the module's docstring). Returns the launch
    counts of the driver's runs and of every worker."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shallow = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, GRAPH_TRAIN_LAYERS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remote_") as tmp:
        work = Path(tmp)
        tok_dir = write_bpe_tokenizer(work / "tokenizer", cfg.vocab_size)
        out = remote_trainer(shallow, "cuda", seed=args.seed, workdir=work,
                             tokenizer_dir=tok_dir)
    print(f"remote: a {shallow.num_layers}-layer Qwen2.5-7B-wide bf16 checkpoint of "
          f"{out['ckpt_bytes'] / 1e9:.2f} GB written in {out['write_s']:.1f} s; "
          f"{len(out['runs']) * REMOTE_WORKERS} worker processes up in {out['start_s']:.1f} s and "
          f"drained in {out['drain_s']:.1f} s; "
          f"Trainer.from_pretrained with rollout_workers, int4 g{QMM_GROUP} base, GRPO clip 0.2, "
          f"4 x 16 x {TRAIN_NEW_TOKENS}, each worker a refill engine of {REMOTE_SLOTS} slots "
          f"with a {REMOTE_GPU_USAGE} share of the card; {card}")
    for line in remote_lines(out, card):
        print(line)
    print(f"remote: phase 16 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    counts = []
    for run in out["runs"].values():
        counts.append(run["counts"])
        counts += [w["counts"] for w in run["workers"]]
    return counts


def remote_rehearsal(workdir) -> dict:
    """Phase 16 at TINY's width with a 1024-token vocabulary on the CPU
    (8 new tokens, f32, worker processes on the CPU): every regime run and
    checked as on the card, launch counts and the in-flight swap apart."""
    from distrl_llm_tpu_torch.models.configs import TINY

    cfg = dataclasses.replace(TINY, vocab_size=1024)
    work = Path(workdir)
    tok = write_bpe_tokenizer(work / "tok", cfg.vocab_size)
    return remote_trainer(cfg, "cpu", seed=0, workdir=work, tokenizer_dir=tok, group=16,
                          max_prompt_tokens=96, max_new_tokens=8,
                          num_candidates=4, topk=4, train_batch_size=4, eval_n=2,
                          max_lora_rank=4)


# ------------------------------------------------------------------ phase 17

# learners sharded over ranks (ROADMAP item 10a) on the one card, in a child
# process whose one-rank process group runs over NCCL (the group must not
# outlive the phase in this process): (a) phase 13 (a)'s QLoRA cell with the
# learner mesh against the same run without a group, (b) the cell with
# engine_impl="paged_sharded", (c) full fine-tuning at Llama-3-8B width
MESH_FULL_LAYERS = 4  # of Llama-3-8B's 32: about 1.9 B parameters
MESH_TIMEOUT_S = 900


def mesh_qlora(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path, meshes,
               label: str, group=QMM_GROUP, hbm_bytes=None, **config_kw) -> dict:
    """(a) and (b): ``Trainer.train()`` of phase 13 (a)'s configuration (int4
    g64, GRPO clip 0.2, rank 32, splash, 4 x 16 x 128, the initial eval and 2
    steps, decode chunks of 16 graphed) over ``meshes`` (None: no process
    group), checked by ``check_trainer_run``; keeps the eval round's inputs
    (the adapter copied) for (b)'s comparison."""
    import torch

    from distrl_llm_tpu_torch.ops.quant import quantize_base
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine

    tok = load_tokenizer(str(tokenizer_dir))
    train, test = trainer_datasets(tok)
    model, _ = make_weights(cfg, device, seed=seed)
    quantize_base(model, "int4", group)
    config = trainer_config(workdir / label, seed=seed, quant_group_size=group, learner="grpo",
                            clip_ratio=0.2, save_every=0, write_adapter_file=False,
                            checkpoint_dir=None, rollout_mode="sync",
                            decode_scan_chunk=GRAPH_CHUNK, **config_kw)
    engine = make_engine(config, model, tok, hbm_bytes=hbm_bytes, meshes=meshes)
    first, generate = [], engine.generate

    def keep_first(model_, lora, *rest):
        if not first:
            first.append((model_, {"layers": {t: {k: x.detach().clone() for k, x in ab.items()}
                                              for t, ab in lora["layers"].items()}}, *rest))
        return generate(model_, lora, *rest)

    engine.generate = keep_first
    out = trainer_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                           engine=engine, model=model, sink=sink,
                                           meshes=meshes), label=label)
    check_trainer_run(out, cfg.num_layers, steps=2, lr=config.lr, cuda=device == "cuda")
    out.update(eval_args=first[0], config=config, tok=tok)
    if device == "cuda":
        torch.cuda.synchronize()
    return out


def _record_values(records) -> list:
    """Each record's values but its times and rates."""
    return [(step, {k: v for k, v in m.items() if not k.startswith(("timing/", "engine/"))})
            for step, m in records]


def check_mesh_plain(plain: dict, mesh: dict) -> None:
    """(a): the mesh run's records and its adapter after each step equal the
    run without a process group, bit for bit (one rank: every gather and
    every merge is a copy)."""
    import torch

    check(_record_values(mesh["records"]) == _record_values(plain["records"]),
          "(a) the records over the learner mesh differ from the run without a group")
    for i, (a, b) in enumerate(zip(mesh["adapters"], plain["adapters"], strict=True)):
        check(all(torch.equal(x, y) for x, y in zip(a, b, strict=True)),
              f"(a) the adapter after step {i} over the learner mesh differs")


def save_state(tr, directory: Path) -> tuple[bytes, float]:
    """``tr.save_checkpoint()`` into ``directory`` (the trainer's own save
    path; over a learner mesh gathered a member at a time): the file's bytes
    and the save's ms."""
    from distrl_llm_tpu_torch.checkpoint import CheckpointManager

    tr.ckpt = CheckpointManager(str(directory))
    t = time.perf_counter()
    tr.save_checkpoint()
    ms = 1e3 * (time.perf_counter() - t)
    return Path(tr.ckpt.path(tr.total_batch_steps)).read_bytes(), ms


def _state_equal(a: dict, b: dict) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def check_mesh_checkpoint(tr, plain_file: bytes, directory: Path) -> dict:
    """(a): the learner mesh's checkpoint is byte for byte the run's without
    a group; then the trained shards zeroed and resumed from it (each rank
    reading its ranges of the file, memory-mapped) hold the saved state
    again."""
    import torch

    data, save_ms = save_state(tr, directory)
    check(data == plain_file,
          "(a) the checkpoint over the learner mesh differs from the run's without a group")
    before = tr._state_tree()
    with torch.no_grad():
        for p in tr.lora.trainable():
            p.zero_()
    t = time.perf_counter()
    tr._try_resume()
    resume_ms = 1e3 * (time.perf_counter() - t)
    after = tr._state_tree()
    check(_state_equal(after["lora"], before["lora"])
          and _state_equal(after["opt_state"], before["opt_state"])
          and after["step"] == before["step"],
          "(a) the state resumed over the learner mesh differs from the saved one")
    return {"bytes": len(data), "save_ms": save_ms, "resume_ms": resume_ms}


def save_peak(tr, cuda: bool) -> dict:
    """(c): the gathered state a checkpoint writes (``_state_tree``, a member
    at a time to the host), its seconds and the device memory it takes
    beyond what the trainer holds: at most one member whole and its piece,
    so no more than twice the largest member."""
    import torch

    largest = max(4 * s.numel for s in tr.lora.shards.values())
    if cuda:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = tr._state_tree()
    seconds = time.perf_counter() - t
    extra = torch.cuda.max_memory_allocated() - held if cuda else 0
    whole = sum(x.numel() * x.element_size() for x in state["lora"].values())
    whole += sum(x.numel() * x.element_size() for e in state["opt_state"]["state"].values()
                 for x in e.values())
    check(all(x.device.type == "cpu" for x in state["lora"].values()),
          "(c) the gathered state is not on the host")
    check(extra <= 2 * largest + 2**26,
          f"(c) the save took {extra} bytes of the card beyond the trainer's state, more "
          f"than twice the largest member ({largest} bytes)")
    del state
    gc.collect()
    return {"extra": extra, "largest": largest, "whole": whole, "seconds": seconds}


def check_sharded_eval(out: dict, hbm_bytes=None) -> dict:
    """(b): the eval round of ``paged_sharded`` (greedy) against one plain
    paged wave engine over the same model, adapter, prompts and seed; its
    launches are not the path's."""
    import dataclasses as dc

    import numpy as np

    from distrl_llm_tpu_torch.trainer import make_engine

    model, lora, ids, mask, sampling, seed = out["eval_args"]
    check(sampling.temperature == 0.0, "(b) the eval round is not greedy")
    plain = make_engine(dc.replace(out["config"], engine_impl="paged"), model, out["tok"],
                        hbm_bytes=hbm_bytes)
    res = plain.generate(model, lora, ids, mask, sampling, seed)
    got = out["rounds"][0]["res"]
    same = np.array_equal(got.tokens, res.tokens) and np.array_equal(got.lengths, res.lengths)
    check(same, "(b) the sharded engine's eval round differs from one paged wave engine's")
    plain.release_decode_graphs()
    return {"rows": int(ids.shape[0]), "tokens": int(np.asarray(res.lengths).sum())}


def mesh_full(cfg, device, *, seed: int, workdir: Path, tokenizer_dir: Path, meshes,
              hbm_bytes=None, **config_kw) -> dict:
    """(c): full fine-tuning as BASELINE config 3 runs it (bf16 rollout copy,
    f32 masters, no quantized base, GRPO, splash; phase 10's refill engine
    and cell) on the learner mesh at fsdp 1, the initial eval and 2 steps:
    every master moved within Adam8bit's clip, the rollout copy the masters
    cast to bf16, the launches as ``check_trainer_run`` holds them."""
    import torch

    from distrl_llm_tpu_torch.config import MeshConfig
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import Trainer, make_engine

    tok = load_tokenizer(str(tokenizer_dir))
    train, test = trainer_datasets(tok)
    model, _ = make_weights(cfg, device, seed=seed)
    initial = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    # a name no preset claims: the width rule holds the loaded 4 layers (the
    # Trainer's check), not Llama-3-8B's 32
    config = full_config(workdir / "full", model="random-weights-at-llama3-width",
                         learner="grpo", seed=seed,
                         dtype=str(model.embed.dtype).removeprefix("torch."),
                         **{"max_prompt_tokens": 350, **config_kw},
                         mesh=MeshConfig(fsdp=meshes.learner.fsdp))
    engine = make_engine(config, model, tok, hbm_bytes=hbm_bytes, meshes=meshes)
    out = trainer_run(lambda sink: Trainer(train, test, smoke_reward, config, tokenizer=tok,
                                           engine=engine, model=model, sink=sink,
                                           meshes=meshes), label="mesh_full")
    check_trainer_run(out, cfg.num_layers, steps=2, lr=config.lr, cuda=device == "cuda")
    tr, lr = out["trainer"], config.lr
    rollout = dict(tr._engine_params()[0].named_parameters())
    worst, still = 0.0, []
    for name, m in tr.lora.full_named():
        d = (m - initial[name].to(m.device, torch.float32)).abs()
        bound = 2 * 5 * lr * (1 + 1e-6) + 2 * m.abs() * 2.0**-23
        check(bool((d <= bound).all()), f"(c) {name} moved beyond 2 Adam8bit steps")
        worst = max(worst, float(d.max()))
        if not bool((d > 0).any()):
            still.append(name)
        check(torch.equal(rollout[name], m.to(rollout[name].dtype)),
              f"(c) the rollout copy's {name} is not the master cast to its dtype")
    check(not still, f"(c) parameters that did not move: {still}")
    opt = tr.optimizer.state_dict()["state"]
    out.update(max_move=worst, params=sum(s.numel for s in tr.lora.shards.values()),
               shard_bytes={"masters": sum(4 * s.data.numel() for s in tr.lora.shards.values()),
                            "moments": sum(t.numel() * t.element_size() for e in opt.values()
                                           for t in e.values())})
    return out


def mesh_runs(qwen, llama, device, *, seed: int, workdir: Path, card: str,
              group=QMM_GROUP, hbm_bytes=None, **config_kw) -> tuple[list, list]:
    """(a) without a group, then in a one-rank process group (NCCL on the
    card, gloo on the CPU) (a) over the learner mesh, (b) and (c): their
    lines and launch counts. The group is left for the caller to close."""
    import torch

    from distrl_llm_tpu_torch.config import MeshConfig, check_full_finetune_fits
    from distrl_llm_tpu_torch.distributed import initialize_distributed
    from distrl_llm_tpu_torch.models.configs import LLAMA3_8B
    from distrl_llm_tpu_torch.parallel import build_role_meshes

    cuda = device == "cuda"

    def release():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    tok_dir = write_bpe_tokenizer(workdir / "tokenizer", qwen.vocab_size)
    kw = dict(seed=seed, workdir=workdir, tokenizer_dir=tok_dir, group=group,
              hbm_bytes=hbm_bytes, **config_kw)
    plain = mesh_qlora(qwen, device, meshes=None, label="mesh_qlora_plain", **kw)
    counts = [plain.pop("counts")]
    plain_file, _ = save_state(plain["trainer"], workdir / "ckpt_plain")
    for key in ("trainer", "eval_args"):  # both hold the model
        plain.pop(key)
    release()

    info = initialize_distributed(device=device, group=True)
    check(info.backend == ("nccl" if cuda else "gloo") and info.num_processes == 1,
          f"phase 17: the process group is {info.backend} over {info.num_processes} ranks")
    meshes = build_role_meshes(MeshConfig(fsdp=1))
    check(meshes.timeshared and meshes.learner.shape == {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1},
          f"phase 17: the default roles over one rank: {meshes}")
    a = mesh_qlora(qwen, device, meshes=meshes, label="mesh_qlora", **kw)
    check_mesh_plain(plain, a)
    ck = check_mesh_checkpoint(a["trainer"], plain_file, workdir / "ckpt_mesh")
    lines = trainer_step_lines(plain, card) + trainer_step_lines(a, card)
    lines.append(f"mesh (a): records and adapters over the one-rank {info.backend} learner "
                 f"mesh equal the run without a group, bit for bit; peak {a['peak_gib']:.2f} "
                 f"GiB (without a group {plain['peak_gib']:.2f}); launches {a['counts']}; {card}")
    lines.append(f"mesh (a) checkpoint: {ck['bytes']} bytes gathered over the group, byte for "
                 f"byte the run's without a group, saved in {ck['save_ms']:.1f} ms; the zeroed "
                 f"shards resumed from it in {ck['resume_ms']:.1f} ms equal the saved state; "
                 f"{card}")
    counts.append(a.pop("counts"))
    del a, plain
    release()

    b = mesh_qlora(qwen, device, meshes=meshes, label="mesh_paged_sharded",
                   **{**kw, "engine_impl": "paged_sharded", "continuous_batching": False,
                      "max_concurrent_sequences": 0, "eval_temperature": 0.0})
    counts.append(b.pop("counts"))  # read before the plain engine's round
    ev = check_sharded_eval(b, hbm_bytes)
    lines += trainer_step_lines(b, card)
    lines.append(f"mesh (b) paged_sharded: the eval round ({ev['rows']} prompts x "
                 f"{b['config'].eval_n}, greedy, {ev['tokens']} tokens) equals one paged wave "
                 f"engine's token for token; peak {b['peak_gib']:.2f} GiB; launches "
                 f"{counts[-1]}; {card}")
    b.pop("trainer")
    del b
    release()

    ltok = write_bpe_tokenizer(workdir / "tokenizer_llama", llama.vocab_size)
    c = mesh_full(llama, device, seed=seed, workdir=workdir, tokenizer_dir=ltok, meshes=meshes,
                  hbm_bytes=hbm_bytes, **config_kw)
    counts.append(c.pop("counts"))
    sv = save_peak(c["trainer"], cuda)
    hbm = hbm_bytes
    if hbm is None:
        from distrl_llm_tpu_torch.engine.budget import device_hbm_bytes

        hbm = device_hbm_bytes()
    verdicts = {}
    for fsdp in (1, 4):
        try:
            check_full_finetune_fits(LLAMA3_8B, "bfloat16", "Llama-3-8B", hbm, fsdp=fsdp)
            verdicts[fsdp] = "passes"
        except ValueError:
            verdicts[fsdp] = "raises"
    if cuda:
        check(verdicts == {1: "raises", 4: "passes"},
              f"(c) check_full_finetune_fits at 32 layers: {verdicts}")
    sb = c["shard_bytes"]
    lines += trainer_step_lines(c, card)
    lines.append(
        f"mesh (c) full fine-tuning at Llama-3-8B width, {llama.num_layers} of 32 layers "
        f"({c['params'] / 1e9:.3f} B parameters), fsdp 1 over one {info.backend} rank: peak "
        f"{c['peak_gib']:.2f} GiB; the rank's sharded state {sb['masters'] / 2**30:.2f} GiB "
        f"of f32 masters (their grads the same during a step) and {sb['moments'] / 2**30:.2f}"
        f" GiB of Adam8bit moments; largest move {c['max_move']:.3g}; "
        f"check_full_finetune_fits for 32 layers on {hbm / 1e9:.1f} GB: fsdp 1 "
        f"{verdicts[1]}, fsdp 4 {verdicts[4]}; launches {counts[-1]}; {card}")
    lines.append(
        f"mesh (c) the checkpoint's gathered state: {sv['whole'] / 2**30:.2f} GiB on the host "
        f"in {sv['seconds']:.2f} s, a member at a time; the card's peak beyond the trainer's "
        f"state {sv['extra'] / 2**30:.2f} GiB (largest member {sv['largest'] / 2**30:.2f} "
        f"GiB); {card}")
    return lines, counts


def mesh_child(workdir: Path, seed: int) -> None:
    """Phase 17's child process: ``mesh_runs`` at Qwen2.5-7B width (7
    layers) and Llama-3-8B width (4 layers). Prints its lines and, last,
    ``MESH_COUNTS`` and the runs' launch counts."""
    import torch

    from distrl_llm_tpu_torch.models.configs import LLAMA3_8B, QWEN2_7B
    from distrl_llm_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    card = f"card: {nvidia_smi()}"
    lines, counts = mesh_runs(dataclasses.replace(QWEN2_7B, num_layers=GRAPH_TRAIN_LAYERS),
                              dataclasses.replace(LLAMA3_8B, num_layers=MESH_FULL_LAYERS),
                              "cuda", seed=seed, workdir=workdir, card=card)
    lines.append(f"mesh: phase 17's child {time.perf_counter() - t0:.1f} s; {card}")
    for line in lines:
        print(line, flush=True)
    torch.distributed.destroy_process_group()
    print("MESH_COUNTS " + json.dumps(counts), flush=True)


def mesh_rehearsal(workdir) -> tuple[list, list]:
    """Phase 17 at TINY on the CPU over a one-rank gloo group (the Qwen run
    with a 1024-token vocabulary for the hand-written BPE, the full run on
    TINY's shape without biases, as Llama's): every run checked as on the
    card, launch counts apart. Run it in a process of its own: it leaves a
    process group."""
    import torch

    from distrl_llm_tpu_torch.models.configs import TINY

    torch.set_num_threads(1)
    qwen = dataclasses.replace(TINY, vocab_size=1024)
    llama = dataclasses.replace(qwen, attention_bias=False)
    return mesh_runs(qwen, llama, "cpu", seed=0, workdir=Path(workdir), card="cpu", group=16,
                     hbm_bytes=2**30, max_prompt_tokens=96, max_new_tokens=8, num_candidates=4,
                     topk=4, train_batch_size=4, eval_n=2, max_concurrent_sequences=8,
                     max_lora_rank=4)


def mesh_phase(args, card: str, t_start: float) -> list:
    """Phase 17 (see the module's docstring) in a child process; returns the
    launch counts of its runs."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the child's card is this process's card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        proc = subprocess.run(
            [sys.executable, str(HERE / "chip_smoke.py"), "--mesh-child", tmp,
             "--seed", str(args.seed)],
            stdout=subprocess.PIPE, text=True, timeout=MESH_TIMEOUT_S, cwd=str(HERE))
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("MESH_COUNTS "):
            print(line)
    check(proc.returncode == 0, f"phase 17's child exited {proc.returncode}")
    counts = [json.loads(line[len("MESH_COUNTS "):]) for line in lines
              if line.startswith("MESH_COUNTS ")]
    check(len(counts) == 1, "phase 17's child printed no launch counts")
    print(f"mesh: phase 17 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s; {card}")
    return counts[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28,
                    help="decoder depth of the Qwen2.5-7B-wide model (28 = full)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--until", type=int, default=17, choices=tuple(range(6, 18)),
                    help="the last phase to run; 6 skips speculative decoding "
                         "(with --profile, the long part), 7 the trainer, 8 the "
                         "refill engine's riders, 9 full fine-tuning at Gemma-2B "
                         "width, 10 scan chunks as CUDA graphs, 11 the refill "
                         "scheduler's, 12 the overlapped rollout modes, 13 the "
                         "kernel domains past rank 64 and 64 query rows, 14 the "
                         "multi-turn environments and full fine-tuning under the "
                         "overlapped modes, 15 the remote rollout workers, 16 the learners "
                         "sharded over ranks; a partial run prints no result line")
    ap.add_argument("--mesh-child", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true",
                    help="also print the device time per decode step and per "
                         "learner step by kernel (torch.profiler) and the "
                         "device's idle share")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import distrl_llm_tpu_torch

    if args.mesh_child is not None:  # phase 17's child process
        mesh_child(args.mesh_child, args.seed)
        return 0

    pkg = Path(distrl_llm_tpu_torch.__file__).resolve().parent
    check(pkg == HERE / "distrl_llm_tpu_torch",
          f"distrl_llm_tpu_torch imported from {pkg}, not from this checkout")
    from distrl_llm_tpu_torch.models.configs import QWEN2_7B
    from distrl_llm_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    card = f"card: {smi}"

    # 2. build
    t = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - t:.1f} s "
          f"into {_build.BUILD_DIR}")
    for kname, b in built.items():
        for entry, line in ptxas_lines(b.log):
            print(f"build {kname}: {entry}: {line}")

    # 3. kernels against their plain versions
    t = time.perf_counter()
    err = compare_fused_sample("cuda", args.seed)
    k1 = time_fused_sample(args.seed)
    plan = k1.pop("plan")
    print(f"kernel fused_sample at [{ROWS},{VOCAB}] (C {plan.cluster}, {plan.threads} "
          f"threads; a CUDA graph over {k1.pop('copies')} logits "
          f"copies past twice the L2): {k1['ms']:.4f} ms; one call at a time "
          f"{k1.pop('single_ms'):.4f} ms; plain version {k1['plain_ms']:.4f} ms, bound "
          f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}; {k1.pop('kept')} kept columns); "
          f"{card}")
    print(f"kernel fused_sample: stanza {time.perf_counter() - t:.1f} s")
    results = {"fused_sample": {"max_abs_err": err, **k1}}
    err = max(compare_paged_attention("cuda", args.seed),
              compare_paged_shapes("cuda", args.seed))
    pa_times = time_paged_attention(args.seed)
    for label, r in pa_times.items():
        print(f"kernel paged_attention at B={r['rows']} x length {PA_TIMED_LENGTH}, "
              f"{label.split('_')[0]} pages, bf16 q ({r['splits']} splits, {r['blocks']} "
              f"blocks; a CUDA graph over {r['copies']} page copies past twice the L2): "
              f"{r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); {card}")
    # the line's headline is the main path's default format, bf16 pages
    results["paged_attention"] = {
        "max_abs_err": err, **{k: pa_times["bfloat16"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    fa_err = compare_flash_attention("cuda", args.seed)
    fa_times = time_flash_attention(args.seed)
    for part, r in fa_times.items():
        lib = "not run" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel flash_attention {part} at q [{FA_BATCH},{FA_PROMPT + FA_ANSWER},"
              f"{PA_HEADS},{PA_HEAD_DIM}], k/v {PA_KV_HEADS} heads, bf16, the learner's "
              f"masks: {r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library (scaled_dot_product_"
              f"attention, bool mask, enable_gqa) {lib}; {card}")
    results["flash_attention_fwd"] = {"max_abs_err": fa_err["f32"]["out"], **fa_times["fwd"]}
    results["flash_attention_bwd"] = {
        "max_abs_err": max(fa_err["f32"][n] for n in ("dq", "dk", "dv")), **fa_times["bwd"]}
    # K4 at head_dim 256: a Gemma-2B learner microbatch, [8, 1550, 8 / 1, 256]
    t = time.perf_counter()
    gemma = dict(heads=GEMMA_HEADS, kv_heads=GEMMA_KV_HEADS, head_dim=GEMMA_HEAD_DIM)
    g_err = compare_flash_attention("cuda", args.seed, **gemma)
    for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        g_times = time_flash_attention(args.seed, dtype, **gemma)
        for part, r in g_times.items():
            lib = "not run" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            print(f"kernel flash_attention {part} at q [{FA_BATCH},{FA_PROMPT + FA_ANSWER},"
                  f"{GEMMA_HEADS},{GEMMA_HEAD_DIM}], k/v {GEMMA_KV_HEADS} head, {dt}, the "
                  f"learner's masks: {r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library (scaled_dot_"
                  f"product_attention, bool mask, enable_gqa) {lib}; {card}")
            errs = g_err["f32" if dt == "f32" else "bf16"]
            results[f"flash_attention_{part}_hd256_{dt}"] = {
                "max_abs_err": errs["out"] if part == "fwd" else max(
                    errs[n] for n in ("dq", "dk", "dv")), **r}
        del g_times
        torch.cuda.empty_cache()
    print(f"kernel flash_attention: head_dim 256 stanza {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    qmm_err = compare_quant_matmul("cuda", args.seed)
    qmm_times = time_quant_matmul(args.seed)
    for (m, k, n, bits), r in qmm_times.items():
        timed = (f"a CUDA graph over {r['copies']} weight copies" if m <= 64
                 else "one call at a time")
        print(f"kernel quant_matmul at x [{m},{k}] bf16 x int{bits} "
              f"{'g' + str(QMM_GROUP) if bits == 4 else 'per-column'} [{k},{n}], rank-"
              f"{QMM_RANK} LoRA ({timed}): {r['ms']:.4f} ms, plain version "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"library (torch.matmul on the weight dequantized beforehand, dequant not "
              f"timed, + the LoRA delta) {r['library_ms']:.4f} ms; {card}")
    step = qlora_decode_step_ms(qmm_times)
    print(f"kernel quant_matmul: K3 per QLoRA decode step (28 x (2 wq/wo + 2 wk/wv + 2 "
          f"w_gate/w_up + w_down), int4 g{QMM_GROUP}, M {QMM_ROWS[0]}): {step['ms']:.4f} ms, "
          f"bound {step['bound_ms']:.4f} ms, library {step['library_ms']:.4f} ms; the "
          f"profiled device time of PR 4's kernel was 37.81 ms; {card}")
    print(f"kernel quant_matmul: stanza {time.perf_counter() - t:.1f} s")
    # the line's headline is the decode step's int4 w_gate (M = 64)
    results["quant_matmul"] = {"max_abs_err": qmm_err["f32_abs"],
                               **qmm_times[(QMM_ROWS[0], 3584, 18944, 4)]}
    results["quant_matmul"].pop("copies")
    # K3 past rank 64 (its rank chunks) at ranks 128 and 200, then K5 past 64
    # query rows (its row tiles) at 91 and 136 rows
    t = time.perf_counter()
    hr_err = compare_quant_matmul_ranks("cuda", args.seed)
    for rank in QMM_HIGH_RANKS:
        hr_times = time_quant_matmul(args.seed, rank=rank, gate_rows=QMM_HIGH_RANK_ROWS[1:])
        for (m, k, n, bits), r in hr_times.items():
            timed = (f"a CUDA graph over {r['copies']} weight copies" if m <= 512
                     else "one call at a time")
            print(f"kernel quant_matmul at x [{m},{k}] bf16 x int{bits} "
                  f"{'g' + str(QMM_GROUP) if bits == 4 else 'per-column'} [{k},{n}], rank-"
                  f"{rank} LoRA ({timed}): {r['ms']:.4f} ms, plain version "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"library (torch.matmul on the weight dequantized beforehand, dequant not "
                  f"timed, + the LoRA delta) {r['library_ms']:.4f} ms; {card}")
        step = qlora_decode_step_ms(hr_times)
        print(f"kernel quant_matmul: K3 per QLoRA decode step at rank {rank} (28 x (2 wq/wo + "
              f"2 wk/wv + 2 w_gate/w_up + w_down), int4 g{QMM_GROUP}, M {QMM_ROWS[0]}): "
              f"{step['ms']:.4f} ms, bound {step['bound_ms']:.4f} ms, library "
              f"{step['library_ms']:.4f} ms; {card}")
        if rank == QMM_HIGH_RANKS[0]:  # the line's: rank 128, int4 w_gate at M = 64
            results["quant_matmul_rank_chunks"] = {
                "max_abs_err": hr_err["f32_abs"], **hr_times[(QMM_ROWS[0], 3584, 18944, 4)]}
            results["quant_matmul_rank_chunks"].pop("copies")
        del hr_times
        torch.cuda.empty_cache()
    print(f"kernel quant_matmul: ranks {list(QMM_HIGH_RANKS)} stanza "
          f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    vt_err = compare_paged_verify_tiles("cuda", args.seed)
    for s_len, heads, kv_heads, hd in VF_TILE_SHAPES:
        vt = time_paged_verify(args.seed, s=s_len, heads=heads, kv_heads=kv_heads, head_dim=hd)
        for kv, r in vt.items():
            print(f"kernel paged_verify at B={PA_PROMPTS * PA_N} x S={s_len} x {heads}/"
                  f"{kv_heads} heads x hd {hd} ({s_len * heads // kv_heads} rows) x lengths "
                  f"550-650, {kv} pages, bf16 q (a CUDA graph over {r['copies']} page copies "
                  f"past twice the L2): {r['ms']:.4f} ms, plain version {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), unrolled {s_len} x K2 (the "
                  f"yardstick; no library call takes a page table) {r['unrolled_ms']:.4f} ms; "
                  f"{card}")
        if (s_len, heads, kv_heads, hd) == VF_TILE_SHAPES[0]:  # the line's: 91 rows, bf16
            results["paged_verify_row_tiles"] = {
                "max_abs_err": vt_err, **{k: vt["bfloat16"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        del vt
        torch.cuda.empty_cache()
    print(f"kernel paged_verify: past 64 rows stanza {time.perf_counter() - t:.1f} s")

    # 4. the main path at full width: the dense engine, then the paged engine
    # with bf16 and with int8 pages, each with the counts reset around it
    cfg = dataclasses.replace(QWEN2_7B, num_layers=args.layers)
    weights = make_weights(cfg, "cuda", seed=args.seed)
    runs = []
    for engine, kv_quant in (("dense", "none"), ("paged", "none"), ("paged", "int8")):
        out = rollout(cfg, "cuda", seed=args.seed, card=card, profile=args.profile,
                      engine=engine, kv_quant=kv_quant, weights=weights)
        label, counts = out["label"], out["counts"]
        check(out["steps"] > 0, f"{label}: no decode step ran")
        check(counts["fused_sample"] == out["steps"],
              f"{label}: fused_sample launches {counts['fused_sample']} != decode steps "
              f"{out['steps']}")
        want_pa = cfg.num_layers * out["forwards"] if engine == "paged" else 0
        check(counts["paged_attention"] == want_pa,
              f"{label}: paged_attention launches {counts['paged_attention']} != "
              f"{want_pa} (num_layers x decode forwards)")
        check(engine == "dense" or out["forwards"] > 0, f"{label}: no decode forward ran")
        check(counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 0,
              f"{label}: K4 launched with attn_impl='reference'")
        print(f"rollout {label}: peak device memory {out['peak_gib']:.2f} GiB; "
              f"total {time.perf_counter() - t_start:.1f} s; {card}")
        runs.append(out)
    # the paged engine's logits against the dense engine's, teacher-forced;
    # then greedy tokens, each share beside its yardstick
    wide = widen(weights)
    lc = compare_engine_logits(weights, wide, seed=args.seed)
    low_tol = 2 * lc["noise"] + LOGIT_F32_ATOL
    int8_tol = 2 * lc["int8_plain"] + LOGIT_F32_ATOL
    print(f"rollout: logits, paged vs dense engine, teacher-forced over the prefill's last "
          f"position and {LOGIT_STEPS} decode forwards of {PA_PROMPTS * PA_N} rows (dense f32 logit "
          f"std {lc['std']:.4g}): max |dlogit| {lc['f32']:.4g} with f32 pages in f32 "
          f"(tolerance {LOGIT_F32_ATOL}); {lc['low']:.4g} with bf16 pages in bf16 "
          f"(tolerance {low_tol:.4g}: twice the dense engine's own bf16-vs-f32 distance "
          f"{lc['noise']:.4g}, plus {LOGIT_F32_ATOL}); {lc['int8']:.4g} with int8 pages in "
          f"f32 (tolerance {int8_tol:.4g}: twice the int8 pages' own distance "
          f"{lc['int8_plain']:.4g}, measured with K2's plain version, plus "
          f"{LOGIT_F32_ATOL}); int8 pages, K2 vs its plain version {lc['int8_k2']:.4g} "
          f"(tolerance {lc['int8_plain']:.4g}, the int8 pages' own distance)")
    check(lc["plain_launches"] == 0, f"K2 launched {lc['plain_launches']} times while "
          "its plain version stood in its place")
    check(lc["f32"] <= LOGIT_F32_ATOL, f"f32 logits of the paged and dense engines "
          f"differ by {lc['f32']:.4g} > {LOGIT_F32_ATOL}")
    check(lc["low"] <= low_tol, f"bf16 logits of the paged and dense engines differ "
          f"by {lc['low']:.4g} > {low_tol:.4g}")
    check(lc["int8"] <= int8_tol, f"int8-page logits of the paged engine differ from "
          f"the dense engine's by {lc['int8']:.4g} > {int8_tol:.4g}")
    check(lc["int8_k2"] <= lc["int8_plain"], f"int8 pages: K2 and its plain version "
          f"differ by {lc['int8_k2']:.4g}, more than the pages' own distance "
          f"{lc['int8_plain']:.4g} from dense")
    # K4 on the engines' prefill: the paged engine with attn_impl="splash"
    sp = splash_prefill(cfg, "cuda", weights, wide, seed=args.seed)
    sc = sp["counts"]
    print(f"rollout {sp['label']}, attn_impl='splash': one greedy round, {sp['steps']} decode "
          f"steps; launches {sc}; f32 prefill logits, splash vs reference: max |dlogit| "
          f"{sp['logit_err']:.4g} (tolerance {LOGIT_F32_ATOL}; logit std {sp['logit_std']:.4g})")
    check(sc["flash_attention_fwd"] == cfg.num_layers and sc["flash_attention_bwd"] == 0,
          f"splash prefill: K4 launched {sc['flash_attention_fwd']} times forward, "
          f"{sc['flash_attention_bwd']} backward; want {cfg.num_layers} (one per layer) and 0")
    check(sc["paged_attention"] == cfg.num_layers * sp["forwards"]
          and sc["fused_sample"] == sp["steps"], "splash prefill round: K1/K2 launches off")
    check(sp["logit_err"] <= LOGIT_F32_ATOL, f"splash prefill logits differ from reference "
          f"by {sp['logit_err']:.4g} > {LOGIT_F32_ATOL}")
    counted = [out["counts"] for out in runs] + [sc]  # every main-path run's launches
    dense = runs[0]
    dense_peak = dense["peak_gib"]
    ga = greedy_agreement(cfg, "cuda", wide, dense["greedy_tokens"], seed=args.seed)
    del wide
    torch.cuda.empty_cache()
    for out in runs[1:]:
        same = out["greedy_tokens"] == dense["greedy_tokens"]
        rows_same = same.reshape(-1, same.shape[-1]).all(axis=1)
        print(f"rollout {out['label']}: greedy tokens equal to the dense engine's on "
              f"{100 * same.mean():.2f}% of positions, {int(rows_same.sum())}/"
              f"{rows_same.size} rows whole (not asserted: bf16 at {cfg.num_layers} "
              f"layers flips near-ties). Yardsticks: the dense engine in bf16 vs in f32 "
              f"{100 * ga['dense_low_vs_f32']:.2f}%; the paged engine (f32 pages) vs the "
              f"dense engine, both f32, {100 * ga['paged_vs_dense_f32']:.2f}%")

    # 5. the learner at full width: the dense engine's sampled round through
    # shaping into 8 microbatches of 8 x 1550 tokens, one optimizer step
    # (phase 8's trainer takes two)
    batch, source = learner_batch(dense, n=PA_N, seed=args.seed, device="cuda")
    print(f"learner: {batch.prompt_ids.shape[0]} rows x ({batch.prompt_ids.shape[1]} + "
          f"{batch.answer_ids.shape[1]}) tokens, micro 8; coefficients from {source}; "
          f"total {time.perf_counter() - t_start:.1f} s")
    lr, scale = 2e-5, 16.0 / 32
    lrn = learner_run(weights, batch, steps=1, lr=lr, scale=scale, card=card,
                      profile=args.profile)
    want_fwd = 2 * cfg.num_layers * lrn["num_micro"]
    want_bwd = cfg.num_layers * lrn["num_micro"]
    for i, st in enumerate(lrn["steps"]):
        c = st["counts"]
        check(math.isfinite(st["loss"]), f"learner step {i + 1}: loss {st['loss']}")
        check(c["flash_attention_fwd"] == want_fwd and c["flash_attention_bwd"] == want_bwd,
              f"learner step {i + 1}: K4 launched {c['flash_attention_fwd']} forward / "
              f"{c['flash_attention_bwd']} backward, want {want_fwd} (2 x layers x "
              f"microbatches: forward and remat recompute) / {want_bwd}")
        check(c["fused_sample"] == c["paged_attention"] == 0,
              f"learner step {i + 1}: K1/K2 launched")
        check(st["within_clip"], f"learner step {i + 1}: an adapter element moved by "
              f"{st['max_delta']:.3g}, beyond Adam8bit's clip 5 lr = {5 * lr:.3g}")
        check(st["moved_share"] > 0, f"learner step {i + 1}: the adapter did not move")
        counted.append(c)
    check(lrn["plain_calls"] == 0, f"K4's plain version ran {lrn['plain_calls']} times "
          "on the learner's main path")
    ms = [1e3 * st["s"] for st in lrn["steps"]]
    print(f"learner: {len(ms)} steps at Qwen2.5-7B width, {cfg.num_layers} layers: "
          f"{', '.join(f'{m:.1f}' for m in ms)} ms/step; "
          f"{lrn['real_tokens'] / (ms[-1] / 1e3):.1f} real and "
          f"{lrn['padded_tokens'] / (ms[-1] / 1e3):.1f} padded learner tokens/s (last step); "
          f"peak device memory {lrn['peak_gib']:.2f} GiB; K4's plain version called "
          f"{lrn['plain_calls']} times; total {time.perf_counter() - t_start:.1f} s; {card}")
    pushed = push_and_round(cfg, "cuda", weights, lrn["lora"], seed=args.seed, version=1)
    check(pushed["versions"] == [1], f"the dense engine reports adapter versions "
          f"{pushed['versions']} after the push, want [1]")
    same = pushed["tokens"] == dense["greedy_tokens"]
    print(f"learner: the trained adapter pushed into the dense engine's mailbox: swapped in "
          f"at decode step {pushed['swap_steps']}, version {pushed['versions']}; its greedy "
          f"round equals the pre-update round on {100 * same.mean():.2f}% of positions")
    del lrn, pushed
    torch.cuda.empty_cache()

    # the learner in f32 at full width, 2 layers: K4 against its plain
    # version (loss and LoRA grads), and the learner's logprobs of the dense
    # engine's greedy tokens against the logprobs that engine captured
    lp = learner_parity(dataclasses.replace(cfg, num_layers=2), "cuda", seed=args.seed)
    print(f"learner parity (f32, 2 layers, {lp['shape'][0]} rows x {lp['shape'][1]}): loss "
          f"K4 {lp['loss_kernel']:.8g} vs plain {lp['loss_plain']:.8g} (relative "
          f"{lp['loss_rel']:.3g}), LoRA grads max |d| / max |g| {lp['grad_rel']:.3g} "
          f"(tolerance {LEARNER_REL} each; max |g| {lp['grad_max']:.3g}); learner vs engine "
          f"logprobs on {lp['gen_positions']} generated positions: max |d| "
          f"{lp['logp_err']:.3g} (tolerance {LEARNER_LOGP_ATOL}); launches with K4 "
          f"{lp['counts_kernel']}, with its plain version {lp['counts_plain']}")
    check(lp["counts_kernel"]["flash_attention_bwd"] > 0 and
          lp["counts_plain"]["flash_attention_fwd"] == lp["counts_plain"]["flash_attention_bwd"]
          == 0, "learner parity: K4 ran where it should not, or not where it should")
    check(lp["loss_rel"] <= LEARNER_REL and lp["grad_rel"] <= LEARNER_REL,
          "learner parity: K4 and its plain version disagree beyond the tolerance")
    check(lp["logp_err"] <= LEARNER_LOGP_ATOL, f"learner vs engine logprobs differ by "
          f"{lp['logp_err']:.3g} > {LEARNER_LOGP_ATOL}")

    # 6. QLoRA, at SHALLOW_LAYERS: the same model with its projections
    # quantized (int4 in groups of 64, the reference's 4-bit base), every
    # projection through K3: the dense and the paged engine, one dense round
    # over an int8 base, f32 logits against K3's plain version, one learner
    # step, f32 parity
    del weights
    torch.cuda.empty_cache()
    shallow = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, SHALLOW_LAYERS))
    qlora_counts, qlora_tokens = qlora_phase(shallow, args, batch, card, t_start)
    counted += qlora_counts
    print(f"qlora: total {time.perf_counter() - t_start:.1f} s; {card}")
    torch.cuda.empty_cache()

    if args.until < 7:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 7. speculative decoding: K5 against its plain version and timed, then
    # BASELINE config 2's refill engine at full width, speculative and
    # plain, bf16 pages at 28 layers and int8 pages at SHALLOW_LAYERS, and
    # f32 verify-vs-decode logits
    spec_counts, results["paged_verify"], plain_refill = spec_phase(cfg, args, card, t_start)
    counted += spec_counts
    if args.until < 8:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 8. the trainer: whole training steps through Trainer.train() over the
    # int4 base at full width, then Trainer.from_pretrained on a checkpoint
    # written by save_hf_checkpoint, each with the counts reset around it
    counted += trainer_phase(cfg, args, card, t_start)
    if args.until < 9:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 9. the refill engine's riders and the dense slice's leftovers at full
    # width: prefix sharing, continuous admission and the radix cache; host
    # spill; the self-drafter with the adaptive draft length; the int8 dense
    # cache, bisect_mw and a Gemma checkpoint with its Unigram tokenizer
    counted += riders_phase(cfg, args, card, t_start, dense_peak_gib=dense_peak,
                            int8_page_err=lc["int8_plain"], plain_refill_pool=plain_refill)
    if args.until < 10:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 10. full fine-tuning at Gemma-2B width under splash (K4's head_dim 256
    # routes: the f32 learner, the bf16 prefill), then one LoRA step there
    # (K4's bf16 backward at head_dim 256)
    counted += full_finetune_phase(args, card, t_start)
    if args.until < 11:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 11. scan chunks: the dense engine and the paged wave scheduler with
    # their decode steps as CUDA graph chunks, graphed against eager at
    # phase 4's cell; a sampled round, an in-flight swap, the int4 base at
    # phase 6's depth and one Trainer.train() step
    counted += graph_phase(cfg, args, card, t_start, qlora_tokens=qlora_tokens)
    if args.until < 12:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 12. scan chunks on the refill scheduler: its plain, speculative and
    # self-drafted steps as CUDA graph chunks, graphed against eager at the
    # trainer's refill cell; the riders under a budget; one Trainer.train()
    # step of phase 8's configuration graphed and eager
    counted += refill_graph_phase(cfg, args, card, t_start)
    if args.until < 13:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 13. the overlapped rollout modes: Trainer.train() of phase 8's QLoRA
    # configuration at 7 layers, sync and pipelined graphed and eager, then
    # async with in-flight updates; every round's and update's launches,
    # versions, swaps and captures checked, the overlap measured
    counted += overlap_phase(cfg, args, card, t_start)
    if args.until < 14:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 14. K3 past rank 64 and K5 past 64 query rows through Trainer.train():
    # phase 13's QLoRA configuration at rank 128 with spec_draft 12, graphed;
    # then speculative vs plain refill at 104 query rows on TINY's width
    counted += domain_phase(cfg, args, card, t_start)
    if args.until < 15:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 15. multi-turn environments: the verifier environment through
    # Trainer.train() over phase 13's QLoRA configuration, graphed and eager;
    # the in-place turn resume against a dense decode of the whole
    # conversation; full fine-tuning at Gemma-2B width pipelined and async
    counted += env_phase(args, card, t_start)
    if args.until < 16:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 16. remote rollout workers: Trainer.from_pretrained with two worker
    # processes on the card over the control plane and the weight bus, sync
    # and async with an in-flight swap graphed, sync and pipelined eager
    counted += remote_phase(cfg, args, card, t_start)
    if args.until < 17:
        print(f"chip_smoke: phases 1-{args.until} done in {time.perf_counter() - t_start:.1f} s "
              f"(a partial run prints no result line); {card}")
        return 0

    # 17. learners sharded over ranks: a child process in a one-rank NCCL
    # group runs phase 13 (a)'s QLoRA cell over the learner mesh (held to the
    # run without a group), with paged_sharded, and full fine-tuning at
    # Llama-3-8B width
    counted += mesh_phase(args, card, t_start)
    print(f"chip_smoke: done in {time.perf_counter() - t_start:.1f} s; {card}")

    kernels = []
    for k in KERNELS:
        r = results[k["name"]]
        kernels.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(c[k["name"]] for c in counted),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — report and fail, never exit 0
        traceback.print_exc()
        sys.exit(1)
