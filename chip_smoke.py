#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``distrl_llm_tpu_torch``).

    python3 chip_smoke.py [--layers N] [--seed S]

Needs one NVIDIA GPU (Hopper: the kernels build for ``sm_90a``) and ``nvcc``.
Without a GPU it exits non-zero before computing anything. Phases, each
printing its own lines:

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: every kernel in ``distrl_llm_tpu_torch/csrc`` is compiled (one
   ``nvcc`` per source, started together) into ``build/torch_kernels/``;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the main path's shapes, with its time, the plain version's time
   and the card's least time for the same work (the bound);
4. rollout: the port's dense rollout engine at Qwen2.5-7B width (random bf16
   weights from a seed, a rank-32 LoRA with non-zero B), 4 math prompts x 16
   candidates x 128 new tokens: one sampled round scored by the reward
   function, then two greedy rounds that must agree. The kernels' launch
   counts are set to 0 just before these rounds and read just after; every
   kernel of the path must have been launched.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits 1 without that last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores, the rate the sampler's arithmetic runs at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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
)


def reset_counts() -> None:
    for k in KERNELS:
        setattr(importlib.import_module(k["module"]), k["counter"], 0)


def read_counts() -> dict[str, int]:
    return {k["name"]: getattr(importlib.import_module(k["module"]), k["counter"])
            for k in KERNELS}


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


def fused_sample_bound_ms(rows: int, vocab: int, sampling: bool) -> tuple[float, str]:
    """Least time on the card for one fused_sample call: each input read and
    each output written once (f32 logits, int32 seeds; int32 token and f32
    logprob per row) over HBM bandwidth, against the per-element f32
    operations the function needs over the f32 peak: 4 for greedy (argmax
    compare; sub, exp, add of the logprob's log-sum-exp), 61 when sampling
    (adds the temperature division, softmax's sub/exp/add/div, 16 bisection
    compare+add pairs, the filter select, 13 for the uint32 hash and its
    float conversion, 4 for -log(-log u), the noise add and the draw's
    compare)."""
    nbytes = rows * vocab * 4 + rows * 4 + rows * 8
    ops = rows * vocab * (61 if sampling else 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_fused_sample(device, seed: int,
                         shapes=((ROWS, VOCAB), (7, 1000))) -> float:
    """The kernel against its plain version on ``device``: [64, 152064]
    (bf16-rounded logits, as the engine's lm_head gives them, so exact ties
    at the top occur) and a ragged [7, 1000], under every sampler setting,
    then a row of NaN. Returns the largest |dlogp|."""
    import torch

    smp = _sampling()
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_err, rows_total, near_ties, excused = 0.0, 0, 0, 0
    for b, v in shapes:
        logits = torch.randn((b, v), generator=gen, device=dev) * 3.0
        if v == VOCAB:
            logits = logits.bfloat16().float()
        for name, t, p in SAMPLER_SETTINGS:
            seeds = torch.randint(-2**31, 2**31, (b,), generator=gen, device=dev,
                                  dtype=torch.int32)
            tok, logp = smp.fused_sample(logits, t, p, seeds)
            rtok, rlogp = smp.fused_sample_reference(logits, t, p, seeds)
            scores = smp.fused_sample_scores(logits, t, p, seeds)
            top2 = scores.topk(2, dim=-1).values
            tie = ((top2[:, 0] - top2[:, 1]).abs()
                   <= NEAR_TIE_REL * top2[:, 0].abs().clamp_min(1e-30))
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
                  f"{int(tie.sum())}, max |dlogp| {err:.3g}")
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


def time_fused_sample(seed: int) -> dict:
    """The kernel's and the plain version's times at the main path's shape
    under the train setting, beside the card's bound."""
    import torch

    smp = _sampling()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = (torch.randn((ROWS, VOCAB), generator=gen, device=dev) * 3.0).bfloat16().float()
    seeds = torch.randint(-2**31, 2**31, (ROWS,), generator=gen, device=dev,
                          dtype=torch.int32)
    ms = _time_ms(lambda: smp.fused_sample(logits, 1.2, 0.95, seeds))
    plain_ms = _time_ms(lambda: smp.fused_sample_reference(logits, 1.2, 0.95, seeds),
                        calls=20)
    bound_ms, bound_by = fused_sample_bound_ms(ROWS, VOCAB, sampling=True)
    # no single PyTorch call computes this function: library_ms is null
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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


def profile_decode(run_round, steps=(8, 40), top: int = 12) -> dict:
    """Device time per decode step, by kernel: ``run_round(n)`` runs a
    greedy round of ``n`` steps (returning the steps dispatched) under
    ``torch.profiler``; the difference of two rounds cancels the prefill."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    totals = []
    for n in steps:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dispatched = run_round(n)
        by_name = defaultdict(float)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] += e.time_range.elapsed_us()
        totals.append((dispatched, by_name))
    (s0, k0), (s1, k1) = totals
    check(s1 > s0, f"profiled rounds dispatched {s0} and {s1} steps")
    per_step = {name: (k1[name] - k0.get(name, 0.0)) / (s1 - s0) / 1e3 for name in k1}
    ranked = sorted(per_step.items(), key=lambda kv: -kv[1])
    return {"device_ms_per_step": sum(per_step.values()), "top": ranked[:top],
            "kernels_per_step": len(per_step)}


def rollout(cfg, device, *, seed: int, max_prompt_tokens: int = 350,
            max_new_tokens: int = 128, n: int = 16, rank: int = 32,
            alpha: float = 16.0, card: str = "", profile: bool = False) -> dict:
    """The port's main path: random weights and a LoRA from ``seed``, the
    math prompts through the tokenizer, a short warm-up round, then (with
    the kernels' launch counts reset) one sampled round scored by the reward
    function and two greedy rounds that must agree. Returns the counts, the
    decode steps dispatched and the timings; with ``profile``, also the
    device time per decode step by kernel (after the counts are read)."""
    import numpy as np
    import torch

    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.data import process_dataset
    from distrl_llm_tpu_torch.engine.engine import GenerationEngine
    from distrl_llm_tpu_torch.models.lora import init_lora_params, lora_scale
    from distrl_llm_tpu_torch.models.transformer import init_params
    from distrl_llm_tpu_torch.rewards import RewardComputer
    from distrl_llm_tpu_torch.tokenizer import CharTokenizer, decode_batch, encode_fixed

    device = torch.device(device)
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

    tok = CharTokenizer()
    prompts = process_dataset(tok, {"problem": [p for p, _ in PROBLEMS]})["problem"]
    ids, mask = encode_fixed(tok, prompts, max_prompt_tokens, side="left")
    solutions = [s for _, s in PROBLEMS]
    engine = GenerationEngine(
        cfg, max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
        eos_token_ids=[tok.eos_token_id], pad_token_id=tok.pad_token_id,
        lora_scale=lora_scale(rank, alpha), cache_dtype=dtype,
        capture_logprobs=True, device=device)
    train = SamplingConfig(max_tokens=max_new_tokens, temperature=1.2, top_p=0.95, n=n)
    greedy = train.replace(temperature=0.0)
    engine.generate(model, lora, ids, mask, train.replace(max_tokens=4), seed)  # warm-up

    def run(sampling, round_seed, what):
        t = time.perf_counter()
        res = engine.generate(model, lora, ids, mask, sampling, round_seed)
        wall = time.perf_counter() - t
        st = engine.last_round_stats
        _check_round(res, rows=len(PROBLEMS), n=n, steps=max_new_tokens,
                     vocab=cfg.vocab_size, eos=tok.eos_token_id,
                     pad=tok.pad_token_id, what=what)
        timing = {
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tok_s": st["gen_tokens"] / st["decode_s"],
            "ms_per_step": st["decode_s"] * 1e3 / res.steps_dispatched,
            "steps": res.steps_dispatched, "gen_tokens": st["gen_tokens"],
            "wall_s": wall,
        }
        print(f"rollout {what}: {res.steps_dispatched} decode steps, "
              f"{st['gen_tokens']} tokens; prefill {timing['prefill_tok_s']:.1f} tok/s "
              f"({st['prefill_tokens']} prompt tokens, {st['prefill_s'] * 1e3:.1f} ms); "
              f"decode {timing['decode_tok_s']:.1f} tok/s, "
              f"{timing['ms_per_step']:.2f} ms/step; {card}")
        return res, timing

    reset_counts()
    sampled, t_sampled = run(train, seed + 1, "sampled t=1.2 top_p=0.95")
    g1, t_g1 = run(greedy, seed + 2, "greedy #1")
    g2, t_g2 = run(greedy, seed + 3, "greedy #2")
    counts = read_counts()

    check(np.array_equal(g1.tokens, g2.tokens) and np.array_equal(g1.lengths, g2.lengths),
          "two greedy rounds differ")
    dlogp = float(np.abs(g1.logprobs - g2.logprobs).max())
    check(not np.array_equal(sampled.tokens, g1.tokens), "the sampled round equals greedy")
    steps = sampled.steps_dispatched + g1.steps_dispatched + g2.steps_dispatched
    print(f"rollout: two greedy rounds identical (max |dlogp| {dlogp:.3g}); "
          f"{steps} decode steps dispatched in all; launches {counts}")

    flat = decode_batch(tok, sampled.tokens.reshape(-1, max_new_tokens),
                        sampled.lengths.reshape(-1))
    groups = [(flat[b * n:(b + 1) * n], [solutions[b]] * n) for b in range(len(PROBLEMS))]
    rewards = RewardComputer()(groups)
    check(all(r.shape == (n, 2) and np.isfinite(r).all() for r in rewards),
          "reward arrays of the wrong shape or non-finite")
    mean = np.concatenate(rewards).mean(axis=0)
    print(f"rollout: sampled round scored, mean format reward {mean[0]:.4f}, "
          f"mean accuracy {mean[1]:.4f}")
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    out = {"counts": counts, "steps": steps, "sampled": t_sampled,
           "greedy": [t_g1, t_g2], "peak_gib": peak}
    if profile:
        prof = profile_decode(lambda k: engine.generate(
            model, lora, ids, mask, greedy.replace(max_tokens=k), seed).steps_dispatched)
        wall = t_g2["ms_per_step"]
        print(f"profile: {prof['device_ms_per_step']:.3f} ms of device time per decode "
              f"step in {prof['kernels_per_step']} kernel names, against "
              f"{wall:.3f} ms/step unprofiled: device idle "
              f"{100 * (1 - prof['device_ms_per_step'] / wall):.1f}%; {card}")
        for name, ms in prof["top"]:
            print(f"profile: {ms:8.4f} ms/step  {name[:110]}")
        out["profile"] = prof
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28,
                    help="decoder depth of the Qwen2.5-7B-wide model (28 = full)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print the device time per decode step by kernel "
                         "(torch.profiler) and the device's idle share")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import distrl_llm_tpu_torch

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
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"build {kname}: {line.strip()}")

    # 3. kernels against their plain versions
    err = compare_fused_sample("cuda", args.seed)
    results = {"fused_sample": {"max_abs_err": err, **time_fused_sample(args.seed)}}
    for kname, r in results.items():
        print(f"kernel {kname} at [{ROWS},{VOCAB}]: {r['ms']:.4f} ms, plain version "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{card}")

    # 4. the main path at full width
    cfg = dataclasses.replace(QWEN2_7B, num_layers=args.layers)
    out = rollout(cfg, "cuda", seed=args.seed, card=card, profile=args.profile)
    check(out["steps"] > 0, "no decode step ran")
    for kname, count in out["counts"].items():
        check(count > 0, f"kernel {kname} was not launched on the main path")
    check(out["counts"]["fused_sample"] == out["steps"],
          f"fused_sample launches {out['counts']['fused_sample']} != decode steps "
          f"{out['steps']}")
    print(f"rollout: peak device memory {out['peak_gib']:.2f} GiB; "
          f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for k in KERNELS:
        r = results[k["name"]]
        kernels.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": out["counts"][k["name"]],
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
