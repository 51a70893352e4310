"""Worker process entry point of the control plane (JAX
``distributed/worker_main.py``).

``python -m distrl_llm_tpu_torch.distributed.worker_main --port 0`` starts a
worker that prints ``PORT <n>`` on stdout and serves control-plane
requests. Request payloads are pickled ``(op, arg)`` tuples:

* ``("echo", x)`` -> x;
* ``("sleep", seconds)`` -> "slept";
* ``("flaky", {"key", "fails"})``: a transient ConnectionError for the first
  ``fails`` calls sharing ``key``, then ``("ok", key, n)``;
* ``("rollout_rewards", chunk)``: per group the (n, 2) rewards of
  ``rewards.py::reward_function`` over ``chunk["answers"]`` and
  ``chunk["solution"]``;
* ``("weights_debug", arg)``: the adapter cache's versions and per-version
  checksums; ``{"corrupt": v}`` flips one byte of a cached leaf first;
* ``("generate", shard)``: a rollout shard through this worker's own engine
  (``--serve-model``), with the adapter shipped in the shard or a
  ``weight_version`` resolved from the adapter cache; returns tokens,
  lengths, behavior logprobs, the round's in-flight swap events and its
  engine stats (decode steps, forwards, sampler calls).

MSG_WEIGHTS frames (the driver's ``WeightBus``, on a connection of their
own, beside a dispatch in flight) are decoded, checksum-checked, cached,
copied into a ring of persistent device buffers (``rollout/adapter_ring.py``)
and handed to the engine's mailbox, which swaps them in at the next decode
step or chunk boundary of a round in flight. A CUDA graph reads its adapter
by address, so the ring keeps a round's graph keys to its buffers. SIGTERM
drains: the dispatch in flight still delivers its result; the worker then
prints the kernels' launch counts of its whole life (``LAUNCHES {...}``), its
peak device memory and ``DRAINED``, and exits 0.

The worker runs on the GPU unless ``--device cpu``; without a GPU it fails.
The flags of the observability, trace, metrics, control, serving and
gateway planes, and ``--autotune on`` / ``--plan-db``, raise
``NotImplementedError`` naming ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import signal
import threading
import time

_ENGINE_STATE: dict = {}
_FLAKY_COUNTS: dict[str, int] = {}
_PLANE_ITEM = "ROADMAP queue 1 item 11"
# the flags of item 11's planes: (dest, default); any other value raises
_PLANE_FLAGS = {
    "trace": False, "metrics_port": None, "serving_obs": False, "serving_dir": None,
    "serving_ring": 1024, "gateway_port": None, "gateway_classes": None,
    "tenant_quota": None, "control": False, "control_hbm": False, "control_shed": False,
    "control_budget": 64, "control_cooldown_steps": 2, "control_dwell_steps": 3,
    "slo_ttft_ms": None, "slo_queue_wait_ms": None, "plan_db": None,
}


def _tokens(model: str):
    """(eos ids, pad id) from the checkpoint's tokenizer, as the JAX worker
    reads them."""
    if not os.path.isfile(os.path.join(model, "tokenizer.json")):
        raise ValueError(f"{model} has no tokenizer.json: the worker reads EOS and pad "
                         "from the checkpoint's tokenizer")
    from distrl_llm_tpu_torch.tokenizer import load_tokenizer
    from distrl_llm_tpu_torch.trainer import stop_token_ids

    tok = load_tokenizer(model)
    return (stop_token_ids(tok),
            tok.pad_token_id if tok.pad_token_id is not None else tok.eos_token_id)


def _init_engine(model: str, max_prompt_tokens: int, max_new_tokens: int, seed: int, *,
                 device: str = "cuda", dtype: str = "bfloat16", lora_rank: int = 32,
                 lora_alpha: float = 16.0, engine_impl: str = "dense",
                 kv_quant: str | None = None, base_quant: str = "none",
                 quant_group_size: int | None = None, max_concurrent: int = 0,
                 scheduler: str = "waves", decode_chunk: int | None = None,
                 spec_draft: int | None = None, spec_ngram: int | None = None,
                 spec_drafter: str | None = None, spec_verify: str | None = None,
                 spec_adapt: bool = False, prefix_sharing: bool = False,
                 continuous_admission: bool = False, prefix_cache: bool | None = None,
                 kv_spill: bool = False, kv_spill_host_mb: int = 0, gpu_usage: float = 0.0,
                 budget_batch: int = 0, scan_chunk: int | None = None,
                 capture_logprobs: bool = False, attn_impl: str = "reference") -> None:
    """Build this worker's rollout engine over ``model``: a local HF
    checkpoint directory (read at ``dtype``), or "tiny" (the TINY preset
    with random weights from ``seed``, eos vocab-1 and pad 0; the port's
    generator, so not the JAX worker's tiny weights)."""
    import torch

    from distrl_llm_tpu_torch.distributed.weight_bus import AdapterCache
    from distrl_llm_tpu_torch.engine import GenerationEngine, PagedGenerationEngine
    from distrl_llm_tpu_torch.models.lora import lora_scale as _scale
    from distrl_llm_tpu_torch.ops.quant import quantize_base
    from distrl_llm_tpu_torch.rollout.adapter_ring import AdapterRing
    from distrl_llm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    torch_dtype = getattr(torch, dtype)
    if model == "tiny":
        from distrl_llm_tpu_torch.models.configs import TINY
        from distrl_llm_tpu_torch.models.transformer import init_params

        cfg = TINY
        decoder = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                              dtype=torch_dtype)
        eos, pad = [cfg.vocab_size - 1], 0
    else:
        from distrl_llm_tpu_torch.models.loading import load_pretrained

        decoder, cfg = load_pretrained(model, dtype=torch_dtype, device=dev)
        eos, pad = _tokens(model)
    # the quantized frozen base the driver's base_quant run trains over
    quantize_base(decoder, base_quant, quant_group_size)
    scale = _scale(lora_rank, lora_alpha)
    kwargs: dict = {"kv_quant": kv_quant, "attn_impl": attn_impl}
    if capture_logprobs:
        kwargs["capture_logprobs"] = True
    if scan_chunk is not None:
        kwargs["scan_chunk"] = scan_chunk
    if decode_chunk is not None:
        # the mailbox is polled between dispatches: this bounds how late an
        # in-flight push lands
        kwargs["decode_chunk"] = decode_chunk
    if engine_impl == "paged":
        engine_cls = PagedGenerationEngine
        kwargs["scheduler"] = scheduler
        for name, value in (("spec_draft", spec_draft), ("spec_ngram", spec_ngram),
                            ("spec_drafter", spec_drafter), ("spec_verify", spec_verify),
                            ("prefix_cache", prefix_cache)):
            if value is not None:  # an explicit value, 0 included, is a pin
                kwargs[name] = value
        for name, value in (("spec_adapt", spec_adapt), ("prefix_sharing", prefix_sharing),
                            ("continuous_admission", continuous_admission),
                            ("kv_spill", kv_spill)):
            if value:
                kwargs[name] = True
        if kv_spill and kv_spill_host_mb:
            kwargs["kv_spill_host_mb"] = kv_spill_host_mb
        if gpu_usage > 0:
            # the page pool's budget, the trainer's contract (engine/budget.py)
            from distrl_llm_tpu_torch.engine.budget import kv_pool_pages, tree_bytes
            from distrl_llm_tpu_torch.ops.paged import DEFAULT_PAGE_SIZE

            if budget_batch <= 0:
                raise ValueError("--gpu-usage requires --budget-batch (prompts per round, "
                                 "for the shared prompt-page accounting)")
            kwargs["max_kv_pages"] = kv_pool_pages(
                cfg, gpu_usage=gpu_usage, param_bytes=tree_bytes(decoder),
                batch_prompts=budget_batch, max_prompt_tokens=max_prompt_tokens,
                max_new_tokens=max_new_tokens, page_size=DEFAULT_PAGE_SIZE,
                kv_quant=kv_quant or "none", spec_draft=spec_draft or 0,
                continuous=continuous_admission, prefix_cache=bool(prefix_cache), device=dev)
    else:
        engine_cls = GenerationEngine
    if max_concurrent:
        kwargs["max_concurrent_rows"] = max_concurrent
    engine = engine_cls(cfg, max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
                        eos_token_ids=eos, pad_token_id=pad, cache_dtype=torch_dtype,
                        lora_scale=scale, device=dev, **kwargs)
    # pushed adapters go into persistent buffers: the published one, the
    # one before it (the adapter cache's superseded slot) and a spare that a
    # round opening with an overwritten version, or with an adapter its
    # dispatch ships, is copied into; one more when the self-drafter keeps
    # the previous adapter resident. The mailbox tells the ring of each
    # swap it consumes
    ring = AdapterRing(4 if getattr(engine, "_track_prev_lora", False) else 3, dev)
    engine.lora_swap_hook = ring.swap_hook
    forwards = [0]

    def count_forward(*_):
        # a forward made while a graph is captured launches nothing; the
        # replays' steps come back as the round's graph_steps
        if not (dev.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            forwards[0] += 1

    decoder.register_forward_hook(count_forward)
    _ENGINE_STATE.update(
        engine=engine, model=decoder, cfg=cfg, device=dev, lora_scale=scale, ring=ring,
        forwards=forwards, adapter_cache=AdapterCache(), weights_mu=threading.Lock(),
        weights_stream=torch.cuda.Stream(dev) if dev.type == "cuda" else None)


def _device_adapter(tree):
    """A wire tree as the port's adapter dict on the engine's device (a
    copy)."""
    from distrl_llm_tpu_torch.models.convert import lora_from_numpy

    return lora_from_numpy(tree, _ENGINE_STATE["cfg"], device=_ENGINE_STATE["device"])


def weights_handler(payload: bytes) -> bytes:
    """A MSG_WEIGHTS frame: decode the update (delta against the cached
    base it names), checksum-checked; copy it into the ring's free buffer on
    this connection's own stream; hand it to the engine's mailbox (before
    the cache, which a version-naming dispatch waits on, so that dispatch's
    entry sees the pending swap and discards it); cache it. Pushes are
    serialized: two must never pick the same free buffer."""
    import torch

    from distrl_llm_tpu_torch.distributed.weight_bus import WeightVersionError, decode_update

    cache = _ENGINE_STATE.get("adapter_cache")
    if cache is None:
        raise RuntimeError("worker started without --serve-model: no adapter cache to "
                           "receive weight pushes")
    msg = pickle.loads(payload)
    base_version = msg.get("base_version")
    prev = cache.get(base_version) if base_version is not None else None
    if base_version is not None and prev is None:
        raise WeightVersionError(
            f"delta update v{msg.get('version')} names base v{base_version} which this "
            f"worker does not hold (cache: {cache.versions()}) — WeightVersionError: send full")
    version, tree = decode_update(msg, prev)
    stream = _ENGINE_STATE["weights_stream"]
    with _ENGINE_STATE["weights_mu"]:
        if stream is not None:
            with torch.cuda.device(_ENGINE_STATE["device"]), torch.cuda.stream(stream):
                published = _ENGINE_STATE["ring"].push(_device_adapter(tree), version)
        else:
            published = _ENGINE_STATE["ring"].push(_device_adapter(tree), version)
        _ENGINE_STATE["engine"].push_lora(published, version=version)
        cache.put(version, tree)
    return pickle.dumps({"version": version, "checksum": msg["checksum"]})


def _weights_debug(arg) -> dict:
    from distrl_llm_tpu_torch.distributed.weight_bus import checksum_tree, tree_leaves

    cache = _ENGINE_STATE.get("adapter_cache")
    if cache is None:
        raise RuntimeError("worker started without --serve-model")
    arg = arg or {}
    if arg.get("corrupt") is not None:
        v = int(arg["corrupt"])
        tree = cache.get(v)
        if tree is None:
            raise ValueError(f"no cached adapter v{v} to corrupt")
        tree_leaves(tree)[0].reshape(-1).view("uint8")[0] ^= 0xFF  # one byte, in place
    return {"versions": cache.versions(), "current": cache.current_version,
            "checksums": {v: checksum_tree(cache.get(v)) for v in cache.versions()}}


def _generate(arg) -> dict:
    import torch

    from distrl_llm_tpu_torch.config import SamplingConfig
    from distrl_llm_tpu_torch.distributed import weight_bus as wb

    if "engine" not in _ENGINE_STATE:
        raise RuntimeError("worker started without --serve-model")
    st = _ENGINE_STATE
    engine, ring = st["engine"], st["ring"]
    lora, weight_version, hold = arg["lora"], arg.get("weight_version"), None
    if lora is None and weight_version is not None:
        # the broadcast bus: the named version from the cache, waiting out a
        # dispatch that outran its broadcast; its ring buffer, or a copy into
        # a free one when later pushes overwrote it
        tree = st["adapter_cache"].wait_for(int(weight_version), timeout_s=wb.resolve_wait_s())
        lora, _, hold = ring.acquire(int(weight_version), load=lambda: _device_adapter(tree))
        # a pending swap at or below the entry version would replay as a
        # step-0 swap; a strictly newer one stays for this round to take
        engine.discard_pending_at_or_below(int(weight_version))
    elif lora is not None:
        # dispatch mode: the shipped adapter, copied into a free ring buffer
        shipped = lora
        lora, _, hold = ring.acquire(load=lambda: _device_adapter(shipped))
    if lora is not None:
        want, have = arg.get("lora_scale"), st["lora_scale"]
        if want is not None and abs(want - have) > 1e-9:
            if hold is not None:
                ring.release_round(hold)
            raise ValueError(f"lora_scale mismatch: trainer sends {want}, worker engine "
                             f"built with {have} (--lora-rank/--lora-alpha)")
    eos = arg.get("eos_token_ids")
    if eos:
        want_eos = sorted(set(int(e) for e in eos))
        if engine.eos_ids.tolist() != want_eos:
            # the graphs read the eos ids by address: they go with the tensor
            engine.eos_ids = torch.tensor(want_eos, dtype=torch.int32, device=st["device"])
            engine.release_decode_graphs()
    swaps_before = len(engine.last_swap_steps)
    f0 = st["forwards"][0]
    try:
        result = engine.generate(st["model"], lora, arg["prompt_ids"], arg["prompt_mask"],
                                 SamplingConfig(**arg["sampling"]), int(arg["rng_seed"]))
    finally:
        if hold is not None:
            ring.release_round(hold)
    stats = dict(engine.last_round_stats or {})
    pool = getattr(engine, "last_pool_stats", None) or {}
    stats.update(model_forwards=st["forwards"][0] - f0 + stats.get("graph_steps", 0),
                 resumes=pool.get("resumes", 0), sampler_calls=stats.get(
                     "sampler_calls", result.steps_dispatched),
                 **{k: pool.get(k) for k in ("pool_pages", "peak_pages_used", "preemptions")})
    return {
        "tokens": result.tokens, "lengths": result.lengths, "logprobs": result.logprobs,
        "entry_version": weight_version,
        "swap_steps": list(engine.last_swap_steps)[swaps_before:],
        "swap_versions": list(engine.last_swap_versions)[swaps_before:],
        "steps_dispatched": result.steps_dispatched, "round_stats": stats,
    }


def handler(payload: bytes) -> bytes:
    op, arg = pickle.loads(payload)
    if op == "echo":
        return pickle.dumps(arg)
    if op == "sleep":
        time.sleep(float(arg))
        return pickle.dumps("slept")
    if op == "flaky":
        key = str(arg.get("key", "k"))
        n = _FLAKY_COUNTS.get(key, 0) + 1
        _FLAKY_COUNTS[key] = n
        if n <= int(arg.get("fails", 1)):
            # ConnectionError classifies transient: the driver retries
            raise ConnectionError(f"injected transient fault {n}/{arg.get('fails', 1)} "
                                  f"for {key!r}")
        return pickle.dumps(("ok", key, n))
    if op == "rollout_rewards":
        from distrl_llm_tpu_torch.rewards import reward_function

        return pickle.dumps([reward_function(answers, solutions)
                             for answers, solutions in zip(arg["answers"], arg["solution"])])
    if op == "weights_debug":
        return pickle.dumps(_weights_debug(arg))
    if op == "generate":
        return pickle.dumps(_generate(arg))
    raise ValueError(f"unknown op {op!r}")


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count in this process, by
    ``module.counter``."""
    import importlib

    out = {}
    for name in ("sampling", "paged_native", "flash_attention", "quant_matmul"):
        mod = importlib.import_module(f"distrl_llm_tpu_torch.ops.{name}")
        for attr in sorted(vars(mod)):
            if attr.endswith("_launches") and isinstance(getattr(mod, attr), int):
                out[f"{mod.__name__}.{attr}"] = getattr(mod, attr)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--serve-model", type=str, default=None,
                   help='a local HF checkpoint directory, or "tiny" (random-init test '
                        "model); enables the generate op")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs; cpu runs the plain PyTorch versions")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"],
                   help="the base weights' and KV cache's dtype")
    p.add_argument("--max-prompt-tokens", type=int, default=350)
    p.add_argument("--max-new-tokens", type=int, default=1200)
    p.add_argument("--seed", type=int, default=0, help="the tiny model's random init")
    p.add_argument("--lora-rank", type=int, default=32)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--engine-impl", type=str, default="dense", choices=["dense", "paged"])
    p.add_argument("--attn-impl", type=str, default="reference",
                   choices=["reference", "flash", "splash"],
                   help="prefill attention; flash/splash run kernel K4 on the GPU")
    p.add_argument("--kv-quant", type=str, default=None, choices=["none", "int8"])
    p.add_argument("--base-quant", type=str, default="none", choices=["none", "int8", "int4"],
                   help="weight-only quantization of the frozen base (kernel K3 on the GPU)")
    p.add_argument("--quant-group-size", type=int, default=None,
                   help="groupwise-scale width for --base-quant (unset: int8 per-column, "
                        "int4 64)")
    p.add_argument("--max-concurrent-sequences", type=int, default=0,
                   help="decode row cap; the refill scheduler's slot count")
    p.add_argument("--scheduler", type=str, default="waves", choices=["waves", "refill"])
    p.add_argument("--spec-draft", type=int, default=None)
    p.add_argument("--spec-ngram", type=int, default=None)
    p.add_argument("--spec-drafter", choices=["ngram", "self"], default=None)
    p.add_argument("--spec-verify", choices=["fused", "unrolled"], default=None)
    p.add_argument("--spec-adapt", action="store_true")
    p.add_argument("--prefix-sharing", action="store_true")
    p.add_argument("--continuous-admission", action="store_true")
    p.add_argument("--prefix-cache", choices=("on", "off"), default=None)
    p.add_argument("--kv-spill", action="store_true")
    p.add_argument("--kv-spill-host-mb", type=int, default=0)
    p.add_argument("--gpu-usage", "--actor-gpu-usage", dest="gpu_usage", type=float,
                   default=0.0,
                   help="device-memory fraction for weights and KV: sizes the paged "
                        "engine's page pool (0 = the worst case). Two workers and a "
                        "driver on one card must keep their shares under 1 together")
    p.add_argument("--budget-batch", type=int, default=0,
                   help="prompts per round assumed by the page-budget math")
    p.add_argument("--decode-chunk", type=int, default=None,
                   help="decode steps per host check (engine default 128); bounds how "
                        "late an in-flight push lands")
    p.add_argument("--decode-scan-chunk", "--scan-chunk", dest="decode_scan_chunk", type=int,
                   default=None,
                   help="decode steps per CUDA graph chunk (0 or 1: one step at a time)")
    p.add_argument("--capture-logprobs", action="store_true",
                   help="record behavior logprobs (the driver's clip_ratio / async runs; "
                        "declare it there with --workers_capture_logprobs)")
    p.add_argument("--env", type=str, default="math", choices=["code", "math", "verifier"])
    p.add_argument("--max-turns", type=int, default=1)
    p.add_argument("--fault-schedule", type=str, default=None,
                   help="fault-injection schedule for this worker's connections "
                        "(resilience.FaultInjector grammar); also $DISTRL_FAULT_SCHEDULE")
    p.add_argument("--autotune", type=str, default=None, choices=["on", "off"],
                   help="off: the engines' static defaults (the port has no plan DB)")
    # item 11's planes
    p.add_argument("--plan-db", dest="plan_db", type=str, default=None)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--metrics-port", type=int, default=None)
    p.add_argument("--serving-obs", dest="serving_obs", action="store_true")
    p.add_argument("--serving-dir", dest="serving_dir", type=str, default=None)
    p.add_argument("--serving-ring", dest="serving_ring", type=int, default=1024)
    p.add_argument("--gateway-port", dest="gateway_port", type=int, default=None)
    p.add_argument("--gateway-classes", dest="gateway_classes", type=str, default=None)
    p.add_argument("--tenant-quota", dest="tenant_quota", type=str, default=None)
    p.add_argument("--control", action="store_true")
    p.add_argument("--control-hbm", dest="control_hbm", action="store_true")
    p.add_argument("--control-shed", dest="control_shed", action="store_true")
    p.add_argument("--control-budget", dest="control_budget", type=int, default=64)
    p.add_argument("--control-cooldown-steps", dest="control_cooldown_steps", type=int,
                   default=2)
    p.add_argument("--control-dwell-steps", dest="control_dwell_steps", type=int, default=3)
    p.add_argument("--slo-ttft-ms", dest="slo_ttft_ms", type=float, default=None)
    p.add_argument("--slo-queue-wait-ms", dest="slo_queue_wait_ms", type=float, default=None)
    return p


def validate(parser: argparse.ArgumentParser, args) -> None:
    """The JAX worker's dead-flag rules, and item 11's flags refused."""
    for dest, default in _PLANE_FLAGS.items():
        if getattr(args, dest) != default:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')}: the worker's observability, trace, metrics, "
                f"control, serving, gateway and autotune planes are not ported ({_PLANE_ITEM})")
    if args.autotune == "on":
        raise NotImplementedError(f"--autotune on: the plan DB is not ported ({_PLANE_ITEM})")
    if args.decode_chunk is not None and args.decode_chunk < 1:
        parser.error("--decode-chunk must be >= 1")
    if args.env != "math" or args.max_turns != 1:
        parser.error("--env/--max-turns: multi-turn environments run driver-local only (the "
                     "turn hook lives on the driver's paged engine); start the driver "
                     "without --rollout_workers for env runs")
    if args.quant_group_size is not None and args.quant_group_size < 1:
        parser.error("--quant-group-size must be >= 1")
    if args.quant_group_size is not None and args.base_quant == "none":
        parser.error("--quant-group-size configures --base-quant's groupwise scales — set "
                     "--base-quant int8/int4 (it would be silently ignored)")
    if args.scheduler == "refill" and args.engine_impl != "paged":
        parser.error("--scheduler refill requires --engine-impl paged")
    if args.scheduler != "refill" and (
            args.spec_draft or args.spec_ngram is not None or args.spec_drafter is not None
            or args.spec_verify is not None or args.spec_adapt):
        parser.error("--spec-draft/--spec-ngram/--spec-drafter/--spec-verify/--spec-adapt "
                     "require --scheduler refill (the refill scheduler hosts speculative "
                     "decoding)")
    if args.spec_draft == 0 and (
            args.spec_ngram is not None or args.spec_drafter is not None
            or args.spec_verify is not None or args.spec_adapt):
        parser.error("--spec-ngram/--spec-drafter/--spec-verify/--spec-adapt require "
                     "--spec-draft > 0 (--spec-draft 0 pins speculation off)")
    if args.scheduler != "refill" and (args.prefix_sharing or args.continuous_admission):
        parser.error("--prefix-sharing/--continuous-admission require --scheduler refill")
    if args.scheduler == "refill" and not args.max_concurrent_sequences:
        parser.error("--scheduler refill requires --max-concurrent-sequences (the decode "
                     "slot count)")
    if args.prefix_cache == "on" and not args.continuous_admission:
        parser.error("--prefix-cache on aliases cached prompt chains out of the "
                     "continuous-admission pool — add --continuous-admission")
    if args.prefix_cache == "on" and args.kv_quant == "int8":
        parser.error("--prefix-cache on requires a lossless KV pool — drop --kv-quant int8 "
                     "or the cache")
    if args.kv_spill and args.prefix_cache != "on":
        parser.error("--kv-spill parks KV pages through the tiered cache's host store — it "
                     "requires --prefix-cache on")
    if args.kv_spill and args.spec_draft:
        parser.error("--kv-spill restores raw decode cursors the speculative scheduler does "
                     "not expose — drop --kv-spill or --spec-draft")
    if args.kv_spill_host_mb and not args.kv_spill:
        parser.error("--kv-spill-host-mb caps the --kv-spill host store — it would be a dead "
                     "knob without it")


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    validate(parser, args)
    if args.fault_schedule:
        os.environ["DISTRL_FAULT_SCHEDULE"] = args.fault_schedule
    if args.serve_model:
        _init_engine(
            args.serve_model, args.max_prompt_tokens, args.max_new_tokens, args.seed,
            device=args.device, dtype=args.dtype, lora_rank=args.lora_rank,
            lora_alpha=args.lora_alpha, engine_impl=args.engine_impl, kv_quant=args.kv_quant,
            base_quant=args.base_quant, quant_group_size=args.quant_group_size,
            max_concurrent=args.max_concurrent_sequences, scheduler=args.scheduler,
            decode_chunk=args.decode_chunk, spec_draft=args.spec_draft,
            spec_ngram=args.spec_ngram, spec_drafter=args.spec_drafter,
            spec_verify=args.spec_verify, spec_adapt=args.spec_adapt,
            prefix_sharing=args.prefix_sharing,
            continuous_admission=args.continuous_admission,
            prefix_cache=None if args.prefix_cache is None else args.prefix_cache == "on",
            kv_spill=args.kv_spill, kv_spill_host_mb=args.kv_spill_host_mb,
            gpu_usage=args.gpu_usage, budget_batch=args.budget_batch,
            scan_chunk=args.decode_scan_chunk, capture_logprobs=args.capture_logprobs,
            attn_impl=args.attn_impl)

    from distrl_llm_tpu_torch.distributed.control_plane import WorkerServer

    server = WorkerServer(port=args.port)
    if args.serve_model:
        server.weights_handler = weights_handler
    signal.signal(signal.SIGTERM, lambda signum, frame: server.request_shutdown())
    print(f"PORT {server.port}", flush=True)
    server.serve_forever(handler)
    if server.draining:
        print(f"LAUNCHES {json.dumps(launch_counts())}", flush=True)
        dev = _ENGINE_STATE.get("device")
        if dev is not None and dev.type == "cuda":
            import torch

            print(f"PEAK_GIB {torch.cuda.max_memory_allocated(dev) / 2**30:.3f}", flush=True)
        print("DRAINED", flush=True)


if __name__ == "__main__":
    main()
