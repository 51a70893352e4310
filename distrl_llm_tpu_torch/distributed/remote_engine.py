"""``RemoteEngine``: the engine surface over control-plane worker processes
(JAX ``distributed/remote_engine.py``).

The trainer drives it as it drives a local engine: ``generate(model, lora,
prompt_ids, prompt_mask, sampling, seed)`` splits the batch into
``even_chunks`` shards, one per healthy worker, ships each to a worker
process (``distributed/worker_main.py``) that runs its own engine, and
reassembles the results in order. A worker's death resubmits its shards to
the others (``DriverClient``), never aborts the run.

The adapter travels by one of two routes (``weight_bus``):

* ``"dispatch"``: the adapter tree rides inside every shard payload.
* ``"broadcast"``: ``push_lora(lora, version=)`` hands it to a
  ``WeightBus`` sender thread once per learner version (delta-encoded,
  out-of-band MSG_WEIGHTS frames); dispatches carry only
  ``{"weight_version": v}``, which workers resolve from their adapter
  cache. A push landing mid-round swaps in the worker's engine mailbox, and
  each round's swap events come back, so the trainer's version tags stay
  true.

Trees go over the wire in the JAX package's layout (``{"layers": {target:
{"a", "b"}}}`` of f32 numpy, ``models/convert.py::lora_to_numpy``), so a
checksum here equals the JAX one. ``model`` is ignored: each worker holds
its own base. Shard seeds are drawn from the caller's seed with a torch
generator (the JAX engine draws them with ``jax.random``): greedy rounds
match the JAX package token for token, sampled ones are reproducible.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Sequence

import numpy as np
import torch

from distrl_llm_tpu_torch import telemetry
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.distributed import resilience
from distrl_llm_tpu_torch.distributed.control_plane import DriverClient
from distrl_llm_tpu_torch.distributed.resilience import RetryPolicy, ShardFailedError
from distrl_llm_tpu_torch.engine.engine import GenerationResult, accumulate_round_stats
from distrl_llm_tpu_torch.utils.chunking import even_chunks

log = logging.getLogger(__name__)


def adapter_to_numpy(lora):
    """An adapter as the wire's JAX-layout tree: the port's dict of tensors
    through ``lora_to_numpy`` (a host copy), a numpy tree as it is."""
    from distrl_llm_tpu_torch.models.convert import lora_to_numpy

    leaf = next(iter(next(iter(lora["layers"].values())).values()))
    return lora_to_numpy(lora) if torch.is_tensor(leaf) else lora


class RemoteEngine:
    """Engine facade over N control-plane workers."""

    is_remote = True

    def __init__(self, driver: DriverClient, *, max_prompt_tokens: int, max_new_tokens: int,
                 timeout_ms: int = 240_000,  # the reference's ray.get(timeout=240)
                 cold_timeout_ms: int = 1_800_000,  # a shape's first round builds graphs
                 lora_scale: float = 1.0,
                 eos_token_ids: Sequence[int] | None = None,
                 degrade_on_shard_failure: bool = False,
                 weight_bus: str = "dispatch"):
        if weight_bus not in ("dispatch", "broadcast"):
            raise ValueError(f"weight_bus must be 'dispatch' or 'broadcast', got {weight_bus!r}")
        self.driver = driver
        self.max_prompt_tokens = max_prompt_tokens
        self.max_new_tokens = max_new_tokens
        self.timeout_ms = timeout_ms
        self.cold_timeout_ms = cold_timeout_ms
        self.lora_scale = lora_scale
        # degrade instead of raise on a quarantined shard: its rows come back
        # zero-filled and listed in last_lost_rows, and the trainer drops them
        self.degrade_on_shard_failure = degrade_on_shard_failure
        self.last_lost_rows: list[int] = []
        # the trainer's whole stop-token set goes with every shard (a worker
        # defaults to its tokenizer's one eos)
        self.eos_token_ids = list(eos_token_ids) if eos_token_ids else None
        # a (shard sizes, n) shape's first round gets the cold deadline: the
        # worker's engine allocates and captures its graphs; a rejoin (a
        # fresh worker process) makes every shape cold again
        self._warm_keys: set[tuple] = set()
        self._seen_rejoin_epoch = getattr(driver, "rejoin_epoch", 0)
        self.last_round_stats: dict | None = None
        # per shard of the last round: {rows, worker, dispatch_id,
        # round_stats} (the worker engine's own stats of that shard)
        self.last_shard_meta: list[dict] = []
        self.weight_bus_mode = weight_bus
        self.bus = None
        # the engine-lifetime swap log the trainer slices per round, merged
        # from the workers' per-round events
        self.last_swap_steps: list[int] = []
        self.last_swap_versions: list[int | None] = []
        self.supports_inflight_push = weight_bus == "broadcast"
        # the latest push as one tuple (lora, lora_np, version): readers on
        # other threads snapshot it once
        self._bus_state: tuple | None = None
        self._auto_version = -1
        self._versioned_pushes = False  # the caller owns the version sequence
        self._round_state: tuple | None = None  # the re-request's source
        if weight_bus == "broadcast":
            from distrl_llm_tpu_torch.distributed.weight_bus import WeightBus

            self.bus = WeightBus(driver.addresses, retry_policy=driver.retry)
            driver.rejoin_hook = self._rejoin_resync
            driver.transient_hook = self._transient_resync
            driver.shutdown_hooks.append(self.bus.close)

    # ------------------------------------------------------------ membership

    def add_worker(self, address) -> bool:
        """Admit one worker mid-run: the bus learns it first (the admission
        hook resyncs through it)."""
        address = self.driver._parse_address(address)
        if self.bus is not None:
            self.bus.add_worker(tuple(address))
        if self.driver.add_worker(address):
            return True
        if self.bus is not None:
            self.bus.retire_worker(tuple(address))
        return False

    def retire_worker(self, address, drain: bool = True) -> bool:
        address = self.driver._parse_address(address)
        ok = self.driver.retire_worker(address, drain=drain)
        if self.bus is not None:
            self.bus.retire_worker(tuple(address))
        return ok

    # ------------------------------------------------------------ weight bus

    def push_lora(self, lora, version: int | None = None) -> None:
        """Broadcast one adapter version to every worker, asynchronously; a
        round in flight swaps it in mid-generation. Idempotent per (tree
        identity, version)."""
        if self.bus is None:
            raise RuntimeError(
                "push_lora requires weight_bus='broadcast' — this RemoteEngine ships "
                "adapters inside dispatch payloads (weight_bus='dispatch') and cannot "
                "update a round in flight")
        if lora is None:
            raise ValueError("push_lora needs an adapter tree, got None")
        if version is None:
            self._auto_version += 1
            version = self._auto_version
        else:
            self._auto_version = max(self._auto_version, int(version))
            self._versioned_pushes = True
        state = self._bus_state
        if state is not None and lora is state[0] and int(version) == state[2]:
            return  # already pushed
        # a host copy now, on the caller's thread: the learner updates its
        # tensors in place at the next step
        lora_np = adapter_to_numpy(lora)
        self._bus_state = (lora, lora_np, int(version))
        self.bus.push(lora_np, int(version))

    def _rejoin_resync(self, address) -> bool:
        """Rejoin hook: a full resync of the current version before the
        recovered worker is re-admitted."""
        state = self._bus_state
        if state is None:
            return True
        return self.bus.sync_worker(tuple(address), state[1], state[2])

    def _transient_resync(self, worker, error) -> None:
        """Transient-retry hook: a worker that lacked this round's version
        gets it re-pushed full before the retry."""
        if "WeightVersionError" not in getattr(error, "traceback_text", ""):
            return
        state = self._round_state
        if state is None:
            return
        telemetry.counter_add(resilience.CP_WEIGHT_REREQUESTS)
        self.bus.sync_worker(tuple(worker.address), state[1], state[2])

    def _merge_swap_events(self, results: list) -> None:
        """Fold the workers' per-round swap logs into the lifetime lists;
        per version the latest step any shard swapped at (tokens are tagged
        no newer than any shard sampled them)."""
        merged: dict[int, int] = {}
        for r in results:
            if not r:
                continue
            for step, version in zip(r.get("swap_steps") or (), r.get("swap_versions") or ()):
                if version is None:
                    continue
                merged[int(version)] = max(merged.get(int(version), -1), int(step))
        for v in sorted(merged, key=lambda v: (merged[v], v)):
            self.last_swap_steps.append(merged[v])
            self.last_swap_versions.append(v)

    # ------------------------------------------------------------ generation

    def generate(self, model, lora, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                 sampling: SamplingConfig, seed: int) -> GenerationResult:
        b, p = prompt_ids.shape
        if p != self.max_prompt_tokens:
            raise ValueError(f"prompts must be padded to {self.max_prompt_tokens}, got {p}")
        sizes = even_chunks(b, min(max(self.driver.num_healthy, 1), b))
        lora_np = weight_version = None
        if lora is not None and self.bus is not None:
            state = self._bus_state
            if state is None or (lora is not state[0] and not self._versioned_pushes):
                self.push_lora(lora)  # a caller that names no versions
                state = self._bus_state
            elif lora is not state[0]:
                # the caller owns the versions and a newer push raced this
                # round's entry: dispatch the newest (as a swap at step 0)
                log.info("generate() entered with a superseded adapter tree; dispatching "
                         "the newest pushed version v%d", state[2])
            weight_version = state[2]
            self._round_state = state
        elif lora is not None:
            lora_np = adapter_to_numpy(lora)
        gen = torch.Generator().manual_seed(int(seed))
        seeds = torch.randint(np.iinfo(np.int32).max, (len(sizes),), generator=gen).tolist()
        shards, start = [], 0
        for i, size in enumerate(sizes):
            shards.append(("generate", {
                "prompt_ids": np.asarray(prompt_ids[start:start + size]),
                "prompt_mask": np.asarray(prompt_mask[start:start + size]),
                "sampling": dataclasses.asdict(sampling),
                "lora": lora_np,
                "weight_version": weight_version,
                "lora_scale": self.lora_scale,
                "eos_token_ids": self.eos_token_ids,
                "rng_seed": int(seeds[i]),
            }))
            start += size
        epoch = getattr(self.driver, "rejoin_epoch", 0)
        if epoch != self._seen_rejoin_epoch:
            self._seen_rejoin_epoch = epoch
            self._warm_keys.clear()
        warm_key = (tuple(sizes), sampling.n)
        timeout = (self.timeout_ms if warm_key in self._warm_keys
                   else max(self.timeout_ms, self.cold_timeout_ms))
        t0 = time.perf_counter()
        with telemetry.span("engine/remote_round"):
            results = self.driver.dispatch_objects(
                shards, timeout_ms=timeout, allow_partial=self.degrade_on_shard_failure)
            dmeta = getattr(self.driver, "last_dispatch_meta", None) or []
            self.last_shard_meta, row0 = [], 0
            for i, size in enumerate(sizes):
                m = dmeta[i] if i < len(dmeta) else None
                r = results[i] if i < len(results) else None
                self.last_shard_meta.append({
                    "rows": (row0, row0 + size),
                    "worker": m.get("worker") if m else None,
                    "dispatch_id": m.get("dispatch_id") if m else None,
                    "round_stats": r.get("round_stats") if r else None,
                })
                row0 += size
            self._merge_swap_events(results)  # a quarantined shard has none
            results, self.last_lost_rows = self._fill_lost_shards(results, sizes)
            tokens = np.concatenate([r["tokens"] for r in results], axis=0)
            lengths = np.concatenate([r["lengths"] for r in results], axis=0)
        self._warm_keys.add(warm_key)
        self.last_round_stats = accumulate_round_stats(
            None, prefill_s=0.0, prefill_tokens=int(np.asarray(prompt_mask).sum()),
            prompt_rows=b, decode_s=time.perf_counter() - t0, gen_tokens=int(lengths.sum()),
            gen_rows=b * max(sampling.n, 1))
        logps = None
        if all(r.get("logprobs") is not None for r in results):
            logps = np.concatenate([r["logprobs"] for r in results], axis=0)
        steps = [r.get("steps_dispatched") for r in results]
        return GenerationResult(
            tokens=tokens, lengths=lengths, logprobs=logps,
            steps_dispatched=max(steps) if steps and None not in steps else None)

    def _fill_lost_shards(self, results: list, sizes: Sequence[int]) -> tuple[list, list[int]]:
        """Zero-fill quarantined shards (None slots) so the arrays keep their
        shape, and list the lost rows; surviving + lost rows = the round's."""
        if all(r is not None for r in results):
            return list(results), []
        survivors = [r for r in results if r is not None]
        if not survivors:
            raise ShardFailedError(-1, message=(
                "every shard in the round was quarantined — no surviving groups to "
                "degrade to"))
        ref = survivors[0]
        filled, lost_rows, start = [], [], 0
        for r, size in zip(results, sizes):
            if r is None:
                lost_rows.extend(range(start, start + size))
                r = {k: np.zeros((size,) + ref[k].shape[1:], dtype=ref[k].dtype)
                     for k in ("tokens", "lengths")}
                r["logprobs"] = (None if ref.get("logprobs") is None else np.zeros(
                    (size,) + ref["logprobs"].shape[1:], dtype=ref["logprobs"].dtype))
            filled.append(r)
            start += size
        assert sum(sizes) == start and len(lost_rows) < start
        telemetry.counter_add(resilience.CP_DEGRADED_GROUPS, len(lost_rows))
        return filled, lost_rows


def connect_remote_engine(addresses: Sequence[tuple[str, int]], *, max_prompt_tokens: int,
                          max_new_tokens: int, timeout_ms: int = 240_000,
                          lora_scale: float = 1.0,
                          eos_token_ids: Sequence[int] | None = None,
                          retry_policy: RetryPolicy | None = None,
                          poison_threshold: int = 3, rejoin: bool = True,
                          degrade_on_shard_failure: bool = False,
                          weight_bus: str = "dispatch") -> RemoteEngine:
    """Connect to running workers and wrap them as an engine (the raw API
    defaults to "dispatch"; ``TrainConfig.weight_bus`` to "broadcast")."""
    return RemoteEngine(
        DriverClient(addresses, retry_policy=retry_policy, poison_threshold=poison_threshold,
                     rejoin=rejoin),
        max_prompt_tokens=max_prompt_tokens, max_new_tokens=max_new_tokens,
        timeout_ms=timeout_ms, lora_scale=lora_scale, eos_token_ids=eos_token_ids,
        degrade_on_shard_failure=degrade_on_shard_failure, weight_bus=weight_bus)
