"""Decode scan chunks as CUDA graphs: k decode steps captured once, then
replayed.

Counterpart of the JAX package's chunked decode programs (``_decode_chunk``
and ``_paged_decode_chunk`` over ``scan_steps_guarded``, cached per key by
``_chunk_fn_for_bucket`` and ``_wave_chunk_fn``). There ``lax.scan`` runs k
decode steps in one dispatch; here the kernels of k steps are captured once
as a ``torch.cuda.CUDAGraph`` and replayed, so the host launches one graph
(and reads ``done`` once) per chunk instead of k steps' worth of kernels.

* **Eager first, then capture.** The first chunk of a key on a thread and
  stream runs eagerly: it builds the kernels (``nvcc``), creates the
  thread's cuBLAS handle and workspace, fills the launch planners' caches
  (``plan_sample_cluster``, ``plan_split_k``) and sets the kernels'
  attributes, none of which a capture may do. The next chunk of that key is
  captured on the thread's own side stream with ``capture_error_mode=
  "thread_local"`` (the trainer's rollout thread captures while the
  learner's thread goes on using the card) and replayed on the caller's
  stream; every later chunk of the key is replayed. The capture waits for
  nothing device-wide (``torch.cuda.graph`` would synchronize the device and
  empty the allocator's cache, stalling the other thread's work): the side
  stream is ordered after the caller's, and the caller's after the capture.
  All graphs share one memory pool: they never run at once, and nothing
  they allocate outlives a replay.
* **Static state.** A chunk body reads and writes only tensors that live
  across replays (the engine's decode state, held for that purpose) and
  reads nothing back to the host: no ``.item()``, ``bool()``, ``.cpu()`` or
  boolean-mask indexing inside a chunk.
* **Weights and adapters are read by address.** The key holds their tensor
  addresses, so an in-place update (the trainer's push, full fine-tuning's
  cast into the rollout copy) is read by the next replay, and an adapter at
  other addresses is another key: its first chunk runs eagerly and the next
  is captured (the JAX package's ``rebuild``).
* **Random draws inside a chunk.** A step that draws from a
  ``torch.Generator`` inside the chunk (the speculative step's uniforms and
  Gumbel noise, the self-drafter's) names it: it is registered with the
  graph before the capture, so each replay reads the generator's seed and
  offset as they stand and advances the offset by the chunk's draws, as the
  eager steps would (``CUDAGraph.register_generator_state``). Draws made
  before a chunk (the plain steps' seed vectors) need nothing.
* **Launch counts.** The kernel wrappers count their launches in Python,
  which a replay never runs. While a thread captures, its launches go to
  the capture (``ops/launch_count.py::diverted``), not to the counts, so
  another thread's launches meanwhile stay its own; each replay adds the
  captured counts.
* **No fallback.** On a CUDA device a chunk is replayed or its capture
  raises; nothing catches a failed capture and runs the chunk eagerly. The
  JAX package's memory guard (``compile_chunk_guarded``, which falls back to
  per-step dispatch when XLA double-buffers the scanned KV cache) has no
  counterpart: a graph writes the cache in place.

On the CPU nothing is graphed: the same body runs eagerly at the same
cadence, which is what the tests hold against the JAX engines.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Hashable

import torch

from distrl_llm_tpu_torch.ops import launch_count


def tensors_key(tree: Any) -> Hashable:
    """The addresses, shapes and dtypes of a tree's tensors (dicts in key
    order, lists, tuples; a module's parameters and buffers): what a
    captured graph reads them by."""
    if tree is None:
        return None
    if isinstance(tree, torch.nn.Module):
        tree = [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(), tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, tensors_key(tree[k])) for k in sorted(tree))
    return tuple(tensors_key(t) for t in tree)


class DecodeGraphs:
    """The captured chunks of one engine, by key, with their counts:
    ``captures`` and ``replays``, ``eager_chunks`` (chunks run as plain
    launches: a key's first chunk on a thread and stream on the card, every
    chunk on the CPU), and ``captured_keys``, every key captured, in order
    and across ``clear``."""

    def __init__(self):
        self._graphs: dict[Hashable, tuple[torch.cuda.CUDAGraph, dict]] = {}
        # (key, thread, stream) whose first chunk ran eagerly
        self._warm: set = set()
        self._pool = None
        # each capturing thread's side stream, by thread ident
        self._capture_streams: dict[int, torch.cuda.Stream] = {}
        self.captures = 0
        self.replays = 0
        self.eager_chunks = 0
        self.captured_keys: list[Hashable] = []

    def run(self, key: Hashable, body: Callable[[], None], device: torch.device,
            generators: tuple = ()) -> None:
        """Run one chunk: ``body()`` does its decode steps in place over
        static tensors, drawing only from ``generators``. On a CUDA device it
        runs eagerly the first time ``key`` is seen on this thread and
        stream, is captured the next time (unless another thread captured
        it), and is replayed from then on; on the CPU it runs eagerly."""
        hit = self._graphs.get(key)
        if hit is None:
            warm = (key, threading.get_ident(),
                    torch.cuda.current_stream(device).cuda_stream
                    if device.type == "cuda" else None)
            if device.type != "cuda" or warm not in self._warm:
                body()
                self.eager_chunks += 1
                if device.type == "cuda":
                    self._warm.add(warm)
                return
            hit = self._capture(key, body, device, generators)
        graph, launches = hit
        graph.replay()
        launch_count.add_counts(launches)
        self.replays += 1

    def _capture(self, key, body, device, generators):
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        ident = threading.get_ident()
        with torch.cuda.device(device):
            side = self._capture_streams.get(ident)
            if side is None:
                side = self._capture_streams[ident] = torch.cuda.Stream(device)
            caller = torch.cuda.current_stream(device)
            side.wait_stream(caller)
            with launch_count.diverted() as launches, torch.cuda.stream(side):
                graph.capture_begin(*(() if self._pool is None else (self._pool,)),
                                    capture_error_mode="thread_local")
                try:
                    body()
                finally:
                    graph.capture_end()
            caller.wait_stream(side)
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[key] = (graph, dict(launches))
        self.captures += 1
        self.captured_keys.append(key)
        return graph, launches

    def clear(self) -> None:
        """Drop every graph (their memory pool with them): the static state
        they read is about to go."""
        self._graphs.clear()
        self._warm.clear()
        self._pool = None
