"""Checkpoint / resume: the trainer's resume state and the adapter artifact.

* :class:`CheckpointManager` — one file per step of the full learner state
  {the trainable tree (the adapter, or full fine-tuning's f32 master
  weights by parameter name), optimizer ``state_dict()``, step, episode,
  batch-in-episode, samples, the trainer's generator state}, published by
  an atomic rename and
  pruned to the newest ``MAX_TO_KEEP`` (3, as the JAX package's Orbax
  manager keeps). Written by ``torch.save`` and read back with ``weights_only=True``:
  the state holds tensors and numbers only. A resume state does not cross
  packages (the JAX package's is Orbax's).
* :func:`save_adapter_file` / :func:`load_adapter_file` — the peft-style
  adapter directory (``adapter_model.safetensors`` + ``adapter_config.json``)
  of the JAX package's ``checkpoint.py``, with the same tensor names and the
  same atomic publication, through the port's safetensors codec: an adapter
  written by either package loads in the other. It is an export artifact;
  weight sync never goes through it.
* :func:`save_rollout_state` / :func:`load_rollout_state` — the async
  rollout regime's in-flight state (the buffer's queued trajectories, the
  producer's episode/batch cursor, the admission counters): numpy and str
  payloads, not tensors, so a pickle sidecar beside ``step_<N>.pt`` keyed by
  the same step (JAX ``checkpoint.py:37-87``). A resumed run reloads the
  unconsumed buffer and restarts the producer at its cursor; a missing or
  corrupt sidecar degrades to a fresh buffer.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import shutil
import tempfile
from typing import Any

import torch

from distrl_llm_tpu_torch.utils import safetensors_io

Params = dict[str, Any]

_CKPT = re.compile(r"^step_(\d+)\.pt$")
MAX_TO_KEEP = 3

log = logging.getLogger(__name__)


def rollout_state_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"rollout_state_{step}.pkl")


def save_rollout_state(directory: str, step: int, state: dict,
                       keep: int = MAX_TO_KEEP) -> str:
    """Atomically write the rollout sidecar for ``step``; prune sidecars past
    the newest ``keep``, as the checkpoints are."""
    path = rollout_state_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)
    folder = os.path.dirname(path)
    stale = sorted((p for p in os.listdir(folder)
                    if p.startswith("rollout_state_") and p.endswith(".pkl")),
                   key=lambda p: int(p[len("rollout_state_"):-len(".pkl")]))[:-keep]
    for name in stale:
        try:
            os.remove(os.path.join(folder, name))
        except OSError:  # a concurrent save already pruned it
            pass
    return path


def load_rollout_state(directory: str, step: int) -> dict | None:
    """The sidecar for ``step``; None when absent or unreadable (a corrupt
    sidecar degrades to a fresh buffer and never blocks the resume)."""
    path = rollout_state_path(directory, step)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:  # noqa: BLE001 — corrupt sidecar: warn and start fresh
        log.warning("rollout sidecar %s unreadable; resuming with an empty buffer", path)
        return None


class CheckpointManager:
    """Save and restore the learner state as ``<directory>/step_<N>.pt``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        """Saved steps, ascending."""
        found = (_CKPT.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` for ``step`` (a temp file renamed into place, so a
        crash never leaves a truncated checkpoint), then prune past the
        newest ``MAX_TO_KEEP``."""
        tmp = self.path(step) + f".tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-MAX_TO_KEEP]:
            try:
                os.remove(self.path(old))
            except OSError:  # a concurrent save already pruned it
                pass

    def restore(self, step: int | None = None, *, mmap: bool = False) -> dict | None:
        """The state saved at ``step`` (default the latest) on the CPU; None
        when there is no checkpoint. ``mmap``: the tensors map the file
        (copy on write) and are read only where used, as a rank of a learner
        mesh reads only its shards' ranges."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True, mmap=mmap)


# the adapter's peft tensor names: the stacked [L, in, out] layout unstacks
# to per-layer peft names, loadable by peft-compatible tooling (the
# reference's adapter is a peft save_lora output, distributed_actor.py:84-86)
_PEFT_NAMES = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj",
    "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}


def _tensor_name(layer: int, peft: str, ab: str) -> str:
    return f"base_model.model.model.layers.{layer}.{peft}.lora_{ab}.weight"


def save_adapter_file(lora: Params, path: str, *, rank: int, alpha: float,
                      model_name: str = "") -> None:
    """Write a peft-style adapter directory: adapter_model.safetensors +
    adapter_config.json, from the stacked layout ``lora["layers"][key]["a"]``
    [L, in, r] and ``["b"]`` [L, r, out] (peft stores lora_A [r, in] and
    lora_B [out, r], f32).

    Atomic: everything is written into a sibling temp directory first. In
    the steady state (per-step saves, unchanged config) only the tensors
    file is replaced, by one rename; a changed config swaps the whole
    directory, so a reader never pairs new tensors with a stale config."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {}
    for key, mats in lora.get("layers", lora).items():
        peft = _PEFT_NAMES.get(key, key)
        a = mats["a"].detach().to("cpu", torch.float32)
        b = mats["b"].detach().to("cpu", torch.float32)
        for layer in range(a.shape[0]):
            tensors[_tensor_name(layer, peft, "A")] = a[layer].T.contiguous()
            tensors[_tensor_name(layer, peft, "B")] = b[layer].T.contiguous()
    config = {
        "peft_type": "LORA",
        "r": rank,
        "lora_alpha": alpha,
        "base_model_name_or_path": model_name,
        "target_modules": sorted({v.rsplit(".", 1)[-1] for v in _PEFT_NAMES.values()}),
    }
    config_text = json.dumps(config, indent=2)
    cfg_path = os.path.join(path, "adapter_config.json")
    try:
        with open(cfg_path) as f:
            config_unchanged = f.read() == config_text
    except OSError:
        config_unchanged = False
    # same-parent temp dir so every rename stays on one filesystem
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp",
                           dir=os.path.dirname(path) or ".")
    try:
        safetensors_io.save_file(tensors, os.path.join(tmp, "adapter_model.safetensors"))
        if config_unchanged:
            os.replace(os.path.join(tmp, "adapter_model.safetensors"),
                       os.path.join(path, "adapter_model.safetensors"))
        else:
            with open(os.path.join(tmp, "adapter_config.json"), "w") as f:
                f.write(config_text)
            if not os.listdir(path):
                os.replace(tmp, path)  # POSIX renames onto an empty directory
                tmp = None
            else:
                old = path + f".old{os.getpid()}"
                os.rename(path, old)
                os.rename(tmp, path)
                tmp = old
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def load_adapter_file(path: str, template: Params) -> Params:
    """Read an adapter directory back into the stacked layout, each tensor
    with its ``template`` counterpart's dtype and device."""
    tensors = safetensors_io.load_file(os.path.join(path, "adapter_model.safetensors"))
    nested = "layers" in template and isinstance(template.get("layers"), dict)
    layer_template = template["layers"] if nested else template
    out: Params = {}
    for key, mats in layer_template.items():
        peft = _PEFT_NAMES.get(key, key)
        stacked = {}
        for ab, name in (("a", "A"), ("b", "B")):
            t = mats[ab]
            stacked[ab] = torch.stack([tensors[_tensor_name(layer, peft, name)].T
                                       for layer in range(t.shape[0])]).to(t.device, t.dtype)
        out[key] = stacked
    return {"layers": out} if nested else out
