"""Multi-process entry: ``torch.distributed`` process group and topology.

Counterpart of the JAX package's ``distributed/launch.py``, where
``jax.distributed.initialize`` wires one process per TPU host into one
global device set. PyTorch runs one process per card: each rank joins one
process group (NCCL on the card, gloo on the CPU), and the roles are carved
from the global rank list (``parallel/mesh.py::build_role_meshes``). Rank 0
is the driver: it owns the training loop, the rewards, the metrics sink and
the checkpoints, as JAX's process 0 does; every other rank follows it.

Two launchers are understood: torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``
/ ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, and the JAX package's
``DISTRL_COORDINATOR`` (``host:port``) / ``DISTRL_NUM_PROCESSES`` /
``DISTRL_PROCESS_ID`` (the card: the process id modulo the visible cards).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from distrl_llm_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


@dataclass
class ProcessInfo:
    process_id: int
    num_processes: int
    local_rank: int
    device: torch.device
    backend: str | None  # None: no process group (one process, none asked for)

    @property
    def is_driver(self) -> bool:
        # rank 0 owns the trainer loop (the reference's single driver process)
        return self.process_id == 0


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device | None = None,  # None = the GPU
    store: dist.Store | None = None,
    group: bool = False,
) -> ProcessInfo:
    """Join the job's process group and report the topology.

    Arguments fall back to the environment (torchrun's variables, then the
    JAX package's ``DISTRL_*``). The backend is NCCL for a CUDA device and
    gloo for the CPU; a CUDA rank runs on ``cuda:{local_rank}``. With one
    process and no coordinator no group is made unless ``group`` asks for
    one (then a one-rank group over an in-process store). ``store`` (a
    ``FileStore`` in the tests) replaces the coordinator's TCP store. A
    process that already joined a group gets its topology back."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "DISTRL_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "DISTRL_PROCESS_ID")
    if coordinator_address is None:
        coordinator_address = os.environ.get("DISTRL_COORDINATOR")
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or 1
    process_id = process_id or 0
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = process_id % max(torch.cuda.device_count(), 1) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        multi = num_processes > 1 or coordinator_address is not None or store is not None
        if not (multi or group):
            return ProcessInfo(0, 1, local_rank, dev, None)
        if num_processes > 1 and store is None and coordinator_address is None:
            raise ValueError("a multi-process job needs a coordinator address "
                             "(MASTER_ADDR / DISTRL_COORDINATOR) or a store")
        if store is None and coordinator_address is None:
            store = dist.HashStore()
        kw = ({"store": store} if store is not None
              else {"init_method": f"tcp://{coordinator_address}"})
        dist.init_process_group(backend, rank=process_id, world_size=num_processes,
                                device_id=dev if dev.type == "cuda" else None, **kw)
        log.info("process group: rank %d/%d over %s on %s", process_id, num_processes,
                 backend, dev)
    return ProcessInfo(dist.get_rank(), dist.get_world_size(), local_rank, dev,
                       dist.get_backend())
