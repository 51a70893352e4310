"""The multi-process runtime: the C++ control plane, remote rollout workers,
the versioned weight bus and their resilience layer (ROADMAP queue 1 item
9), and ``initialize_distributed``, the ``torch.distributed`` process group
that learners sharded over ranks run in (item 10a; the JAX package's
``jax.distributed`` entry)."""

from distrl_llm_tpu_torch.distributed.control_plane import (
    DriverClient,
    WorkerDeadError,
    WorkerServer,
)
from distrl_llm_tpu_torch.distributed.launch import ProcessInfo, initialize_distributed
from distrl_llm_tpu_torch.distributed.remote_engine import (
    RemoteEngine,
    connect_remote_engine,
)
from distrl_llm_tpu_torch.distributed.resilience import (
    FaultInjector,
    RetryPolicy,
    ShardFailedError,
    WorkerError,
)
from distrl_llm_tpu_torch.distributed.weight_bus import (
    AdapterCache,
    WeightBus,
    WeightChecksumError,
    WeightVersionError,
)

__all__ = [
    "AdapterCache",
    "DriverClient",
    "FaultInjector",
    "ProcessInfo",
    "RemoteEngine",
    "RetryPolicy",
    "ShardFailedError",
    "WeightBus",
    "WeightChecksumError",
    "WeightVersionError",
    "WorkerDeadError",
    "WorkerError",
    "WorkerServer",
    "connect_remote_engine",
    "initialize_distributed",
]
