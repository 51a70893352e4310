"""The multi-process rollout runtime: the C++ control plane, remote rollout
workers, the versioned weight bus and their resilience layer (ROADMAP queue
1 item 9). ``initialize_distributed`` (the JAX package's
``jax.distributed`` entry) is item 10."""

from distrl_llm_tpu_torch.distributed.control_plane import (
    DriverClient,
    WorkerDeadError,
    WorkerServer,
)
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
]
