"""Rank-mesh topology: parallelism axes and the role submeshes.

Counterpart of the JAX package's ``parallel/mesh.py``. The reference maps
roles (rollout actors, learners) to whole GPUs through Ray placement groups
(distributed_actor.py:517-585); JAX carves one global device mesh. Here the
roles are carved from the ranks of the ``torch.distributed`` job, one rank
per card, by the same rules, and each role gets a ``DeviceMesh`` with the
axes

    ("dp", "fsdp", "sp", "tp")

- dp:   data parallel: the update batch's rows, gradients merged by an
        all-reduce (the reference's multi-learner gradient merge)
- fsdp: sharding of the learner state (ZeRO-style), gathered per layer
- sp, tp: sequence and tensor parallelism (ROADMAP item 10b: size 1 here)

With fewer ranks than roles (one card) the roles time-share one mesh, the
reference's hybrid learner-generation in spirit (README.md:19).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist

from distrl_llm_tpu_torch.config import MeshConfig

AXES = ("dp", "fsdp", "sp", "tp")


@dataclass
class RoleMesh:
    """One role's ranks, shaped ``[dp, fsdp, sp, tp]``, and the
    ``DeviceMesh`` over them (None when built without a process group)."""

    ranks: np.ndarray
    device_mesh: object | None = field(default=None, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def dp(self) -> int:
        return self.ranks.shape[0]

    @property
    def fsdp(self) -> int:
        return self.ranks.shape[1]

    @property
    def rank_list(self) -> list[int]:
        return [int(r) for r in self.ranks.flat]

    @property
    def first_rank(self) -> int:
        return int(self.ranks.flat[0])

    def __contains__(self, rank: int) -> bool:
        return rank in self.rank_list

    def coordinate(self, rank: int | None = None) -> tuple[int, ...]:
        """(dp, fsdp, sp, tp) index of ``rank`` (default this process's; rank
        0 without a process group)."""
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in this mesh {self.rank_list}")
        return tuple(int(i) for i in where[0])

    def group(self, axis: str):
        """This process's group along ``axis`` (the ranks that differ from
        it only there)."""
        return self.device_mesh.get_group(axis)


@dataclass
class RoleMeshes:
    """The carved-up ranks: ``rollout`` serves generation, ``learner`` the
    train step; ``timeshared`` means both are the same mesh."""

    rollout: RoleMesh
    learner: RoleMesh
    timeshared: bool


def _make_mesh(ranks: list[int], tp: int, sp: int, fsdp: int) -> np.ndarray:
    n = len(ranks)
    denom = tp * sp * fsdp
    if n % denom != 0:
        raise ValueError(f"{n} devices not divisible by tp*sp*fsdp={denom}")
    return np.asarray(ranks).reshape(n // denom, fsdp, sp, tp)


def carve_roles(cfg: MeshConfig, ranks: list[int]) -> tuple[np.ndarray, np.ndarray, bool]:
    """(rollout ranks, learner ranks, timeshared), each ``[dp, fsdp, sp,
    tp]``: the JAX ``build_role_meshes`` rules over a rank list. Each role is
    one dp group of ``tp * sp * fsdp`` ranks: actors first, learners after
    (the reference's first-N / next-M GPU assignment,
    distributed_actor.py:535-537)."""
    per_role = cfg.tp * cfg.sp * cfg.fsdp
    needed = cfg.num_roles * per_role
    if len(ranks) < needed:
        if not cfg.allow_timeshare:
            raise RuntimeError(
                f"Not enough devices. Available: {len(ranks)}, Required: {needed}")
        if len(ranks) < per_role:
            raise RuntimeError(
                f"Need at least tp*sp*fsdp={per_role} devices, have {len(ranks)}")
        usable = max(per_role, len(ranks) - len(ranks) % per_role)
        mesh = _make_mesh(ranks[:usable], cfg.tp, cfg.sp, cfg.fsdp)
        return mesh, mesh, True
    if cfg.number_of_actors == 0:
        # learners generate too (the reference allows actors=0,
        # train_distributed.py:27): rollout aliases the learner mesh
        mesh = _make_mesh(ranks[: cfg.number_of_learners * per_role], cfg.tp, cfg.sp, cfg.fsdp)
        return mesh, mesh, True
    n_rollout = cfg.number_of_actors * per_role
    rollout = _make_mesh(ranks[:n_rollout], cfg.tp, cfg.sp, cfg.fsdp)
    learner = _make_mesh(ranks[n_rollout: n_rollout + cfg.number_of_learners * per_role],
                         cfg.tp, cfg.sp, cfg.fsdp)
    return rollout, learner, False


def build_role_meshes(cfg: MeshConfig) -> RoleMeshes:
    """Carve the job's ranks into role meshes, each with
    its ``DeviceMesh`` when a process group exists. Every rank must call it
    (building a ``DeviceMesh`` makes its groups, a collective)."""
    grouped = dist.is_initialized()
    ranks = list(range(dist.get_world_size() if grouped else 1))
    rollout, learner, timeshared = carve_roles(cfg, ranks)

    def role(arr: np.ndarray) -> RoleMesh:
        if not grouped:
            return RoleMesh(arr)
        from torch.distributed.device_mesh import DeviceMesh

        dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return RoleMesh(arr, DeviceMesh(dtype, arr.tolist(), mesh_dim_names=AXES))

    r = role(rollout)
    return RoleMeshes(rollout=r, learner=r if timeshared else role(learner),
                      timeshared=timeshared)
