"""Learners sharded over ranks (ROADMAP item 10a): the role meshes over the
ranks of a ``torch.distributed`` job and the placement of the learner state
over them."""

from distrl_llm_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    RoleMesh,
    RoleMeshes,
    build_role_meshes,
    carve_roles,
)
from distrl_llm_tpu_torch.parallel.partition import (  # noqa: F401
    ShardedDecoder,
    ShardedLora,
    gather_opt_state,
    shard_opt_state,
    shard_tree,
    spec_for_path,
)
