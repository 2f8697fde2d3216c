"""Batched rollouts and resets, and the env batch's data-parallel sharding."""
from rware_tpu_torch.parallel.rollout import (
    Trajectory,
    autoreset_select,
    batched_reset,
    build_batched_rollout_fn,
    build_scan_collect,
    random_policy,
)
from rware_tpu_torch.parallel.sharding import (
    ENV_AXIS,
    Mesh,
    data_parallel,
    make_mesh,
    psum,
    replicate,
    shard_env_batch,
)

__all__ = [
    "ENV_AXIS",
    "Mesh",
    "Trajectory",
    "autoreset_select",
    "batched_reset",
    "build_batched_rollout_fn",
    "build_scan_collect",
    "data_parallel",
    "make_mesh",
    "psum",
    "random_policy",
    "replicate",
    "shard_env_batch",
]
