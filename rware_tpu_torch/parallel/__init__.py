"""Batched rollouts and resets."""
from rware_tpu_torch.parallel.rollout import (
    Trajectory,
    autoreset_select,
    batched_reset,
    build_batched_rollout_fn,
    random_policy,
)

__all__ = [
    "Trajectory",
    "autoreset_select",
    "batched_reset",
    "build_batched_rollout_fn",
    "random_policy",
]
