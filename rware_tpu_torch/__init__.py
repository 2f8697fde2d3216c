"""rware_tpu_torch — the multi-robot warehouse (RWARE) engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``rware_tpu``, which stays the reference: the
same module structure and names, batched tensors with a leading env axis,
explicit devices and explicit random sources.

Quick start::

    import torch, rware_tpu_torch
    from rware_tpu_torch.parallel import batched_reset
    from rware_tpu_torch.ops.fused_rollout import build_fused_rollout

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cuda")
    states, obs = batched_reset(env, seed=0, n_envs=65536)
    rollout = build_fused_rollout(env.config, n_steps=256)
    states, rewards_sum, episodes = rollout(states, seed=1)
"""
from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.engine import StepResult
from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.registry import make, parse_env_id
from rware_tpu_torch.types import (
    Action,
    Direction,
    ImageLayer,
    ObservationType,
    RewardType,
)

__version__ = "0.1.0"

__all__ = [
    "Action",
    "Direction",
    "ImageLayer",
    "ObservationType",
    "RewardType",
    "StepResult",
    "Warehouse",
    "WarehouseConfig",
    "WarehouseState",
    "make",
    "parse_env_id",
    "__version__",
]
