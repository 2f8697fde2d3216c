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

The Gymnasium surface (``gym.make("rware-tiny-2ag-v2")`` after ``import
rware_tpu_torch``; ``device="cpu"`` to run on the CPU)::

    import gymnasium as gym, rware_tpu_torch

    env = gym.make("rware-tiny-2ag-v2", device="cuda")
    venv = gym.make_vec("rware-tiny-2ag-v2", num_envs=4096, device="cuda")
"""
import os

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



def make_gym(env_id_or_config, device="cuda", **overrides):
    """Gymnasium-style adapter env on ``device`` (lazy import keeps
    gymnasium optional)."""
    from rware_tpu_torch.gym_adapter import make_gym as _make_gym

    return _make_gym(env_id_or_config, device=device, **overrides)


def make_vec(env_id_or_config, num_envs=8, device="cuda", **overrides):
    """Gymnasium ``VectorEnv`` over the batched engine on ``device`` (lazy
    import)."""
    from rware_tpu_torch.vector import make_vec as _make_vec

    return _make_vec(env_id_or_config, num_envs, device=device, **overrides)


def register_all(force=False, image=False):
    """Register the reference env-id grid with gymnasium (lazy import);
    ``image=True`` adds the -img/-imgdict/-Nd variants.  Runs once at import
    by default (see gym_adapter.register_all)."""
    from rware_tpu_torch.gym_adapter import register_all as _register_all

    return _register_all(force=force, image=image)


__version__ = "0.1.0"

# As ``rware_tpu`` and the reference do, register the default env-id grid at
# import; RWARE_TPU_NO_REGISTER=1 (or RWARE_TPU_AUTO_REGISTER=0) opts out and
# RWARE_TPU_AUTO_REGISTER=image adds the image variants.  Ids another package
# registered first keep their entry points; without gymnasium this passes.
_auto = os.environ.get("RWARE_TPU_AUTO_REGISTER", "1").lower()
if os.environ.get("RWARE_TPU_NO_REGISTER", "").lower() in ("1", "true"):
    _auto = "0"
if _auto not in ("0", "false", ""):
    try:
        from rware_tpu_torch.gym_adapter import register_all as _register_all

        _register_all(image=_auto == "image")
    except ImportError:  # gymnasium not installed: the batched API still works
        pass

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
    "make_gym",
    "make_vec",
    "parse_env_id",
    "register_all",
    "__version__",
]
