"""Gymnasium ``VectorEnv`` over the port's batched engine (the counterpart of
``rware_tpu/vector.py``).

The reference has no vector API: users wrap N ``Warehouse`` objects in
``gymnasium.vector.SyncVectorEnv`` and step them one Python call per env.
Here the whole batch steps as tensors on one device
(``Warehouse.step_next_autoreset`` through
:class:`rware_tpu_torch.core.host.HostVectorEnv`), so external training loops (cleanrl- or
SB3-style) get the batched engine through the standard ``gym.vector``
contract, with one device-to-host copy a step.

Semantics follow Gymnasium 1.x ``AutoresetMode.NEXT_STEP``: the step that
ends an episode returns its final observation and reward; the *next*
``step`` call resets that env on the device (its action is ignored) and
returns the reset observation with zero reward and ``terminated=False``.

Multi-agent shapes: observations and actions keep the reference's per-agent
tuple structure (batched leaves, via ``gymnasium.vector.utils.batch_space``);
``rewards`` is ``(num_envs, n_agents)`` float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import gymnasium as gym
import numpy as np
import torch
from gymnasium.vector.utils import batch_space

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.core.host import HostVectorEnv, flat_to_dict_batch
from rware_tpu_torch.gym_adapter import GymWarehouse
from rware_tpu_torch.registry import parse_env_id


class VectorGymWarehouse(gym.vector.VectorEnv):
    """``num_envs`` warehouses stepping as one batch on one device."""

    metadata = {
        "render_modes": ["rgb_array"],
        "autoreset_mode": gym.vector.AutoresetMode.NEXT_STEP,
    }

    def __init__(
        self,
        env_id_or_config: Any = "rware-tiny-2ag-v2",
        num_envs: int = 8,
        device="cuda",
        **overrides,
    ):
        if isinstance(env_id_or_config, WarehouseConfig):
            config = env_id_or_config
        else:
            config = parse_env_id(env_id_or_config)
        if overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.num_envs = int(num_envs)
        self._env = Warehouse(config, device=device)
        self._host = HostVectorEnv(self._env, self.num_envs)
        self.device = self._env.device

        # Single-env spaces come from the scalar adapter (one source of truth
        # for the reference space layout); batched spaces are derived.
        proto = GymWarehouse(config, device=self.device)
        self.single_observation_space = proto.observation_space
        self.single_action_space = proto.action_space
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)
        self.action_space = batch_space(self.single_action_space, self.num_envs)

        self._viewer = None

    # -- conversion ------------------------------------------------------------

    def _flat_to_dict_batch(self, flat: np.ndarray) -> dict:
        return flat_to_dict_batch(self.config, flat)

    def _convert_actions(self, actions: Any) -> torch.Tensor:
        """The batched action-space layout (tuple over agents of ``(B,)`` /
        ``(B, 1+msg_bits)`` arrays) or a ready ``(B, N[, ...])`` array, as
        int32 on the env's device (one host-to-device copy)."""
        return self._host.actions_to_device(actions)

    # -- gym.vector API --------------------------------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None):
        """Gymnasium VectorEnv reset.  ``seed`` may be an int (one generator
        for the batch) or a per-env list of ints (env i drawn from a
        generator of its own seeded ``seed[i]``, equal to a one-env
        ``GymWarehouse.reset(seed=seed[i])`` on the same device).
        ``options`` is accepted and ignored (the reference's reset takes
        none)."""
        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2**31 - 1))
        return self._host.reset(seed)

    def step(self, actions):
        if self._host.states is None:
            raise RuntimeError("Call reset() before step()")
        return self._host.step(actions)

    def render(self):
        """rgb_array of env 0 (debug aid)."""
        from rware_tpu_torch.rendering import Viewer

        if self._viewer is None:
            self._viewer = Viewer(self.config)
        return self._viewer.render(self._host.states, return_rgb_array=True)

    def close_extras(self, **kwargs):
        pass

    @property
    def states(self):
        """The batched ``WarehouseState`` (functional escape hatch)."""
        return self._host.states


def make_vec(env_id_or_config: Any = "rware-tiny-2ag-v2", num_envs: int = 8, device="cuda",
             **overrides) -> VectorGymWarehouse:
    """Vectorised counterpart of ``make_gym``."""
    return VectorGymWarehouse(env_id_or_config, num_envs, device=device, **overrides)


def vector_entry_point(num_envs: int = 1, env_id: str = None, device="cuda", **overrides):
    """``gymnasium.make_vec`` hook (registered ids carry
    ``vector_entry_point="rware_tpu_torch.vector:vector_entry_point"``), so
    ``gym.make_vec("rware-tiny-2ag-v2", num_envs=1024)`` returns the batched
    env instead of a host SyncVectorEnv loop."""
    return VectorGymWarehouse(env_id, num_envs, device=device, **overrides)
