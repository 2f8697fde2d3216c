"""Environment facade (the counterpart of ``rware_tpu/core/env.py``).

``Warehouse`` bundles the reset/step/observe functions of one config on one
device.  State flows through the caller, batched over a leading env axis;
random draws come from a ``torch.Generator`` the caller passes (it must live
on the env's device).

Usage::

    env = rware_tpu_torch.make("rware-tiny-2ag-v2", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, obs = env.reset(gen, n_envs=4096)
    result = env.step(state, env.sample_actions(gen, 4096), gen)
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from rware_tpu_torch.config import WarehouseConfig
from rware_tpu_torch.core.engine import (
    StepResult,
    build_obs_fn,
    build_reset_fn,
    build_step_fn,
    n_reset_draws,
)
from rware_tpu_torch.core.state import WarehouseState


def _bits(generator: torch.Generator, shape) -> torch.Tensor:
    """Raw uint32 draws (held in int64) from ``generator``."""
    return torch.randint(
        0, 2**32, shape, generator=generator, device=generator.device,
        dtype=torch.int64,
    )


class Warehouse:
    """Batched warehouse environment for one static config on one device."""

    def __init__(self, config: Optional[WarehouseConfig] = None, device="cpu", **kwargs):
        if config is None:
            config = WarehouseConfig(**kwargs)
        elif kwargs:
            raise TypeError("Pass either a config or kwargs, not both")
        if config.msg_bits:
            raise NotImplementedError("message bits are not ported yet")
        self.config = config
        self.device = torch.device(device)
        self.layout = config.compile_layout()
        self._obs_fn = build_obs_fn(config)
        self._reset_fn = build_reset_fn(config)
        self._step_fn = build_step_fn(config, self._obs_fn)

    # -- core API --------------------------------------------------------------

    def reset_state(self, generator: torch.Generator, n_envs: int) -> WarehouseState:
        return self._reset_fn(_bits(generator, (n_envs, n_reset_draws(self.config))))

    def reset(self, generator: torch.Generator, n_envs: int) -> Tuple[WarehouseState, Any]:
        state = self.reset_state(generator, n_envs)
        return state, self.observe(state)

    def step(self, state: WarehouseState, actions: torch.Tensor,
             generator: torch.Generator) -> StepResult:
        """One transition; ``generator`` draws the queue resamples."""
        bits = _bits(generator, (state.batch_size, self.layout.n_goals))
        return self._step_fn(state, actions, bits)

    def observe(self, state: WarehouseState) -> Any:
        return self._obs_fn(state)

    def step_autoreset(self, state: WarehouseState, actions: torch.Tensor,
                       generator: torch.Generator) -> StepResult:
        """``step``, then a fresh reset (and its obs) for every env whose
        episode ended — the batched-RL convention."""
        result = self.step(state, actions, generator)
        fresh = self.reset_state(generator, state.batch_size)
        next_state = fresh.where(result.done, result.state)
        obs = torch.where(
            result.done[:, None, None], self._obs_fn(next_state), result.obs
        )
        return result._replace(state=next_state, obs=obs)

    # -- conveniences ----------------------------------------------------------

    @property
    def n_agents(self) -> int:
        return self.config.n_agents

    @property
    def grid_size(self) -> Tuple[int, int]:
        return self.layout.grid_size

    @property
    def n_actions(self) -> int:
        return 5

    def sample_actions(self, generator: torch.Generator, n_envs: int) -> torch.Tensor:
        """Uniform random actions (B, N) int32."""
        return torch.randint(
            0, 5, (n_envs, self.config.n_agents), generator=generator,
            device=generator.device, dtype=torch.int32,
        )
