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
    build_transition_fn,
    n_reset_draws,
)
from rware_tpu_torch.core.observations import build_global_layers_fn
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.types import DEFAULT_GLOBAL_IMAGE_LAYERS


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist.  Nothing
    in the package picks the CPU for a caller who did not ask for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device=\"cpu\" to run on the CPU)")
    return dev


def _bits(generator: torch.Generator, shape) -> torch.Tensor:
    """Raw uint32 draws (held in int64) from ``generator``."""
    return torch.randint(
        0, 2**32, shape, generator=generator, device=generator.device,
        dtype=torch.int64,
    )


class Warehouse:
    """Batched warehouse environment for one static config on one device:
    the card unless the caller names another (``device="cpu"``)."""

    def __init__(self, config: Optional[WarehouseConfig] = None, device="cuda", **kwargs):
        if config is None:
            config = WarehouseConfig(**kwargs)
        elif kwargs:
            raise TypeError("Pass either a config or kwargs, not both")
        self.config = config
        self.device = resolve_device(device)
        self.layout = config.compile_layout()
        self._obs_fn = build_obs_fn(config)
        self._reset_fn = build_reset_fn(config)
        self._step_fn = build_step_fn(config, self._obs_fn)
        self._transition = build_transition_fn(config)
        self._global_image = build_global_layers_fn(config, DEFAULT_GLOBAL_IMAGE_LAYERS)

    # -- core API --------------------------------------------------------------

    def reset_state(self, generator: torch.Generator, n_envs: int) -> WarehouseState:
        return self._reset_fn(_bits(generator, (n_envs, n_reset_draws(self.config))))

    def reset_from_seeds(self, seeds) -> WarehouseState:
        """One env per seed, env i drawn from its own generator seeded
        ``seeds[i]``: the state a one-env ``reset`` from that generator gives."""
        bits = [
            _bits(torch.Generator(device=self.device).manual_seed(int(s)),
                  (1, n_reset_draws(self.config)))
            for s in seeds
        ]
        return self._reset_fn(torch.cat(bits))

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

        def select(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
            done = result.done.reshape((-1,) + (1,) * (old.dim() - 1))
            return torch.where(done, new, old)

        fresh_obs = self._obs_fn(next_state)
        if isinstance(fresh_obs, dict):  # IMAGE_DICT: select leaf by leaf
            obs = {k: select(v, result.obs[k]) for k, v in fresh_obs.items()}
        else:
            obs = select(fresh_obs, result.obs)
        return result._replace(state=next_state, obs=obs)

    def step_next_autoreset(self, state: WarehouseState, prev_done: torch.Tensor,
                            actions: torch.Tensor, generator: torch.Generator) -> StepResult:
        """Gymnasium 1.x ``NEXT_STEP`` autoreset (``rware_tpu/vector.py:94-118``):
        every env flagged in ``prev_done`` (B,) is reset instead of stepped,
        its action ignored, with reward 0, ``done`` False and its info
        zeroed; the others step.  ``generator`` draws the queue resamples,
        then a reset for every env."""
        b = state.batch_size
        new_state, rewards, done, info = self._transition(
            state, actions, _bits(generator, (b, self.layout.n_goals)))
        next_state = self.reset_state(generator, b).where(prev_done, new_state)
        done = done & ~prev_done
        return StepResult(
            state=next_state,
            obs=self._obs_fn(next_state),
            rewards=torch.where(prev_done[:, None], 0.0, rewards),
            done=done,
            truncated=torch.zeros_like(done),
            info={k: torch.where(prev_done, 0, v) for k, v in info.items()},
        )

    # -- conveniences ----------------------------------------------------------

    def global_image(self, state: WarehouseState) -> torch.Tensor:
        """(B, C, H, W) global layer stack over
        ``DEFAULT_GLOBAL_IMAGE_LAYERS`` (``rware_tpu/core/env.py:103-111``)."""
        return self._global_image(state)

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
        """Uniform random actions: (B, N) int32, or (B, N, 1 + msg_bits) with
        uniform message bits after the move when the config has message bits
        (the shape ``step`` takes; ``rware_tpu/core/env.py:125-135``)."""
        n, m = self.config.n_agents, self.config.msg_bits
        kw = dict(generator=generator, device=generator.device, dtype=torch.int32)
        acts = torch.randint(0, 5, (n_envs, n), **kw)
        if not m:
            return acts
        return torch.cat([acts[..., None], torch.randint(0, 2, (n_envs, n, m), **kw)], dim=-1)
