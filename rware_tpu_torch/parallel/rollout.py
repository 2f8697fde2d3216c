"""Batched rollouts (the counterpart of ``rware_tpu/parallel/rollout.py``).

The env axis is the tensors' leading axis and the time axis a Python loop;
every random draw comes from the Philox stream of
:mod:`rware_tpu_torch.ops.philox`, keyed by one integer seed, so a rollout
gives the same result on every device and the same draws as the fused
kernels.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from rware_tpu_torch.core.engine import build_transition_fn, n_reset_draws
from rware_tpu_torch.core.env import Warehouse
from rware_tpu_torch.core.state import WarehouseState
from rware_tpu_torch.ops import philox


class Trajectory(NamedTuple):
    """Stacked (T, B, ...) rollout tensors."""

    obs: Any  # (T, B, N, ...) observations seen BEFORE each action
    actions: torch.Tensor  # (T, B, N) int32, or (T, B, N, 1 + M) with message bits
    rewards: torch.Tensor  # (T, B, N) float32
    dones: torch.Tensor  # (T, B) bool
    info: dict


def autoreset_select(reset_fn, state: WarehouseState, done: torch.Tensor,
                     bits: torch.Tensor) -> WarehouseState:
    """Replace the state of every env where ``done`` with a fresh reset
    drawn from ``bits`` (B, 2N+R)."""
    return reset_fn(bits).where(done, state)


def random_policy(env: Warehouse) -> Callable:
    """``policy(obs, seed, step) -> (B, N)`` uniform random actions, drawn as
    the fused rollout kernel draws them (``_rand_mod(5)`` per agent); with
    message bits ``(B, N, 1 + M)``, each bit ``_rand_mod(2)`` of purpose
    MESSAGE, slot ``i * M + m``."""
    n, m = env.config.n_agents, env.config.msg_bits

    def policy(obs: Any, seed: int, step: int) -> torch.Tensor:
        envs = torch.arange(obs.shape[0], device=obs.device)
        bits = philox.uniform_bits(seed, envs, step, philox.ACTION, n)
        acts = philox.rand_mod(bits, 5).to(torch.int32)
        if not m:
            return acts
        msg = philox.rand_mod(philox.uniform_bits(seed, envs, step, philox.MESSAGE, n * m), 2)
        return torch.cat([acts[..., None], msg.to(torch.int32).reshape(-1, n, m)], dim=-1)

    return policy


def build_batched_rollout_fn(
    env: Warehouse,
    policy: Optional[Callable] = None,
    *,
    n_steps: int,
    autoreset: bool = True,
) -> Callable[[WarehouseState, int], tuple]:
    """Returns ``rollout(states, seed) -> (final_states, Trajectory)`` with
    (T, B, ...) trajectory tensors.  ``policy(obs, seed, step) -> actions``
    defaults to uniform random."""
    if policy is None:
        policy = random_policy(env)
    transition = build_transition_fn(env.config)
    reset_fn = env._reset_fn
    obs_fn = env._obs_fn
    n_goals = env.layout.n_goals
    n_draws = n_reset_draws(env.config)

    def rollout(states: WarehouseState, seed: int):
        envs = torch.arange(states.batch_size, device=states.device)
        obs = obs_fn(states)
        out = []
        for t in range(n_steps):
            actions = policy(obs, seed, t)
            qbits = philox.uniform_bits(seed, envs, t, philox.QUEUE, n_goals)
            next_state, rewards, done, info = transition(states, actions, qbits)
            if autoreset:
                rbits = philox.uniform_bits(seed, envs, t, philox.RESPAWN, n_draws)
                next_state = autoreset_select(reset_fn, next_state, done, rbits)
            out.append((obs, actions, rewards, done, info))
            states, obs = next_state, obs_fn(next_state)
        obs_t, act_t, rew_t, done_t, info_t = zip(*out)
        info = {k: torch.stack([i[k] for i in info_t]) for k in info_t[0]}
        traj = Trajectory(
            torch.stack(obs_t), torch.stack(act_t), torch.stack(rew_t),
            torch.stack(done_t), info,
        )
        return states, traj

    return rollout


def batched_reset(env: Warehouse, seed: int, n_envs: int, env_offset: int = 0):
    """(states, obs) for ``n_envs`` parallel envs on ``env.device`` from one
    seed (Philox purpose RESET), env i keyed by its global index ``env_offset
    + i``: a shard's reset equals those rows of the global reset bit for
    bit."""
    envs = philox.env_ids(n_envs, env_offset, env.device)
    bits = philox.uniform_bits(seed, envs, 0, philox.RESET, n_reset_draws(env.config))
    states = env._reset_fn(bits)
    return states, env._obs_fn(states)
